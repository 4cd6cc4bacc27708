"""UNetSpatioTemporalConditionModel — the Stable Video Diffusion UNet, NHWC,
as an ``nn.Module`` with diffusers' state-dict names.

Counterpart of ``sfast_tpu/models/unet_spatio_temporal.py``.  Frames fold
into the batch for every spatial op ((B·F, H, W, C) NHWC); the temporal
ops view (B, F, ...) and attend or convolve over F.  Each resnet is a
:class:`SpatioTemporalResBlock` (diffusers' ``spatial_res_block``, a
``ResnetBlock2D`` over each frame, ``temporal_res_block``, a
:class:`TemporalResnetBlock` with (3, 1, 1) convs over the frames, and
``time_mixer.mix_factor``); each attention is a
:class:`TransformerSpatioTemporalModel` (``transformer_blocks`` over the
pixels of a frame, ``temporal_transformer_blocks`` over the frames of a
pixel behind ``time_pos_embed``, blended by ``time_mixer``).

Routing follows ``backends(config)`` as in the 2-D UNet: the spatial
self-attentions at 9,216 and 2,304 tokens (576×1024, levels 0 and 1) take
K1 by ``flash_ok``; the 576-token level, the cross-attentions to the one
image token and the temporal attentions over the frames take the plain
route.  Under ``enable_fused_group_norm`` the GroupNorms take the fused
GroupNorm where ``fused_plan`` accepts the shape, else K3 then K5.  The
LayerNorms of both kinds of transformer block (3 spatial, 4 temporal) take
K7 by ``layer_norm_ok``.

``TransformerSpatioTemporalModel.time_pos_embed`` is diffusers'
``TimestepEmbedding(C, 4·C, out_dim=C)``; JAX's ``init_svd_unet_params``
draws it C → C → C, and ``interop.from_jax`` pads such a tree with zeros
to diffusers' width.
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.models.layers import (
    Attention,
    BasicTransformerBlock,
    Conv2d,
    Downsample2D,
    FeedForward,
    GroupNorm,
    LayerNorm,
    Linear,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    init_weights_,
    quantized_conv,
    timestep_embedding,
)
from sfast_tpu_torch.models.unet_2d_condition import _Block, backends
from sfast_tpu_torch.ops.conv import conv2d
from sfast_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SVDUNetConfig:
    sample_size: int = 96
    in_channels: int = 8  # 4 noisy + 4 conditioning-frame latents
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "DownBlockSpatioTemporal",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    num_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768  # fps, motion, aug × 256
    num_frames: int = 25
    norm_num_groups: int = 32

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


# SVD-XT (stabilityai/stable-video-diffusion-img2vid-xt): 1.5 B parameters
SVD_UNET = SVDUNetConfig()
TINY_SVD_UNET = SVDUNetConfig(
    sample_size=16,
    block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
    up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
    layers_per_block=1,
    transformer_layers_per_block=(1, 1),
    num_heads=(4, 4),
    cross_attention_dim=32,
    projection_class_embeddings_input_dim=3 * 32,
    addition_time_embed_dim=32,
    num_frames=4,
    norm_num_groups=8,
)


# ---------------------------------------------------------------------------
# Temporal building blocks (shared with the temporal VAE decoder)
# ---------------------------------------------------------------------------


class TemporalConv3d(nn.Conv3d):
    """diffusers' ``Conv3d`` with a (3, 1, 1) kernel and zero padding over
    the frames, on an NHWC video (B, F, H, W, C).  The kernel is 1×1 over
    the pixels, so it is the 2-D (3, 1) conv of the folded (B, F, H·W, C)
    plane (JAX ``_conv_temporal2d``): one cuDNN call, f32 accumulation,
    the input's dtype out.  The (C_out, C_in, 3, 1, 1) weight is kept
    channels_last_3d, so that its (C_out, C_in, 3, 1) view is the
    channels_last layout cuDNN reads for an NHWC input.  Quantized (W8A8),
    it holds a (C_out, C_in, 3, 1) ``w_q8``, JAX's 4-D temporal kernel, and
    runs the int8 (3, 1) conv of the same plane."""

    def __init__(self, cin: int, cout: int, *, device=None, dtype=None):
        super().__init__(cin, cout, (3, 1, 1), padding=(1, 0, 0), device=device, dtype=dtype)
        self.weight.data = self.weight.data.contiguous(memory_format=torch.channels_last_3d)

    def forward(self, x5: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = x5.shape
        plane = x5.reshape(b, f, hh * ww, c)
        if self.weight is None:
            y = quantized_conv(self, plane, 1, (1, 0))
        else:
            y = conv2d(plane, self.weight[..., 0], self.bias, padding=(1, 0))
        return y.reshape(b, f, hh, ww, y.shape[-1])


def group_norm_over_frames(norm: GroupNorm, x5: torch.Tensor, *, act=None, backend=None):
    """GroupNorm of a (B, F, H, W, C) video with statistics over
    (C/G, F, H, W) per sample: diffusers applies torch's GroupNorm to
    (B, C, F, H, W), so the frames share the statistics.  Folding F into
    the height gives the NHWC op the same reduction; normalizing each
    frame alone would be a silent numerics bug (JAX ``_gn_over_frames``)."""
    b, f, hh, ww, c = x5.shape
    return norm(x5.reshape(b, f * hh, ww, c), act=act, backend=backend).reshape(b, f, hh, ww, c)


class AlphaBlender(nn.Module):
    """diffusers' ``AlphaBlender`` ('learned'): ``mix_factor`` (1,) f32,
    α = σ(mix_factor), out = α·spatial + (1 − α)·temporal in f32, cast to
    the spatial input's dtype.  ``switch`` (the temporal decoder's
    ``switch_spatial_to_temporal_mix``) takes 1 − α as the spatial weight."""

    def __init__(self, merge_factor: float, *, switch: bool = False, device=None):
        super().__init__()
        self.merge_factor = merge_factor
        self.switch = switch
        self.mix_factor = nn.Parameter(
            torch.full((1,), merge_factor, dtype=torch.float32, device=device))

    def forward(self, spatial: torch.Tensor, temporal: torch.Tensor) -> torch.Tensor:
        a = torch.sigmoid(self.mix_factor.float())
        if self.switch:
            a = 1.0 - a
        return (a * spatial.float() + (1.0 - a) * temporal.float()).to(spatial.dtype)


class TemporalResnetBlock(nn.Module):
    """GroupNorm+SiLU over the frames, (3, 1, 1) conv, the time embedding's
    projection per frame, GroupNorm+SiLU, conv, plus the input (JAX
    ``_temporal_resnet_fwd``)."""

    def __init__(self, c: int, temb_dim, *, groups: int, eps: float = 1e-5, device=None,
                 dtype=None):
        super().__init__()
        f32 = dict(device=device, dtype=torch.float32)
        mk = dict(device=device, dtype=dtype)
        self.norm1 = GroupNorm(groups, c, eps=eps, **f32)
        self.conv1 = TemporalConv3d(c, c, **mk)
        self.time_emb_proj = Linear(temb_dim, c, **mk) if temb_dim is not None else None
        self.norm2 = GroupNorm(groups, c, eps=eps, **f32)
        self.conv2 = TemporalConv3d(c, c, **mk)

    def forward(self, x5, temb=None, *, gn_backend=None):
        b, f, _, _, c = x5.shape
        h = self.conv1(group_norm_over_frames(self.norm1, x5, act="silu", backend=gn_backend))
        if temb is not None and self.time_emb_proj is not None:
            te = self.time_emb_proj(torch.nn.functional.silu(temb.float()).to(temb.dtype))
            h = h + te.reshape(b, f, 1, 1, c).to(h.dtype)
        h = self.conv2(group_norm_over_frames(self.norm2, h, act="silu", backend=gn_backend))
        return x5 + h


class SpatioTemporalResBlock(nn.Module):
    """``spatial_res_block`` over each frame, ``temporal_res_block`` over
    its output's frames, blended by ``time_mixer`` (JAX ``_st_resnet_fwd``;
    the temporal decoder's ``_dec_st_resnet_fwd`` with ``switch``)."""

    def __init__(self, cin: int, cout: int, temb_dim, *, groups: int, eps: float = 1e-5,
                 temporal_eps: float = 1e-5, merge_factor: float = 0.5, switch: bool = False,
                 device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb_dim, groups=groups, eps=eps, **mk)
        self.temporal_res_block = TemporalResnetBlock(cout, temb_dim, groups=groups,
                                                      eps=temporal_eps, **mk)
        self.time_mixer = AlphaBlender(merge_factor, switch=switch, device=device)

    def forward(self, x, temb=None, *, num_frames: int, gn_backend=None, conv_backend=None):
        """x (B·F, H, W, C_in) → (B·F, H, W, C_out)."""
        h = self.spatial_res_block(x, temb, gn_backend=gn_backend, conv_backend=conv_backend)
        bf, hh, ww, c = h.shape
        h5 = h.reshape(bf // num_frames, num_frames, hh, ww, c)
        t5 = self.temporal_res_block(h5, temb, gn_backend=gn_backend)
        return self.time_mixer(h5, t5).to(x.dtype).reshape(bf, hh, ww, c)


class TemporalBasicTransformerBlock(nn.Module):
    """diffusers' ``TemporalBasicTransformerBlock`` over (B·H·W, F, C):
    ``ff_in`` with its residual, self-attention over the frames, the
    cross-attention to the time context, the feed-forward (JAX
    ``_temporal_transformer_block_fwd``)."""

    def __init__(self, dim: int, heads: int, context_dim: int, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.norm_in = LayerNorm(dim, **f32)
        self.ff_in = FeedForward(dim, **mk)
        self.norm1 = LayerNorm(dim, **f32)
        self.attn1 = Attention(dim, heads, **mk)
        self.norm2 = LayerNorm(dim, **f32)
        self.attn2 = Attention(dim, heads, context_dim=context_dim, **mk)
        self.norm3 = LayerNorm(dim, **f32)
        self.ff = FeedForward(dim, **mk)

    def forward(self, x, context=None, *, attn_backend=None, geglu_backend=None,
                ln_backend=None):
        x = x + self.ff_in(self.norm_in(x, ln_backend), geglu_backend=geglu_backend)
        x = x + self.attn1(self.norm1(x, ln_backend), attn_backend=attn_backend)
        if context is not None:
            x = x + self.attn2(self.norm2(x, ln_backend), context, attn_backend=attn_backend)
        return x + self.ff(self.norm3(x, ln_backend), geglu_backend=geglu_backend)


class TransformerSpatioTemporalModel(nn.Module):
    """GroupNorm (32 groups, eps 1e-6, whatever the model's group count, as
    diffusers), linear ``proj_in``, spatial and temporal blocks in turn
    (the frame-position embedding added before each temporal block, its
    context frame 0's tokens), each pair blended in f32, ``proj_out``, plus
    the input (JAX ``_st_transformer_fwd``)."""

    def __init__(self, c: int, heads: int, context_dim: int, *, depth: int = 1,
                 device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.norm = GroupNorm(32, c, eps=1e-6, device=device, dtype=torch.float32)
        self.proj_in = Linear(c, c, **mk)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(c, heads, context_dim, **mk) for _ in range(depth)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(c, heads, context_dim, **mk) for _ in range(depth)])
        self.time_pos_embed = TimestepEmbedding(c, 4 * c, out_dim=c, **mk)
        self.proj_out = Linear(c, c, **mk)
        self.time_mixer = AlphaBlender(0.5, device=device)

    def forward(self, x, context, *, num_frames: int, gn_backend=None, attn_backend=None,
                geglu_backend=None, ln_backend=None):
        """x (B·F, H, W, C); context (B·F, S, D), the image token per frame."""
        bf, hh, ww, c = x.shape
        b, hw = bf // num_frames, hh * ww
        h = self.proj_in(self.norm(x, backend=gn_backend).reshape(bf, hw, c))
        f_idx = torch.arange(num_frames, dtype=torch.float32, device=x.device)
        t_emb = self.time_pos_embed(timestep_embedding(f_idx, c).to(x.dtype))  # (F, C)
        # the temporal blocks' context: frame 0's tokens, one copy per pixel
        time_context = context.reshape(b, num_frames, *context.shape[1:])[:, 0]
        time_context = time_context.repeat_interleave(hw, dim=0)  # (B·HW, S, D)
        kw = dict(attn_backend=attn_backend, geglu_backend=geglu_backend, ln_backend=ln_backend)
        for blk, tblk in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = blk(h, context, **kw)
            ht = h.reshape(b, num_frames, hw, c).transpose(1, 2).reshape(b * hw, num_frames, c)
            ht = tblk(ht + t_emb[None], time_context, **kw)
            ht = ht.reshape(b, hw, num_frames, c).transpose(1, 2).reshape(bf, hw, c)
            h = self.time_mixer(h, ht).to(x.dtype)
        return self.proj_out(h).reshape(bf, hh, ww, c) + x


# ---------------------------------------------------------------------------
# The UNet
# ---------------------------------------------------------------------------


def reset_mix_factors_(module: nn.Module) -> nn.Module:
    """Every ``AlphaBlender.mix_factor`` back to its merge factor."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, AlphaBlender):
                m.mix_factor.fill_(m.merge_factor)
    return module


def init_svd_unet_weights_(unet: nn.Module, generator: torch.Generator) -> nn.Module:
    """``init_weights_`` (the temporal convs N(0, 1/(3·C)), as JAX draws
    them), then each ``mix_factor`` at its merge factor, 0.5 as JAX's
    ``init_svd_unet_params``: both branches reach the output."""
    return reset_mix_factors_(init_weights_(unet, generator))


class UNetSpatioTemporalConditionModel(nn.Module):
    def __init__(self, cfg: SVDUNetConfig = SVD_UNET, *, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        self.compilation_config = CompilationConfig.Default()
        mk = dict(device=device, dtype=dtype)
        boc = cfg.block_out_channels
        n_levels = len(boc)
        temb = cfg.time_embed_dim

        def resnet(cin, cout):
            return SpatioTemporalResBlock(cin, cout, temb, groups=cfg.norm_num_groups, **mk)

        def transformer(c, level):
            return TransformerSpatioTemporalModel(
                c, cfg.num_heads[level], cfg.cross_attention_dim,
                depth=cfg.transformer_layers_per_block[level], **mk)

        self.conv_in = Conv2d(cfg.in_channels, boc[0], 3, padding=1, **mk)
        self.time_embedding = TimestepEmbedding(boc[0], temb, **mk)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb,
                                               **mk)
        down = []
        c_out = boc[0]
        for i, btype in enumerate(cfg.down_block_types):
            c_in, c_out = c_out, boc[i]
            down.append(_Block(
                [resnet(c_in if j == 0 else c_out, c_out) for j in range(cfg.layers_per_block)],
                [transformer(c_out, i) for _ in range(cfg.layers_per_block)]
                if btype.startswith("CrossAttn") else None,
                downsample=Downsample2D(c_out, **mk) if i < n_levels - 1 else None,
            ))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Block([resnet(boc[-1], boc[-1]), resnet(boc[-1], boc[-1])],
                                [transformer(boc[-1], n_levels - 1)])
        up = []
        rev = list(reversed(boc))
        c_prev = rev[0]
        for i, btype in enumerate(cfg.up_block_types):
            c_out = rev[i]
            c_skip_in = rev[min(i + 1, n_levels - 1)]
            resnets = []
            for j in range(cfg.layers_per_block + 1):
                res_skip = c_skip_in if j == cfg.layers_per_block else c_out
                resnets.append(resnet((c_prev if j == 0 else c_out) + res_skip, c_out))
            up.append(_Block(
                resnets,
                [transformer(c_out, n_levels - 1 - i) for _ in range(cfg.layers_per_block + 1)]
                if btype.startswith("CrossAttn") else None,
                upsample=Upsample2D(c_out, **mk) if i < n_levels - 1 else None,
            ))
            c_prev = c_out
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[0], device=device,
                                       dtype=torch.float32)
        self.conv_out = Conv2d(boc[0], cfg.out_channels, 3, padding=1, **mk)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def _level(self, blk, j, h, emb, context, f, be):
        h = blk.resnets[j](h, emb, num_frames=f, gn_backend=be["gn"], conv_backend=be["conv"])
        if blk.attentions is not None:
            h = blk.attentions[j](h, context, num_frames=f, gn_backend=be["gn"],
                                  attn_backend=be["attn"], geglu_backend=be["geglu"],
                                  ln_backend=be["ln"])
        return h

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, added_time_ids: torch.Tensor) -> torch.Tensor:
        """sample (B, F, H, W, C_in) NHWC video latents, timesteps () or
        (B,), encoder_hidden_states (B, 1, cross_dim) (the CLIP image
        embedding), added_time_ids (B, 3) = (fps − 1, motion bucket, noise
        augmentation) → (B, F, H, W, C_out).  Each frame takes its video's
        time embedding and context (JAX ``svd_unet_fwd``)."""
        cfg = self.config
        be = backends(self.compilation_config)
        dtype = self.dtype
        b, f, hh, ww, cin = sample.shape
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(b)
        emb = self.time_embedding(timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dtype))
        add = timestep_embedding(added_time_ids.reshape(-1), cfg.addition_time_embed_dim)
        emb = emb + self.add_embedding(add.reshape(b, -1).to(dtype))
        emb = emb.repeat_interleave(f, dim=0)  # (B·F, T)
        context = encoder_hidden_states.to(dtype).repeat_interleave(f, dim=0)  # (B·F, S, D)

        h = self.conv_in(sample.reshape(b * f, hh, ww, cin).to(dtype))
        res_stack = [h]
        for blk in self.down_blocks:
            for j in range(len(blk.resnets)):
                h = self._level(blk, j, h, emb, context, f, be)
                res_stack.append(h)
            if blk.downsamplers is not None:
                h = blk.downsamplers[0](h)
                res_stack.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, emb, num_frames=f, gn_backend=be["gn"], conv_backend=be["conv"])
        h = mid.attentions[0](h, context, num_frames=f, gn_backend=be["gn"],
                              attn_backend=be["attn"], geglu_backend=be["geglu"],
                              ln_backend=be["ln"])
        h = mid.resnets[1](h, emb, num_frames=f, gn_backend=be["gn"], conv_backend=be["conv"])
        for blk in self.up_blocks:
            for j in range(len(blk.resnets)):
                h = torch.cat([h, res_stack.pop().to(h.dtype)], dim=-1)
                h = self._level(blk, j, h, emb, context, f, be)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h, conv_backend=be["conv"])
        h = self.conv_out(self.conv_norm_out(h, act="silu", backend=be["gn"]))
        return h.reshape(b, f, hh, ww, cfg.out_channels)
