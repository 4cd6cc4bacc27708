"""The plain reference of SVD-XT: the spatio-temporal UNet, the temporal
VAE (its KL encoder's posterior mean and its temporal decoder) and the
CLIP ViT-H vision encoder with its projection.

Straightforward PyTorch after diffusers' ``UNetSpatioTemporalConditionModel``
(``unet_3d_blocks.py``'s spatio-temporal blocks, ``TransformerSpatioTemporalModel``,
``TemporalBasicTransformerBlock``, ``AlphaBlender``) and
``AutoencoderKLTemporalDecoder``, and transformers'
``CLIPVisionModelWithProjection``, in NCHW (a video is (B, C, F, H, W)
where diffusers makes it so), with their state-dict names.  It imports
nothing but torch and the plain modules of ``families/sd_unet_lib/reference.py``
(the linear and conv layers that read their operands through ``operand``,
the materialized attention, the 2-D resnet, the resamplers, GEGLU, CLIP's
MLP, the VAE's attention and its encoder's module names): nothing of the program under test.  The
benchmark runs it in float32 with TF32 off; ``set_operand_precision`` puts
every product, the temporal ``Conv3d`` included, in fp8 for the control.

The blend of a spatial and a temporal branch is ``AlphaBlender`` with no
image-only frames: α = σ(``mix_factor``), out = α·spatial + (1 − α)·temporal
(``learned_with_images`` in the UNet, ``learned`` with
``switch_spatial_to_temporal_mix`` in the decoder, which swaps the two
weights).  Where the reference departs from diffusers, on purpose:

- the spatial self-attention is computed a few batch rows at a time
  (:func:`blocked_attention`): the whole batch-50 score matrix at 9,216
  tokens is 85 GB in float32.  Each row's softmax is whole, so this is a
  blocking and no approximation;
- the modules take their GroupNorm group count from the configuration
  (``norm_num_groups``, 32 where absent, diffusers' fixed value), so that
  the CPU tests can build them at tiny widths.
"""

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from families.sd_unet_lib.reference import (
    CLIPMLP,
    Conv2d,
    Downsample2D,
    FeedForward,
    Linear,
    Operand,
    ResnetBlock2D,
    Upsample2D,
    VAEAttention,
    _Block,
    _Coder,
    _per_level,
    attention,
    levels,
    no_tf32,
    set_operand_precision,
    sinusoid,
)

__all__ = ["UNetSpatioTemporalConditionModel", "AutoencoderKLTemporalDecoder",
           "CLIPVisionModelWithProjection", "levels", "no_tf32", "set_operand_precision"]

ATTENTION_BYTES = 1 << 30  # the float32 scores of one block of batch rows, at most
GROUPS = 32  # diffusers' GroupNorm group count in every one of these blocks


def blocked_attention(q, k, v, operand, max_bytes: int = ATTENTION_BYTES):
    """softmax(q·kᵀ/√d)·v over (B, H, S, D), materialized for as many batch
    rows at a time as keep the scores under ``max_bytes``."""
    b, h, sq, _ = q.shape
    rows = max(1, max_bytes // (h * sq * k.shape[2] * 4))
    if rows >= b:
        return attention(q, k, v, operand)
    return torch.cat([attention(q[i:i + rows], k[i:i + rows], v[i:i + rows], operand)
                      for i in range(0, b, rows)])


class Conv3d(nn.Conv3d, Operand):
    def forward(self, x):
        q = self.operand
        return F.conv3d(q(x), q(self.weight), self.bias, self.stride, self.padding)


class Attention(nn.Module, Operand):
    """diffusers' ``Attention`` of a transformer block: bias-free q, k, v,
    ``to_out`` with its bias; the scores blocked over the batch."""

    def __init__(self, d, heads, ctx_dim=None):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(d, d, bias=False)
        self.to_k = Linear(ctx_dim or d, d, bias=False)
        self.to_v = Linear(ctx_dim or d, d, bias=False)
        self.to_out = nn.ModuleList([Linear(d, d)])

    def forward(self, x, ctx=None):
        b, s, d = x.shape
        ctx = x if ctx is None else ctx

        def split(t):
            return t.view(b, -1, self.heads, d // self.heads).transpose(1, 2)

        o = blocked_attention(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)),
                              self.operand)
        return self.to_out[0](o.transpose(1, 2).reshape(b, s, d))


class TimestepEmbedding(nn.Module):
    """linear_1, SiLU, linear_2 (to ``out_dim`` where given)."""

    def __init__(self, cin, dim, out_dim=None):
        super().__init__()
        self.linear_1 = Linear(cin, dim)
        self.linear_2 = Linear(dim, out_dim or dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class AlphaBlender(nn.Module):
    def __init__(self, alpha: float, switch: bool = False):
        super().__init__()
        self.switch = switch
        self.mix_factor = nn.Parameter(torch.tensor([alpha]))

    def forward(self, spatial, temporal):
        a = torch.sigmoid(self.mix_factor)
        if self.switch:
            a = 1.0 - a
        return a * spatial + (1.0 - a) * temporal


class TemporalResnetBlock(nn.Module):
    """Over (B, C, F, H, W): GroupNorm, SiLU, a (3, 1, 1) conv over the
    frames, the time embedding's projection per frame, GroupNorm, SiLU,
    conv, plus the input."""

    def __init__(self, c, temb, eps, groups=GROUPS):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, c, eps=eps)
        self.conv1 = Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0))
        self.time_emb_proj = Linear(temb, c) if temb else None
        self.norm2 = nn.GroupNorm(groups, c, eps=eps)
        self.conv2 = Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and self.time_emb_proj is not None:
            # temb (B, F, T) → (B, C, F, 1, 1)
            h = h + self.time_emb_proj(F.silu(temb)).permute(0, 2, 1)[:, :, :, None, None]
        return x + self.conv2(F.silu(self.norm2(h)))


class SpatioTemporalResBlock(nn.Module):
    """The spatial resnet over each frame of (B·F, C, H, W), the temporal
    resnet over its output's frames, blended."""

    def __init__(self, cin, cout, temb, eps, temporal_eps=None, merge_factor=0.5,
                 switch=False, groups=GROUPS):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb, groups, eps)
        self.temporal_res_block = TemporalResnetBlock(
            cout, temb, eps if temporal_eps is None else temporal_eps, groups)
        self.time_mixer = AlphaBlender(merge_factor, switch)

    def forward(self, x, temb, num_frames: int):
        h = self.spatial_res_block(x, temb)
        bf, c, hh, ww = h.shape
        h5 = h.reshape(bf // num_frames, num_frames, c, hh, ww).permute(0, 2, 1, 3, 4)
        t = None if temb is None else temb.reshape(bf // num_frames, num_frames, -1)
        out = self.time_mixer(h5, self.temporal_res_block(h5, t))
        return out.permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)


class BasicTransformerBlock(nn.Module):
    def __init__(self, d, heads, ctx_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(d)
        self.attn1 = Attention(d, heads)
        self.norm2 = nn.LayerNorm(d)
        self.attn2 = Attention(d, heads, ctx_dim)
        self.norm3 = nn.LayerNorm(d)
        self.ff = FeedForward(d)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module):
    """Over (B·H·W, F, C): ``ff_in`` with its residual, self-attention over
    the frames, cross-attention to the time context, the feed-forward."""

    def __init__(self, d, heads, ctx_dim):
        super().__init__()
        self.norm_in = nn.LayerNorm(d)
        self.ff_in = FeedForward(d)
        self.norm1 = nn.LayerNorm(d)
        self.attn1 = Attention(d, heads)
        self.norm2 = nn.LayerNorm(d)
        self.attn2 = Attention(d, heads, ctx_dim)
        self.norm3 = nn.LayerNorm(d)
        self.ff = FeedForward(d)

    def forward(self, x, ctx):
        x = x + self.ff_in(self.norm_in(x))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class TransformerSpatioTemporalModel(nn.Module):
    def __init__(self, c, heads, ctx_dim, depth):
        super().__init__()
        self.norm = nn.GroupNorm(GROUPS, c, eps=1e-6)
        self.proj_in = Linear(c, c)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(c, heads, ctx_dim) for _ in range(depth))
        self.temporal_transformer_blocks = nn.ModuleList(
            TemporalBasicTransformerBlock(c, heads, ctx_dim) for _ in range(depth))
        self.time_pos_embed = TimestepEmbedding(c, 4 * c, out_dim=c)
        self.time_mixer = AlphaBlender(0.5)
        self.proj_out = Linear(c, c)

    def forward(self, x, ctx, num_frames: int):
        """x (B·F, C, H, W); ctx (B·F, S, D)."""
        bf, c, hh, ww = x.shape
        b, hw = bf // num_frames, hh * ww
        # the temporal blocks' context: each video's first frame's, per pixel
        tctx = ctx.reshape(b, num_frames, *ctx.shape[1:])[:, 0]
        tctx = tctx[:, None].expand(b, hw, *tctx.shape[1:]).reshape(b * hw, *tctx.shape[1:])
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(bf, hw, c))
        frames = torch.arange(num_frames, device=x.device).repeat(b)
        emb = self.time_pos_embed(sinusoid(frames, c))[:, None, :]  # (B·F, 1, C)
        for blk, tblk in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = blk(h, ctx)
            t = (h + emb).reshape(b, num_frames, hw, c).permute(0, 2, 1, 3).reshape(
                b * hw, num_frames, c)
            t = tblk(t, tctx).reshape(b, hw, num_frames, c).permute(0, 2, 1, 3).reshape(
                bf, hw, c)
            h = self.time_mixer(h, t)
        h = self.proj_out(h).reshape(bf, hh, ww, c).permute(0, 3, 1, 2)
        return h + x


# the spatio-temporal resnets' eps by block type, as diffusers' blocks set it
BLOCK_EPS = {"CrossAttnDownBlockSpatioTemporal": 1e-6, "DownBlockSpatioTemporal": 1e-5,
             "UpBlockSpatioTemporal": 1e-6, "CrossAttnUpBlockSpatioTemporal": 1e-6,
             "mid": 1e-5}


class UNetSpatioTemporalConditionModel(nn.Module):
    """diffusers' UNetSpatioTemporalConditionModel of the published
    ``config.json``: ``forward(sample (B, F, C_in, H, W), t (), context
    (B, 1, D), added_time_ids (B, 3))`` → (B, F, C_out, H, W)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        boc = cfg["block_out_channels"]
        n = len(boc)
        heads = _per_level(cfg["num_attention_heads"], n)
        depth = _per_level(cfg.get("transformer_layers_per_block", 1), n)
        lpb, ctx = cfg["layers_per_block"], cfg["cross_attention_dim"]
        groups = cfg.get("norm_num_groups", GROUPS)
        temb = 4 * boc[0]

        def resnet(i, o, kind):
            return SpatioTemporalResBlock(i, o, temb, BLOCK_EPS[kind], groups=groups)

        def transformer(c, level):
            return TransformerSpatioTemporalModel(c, heads[level], ctx, depth[level])

        self.conv_in = Conv2d(cfg["in_channels"], boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)
        self.add_embedding = TimestepEmbedding(cfg["projection_class_embeddings_input_dim"], temb)
        # diffusers registers down_blocks and up_blocks before it builds the
        # mid block: the state dict's order
        self.down_blocks = nn.ModuleList()
        self.up_blocks = nn.ModuleList()
        c_out = boc[0]
        for i, kind in enumerate(cfg["down_block_types"]):
            c_in, c_out = c_out, boc[i]
            self.down_blocks.append(_Block(
                [resnet(c_in if j == 0 else c_out, c_out, kind) for j in range(lpb)],
                [transformer(c_out, i) for _ in range(lpb)] if kind.startswith("CrossAttn")
                else None,
                down=Downsample2D(c_out) if i < n - 1 else None))
        self.mid_block = _Block([resnet(boc[-1], boc[-1], "mid") for _ in range(2)],
                                [transformer(boc[-1], n - 1)])
        rev = list(reversed(boc))
        c_prev = rev[0]
        for i, kind in enumerate(cfg["up_block_types"]):
            c_out, c_skip = rev[i], rev[min(i + 1, n - 1)]
            self.up_blocks.append(_Block(
                [resnet((c_prev if j == 0 else c_out) + (c_skip if j == lpb else c_out), c_out,
                        kind) for j in range(lpb + 1)],
                [transformer(c_out, n - 1 - i) for _ in range(lpb + 1)]
                if kind.startswith("CrossAttn") else None,
                up=Upsample2D(c_out) if i < n - 1 else None))
            c_prev = c_out
        self.conv_norm_out = nn.GroupNorm(groups, boc[0], eps=1e-5)
        self.conv_out = Conv2d(boc[0], cfg["out_channels"], 3, padding=1)

    def embedding(self, t, ids):
        """The time embedding plus the micro-conditioning's, per video."""
        cfg, b = self.cfg, ids.shape[0]
        emb = self.time_embedding(sinusoid(t.reshape(-1).expand(b), cfg["block_out_channels"][0]))
        add = sinusoid(ids.reshape(-1), cfg["addition_time_embed_dim"]).reshape(b, -1)
        return emb + self.add_embedding(add)

    def forward(self, x, t, ctx, ids):
        b, f = x.shape[:2]
        emb = self.embedding(t, ids).repeat_interleave(f, dim=0)
        ctx = ctx.repeat_interleave(f, dim=0)
        h = self.conv_in(x.flatten(0, 1))
        skips = [h]
        for blk in self.down_blocks:
            for j, rn in enumerate(blk.resnets):
                h = rn(h, emb, f)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, ctx, f)
                skips.append(h)
            if blk.downsamplers is not None:
                h = blk.downsamplers[0](h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, emb, f)
        h = mid.resnets[1](mid.attentions[0](h, ctx, f), emb, f)
        for blk in self.up_blocks:
            for j, rn in enumerate(blk.resnets):
                h = rn(torch.cat([h, skips.pop()], dim=1), emb, f)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, ctx, f)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.reshape(b, f, *h.shape[1:])


# ---------------------------------------------------------------------------
# The temporal VAE
# ---------------------------------------------------------------------------


class _MidTemporal(nn.Module):
    def __init__(self, c, layers, groups):
        super().__init__()
        self.resnets = nn.ModuleList(_decoder_resnet(c, c, groups) for _ in range(layers))
        self.attentions = nn.ModuleList([VAEAttention(c, groups)])

    def forward(self, h, num_frames):
        h = self.resnets[0](h, None, num_frames)
        for rn in self.resnets[1:]:
            h = rn(self.attentions[0](h), None, num_frames)
        return h


def _decoder_resnet(cin, cout, groups):
    return SpatioTemporalResBlock(cin, cout, None, 1e-6, temporal_eps=1e-5, merge_factor=0.0,
                                  switch=True, groups=groups)


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        boc, lpb = cfg["block_out_channels"], cfg["layers_per_block"]
        groups = cfg.get("norm_num_groups", GROUPS)
        rev = list(reversed(boc))
        self.conv_in = Conv2d(cfg["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = _MidTemporal(rev[0], lpb, groups)
        blocks, c_prev = [], rev[0]
        for i, c in enumerate(rev):
            blocks.append(_Block([_decoder_resnet(c_prev if j == 0 else c, c, groups)
                                  for j in range(lpb + 1)], None,
                                 up=Upsample2D(c) if i < len(rev) - 1 else None))
            c_prev = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(groups, boc[0], eps=1e-6)
        self.conv_out = Conv2d(boc[0], cfg["out_channels"], 3, padding=1)
        self.time_conv_out = Conv3d(cfg["out_channels"], cfg["out_channels"], (3, 1, 1),
                                    padding=(1, 0, 0))

    def forward(self, z, num_frames: int):
        h = self.mid_block(self.conv_in(z), num_frames)
        for blk in self.up_blocks:
            for rn in blk.resnets:
                h = rn(h, None, num_frames)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        bf, c, hh, ww = h.shape
        h = h.reshape(bf // num_frames, num_frames, c, hh, ww).permute(0, 2, 1, 3, 4)
        return self.time_conv_out(h).permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)


class AutoencoderKLTemporalDecoder(nn.Module):
    """``encode(image)`` → the posterior mean (B, 4, h, w);
    ``decode(z, num_frames)``: z (B·F, 4, h, w), already divided by the
    scaling factor, → frames (B·F, 3, H, W) in about [-1, 1]."""

    def __init__(self, cfg: dict):
        super().__init__()
        enc = dict(cfg, norm_num_groups=cfg.get("norm_num_groups", GROUPS))
        self.encoder = _Coder(enc, decoder=False)
        self.decoder = TemporalDecoder(cfg)
        lc = cfg["latent_channels"]
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1)
        self.latent_channels = lc

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        e = self.encoder
        h = e.conv_in(x)
        for blk in e.down_blocks:
            for rn in blk.resnets:
                h = rn(h)
            if blk.downsamplers is not None:  # diffusers pads right and bottom, then strides
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = e.mid_block(h)
        moments = self.quant_conv(e.conv_out(F.silu(e.conv_norm_out(h))))
        return moments[:, :self.latent_channels]

    def decode(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        return self.decoder(z, num_frames)


# ---------------------------------------------------------------------------
# CLIP ViT-H/14 vision with projection
# ---------------------------------------------------------------------------


class CLIPVisionAttention(nn.Module, Operand):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(d, d) for _ in range(4))

    def forward(self, x):
        b, s, d = x.shape

        def split(t):
            return t.view(b, s, self.heads, -1).transpose(1, 2)

        o = attention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)),
                      self.operand)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class CLIPVisionLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg.get("layer_norm_eps", 1e-5)
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.self_attn = CLIPVisionAttention(d, cfg["num_attention_heads"])
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(d, cfg["intermediate_size"], cfg["hidden_act"])

    def forward(self, h):
        h = h + self.self_attn(self.layer_norm1(h))
        return h + self.mlp(self.layer_norm2(h))


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, p = cfg["hidden_size"], cfg["patch_size"]
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = Conv2d(cfg.get("num_channels", 3), d, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding((cfg["image_size"] // p) ** 2 + 1, d)

    def forward(self, px):
        h = self.patch_embedding(px).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(px.shape[0], 1, -1)
        return torch.cat([cls, h], dim=1) + self.position_embedding.weight


class _VisionEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(CLIPVisionLayer(cfg) for _ in range(cfg["num_hidden_layers"]))


class _VisionTransformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg.get("layer_norm_eps", 1e-5)
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(d, eps=eps)  # transformers' spelling
        self.encoder = _VisionEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(d, eps=eps)


class CLIPVisionModelWithProjection(nn.Module):
    """``forward(pixel_values (B, 3, 224, 224), CLIP-normalized)`` → the
    image embeddings (B, projection_dim): the class token after the last
    layer, post-LayerNorm, projected."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.image_size = cfg["image_size"]
        self.vision_model = _VisionTransformer(cfg)
        self.visual_projection = Linear(cfg["hidden_size"], cfg["projection_dim"], bias=False)

    def forward(self, px):
        vm = self.vision_model
        h = vm.pre_layrnorm(vm.embeddings(px))
        for layer in vm.encoder.layers:
            h = layer(h)
        return self.visual_projection(vm.post_layernorm(h[:, 0]))


def modules(cfg: dict) -> Dict[str, nn.Module]:
    """The configuration's reference modules, by the pipeline slot they
    stand for, on the current default device."""
    return {"unet": UNetSpatioTemporalConditionModel(cfg["unet"]),
            "vae": AutoencoderKLTemporalDecoder(cfg["vae"]),
            "image_encoder": CLIPVisionModelWithProjection(cfg["image_encoder"])}


def time_ids(fps: int, motion_bucket_id: int, noise_aug_strength: float,
             batch: int, device) -> torch.Tensor:
    """diffusers' ``added_time_ids``: (fps − 1, motion bucket, noise
    augmentation) per row (SVD was conditioned on fps − 1)."""
    return torch.tensor([[fps - 1, motion_bucket_id, noise_aug_strength]] * batch,
                        dtype=torch.float32, device=device)

