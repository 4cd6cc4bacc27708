"""UNet2DConditionModel for SD1.5, SD2.x and SDXL, NHWC, as an
``nn.Module`` with diffusers' state-dict names.

Counterpart of ``sfast_tpu/models/unet_2d_condition.py``, with SDXL's
``text_time`` addition embedding (the pooled text embeds and the six
micro-conditioning ids, ``add_embedding``) and an LCM-distilled UNet's
``time_embedding.cond_proj`` (``timestep_cond``, the embedded guidance
scale), a ControlNet's residuals (``down_block_additional_residuals``,
``mid_block_additional_residual``) and IP-Adapter image tokens
(``ip_adapter_embeds``); without JAX's weight stacking.  Head counts follow
diffusers' legacy SD1.5 reading of ``attention_head_dim`` as the number of
heads (8 → head dim 40 / 80 / 160); SDXL's 5 / 10 / 20 heads are of dim 64.

:class:`UNetTrunk` holds what a ControlNet shares with the UNet (conv_in,
the embeddings, the down blocks, the mid block) and runs it;
``models/controlnet.py`` builds on it, so both carry the same names.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.models.layers import (
    Conv2d,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2DModel,
    Upsample2D,
    timestep_embedding,
)
from sfast_tpu_torch.parallel.mesh import axis_size
from sfast_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    addition_embed_type: Optional[str] = None  # None | 'text_time' (SDXL)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None  # SDXL: 1280 + 6·256
    norm_num_groups: int = 32
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    # an LCM-distilled UNet (e.g. SimianLuo/LCM_Dreamshaper_v7: 256): the
    # width of the guidance embedding that time_embedding.cond_proj takes
    time_cond_proj_dim: Optional[int] = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


SD15_UNET = UNetConfig()
SD21_UNET = dataclasses.replace(
    SD15_UNET, cross_attention_dim=1024, num_heads=(5, 10, 20, 20), use_linear_projection=True,
)
SDXL_UNET = UNetConfig(
    sample_size=128,
    block_out_channels=(320, 640, 1280),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    transformer_layers_per_block=(1, 2, 10),
    num_heads=(5, 10, 20),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_type="text_time",
    projection_class_embeddings_input_dim=2816,
)
# Tiny config for CPU tests (structure-identical to SD15), as in JAX.
TINY_UNET = UNetConfig(
    sample_size=16,
    block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1,
    transformer_layers_per_block=(1, 1),
    num_heads=(4, 4),
    cross_attention_dim=32,
    norm_num_groups=8,
)


def backends(ccfg: CompilationConfig) -> dict:
    """Config knobs → op routes, as JAX's ``_backends``
    (``unet_2d_condition.py:324-349``): None = the op's auto rule, 'plain' =
    never a kernel, 'kernel' = K3 + K5 for every GroupNorm, 'int8' = the
    auto rule with K6 in place of K1, ``('ring', mesh, 'sp')`` = ring
    attention when the mesh's ``sp`` axis has more than one rank (checked
    before the flash rule, after ``enable_kernels``, as JAX checks it after
    ``enable_pallas``).  ``ln`` routes the transformer blocks' LayerNorms:
    None (K7 for a bf16 call on the card) unless the kernels are off; JAX
    has no such knob, its LayerNorm being one XLA fusion."""
    if not ccfg.enable_kernels:
        return dict(gn="plain", attn="plain", geglu="plain", conv="plain", ln="plain")
    gn = "kernel" if ccfg.enable_fused_group_norm else None
    conv = None if ccfg.enable_fused_conv else "plain"
    mesh = getattr(ccfg, "mesh", None)
    if axis_size(mesh, "sp") > 1:
        attn = ("ring", mesh, "sp")
    elif not ccfg.enable_flash_attention:
        attn = "plain"
    elif ccfg.enable_int8_attention:
        attn = "int8"
    else:
        attn = None
    geglu = None if ccfg.enable_fused_linear_geglu else "plain"
    return dict(gn=gn, attn=attn, geglu=geglu, conv=conv, ln=None)


class _Block(nn.Module):
    """One resolution level: resnets, optional attentions, optional resampler
    (diffusers' ``resnets`` / ``attentions`` / ``downsamplers`` /
    ``upsamplers`` names)."""

    def __init__(self, resnets, attentions=None, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.downsamplers = nn.ModuleList([downsample]) if downsample else None
        self.upsamplers = nn.ModuleList([upsample]) if upsample else None


def _new_resnet(cfg: UNetConfig, cin: int, cout: int, mk: dict) -> ResnetBlock2D:
    return ResnetBlock2D(cin, cout, cfg.time_embed_dim, groups=cfg.norm_num_groups, **mk)


def _new_transformer(cfg: UNetConfig, c: int, level: int, mk: dict) -> Transformer2DModel:
    return Transformer2DModel(
        c, cfg.num_heads[level], cfg.cross_attention_dim,
        depth=cfg.transformer_layers_per_block[level],
        use_linear_projection=cfg.use_linear_projection, **mk,
    )


class UNetTrunk(nn.Module):
    """conv_in, the time embedding (with SDXL's ``add_embedding``), the down
    blocks and the mid block, and the passes through them: the part of the
    UNet a ControlNet copies (JAX ``controlnet.py:58-78``)."""

    def __init__(self, cfg: UNetConfig, *, device=None, dtype=None):
        super().__init__()
        self.unet_config = cfg
        self.compilation_config = CompilationConfig.Default()
        mk = dict(device=device, dtype=dtype)
        boc = cfg.block_out_channels
        n_levels = len(boc)
        self.conv_in = Conv2d(cfg.in_channels, boc[0], 3, padding=1, **mk)
        self.time_embedding = TimestepEmbedding(boc[0], cfg.time_embed_dim,
                                                cond_proj_dim=cfg.time_cond_proj_dim, **mk)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                                   cfg.time_embed_dim, **mk)
        elif cfg.addition_embed_type is not None:
            raise ValueError(f"addition_embed_type {cfg.addition_embed_type!r}")

        down = []
        c_out = boc[0]
        for i, btype in enumerate(cfg.down_block_types):
            c_in, c_out = c_out, boc[i]
            cross = btype == "CrossAttnDownBlock2D"
            down.append(_Block(
                [_new_resnet(cfg, c_in if j == 0 else c_out, c_out, mk)
                 for j in range(cfg.layers_per_block)],
                [_new_transformer(cfg, c_out, i, mk) for _ in range(cfg.layers_per_block)]
                if cross else None,
                downsample=Downsample2D(c_out, **mk) if i < n_levels - 1 else None,
            ))
        self.down_blocks = nn.ModuleList(down)

        c_mid = boc[-1]
        self.mid_block = _Block(
            [_new_resnet(cfg, c_mid, c_mid, mk), _new_resnet(cfg, c_mid, c_mid, mk)],
            [_new_transformer(cfg, c_mid, n_levels - 1, mk)],
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def embed(self, sample, timesteps, added_cond_kwargs=None, timestep_cond=None):
        """The time embedding of ``timesteps`` (() or (B,)), plus SDXL's
        added embedding of ``added_cond_kwargs``."""
        cfg = self.unet_config
        dtype = self.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift,
        ).to(dtype)
        emb = self.time_embedding(t_emb, cond=timestep_cond)
        if cfg.addition_embed_type == "text_time":
            text_embeds = added_cond_kwargs["text_embeds"]
            t_ids = timestep_embedding(
                added_cond_kwargs["time_ids"].reshape(-1), cfg.addition_time_embed_dim,
                flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift,
            ).reshape(text_embeds.shape[0], -1)
            add = torch.cat([text_embeds.float(), t_ids], dim=-1).to(dtype)
            emb = emb + self.add_embedding(add)
        return emb

    def _resnet(self, rn, h, emb, be):
        return rn(h, emb, gn_backend=be["gn"], conv_backend=be["conv"])

    def _attention(self, at, h, context, be, ip):
        return at(h, context, gn_backend=be["gn"], attn_backend=be["attn"],
                  geglu_backend=be["geglu"], ln_backend=be["ln"], **ip)

    def _level(self, blk, j, h, emb, context, be, ip):
        h = self._resnet(blk.resnets[j], h, emb, be)
        if blk.attentions is not None:
            h = self._attention(blk.attentions[j], h, context, be, ip)
        return h

    def down(self, h, emb, context, be, ip):
        """The down blocks from ``h`` (conv_in's output): (h, the skips in
        order: ``h`` itself, each level's resnets, each downsampler)."""
        res_stack = [h]
        for blk in self.down_blocks:
            for j in range(len(blk.resnets)):
                h = self._level(blk, j, h, emb, context, be, ip)
                res_stack.append(h)
            if blk.downsamplers is not None:
                h = blk.downsamplers[0](h)
                res_stack.append(h)
        return h, res_stack

    def mid(self, h, emb, context, be, ip):
        mid = self.mid_block
        h = self._resnet(mid.resnets[0], h, emb, be)
        h = self._attention(mid.attentions[0], h, context, be, ip)
        return self._resnet(mid.resnets[1], h, emb, be)


def _add_f32(h: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``h + r`` summed in f32 and cast back to ``h``'s dtype, as JAX adds a
    ControlNet residual (``unet_2d_condition.py:469-493``)."""
    return (h.float() + r.float()).to(h.dtype)


class UNet2DConditionModel(UNetTrunk):
    def __init__(self, cfg: UNetConfig = SD15_UNET, *, device=None, dtype=None):
        device = resolve_device(device)
        super().__init__(cfg, device=device, dtype=dtype)
        self.config = cfg
        mk = dict(device=device, dtype=dtype)
        boc = cfg.block_out_channels
        n_levels = len(boc)

        up = []
        rev = list(reversed(boc))
        c_prev = rev[0]
        for i, btype in enumerate(cfg.up_block_types):
            c_out = rev[i]
            c_skip_in = rev[min(i + 1, n_levels - 1)]
            level = n_levels - 1 - i
            resnets = []
            for j in range(cfg.layers_per_block + 1):
                res_skip = c_skip_in if j == cfg.layers_per_block else c_out
                res_in = c_prev if j == 0 else c_out
                resnets.append(_new_resnet(cfg, res_in + res_skip, c_out, mk))
            cross = btype == "CrossAttnUpBlock2D"
            up.append(_Block(
                resnets,
                [_new_transformer(cfg, c_out, level, mk) for _ in range(cfg.layers_per_block + 1)]
                if cross else None,
                upsample=Upsample2D(c_out, **mk) if i < n_levels - 1 else None,
            ))
            c_prev = c_out
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[0], device=device,
                                       dtype=torch.float32)
        self.conv_out = Conv2d(boc[0], cfg.out_channels, 3, padding=1, **mk)

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        added_cond_kwargs: Optional[dict] = None,
        timestep_cond: Optional[torch.Tensor] = None,
        down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
        mid_block_additional_residual: Optional[torch.Tensor] = None,
        ip_adapter_embeds: Optional[torch.Tensor] = None,
        ip_adapter_scale=1.0,
        compilation_config: Optional[CompilationConfig] = None,
    ) -> torch.Tensor:
        """sample (B, H, W, C_in) NHWC latents, timesteps () or (B,),
        encoder_hidden_states (B, S, cross_dim) → predicted noise
        (B, H, W, C_out).  SDXL's ``added_cond_kwargs`` holds
        ``text_embeds`` (B, pooled_dim) and ``time_ids`` (B, 6); an LCM
        UNet's ``timestep_cond`` is the (B, time_cond_proj_dim) guidance
        embedding.  A ControlNet's residuals (one per skip, in the down
        pass's order, and the mid block's) are added in f32;
        ``ip_adapter_embeds`` (B, N, cross_dim) and ``ip_adapter_scale`` (a
        float or a 0-d tensor) reach every ``attn2`` that holds IP
        projections.  ``compilation_config`` routes this call in place of
        the module's own, which stays as it is (the trainer's ``ccfg``)."""
        be = backends(compilation_config or self.compilation_config)
        emb = self.embed(sample, timesteps, added_cond_kwargs, timestep_cond)
        context = encoder_hidden_states.to(self.dtype)
        ip = {}
        if ip_adapter_embeds is not None:
            ip = dict(ip_embeds=ip_adapter_embeds, ip_scale=ip_adapter_scale)

        h, res_stack = self.down(self.conv_in(sample.to(self.dtype)), emb, context, be, ip)
        if down_block_additional_residuals is not None:
            if len(down_block_additional_residuals) != len(res_stack):
                raise ValueError(f"{len(down_block_additional_residuals)} down residuals for "
                                 f"{len(res_stack)} skips")
            res_stack = [_add_f32(r, a) for r, a in zip(res_stack, down_block_additional_residuals)]
        h = self.mid(h, emb, context, be, ip)
        if mid_block_additional_residual is not None:
            h = _add_f32(h, mid_block_additional_residual)

        for blk in self.up_blocks:
            for j in range(len(blk.resnets)):
                h = torch.cat([h, res_stack.pop().to(h.dtype)], dim=-1)
                h = self._level(blk, j, h, emb, context, be, ip)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h, conv_backend=be["conv"])

        return self.conv_out(self.conv_norm_out(h, act="silu", backend=be["gn"]))
