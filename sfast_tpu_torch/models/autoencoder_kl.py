"""AutoencoderKL (SD VAE), decoder only, NHWC, with diffusers' state-dict
names (``post_quant_conv``, ``decoder.*``).

Counterpart of ``sfast_tpu/models/autoencoder_kl.py::vae_decode_fwd``.  The
decoder's resnets and upsample convs at 128² and above take the fused
kernels (K3 statistics, K2 convs) on CUDA; the mid-block attention stays
on the plain path, as JAX forces it (``autoencoder_kl.py:64``).  The
encoder (img2img) is a later slice.
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.models.layers import (
    Conv2d,
    GroupNorm,
    Linear,
    ResnetBlock2D,
    Upsample2D,
)
from sfast_tpu_torch.ops.attention import dot_product_attention
from sfast_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


SD_VAE = VAEConfig()
TINY_TEST_VAE = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)


class VAEAttention(nn.Module):
    """Single-head attention over the (H·W, C) tokens of the mid block."""

    def __init__(self, c: int, groups: int, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.group_norm = GroupNorm(groups, c, eps=1e-6, device=device, dtype=torch.float32)
        self.to_q = Linear(c, c, **mk)
        self.to_k = Linear(c, c, **mk)
        self.to_v = Linear(c, c, **mk)
        self.to_out = nn.ModuleList([Linear(c, c, **mk)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        hn = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = (lin(hn)[:, None] for lin in (self.to_q, self.to_k, self.to_v))
        o = dot_product_attention(q, k, v, backend="plain")[:, 0]
        return x + self.to_out[0](o).reshape(b, h, w, c)


class _MidBlock(nn.Module):
    def __init__(self, c: int, groups: int, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, c, None, groups=groups, eps=1e-6, **mk) for _ in range(2)]
        )
        self.attentions = nn.ModuleList([VAEAttention(c, groups, **mk)])


class _UpBlock(nn.Module):
    def __init__(self, resnets, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.upsamplers = nn.ModuleList([upsample]) if upsample else None


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        groups = cfg.norm_num_groups
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1, **mk)
        self.mid_block = _MidBlock(rev[0], groups, **mk)
        blocks = []
        c_prev = rev[0]
        for i, c_out in enumerate(rev):
            blocks.append(_UpBlock(
                [
                    ResnetBlock2D(c_prev if j == 0 else c_out, c_out, None,
                                  groups=groups, eps=1e-6, **mk)
                    for j in range(cfg.layers_per_block + 1)
                ],
                Upsample2D(c_out, **mk) if i < len(rev) - 1 else None,
            ))
            c_prev = c_out
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(
            groups, cfg.block_out_channels[0], eps=1e-6, device=device, dtype=torch.float32
        )
        self.conv_out = Conv2d(cfg.block_out_channels[0], cfg.out_channels, 3, padding=1, **mk)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = SD_VAE, *, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        self.compilation_config = CompilationConfig.Default()
        device = resolve_device(device)
        self.post_quant_conv = Conv2d(
            cfg.latent_channels, cfg.latent_channels, 1, device=device, dtype=dtype
        )
        self.decoder = Decoder(cfg, device=device, dtype=dtype)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, h, w, latent_channels), already divided by the
        scaling factor → image (B, 8h, 8w, 3) in about [-1, 1]."""
        # JAX's enable_pallas reaches only the decoder's GroupNorms; here
        # enable_kernels switches the fused convs off too.
        conv = None if self.compilation_config.enable_kernels else "plain"
        d = self.decoder
        h = self.post_quant_conv(latents.to(self.post_quant_conv.weight.dtype))
        h = d.conv_in(h)
        h = d.mid_block.resnets[0](h, conv_backend=conv)
        h = d.mid_block.attentions[0](h)
        h = d.mid_block.resnets[1](h, conv_backend=conv)
        for blk in d.up_blocks:
            for rn in blk.resnets:
                h = rn(h, conv_backend=conv)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h, conv_backend=conv)
        return d.conv_out(d.conv_norm_out(h, act="silu"))

    forward = decode
