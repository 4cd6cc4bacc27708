"""AutoencoderKL (SD VAE), NHWC, with diffusers' state-dict names
(``encoder.*``, ``quant_conv``, ``post_quant_conv``, ``decoder.*``).

Counterpart of ``sfast_tpu/models/autoencoder_kl.py`` (``vae_decode_fwd``,
``vae_encode_fwd``).  Both halves' resnets and the decoder's upsample
convs at 128² and above take the fused kernels (K3 statistics, K2 convs)
on CUDA; the mid-block attention stays on the plain path, as JAX forces it
(``autoencoder_kl.py:64``).  JAX builds the decoder and the encoder as two
``Model`` bundles over one parameter tree; here they are the two methods
``decode`` and ``encode`` of one module.
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

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
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
TINY_TEST_VAE = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)


class VAEAttention(nn.Module):
    """Single-head attention over the (H·W, C) tokens of the mid block.

    JAX's rule splits its projections over ``tp`` as any attention's; one
    head cannot be split, so it declares no Megatron pair: under tensor
    parallelism ``to_q``, ``to_k`` and ``to_v`` all-gather their outputs and
    ``to_out`` slices its input, all-reducing its partial sums
    (``parallel/tensor_parallel.py``), and the attention itself runs whole
    on every rank."""

    def __init__(self, c: int, groups: int, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.group_norm = GroupNorm(groups, c, eps=1e-6, device=device, dtype=torch.float32)
        self.to_q = Linear(c, c, **mk)
        self.to_k = Linear(c, c, **mk)
        self.to_v = Linear(c, c, **mk)
        self.to_out = nn.ModuleList([Linear(c, c, **mk)])

    def forward(self, x: torch.Tensor, gn_backend=None) -> torch.Tensor:
        b, h, w, c = x.shape
        hn = self.group_norm(x, backend=gn_backend).reshape(b, h * w, c)
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

    def forward(self, h: torch.Tensor, conv_backend=None, gn_backend=None) -> torch.Tensor:
        h = self.resnets[0](h, gn_backend=gn_backend, conv_backend=conv_backend)
        h = self.attentions[0](h, gn_backend=gn_backend)
        return self.resnets[1](h, gn_backend=gn_backend, conv_backend=conv_backend)


class VAEDownsample2D(nn.Module):
    """The encoder's downsampler: pad (0, 1, 0, 1), then a stride-2 3×3 conv
    with no padding (diffusers builds it with ``padding=0``; JAX
    ``autoencoder_kl.py:257-266``).  Symmetric ``padding=1`` gives the
    same output size from windows shifted by one pixel."""

    def __init__(self, c: int, *, device=None, dtype=None):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2, padding=0, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))  # NHWC: C, then W, then H


class _DownBlock(nn.Module):
    def __init__(self, resnets, downsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.downsamplers = nn.ModuleList([downsample]) if downsample else None


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        groups = cfg.norm_num_groups
        chans = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1, **mk)
        blocks = []
        c_prev = chans[0]
        for i, c_out in enumerate(chans):
            blocks.append(_DownBlock(
                [
                    ResnetBlock2D(c_prev if j == 0 else c_out, c_out, None,
                                  groups=groups, eps=1e-6, **mk)
                    for j in range(cfg.layers_per_block)
                ],
                VAEDownsample2D(c_out, **mk) if i < len(chans) - 1 else None,
            ))
            c_prev = c_out
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(chans[-1], groups, **mk)
        self.conv_norm_out = GroupNorm(groups, chans[-1], eps=1e-6, device=device,
                                       dtype=torch.float32)
        self.conv_out = Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1, **mk)


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


class KLEncoderHalf(nn.Module):
    """What a KL autoencoder's encode runs: ``encoder`` and ``quant_conv``
    (built by the subclass), and ``encode``.  ``AutoencoderKL`` and the
    SVD ``AutoencoderKLTemporalDecoder`` share it."""

    def _backend(self):
        """The route of every GroupNorm and fused conv: the op's auto rule,
        or ``'plain'`` under ``enable_kernels=False`` (JAX's enable_pallas
        reaches only the GroupNorms; here it switches the fused convs off
        too)."""
        return None if self.compilation_config.enable_kernels else "plain"

    def encode(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image (B, H, W, 3) in [-1, 1] → (mean, logvar) of the latent
        posterior, each (B, H/8, W/8, latent_channels); logvar clamped to
        [-30, 20]."""
        be = self._backend()
        e = self.encoder
        h = e.conv_in(image.to(e.conv_in.weight.dtype))
        for blk in e.down_blocks:
            for rn in blk.resnets:
                h = rn(h, gn_backend=be, conv_backend=be)
            if blk.downsamplers is not None:
                h = blk.downsamplers[0](h)
        h = e.mid_block(h, conv_backend=be, gn_backend=be)
        h = self.quant_conv(e.conv_out(e.conv_norm_out(h, act="silu", backend=be)))
        mean, logvar = h.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)


class AutoencoderKL(KLEncoderHalf):
    def __init__(self, cfg: VAEConfig = SD_VAE, *, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        self.compilation_config = CompilationConfig.Default()
        device = resolve_device(device)
        # decoder first: init_weights_ draws in module order, so the decoder
        # takes the same random weights as when the module had no encoder
        self.post_quant_conv = Conv2d(
            cfg.latent_channels, cfg.latent_channels, 1, device=device, dtype=dtype
        )
        self.decoder = Decoder(cfg, device=device, dtype=dtype)
        self.encoder = Encoder(cfg, device=device, dtype=dtype)
        self.quant_conv = Conv2d(
            2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, device=device, dtype=dtype
        )

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, h, w, latent_channels), already divided by the
        scaling factor → image (B, 8h, 8w, 3) in about [-1, 1]."""
        be = self._backend()
        d = self.decoder
        h = self.post_quant_conv(latents.to(self.post_quant_conv.weight.dtype))
        h = d.mid_block(d.conv_in(h), conv_backend=be, gn_backend=be)
        for blk in d.up_blocks:
            for rn in blk.resnets:
                h = rn(h, gn_backend=be, conv_backend=be)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h, conv_backend=be)
        return d.conv_out(d.conv_norm_out(h, act="silu", backend=be))

    forward = decode
