"""AutoencoderKLTemporalDecoder — the Stable Video Diffusion VAE, NHWC, with
diffusers' state-dict names (``encoder.*``, ``quant_conv``, ``decoder.*``,
``decoder.time_conv_out``; no ``post_quant_conv``).

Counterpart of ``sfast_tpu/models/autoencoder_kl_temporal.py``.  The
encoder and ``quant_conv`` are ``AutoencoderKL``'s (``encode`` is shared);
the decoder adds temporal mixing:

- every resnet is a ``SpatioTemporalResBlock``: the spatial
  ``ResnetBlock2D`` (eps 1e-6; K2 and K3 from 128² pixels, as the 2-D
  decoder's) and a temporal resnet ((3, 1, 1) convs over the frames, eps
  1e-5), blended with the mix **switched**: ``(1 − σ)·spatial +
  σ·temporal`` (diffusers' ``switch_spatial_to_temporal_mix``);
- the mid block: resnet, single-head attention (plain route), resnet;
- after ``conv_out``, ``time_conv_out`` smooths over the frames.

``decode(latents, num_frames)`` takes (B·F, h, w, 4) latents, frames
folded into the batch, as one video of F frames per B; the pipeline
decodes a clip in chunks of ``decode_chunk_size`` frames, and a CUDA graph
is captured per chunk size.
"""

import dataclasses

import torch
import torch.nn as nn

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.models.autoencoder_kl import (
    Encoder,
    KLEncoderHalf,
    VAEAttention,
    VAEConfig,
)
from sfast_tpu_torch.models.layers import Conv2d, GroupNorm, Upsample2D, init_weights_
from sfast_tpu_torch.models.unet_spatio_temporal import (
    SpatioTemporalResBlock,
    TemporalConv3d,
    reset_mix_factors_,
)
from sfast_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TemporalVAEConfig(VAEConfig):
    """The widths of ``AutoencoderKLTemporalDecoder``: ``VAEConfig``'s."""


SVD_VAE = TemporalVAEConfig()
TINY_TEMPORAL_VAE = TemporalVAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                                      norm_num_groups=8)


def _st_resnet(cfg: TemporalVAEConfig, cin: int, cout: int, mk: dict) -> SpatioTemporalResBlock:
    return SpatioTemporalResBlock(cin, cout, None, groups=cfg.norm_num_groups, eps=1e-6,
                                  temporal_eps=1e-5, merge_factor=0.0, switch=True, **mk)


class _MidBlockTemporalDecoder(nn.Module):
    def __init__(self, cfg: TemporalVAEConfig, c: int, mk: dict):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_st_resnet(cfg, c, c, mk) for _ in range(cfg.layers_per_block)])
        self.attentions = nn.ModuleList([VAEAttention(c, cfg.norm_num_groups, **mk)])

    def forward(self, h, *, num_frames: int, conv_backend=None, gn_backend=None):
        """resnets[0], then attention and resnet for each further resnet
        (JAX ``temporal_vae_decode_fwd``: with two resnets, diffusers'
        order)."""
        kw = dict(num_frames=num_frames, gn_backend=gn_backend, conv_backend=conv_backend)
        h = self.resnets[0](h, **kw)
        for rn in self.resnets[1:]:
            h = rn(self.attentions[0](h, gn_backend=gn_backend), **kw)
        return h


class _UpBlockTemporalDecoder(nn.Module):
    def __init__(self, resnets, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.upsamplers = nn.ModuleList([upsample]) if upsample else None


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: TemporalVAEConfig, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1, **mk)
        self.mid_block = _MidBlockTemporalDecoder(cfg, rev[0], mk)
        blocks = []
        c_prev = rev[0]
        for i, c_out in enumerate(rev):
            blocks.append(_UpBlockTemporalDecoder(
                [_st_resnet(cfg, c_prev if j == 0 else c_out, c_out, mk)
                 for j in range(cfg.layers_per_block + 1)],
                Upsample2D(c_out, **mk) if i < len(rev) - 1 else None,
            ))
            c_prev = c_out
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, cfg.block_out_channels[0], eps=1e-6,
                                       device=device, dtype=torch.float32)
        self.conv_out = Conv2d(cfg.block_out_channels[0], cfg.out_channels, 3, padding=1, **mk)
        self.time_conv_out = TemporalConv3d(cfg.out_channels, cfg.out_channels, **mk)


class AutoencoderKLTemporalDecoder(KLEncoderHalf):
    def __init__(self, cfg: TemporalVAEConfig = SVD_VAE, *, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        self.compilation_config = CompilationConfig.Default()
        device = resolve_device(device)
        mk = dict(device=device, dtype=dtype)
        self.decoder = TemporalDecoder(cfg, **mk)
        self.encoder = Encoder(cfg, **mk)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, **mk)

    def decode(self, latents: torch.Tensor, num_frames: int = 1) -> torch.Tensor:
        """latents (B·F, h, w, latent_channels), already divided by the
        scaling factor, F = ``num_frames`` → frames (B·F, 8h, 8w, 3) in
        about [-1, 1]."""
        bf = latents.shape[0]
        if bf % num_frames:
            raise ValueError(f"{bf} latent frames are not videos of {num_frames} frames")
        be = self._backend()
        d = self.decoder
        h = d.conv_in(latents.to(d.conv_in.weight.dtype))
        h = d.mid_block(h, num_frames=num_frames, conv_backend=be, gn_backend=be)
        for blk in d.up_blocks:
            for rn in blk.resnets:
                h = rn(h, num_frames=num_frames, gn_backend=be, conv_backend=be)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h, conv_backend=be)
        h = d.conv_out(d.conv_norm_out(h, act="silu", backend=be))
        _, hh, ww, c = h.shape
        return d.time_conv_out(h.reshape(bf // num_frames, num_frames, hh, ww, c)).reshape(
            bf, hh, ww, c)

    forward = decode


def init_temporal_vae_weights_(vae: nn.Module, generator: torch.Generator) -> nn.Module:
    """``init_weights_``, then each ``mix_factor`` at 0.0, as JAX's
    ``init_temporal_vae_params``: σ(0) = ½ weighs both branches alike."""
    return reset_mix_factors_(init_weights_(vae, generator))
