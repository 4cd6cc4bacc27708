"""AutoencoderTiny (TAESD), the distilled tiny VAE, NHWC, with diffusers'
``AutoencoderTiny`` state-dict names (``encoder.layers.{i}``,
``decoder.layers.{i}``, a block's ``conv.0`` / ``conv.2`` / ``conv.4``).

Counterpart of ``sfast_tpu/models/autoencoder_tiny.py``: plain 64-wide conv
stacks with ReLU blocks, no norm and no attention, so no kernel of the port
applies and every conv is cuDNN's.  Short-step pipelines (LCM) are why it
exists: there the KL decoder is a large share of an image.

- ``decode(latents)``: the tanh clamp ``tanh(x / 3)·3`` in f32, then
  conv + ReLU, per stage the blocks, a nearest ×2 upsample and a conv, a
  last block and the conv to RGB; TAESD's [0, 1] output is mapped to
  [-1, 1] (``x·2 − 1`` in f32), the contract of ``AutoencoderKL.decode``.
- ``encode(image)``: the [-1, 1] image mapped to [0, 1] in f32, conv, per
  stage the blocks and a stride-2 conv (padding 1 on every side), the
  conv to the latents; returns ``(mean, −30 everywhere)``, the
  ``(mean, logvar)`` contract of ``AutoencoderKL.encode`` for a
  deterministic encoder.
- a block is ``relu(conv(relu(conv(relu(conv(x))))) + x)``, the sum in
  f32.  TAESD's width is constant, so no block has a skip conv.

The stride-2 and the upsample convs carry a bias, as JAX's ``init_conv``
gives every conv one; diffusers' are bias-free.  A diffusers checkpoint
loads with ``strict=False`` and those biases left at zero, which is the
same function.
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.models.layers import Conv2d, init_weights_
from sfast_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TinyVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    hidden: int = 64
    encoder_blocks: Tuple[int, ...] = (1, 3, 3, 3)
    decoder_blocks: Tuple[int, ...] = (3, 3, 3, 1)
    scaling_factor: float = 1.0

    @property
    def block_out_channels(self) -> Tuple[int, ...]:
        """One width per decoder stage: the pipelines derive
        ``vae_scale_factor`` (8 for TAESD) from its length."""
        return (self.hidden,) * len(self.decoder_blocks)


TAESD = TinyVAEConfig()
TINY_TEST_TAESD = TinyVAEConfig(hidden=16, encoder_blocks=(1, 1), decoder_blocks=(1, 1))


class TinyBlock(nn.Module):
    """diffusers' ``AutoencoderTinyBlock`` at a constant width: ``conv`` is
    (conv, ReLU, conv, ReLU, conv), fused with the input by a ReLU."""

    def __init__(self, c: int, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.conv = nn.ModuleList([Conv2d(c, c, 3, padding=1, **mk), nn.ReLU(),
                                   Conv2d(c, c, 3, padding=1, **mk), nn.ReLU(),
                                   Conv2d(c, c, 3, padding=1, **mk)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv[0](x))
        h = F.relu(self.conv[2](h))
        h = self.conv[4](h)
        return F.relu(h.float() + x.float()).to(x.dtype)


class NearestUpsample2x(nn.Module):
    """Nearest-neighbour ×2 of an NHWC map, by broadcast."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


class EncoderTiny(nn.Module):
    def __init__(self, cfg: TinyVAEConfig, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        h = cfg.hidden
        layers = []
        for i, n in enumerate(cfg.encoder_blocks):
            layers.append(Conv2d(cfg.in_channels, h, 3, padding=1, **mk) if i == 0
                          else Conv2d(h, h, 3, stride=2, padding=1, **mk))
            layers += [TinyBlock(h, **mk) for _ in range(n)]
        layers.append(Conv2d(h, cfg.latent_channels, 3, padding=1, **mk))
        self.layers = nn.Sequential(*layers)


class DecoderTiny(nn.Module):
    def __init__(self, cfg: TinyVAEConfig, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        h = cfg.hidden
        layers = [Conv2d(cfg.latent_channels, h, 3, padding=1, **mk), nn.ReLU()]
        for i, n in enumerate(cfg.decoder_blocks):
            layers += [TinyBlock(h, **mk) for _ in range(n)]
            if i < len(cfg.decoder_blocks) - 1:
                layers += [NearestUpsample2x(), Conv2d(h, h, 3, padding=1, **mk)]
        layers.append(Conv2d(h, cfg.out_channels, 3, padding=1, **mk))
        self.layers = nn.Sequential(*layers)


def init_tiny_vae_weights_(vae: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights at JAX's init scales (``init_weights_``: convs
    N(0, 1/fan_in), biases 0)."""
    return init_weights_(vae, generator)


class AutoencoderTiny(nn.Module):
    """TAESD: ``decode`` serves a pipeline's ``vae`` slot and ``encode`` its
    ``vae_encode`` slot (``sfast_tpu_torch.compile`` wraps each)."""

    def __init__(self, cfg: TinyVAEConfig = TAESD, *, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        self.compilation_config = CompilationConfig.Default()
        self.encoder = EncoderTiny(cfg, device=device, dtype=dtype)
        self.decoder = DecoderTiny(cfg, device=device, dtype=dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.layers[0].weight.dtype

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, h, w, latent_channels) → image (B, 8h, 8w, 3) in
        about [-1, 1]."""
        x = (torch.tanh(latents.float() / 3.0) * 3.0).to(self.dtype)
        x = self.decoder.layers(x)
        return (x.float() * 2.0 - 1.0).to(self.dtype)

    forward = decode

    def encode(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image (B, H, W, 3) in [-1, 1] → (mean, logvar), each (B, H/8,
        W/8, latent_channels); logvar is −30 everywhere."""
        x = ((image.float() + 1.0) / 2.0).to(self.dtype)
        x = self.encoder.layers(x)
        return x, torch.full_like(x, -30.0)
