"""ControlNetModel — diffusers' ControlNet as an ``nn.Module``, NHWC.

Counterpart of ``sfast_tpu/models/controlnet.py``.  The UNet's conv_in, time
embedding (and SDXL's ``add_embedding``), down blocks and mid block, built
by the UNet's own :class:`UNetTrunk`, so the names are the UNet's and one
exporter (``interop/from_jax.controlnet_state_dict``) covers both; plus

- ``controlnet_cond_embedding``: ``conv_in``, then ``blocks`` as pairs of
  3×3 conv + SiLU (the second of each pair with stride 2, symmetric padding
  1), then the zero-initialised 3×3 ``conv_out``.  It embeds the control
  image (NHWC, [0, 1]) from pixel to latent resolution and is added to
  conv_in's output.  JAX runs it as XLA convs (``ops/conv.py:39-93``); here
  it is ``F.conv2d`` (cuDNN), with the SiLU taken on the conv's output in
  the model's dtype, the rounding of JAX's bf16 conv outputs;
- ``controlnet_down_blocks`` (one zero-initialised 1×1 conv per skip of the
  down pass: conv_in's, each resnet's and each downsampler's, 12 for
  SD1.5) and ``controlnet_mid_block``.

``forward`` returns ``(down residuals, mid residual)``, each scaled by
``conditioning_scale`` in f32 and cast back (JAX ``:213-222``), for the
UNet's ``down_block_additional_residuals`` /
``mid_block_additional_residual``.  ``cond_embed`` is a method of its
own: the control image's embedding does not change over the steps, so the
fused loop computes it once and passes it as ``cond_embed``.
"""

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfast_tpu_torch.models.layers import Conv2d, init_weights_
from sfast_tpu_torch.models.unet_2d_condition import (
    SD15_UNET,
    TINY_UNET,
    UNetConfig,
    UNetTrunk,
    backends,
)
from sfast_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    unet: UNetConfig = SD15_UNET
    conditioning_channels: int = 3
    conditioning_embedding_out_channels: Tuple[int, ...] = (16, 32, 96, 256)


SD15_CONTROLNET = ControlNetConfig()
TINY_CONTROLNET = ControlNetConfig(unet=TINY_UNET, conditioning_embedding_out_channels=(16, 32))


class ControlNetConditioningEmbedding(nn.Module):
    def __init__(self, cin: int, channels: Tuple[int, ...], cout: int, *, device=None,
                 dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.conv_in = Conv2d(cin, channels[0], 3, padding=1, **mk)
        blocks = []
        for c0, c1 in zip(channels[:-1], channels[1:]):
            blocks.append(Conv2d(c0, c0, 3, padding=1, **mk))
            blocks.append(Conv2d(c0, c1, 3, stride=2, padding=1, **mk))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv2d(channels[-1], cout, 3, padding=1, **mk)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.conv_in(cond))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(h)


def _scaled(y: torch.Tensor, scale) -> torch.Tensor:
    """``y · scale`` in f32, cast back to ``y``'s dtype; ``scale`` a float or
    a 0-d f32 tensor (a graph input, so a new scale captures nothing)."""
    return (y.float() * scale).to(y.dtype)


class ControlNetModel(UNetTrunk):
    def __init__(self, cfg: ControlNetConfig = SD15_CONTROLNET, *, device=None, dtype=None):
        device = resolve_device(device)
        super().__init__(cfg.unet, device=device, dtype=dtype)
        self.config = cfg
        mk = dict(device=device, dtype=dtype)
        ucfg = cfg.unet
        boc = ucfg.block_out_channels
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            cfg.conditioning_channels, cfg.conditioning_embedding_out_channels, boc[0], **mk)
        skips = [boc[0]]
        for i, c in enumerate(boc):
            skips += [c] * ucfg.layers_per_block + ([c] if i < len(boc) - 1 else [])
        self.controlnet_down_blocks = nn.ModuleList([Conv2d(c, c, 1, **mk) for c in skips])
        self.controlnet_mid_block = Conv2d(boc[-1], boc[-1], 1, **mk)
        with torch.no_grad():
            for conv in self.zero_convs():
                conv.weight.zero_()
                conv.bias.zero_()

    def zero_convs(self):
        """The convs a fresh ControlNet holds at zero: the embedding's
        ``conv_out``, ``controlnet_down_blocks`` and ``controlnet_mid_block``."""
        return [self.controlnet_cond_embedding.conv_out, *self.controlnet_down_blocks,
                self.controlnet_mid_block]

    def cond_embed(self, controlnet_cond: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) control image in [0, 1] → its (B, H/8, W/8, C0)
        embedding; it depends on nothing else, so a loop may hoist it."""
        return self.controlnet_cond_embedding(controlnet_cond.to(self.dtype))

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        controlnet_cond=None,
        *,
        conditioning_scale=1.0,
        added_cond_kwargs=None,
        cond_embed=None,
    ):
        """sample (B, h, w, 4) latents, timesteps () or (B,),
        encoder_hidden_states (B, S, D), controlnet_cond (B, H, W, 3) in
        [0, 1] (or ``cond_embed``, its precomputed embedding) → (tuple of
        the down residuals, the mid residual)."""
        be = backends(self.compilation_config)
        dtype = self.dtype
        emb = self.embed(sample, timesteps, added_cond_kwargs)
        context = encoder_hidden_states.to(dtype)
        c = cond_embed.to(dtype) if cond_embed is not None else self.cond_embed(controlnet_cond)
        h, skips = self.down(self.conv_in(sample.to(dtype)) + c, emb, context, be, {})
        h = self.mid(h, emb, context, be, {})
        down = tuple(_scaled(conv(r), conditioning_scale)
                     for r, conv in zip(skips, self.controlnet_down_blocks))
        return down, _scaled(self.controlnet_mid_block(h), conditioning_scale)


@torch.no_grad()
def init_controlnet_weights_(module: ControlNetModel, generator: torch.Generator,
                             zero_conv_scale: float = 0.0) -> ControlNetModel:
    """Seeded random weights at the init scales (``init_weights_``), then the
    zero convs: zero, as a fresh ControlNet's, or at ``zero_conv_scale``
    times the init scale (weights N(0, scale²/fan_in), biases 0), a stand-in
    for a trained ControlNet's, whose residuals reach the UNet."""
    init_weights_(module, generator)
    for conv in module.zero_convs():
        w = torch.randn(conv.weight.shape, generator=generator, device=conv.weight.device)
        conv.weight.copy_(w * (zero_conv_scale / math.sqrt(conv.weight[0].numel())))
        conv.bias.zero_()
    return module
