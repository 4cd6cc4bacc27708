"""CLIP vision encoder — transformers' ``CLIPVisionModelWithProjection``.

Counterpart of ``sfast_tpu/models/clip_vision.py``: the image encoder of
IP-Adapter (OpenCLIP ViT-H/14, exact gelu, projection 1024) and of the
classic IP-Adapter / SD image variation (OpenAI ViT-L/14).  A bias-free
patch conv, the class token and position embedding, pre-LN, non-causal
layers, post-LN on token 0 and ``visual_projection``.  Attention always
takes the plain route (257 tokens), as JAX forces it (``attn_backend=
"xla"``, ``clip_vision.py:130-132``); the MLP's activation runs in f32.

The module carries transformers' state-dict names
(``vision_model.embeddings.patch_embedding.weight``,
``vision_model.pre_layrnorm`` — sic —, ``vision_model.encoder.layers.{i}.
self_attn.q_proj``..., ``visual_projection`` at the top level).
``forward`` takes NHWC pixel values, CLIP-normalized, and returns JAX's
dict: ``last_hidden_state``, ``pooler_output``, ``image_embeds`` (with a
projection) and ``hidden_states`` (with ``output_hidden_states``).
"""

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from sfast_tpu_torch.models.clip_text import CLIPEncoder
from sfast_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from sfast_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: Optional[int] = None
    hidden_act: str = "quick_gelu"  # 'quick_gelu' (OpenAI) | 'gelu' (OpenCLIP, exact erf)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


# laion CLIP ViT-H/14: IP-Adapter's (and SVD's) image encoder
VIT_H_IMAGE_ENCODER = CLIPVisionConfig(
    hidden_size=1280, intermediate_size=5120, num_layers=32, num_heads=16,
    projection_dim=1024, hidden_act="gelu",
)
# OpenAI CLIP ViT-L/14 (SD image variation, the classic IP-Adapter)
VIT_L_IMAGE_ENCODER = CLIPVisionConfig(projection_dim=768)
TINY_IMAGE_ENCODER = CLIPVisionConfig(
    image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, projection_dim=32,
)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size, **mk))
        self.patch_embedding = Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                      stride=cfg.patch_size, bias=False, **mk)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, cfg.hidden_size, **mk)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        b = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values.to(self.class_embedding.dtype))
        h = patches.reshape(b, -1, patches.shape[-1])
        cls = self.class_embedding[None, None, :].expand(b, 1, -1)
        h = torch.cat([cls, h], dim=1)
        return h + self.position_embedding.weight[: h.shape[1]]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device=None, dtype=None):
        super().__init__()
        f32 = dict(device=device, dtype=torch.float32)
        self.embeddings = CLIPVisionEmbeddings(cfg, device=device, dtype=dtype)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, **f32)  # transformers' spelling
        self.encoder = CLIPEncoder(cfg, causal=False, device=device, dtype=dtype)
        self.post_layernorm = LayerNorm(cfg.hidden_size, **f32)


class CLIPVisionModel(nn.Module):
    """``forward(pixel_values (B, H, W, 3), output_hidden_states=False)``
    → dict (see the module docstring)."""

    def __init__(self, cfg: CLIPVisionConfig = VIT_H_IMAGE_ENCODER, *, device=None,
                 dtype=None):
        super().__init__()
        self.config = cfg
        device = resolve_device(device)
        self.vision_model = CLIPVisionTransformer(cfg, device=device, dtype=dtype)
        self.visual_projection = (
            Linear(cfg.hidden_size, cfg.projection_dim, bias=False, device=device, dtype=dtype)
            if cfg.projection_dim is not None else None
        )

    def forward(self, pixel_values: torch.Tensor, output_hidden_states: bool = False) -> dict:
        vm = self.vision_model
        h = vm.pre_layrnorm(vm.embeddings(pixel_values))
        hidden_states = [h]
        for layer in vm.encoder.layers:
            h = layer(h)
            hidden_states.append(h)
        pooled = vm.post_layernorm(h[:, 0])
        out = {"last_hidden_state": h, "pooler_output": pooled}
        if output_hidden_states:
            out["hidden_states"] = tuple(hidden_states)
        if self.visual_projection is not None:
            out["image_embeds"] = self.visual_projection(pooled)
        return out
