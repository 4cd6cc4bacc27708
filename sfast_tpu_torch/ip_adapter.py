"""IP-Adapter: image-prompt conditioning through decoupled cross-attention.

Counterpart of ``sfast_tpu/ip_adapter.py``, after the reference's community
example (``community/optimize_sd15_with_controlnet_and_ip_adapter.py``):
every ``attn2`` of the UNet gets the bias-free ``to_k_ip`` / ``to_v_ip``
projections of diffusers' ``IPAdapterAttnProcessor``
(``models/layers.Attention``), and a small image projection maps a CLIP
image embedding to ``num_tokens`` context tokens.  The pipeline takes those
tokens as ``ip_adapter_embeds``, stacked [uncond; cond] for CFG as the
community example stacks them.

:func:`load_ip_adapter` reads the torch ``ip_adapter.bin`` layout,
``{"image_proj": {"proj.weight", "proj.bias", "norm.weight",
"norm.bias"}, "ip_adapter": {"1.to_k_ip.weight", "1.to_v_ip.weight",
"3.to_k_ip.weight", ...}}``: diffusers numbers every attention processor,
attn1 and attn2 alike, so the attn2 ids are the odd ones, in the order of
:func:`attn2_paths_in_diffusers_order`.  Loading adds the projections to
the module in place, so a graph captured before it (which passed no IP
tokens) keeps its signature; a call with tokens captures its own.
"""

from typing import Dict, List

import torch
import torch.nn as nn

from sfast_tpu_torch.models.layers import LayerNorm, Linear
from sfast_tpu_torch.models.unet_2d_condition import UNetConfig


def attn2_paths_in_diffusers_order(cfg: UNetConfig) -> List[str]:
    """The module name of every ``attn2`` of a UNet of ``cfg``, in
    diffusers' ``attn_processors`` order — down blocks, then up blocks,
    then the mid block — which IP-Adapter checkpoints number."""
    n = len(cfg.block_out_channels)
    paths = []
    for i, btype in enumerate(cfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            for j in range(cfg.layers_per_block):
                for k in range(cfg.transformer_layers_per_block[i]):
                    paths.append(f"down_blocks.{i}.attentions.{j}.transformer_blocks.{k}.attn2")
    for i, btype in enumerate(cfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            for j in range(cfg.layers_per_block + 1):
                for k in range(cfg.transformer_layers_per_block[n - 1 - i]):
                    paths.append(f"up_blocks.{i}.attentions.{j}.transformer_blocks.{k}.attn2")
    for k in range(cfg.transformer_layers_per_block[-1]):
        paths.append(f"mid_block.attentions.0.transformer_blocks.{k}.attn2")
    return paths


class ImageProjModel(nn.Module):
    """IP-Adapter's image projection: a linear to ``num_tokens × cross_dim``,
    a reshape to tokens, LayerNorm (f32 statistics, as JAX's)."""

    def __init__(self, clip_embed_dim: int, cross_dim: int, num_tokens: int = 4, *,
                 device=None, dtype=None):
        super().__init__()
        self.num_tokens = num_tokens
        self.proj = Linear(clip_embed_dim, num_tokens * cross_dim, device=device, dtype=dtype)
        self.norm = LayerNorm(cross_dim, device=device, dtype=torch.float32)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        h = self.proj(image_embeds.to(self.proj.weight.dtype))
        return self.norm(h.reshape(h.shape[0], self.num_tokens, -1))


def ip_image_embed(image_proj: ImageProjModel, clip_image_embeds: torch.Tensor) -> torch.Tensor:
    """CLIP image embeddings (B, D_clip) → IP tokens (B, num_tokens,
    cross_dim)."""
    return image_proj(clip_image_embeds)


def _module(unet):
    return getattr(unet, "module", unet)  # a CompiledModel's module


def add_ip_projections(unet) -> List[str]:
    """Give every ``attn2`` of ``unet`` (a module or a ``CompiledModel``)
    its IP projections (zero), so that a state dict holding them loads;
    returns their module names in diffusers' order."""
    module = _module(unet)
    paths = attn2_paths_in_diffusers_order(module.config)
    for name in paths:
        attn = module.get_submodule(name)
        if attn.to_k_ip is None:
            attn.add_ip_projections()
    return paths


@torch.no_grad()
def load_ip_adapter(unet, ip_state_dict: Dict, *, num_tokens: int = 4) -> ImageProjModel:
    """Load a torch ``ip_adapter.bin``-layout dict into ``unet`` in place and
    return the image projection, on the UNet's device and dtype.  Raises
    when no attn2 key matches."""
    module = _module(unet)
    ip_sd, proj_sd = ip_state_dict["ip_adapter"], ip_state_dict["image_proj"]
    loaded = 0
    for n, name in enumerate(attn2_paths_in_diffusers_order(module.config)):
        key = 2 * n + 1  # attn1 takes the even ids
        if f"{key}.to_k_ip.weight" not in ip_sd:
            continue
        attn = module.get_submodule(name)
        if attn.to_k_ip is None:
            attn.add_ip_projections()
        attn.to_k_ip.weight.copy_(torch.as_tensor(ip_sd[f"{key}.to_k_ip.weight"]))
        attn.to_v_ip.weight.copy_(torch.as_tensor(ip_sd[f"{key}.to_v_ip.weight"]))
        loaded += 1
    if loaded == 0:
        raise ValueError("load_ip_adapter: no '<odd id>.to_k_ip.weight' key matches an attn2 "
                         f"of this UNet (keys: {sorted(ip_sd)[:4]}...)")
    w = module.conv_in.weight
    proj_w = torch.as_tensor(proj_sd["proj.weight"])
    image_proj = ImageProjModel(proj_w.shape[1], proj_w.shape[0] // num_tokens, num_tokens,
                                device=w.device, dtype=w.dtype)
    image_proj.load_state_dict({k: torch.as_tensor(v) for k, v in proj_sd.items()})
    return image_proj


@torch.no_grad()
def init_ip_adapter_params(generator: torch.Generator, unet, *, clip_embed_dim: int = 1024,
                           num_tokens: int = 4) -> Dict:
    """Seeded random IP-Adapter weights in the ``ip_adapter.bin`` layout, at
    JAX's init scales (``ip_adapter.py:160-195``): the projections and the
    image projection's linear N(0, 0.02²), its bias 0, the norm (1, 0).
    Drawn in f32 on ``generator``'s device, attn2 by attn2 (k then v), then
    the image projection."""
    module = _module(unet)
    dev = generator.device

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32) * 0.02

    ip_sd = {}
    for n, name in enumerate(attn2_paths_in_diffusers_order(module.config)):
        to_k = module.get_submodule(name).to_k  # its weight is None once quantized
        dim, ctx = to_k.out_features, to_k.in_features
        ip_sd[f"{2 * n + 1}.to_k_ip.weight"] = randn(dim, ctx)
        ip_sd[f"{2 * n + 1}.to_v_ip.weight"] = randn(dim, ctx)
    cross = module.config.cross_attention_dim
    proj_sd = {
        "proj.weight": randn(num_tokens * cross, clip_embed_dim),
        "proj.bias": torch.zeros(num_tokens * cross, device=dev),
        "norm.weight": torch.ones(cross, device=dev),
        "norm.bias": torch.zeros(cross, device=dev),
    }
    return {"image_proj": proj_sd, "ip_adapter": ip_sd}
