"""In-place int8 quantization of a model's linears and convs, and of a
pipeline's UNet (and ControlNet).

Counterpart of ``sfast_tpu/quant/dynamic_quant.py``, the analog of the
reference's ``torch.quantization.quantize_dynamic(unet, {nn.Linear},
qint8)``.  A site gives up its ``weight`` and holds ``w_q`` (W8A16) or
``w_q8`` (W8A8) with ``w_scale``, and a static ``a_scale`` where a
calibration (``quant/calibrate.py``) has the site; its forward routes by
what it holds (``models/layers.py``).

The sites are JAX's, site for site: JAX quantizes a weight whose parent
key is a target, so each of the port's modules is read under JAX's key
for it (``interop.from_jax.jax_key``, from the name map the state-dict
writers use): ``...attn1.to_out.0`` is ``to_out``, ``...ff.net.0.proj`` is
``proj``, ``...ff.net.2`` is ``out``.  Linears need ``min_features`` input
features; convs (W8A8 only) ``min_channels`` input channels, and the SVD
UNet's temporal (3, 1, 1) convs count, as JAX keeps them 4-D.  The
IP-Adapter's ``to_k_ip`` / ``to_v_ip`` are not targets.

Quantizing replaces the tensors that CUDA graphs read by address, and a
stale replay would read freed memory.  So both ``quantize_*_params``
functions bump the module's ``weights_version``: every captured function
that reads it (a ``CompiledModel`` of it, a fused loop over it, in any
pipeline that holds it) drops its graphs at its next call and captures
anew.  :func:`quantize_pipeline` also drops the graphs of the pipeline it
is given at once, so that their memory goes with the bf16 weights.
"""

from typing import Optional, Tuple

import torch
import torch.nn as nn

from sfast_tpu_torch.interop.from_jax import jax_key
from sfast_tpu_torch.ops.quant import quantize_conv_weight, quantize_weight
from sfast_tpu_torch.runtime.tracing import bump_weights_version

# JAX's linear targets (dynamic_quant.py:21-32): the attention projections
# and the MLPs, about 90% of an SD UNet's linear weights
_DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out", "proj", "out", "fc1", "fc2", "proj_in",
                    "proj_out")
# JAX's conv targets: the resnet and resampling convs, the FLOP carriers;
# conv_in / conv_out and the 1×1 projections stay bf16
_CONV_TARGETS = ("conv1", "conv2", "conv_shortcut", "conv")
_MODES = ("w8a16", "w8a8")


def _is_conv(m: nn.Module) -> bool:
    """A conv JAX keeps as a 4-D weight: 2-D convs, and the temporal
    (3, 1, 1) Conv3d (JAX's (3, 1, C_in, C_out))."""
    return isinstance(m, nn.Conv2d) or (isinstance(m, nn.Conv3d) and m.kernel_size == (3, 1, 1))


def _scale_buffer(a: float, device) -> torch.Tensor:
    return torch.tensor(a, dtype=torch.float32, device=device)


def _quantize_site(m: nn.Module, key: str, wq: torch.Tensor, scale: torch.Tensor,
                   a_scale: Optional[float]) -> None:
    m.weight = None  # the bf16 weight goes, and with the last reference its memory
    m.register_buffer(key, wq)
    m.register_buffer("w_scale", scale)
    if a_scale is not None:
        m.register_buffer("a_scale", _scale_buffer(a_scale, wq.device))


def linear_sites(module: nn.Module, targets: Tuple[str, ...] = _DEFAULT_TARGETS,
                 min_features: int = 64):
    """(name, module) of every bf16 linear JAX's rule quantizes."""
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, nn.Linear) and m.weight is not None
            and jax_key(name) in targets and m.in_features >= min_features]


def conv_sites(module: nn.Module, targets: Tuple[str, ...] = _CONV_TARGETS,
               min_channels: int = 64):
    """(name, module) of every conv JAX's W8A8 conv rule quantizes."""
    return [(name, m) for name, m in module.named_modules()
            if _is_conv(m) and m.weight is not None
            and jax_key(name) in targets and m.in_channels >= min_channels]


@torch.no_grad()
def quantize_linear_params(module: nn.Module, targets: Tuple[str, ...] = _DEFAULT_TARGETS,
                           min_features: int = 64, mode: str = "w8a16",
                           act_scales=None) -> nn.Module:
    """Quantize ``module``'s target linears in place: ``w_q`` (W8A16, the
    memory win) or ``w_q8`` (W8A8, int8 compute, the activation quantized
    per call unless ``act_scales`` — a ``Calibration`` — gives the site a
    static ``a_scale``).  Returns the module."""
    if mode not in _MODES:
        raise ValueError(mode)
    key = "w_q8" if mode == "w8a8" else "w_q"
    sites = linear_sites(module, targets, min_features)
    for name, m in sites:
        wq, scale = quantize_weight(m.weight)
        a = act_scales.scale_for(name) if act_scales is not None and mode == "w8a8" else None
        _quantize_site(m, key, wq, scale, a)
    if sites:
        bump_weights_version(module)
    return module


@torch.no_grad()
def quantize_conv_params(module: nn.Module, targets: Tuple[str, ...] = _CONV_TARGETS,
                         min_channels: int = 64, act_scales=None) -> nn.Module:
    """W8A8 for ``module``'s target convs in place: ``w_q8`` (F, C, kh, kw)
    int8 and per-output-channel ``w_scale``, a static ``a_scale`` where
    ``act_scales`` has the site.  Returns the module."""
    sites = conv_sites(module, targets, min_channels)
    for name, m in sites:
        w = m.weight if m.weight.dim() == 4 else m.weight[..., 0]  # temporal: (F, C, 3, 1)
        wq, scale = quantize_conv_weight(w)
        a = act_scales.scale_for(name) if act_scales is not None else None
        _quantize_site(m, "w_q8", wq, scale, a)
    if sites:
        bump_weights_version(module)
    return module


def quantize_pipeline(pipe, mode: str = "w8a16", quantize_convs: bool = False,
                      act_scales=None, quantize_controlnet: bool = False,
                      controlnet_act_scales=None):
    """Quantize the pipeline's UNet in place (its linears; with
    ``mode='w8a8'`` and ``quantize_convs`` its resnet and resampling convs
    too), and with ``quantize_controlnet`` its ControlNet with
    ``controlnet_act_scales``.  ``act_scales`` from
    :func:`~sfast_tpu_torch.quant.calibrate_pipeline` selects static
    W8A8.  Composes with ``sfast_tpu_torch.compile`` before or after:
    every graph of a touched slot and every fused loop is dropped here, the
    graphs of any other pipeline that holds the same modules at its next
    call, and the next call captures anew.  Returns the pipeline."""
    if mode not in _MODES:
        raise ValueError(mode)
    if quantize_convs and mode != "w8a8":
        raise ValueError("quantize_convs requires mode='w8a8'")
    if quantize_controlnet and getattr(pipe, "controlnet", None) is None:
        raise ValueError("quantize_controlnet=True but pipeline has no controlnet")
    slots = [("unet", act_scales)]
    if quantize_controlnet:
        slots.append(("controlnet", controlnet_act_scales))
    for slot, scales in slots:
        sub = getattr(pipe, slot)
        module = getattr(sub, "module", sub)
        quantize_linear_params(module, mode=mode, act_scales=scales)
        if quantize_convs:
            quantize_conv_params(module, act_scales=scales)
        if hasattr(sub, "clear_cache"):  # a CompiledModel: free its graphs' memory now
            sub.clear_cache()
    if hasattr(pipe, "_drop_fused_loops"):
        pipe._drop_fused_loops()
    return pipe
