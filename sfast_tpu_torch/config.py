"""Compilation configuration of the PyTorch port.

The fields the SD1.5 text2img slice reads, with the same defaults as
``sfast_tpu.config.CompilationConfig``.  Kernel routes:

- ``enable_flash_attention``: long self-attention goes to the hand-written
  flash kernel (K1) when its tensors lie on a CUDA device;
- ``enable_int8_attention``: that attention takes the int8 flash kernel
  (K6) instead of K1.  Off by default, as in JAX;
- ``enable_fused_group_norm``: every UNet GroupNorm takes the fused
  GroupNorm kernel (one launch) where ``ops/group_norm.fused_plan`` accepts
  its shape, else the statistics kernel (K3) then the normalize kernel
  (K5).  Off by default, as in JAX;
- ``enable_fused_linear_geglu``: the feed-forward's linear + GEGLU may take
  the dual-GEMM kernel (K4) where its widths allow.  Off by default, as in
  JAX; the kernel computes the tanh GELU of the Pallas kernel, the plain
  route diffusers' erf GELU;
- ``enable_fused_conv``: the UNet's 3×3 convs may take the fused
  GroupNorm+SiLU→conv kernel (K2).  Off by default, as in JAX; the VAE
  decoder takes K2 regardless, as it does in JAX;
- ``enable_kernels`` (≙ ``enable_pallas``): one switch for every
  hand-written kernel.  False sends every op to its plain PyTorch version.

The compile layer (``compilers/``, ``runtime/tracing.py``):

==============================  ==========================================
reference knob                  here (JAX's knob)
==============================  ==========================================
enable_cuda_graph               ``enable_cuda_graph`` (≙ ``enable_jit`` and
                                ``enable_aot_cache``): the UNet, the VAE
                                decoder and CLIP replay one CUDA graph per
                                input signature.  False runs them eagerly.
trace_scheduler                 ``trace_scheduler``: the DPM++ step replays
                                a graph too, one graph for all the steps
                                (its index and coefficients are device
                                tensors).
(new in JAX)                    ``fuse_denoising_loop``: the whole N-step
                                loop (CFG concat, UNet, guidance, step) is
                                one graph (JAX: one ``fori_loop``
                                executable).  Off by default, as in JAX.
(new in JAX)                    ``batch_buckets``: the prompt batch is
                                padded up to these buckets, bounding the
                                number of graphs; padded rows are dropped.
==============================  ==========================================

JAX's ``freeze`` and ``preserve_parameters`` have no counterpart: a CUDA
graph reads the weights by address, so an in-place copy
(``CompiledModel.update_params``) is the hot-swap, and there is nothing to
fold.
"""

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class CompilationConfig:
    enable_flash_attention: bool = True
    enable_int8_attention: bool = False
    enable_fused_group_norm: bool = False
    enable_fused_linear_geglu: bool = False
    enable_fused_conv: bool = False
    enable_kernels: bool = True
    enable_cuda_graph: bool = True
    trace_scheduler: bool = True
    fuse_denoising_loop: bool = False
    batch_buckets: Optional[Sequence[int]] = None

    @staticmethod
    def Default() -> "CompilationConfig":
        return CompilationConfig()

    def replace(self, **kw) -> "CompilationConfig":
        return dataclasses.replace(self, **kw)
