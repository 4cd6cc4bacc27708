"""Compilation configuration of the PyTorch port.

The fields the port reads, with the same defaults as
``sfast_tpu.config.CompilationConfig``.  Kernel routes:

- ``enable_flash_attention``: long self-attention goes to the hand-written
  flash kernel (K1) when its tensors lie on a CUDA device;
- ``enable_int8_attention``: that attention takes the int8 flash kernel
  (K6) instead of K1.  Off by default, as in JAX;
- ``enable_fused_group_norm``: every UNet GroupNorm takes the fused
  GroupNorm kernel (one launch) where ``ops/group_norm.fused_plan`` accepts
  its shape, else the statistics kernel (K3) then the normalize kernel
  (K5), and raises where the kernels cannot take the tensor.  Off by
  default, as in JAX; off, a GroupNorm takes the op's auto rule
  (``ops/group_norm.group_norm_ok``), which on the card sends every bf16
  GroupNorm that autograd does not record to the same kernels: plain
  PyTorch does not fuse the plain form's passes as XLA fuses JAX's;
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
                                ``enable_aot_cache``): the UNet, the VAE's
                                decode and encode and CLIP replay one CUDA
                                graph per input signature.  False runs them
                                eagerly.
trace_scheduler                 ``trace_scheduler``: the scheduler's step
                                replays a graph too, one graph for all the
                                steps (its index and tables are device
                                tensors, its noise an input).
(new in JAX)                    ``fuse_denoising_loop``: the whole N-step
                                loop (CFG concat, UNet, guidance, step) is
                                one graph (JAX: one ``fori_loop``
                                executable).  Off by default, as in JAX.
(new in JAX)                    ``batch_buckets``: the prompt batch is
                                padded up to these buckets, bounding the
                                number of graphs; padded rows are dropped.
memory_format                   ``memory_format``: the models are NHWC;
                                'NCHW' transposes a compiled model's 4-D
                                and 5-D tensor inputs and outputs at its
                                boundary (``utils/memory_format.py``), for
                                models called alone: the pipelines hand
                                their models NHWC tensors and refuse it.
prefer_lowp_gemm                ``prefer_lowp_gemm``: True runs the models
                                under the process's precision flags; False
                                runs each call, and its capture, under
                                ``utils.compute_precision.high_compute_precision``
                                (no TF32, no reduced-precision bf16 sums).
(new in JAX)                    ``param_dtype``: the dtype in which
                                ``compile`` builds the port's models from
                                a diffusers pipeline
                                (``interop/diffusers_adapter.py``).
==============================  ==========================================

Multi-device, as JAX's (``sfast_tpu/config.py:114-117``), each None by
default:

- ``mesh``: a ``torch.distributed`` ``DeviceMesh`` from
  ``parallel.make_mesh``.  Each compiled model is sharded over its ``tp``
  axis by the rule (``parallel/tensor_parallel.py``), and with an ``sp``
  axis of more than one rank the UNets' attention runs as ring attention;
- ``sharding_rules``: ``(pattern, spec)`` pairs in place of the Megatron
  rule (``parallel/sharding.py`` states their layout);
- ``cache_dir``: the directory of the kernels' nvcc build
  (``runtime/cuda_build.py``), the counterpart of JAX's persistent
  executable cache.  The process has one library, so one directory: the
  first compiled model whose config names one fixes it (as loading the
  library does), and a later config naming another raises.  None names
  none, and the default is ``build/sfast_tpu_torch/`` in the checkout.

JAX's ``freeze`` and ``preserve_parameters`` have no counterpart: a CUDA
graph reads the weights by address, so an in-place copy
(``CompiledModel.update_params``) is the hot-swap, and there is nothing to
fold.  JAX's ``compute_dtype`` is read nowhere in ``sfast_tpu``, so it has
none either.
"""

import dataclasses
from typing import Any, Optional, Sequence, Tuple


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
    memory_format: str = "NHWC"  # or 'NCHW'
    prefer_lowp_gemm: bool = True
    param_dtype: str = "bfloat16"
    cache_dir: Optional[str] = None
    mesh: Any = None  # a torch.distributed DeviceMesh, or None for one device
    sharding_rules: Optional[Tuple[Tuple[str, Any], ...]] = None

    def __post_init__(self):
        if self.memory_format not in ("NHWC", "NCHW"):
            raise ValueError(
                f"memory_format must be 'NHWC' or 'NCHW', got {self.memory_format!r}")

    @staticmethod
    def Default() -> "CompilationConfig":
        return CompilationConfig()

    def replace(self, **kw) -> "CompilationConfig":
        return dataclasses.replace(self, **kw)
