"""sfast_tpu_torch — the PyTorch / CUDA port of sfast_tpu.

The JAX package ``sfast_tpu`` stays the reference.  This package runs the
SD1.5 text2img slice on an NVIDIA H100 with PyTorch, through CUDA kernels
written by hand for Hopper, eight sources in ``csrc/``: flash attention
(K1), the fused GroupNorm+SiLU→3×3 conv (K2), GroupNorm statistics (K3),
GroupNorm apply (K5), the fused GroupNorm (K3′ and K5 in one launch),
linear + GEGLU (K4), and int8 flash attention (K6) with its quantization
of q, k and v.  Each has a plain PyTorch version beside it, which is what
runs for CPU tensors.  The kernels are built with nvcc at first use;
importing the package builds and loads nothing.

``compile`` wraps the pipeline's models so that each replays a CUDA graph
per input signature (``runtime/tracing.py``).
"""

from sfast_tpu_torch.compilers import compile
from sfast_tpu_torch.config import CompilationConfig

__all__ = ["CompilationConfig", "compile"]
