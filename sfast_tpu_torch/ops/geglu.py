"""Linear + GEGLU: the plain erf path and K4, the fused dual-GEMM kernel
(``csrc/geglu.cu``).

Counterpart of ``sfast_tpu/ops/geglu.py``.  diffusers' convention:
``hidden * gelu(gate)`` where the fused weight's first half of output rows
gives ``hidden`` and the second half ``gate``.  The port's weight is
torch's ``(2F, K)``; JAX's is its transpose ``(K, 2F)``.

- :func:`linear_geglu_plain` ≙ ``linear_geglu_xla``: one GEMM, chunk, erf
  GELU — the route while ``enable_fused_linear_geglu`` is off.
- :func:`linear_geglu_fused_ref` ≙ ``_geglu_kernel``: f32 accumulation, f32
  bias, the tanh GELU, one cast at the end.  K4's plain version.
- :func:`linear_geglu_fused`, the K4 wrapper.
- :func:`linear_geglu` dispatches as JAX's ``linear_geglu``: ``None`` is
  the auto rule :func:`geglu_ok`, ``'kernel'`` ≙ ``'pallas'`` forces K4,
  ``'plain'`` ≙ ``'xla'``.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from sfast_tpu_torch.runtime import cuda_build

BLOCK_K = 32  # K must be a multiple (the tail of K4's 64-wide k tile loads as zeros)
BLOCK_F = 64  # K4's F tile: F must be a multiple


def geglu_ok(x_shape, w_shape, dtype: torch.dtype, device_type: str) -> bool:
    """The auto rule for K4 (JAX ``linear_geglu``'s ``lanes_ok``, with "on
    TPU" read as "bf16 tensor on CUDA"): 2F % 256 == 0 and K % 128 == 0.
    For SD1.5 that excludes the level-0 blocks (K = 320)."""
    return (
        w_shape[0] % 256 == 0
        and x_shape[-1] % 128 == 0
        and device_type == "cuda"
        and dtype == torch.bfloat16
    )


def linear_geglu_plain(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``x: (..., K)``, ``w: (2F, K)``, ``b: (2F,)`` → ``(..., F)`` with the
    erf GELU.  bf16 inputs keep the GEMM output in bf16, as JAX does; other
    dtypes compute in f32."""
    acc_t = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    y = F.linear(x.to(acc_t), w.to(acc_t), None if b is None else b.to(acc_t))
    h, g = y.chunk(2, dim=-1)
    return (h * F.gelu(g)).to(x.dtype)


def linear_geglu_fused_ref(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version of K4: ``(x·W₁ᵀ+b₁) ⊙ gelu_tanh(x·W₂ᵀ+b₂)`` with f32
    products and bias, cast to x's dtype at the end."""
    f = w.shape[0] // 2
    y = torch.matmul(x.float(), w.float().t())
    if b is not None:
        y = y + b.float()
    h, g = y[..., :f], y[..., f:]
    return (h * F.gelu(g, approximate="tanh")).to(x.dtype)


@cuda_build.no_backward("linear_geglu")
def linear_geglu_fused(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The fused linear + tanh GEGLU; neither (M, F) GEMM output reaches
    device memory.  On CUDA: bf16 x and w, K % 32 == 0, F % 64 == 0."""
    if x.device.type == "cpu":
        return linear_geglu_fused_ref(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"linear_geglu: unsupported device {x.device}")
    *lead, k = x.shape
    f2 = w.shape[0]
    if (
        x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16
        or w.dim() != 2 or w.shape[1] != k or w.device != x.device
        or (b is not None and tuple(b.shape) != (f2,))
    ):
        raise ValueError(
            f"linear_geglu: needs bf16 x (..., K), w (2F, K) and b (2F,) on {x.device}, "
            f"got {tuple(x.shape)} {x.dtype}, {tuple(w.shape)} {w.dtype}, "
            f"{None if b is None else tuple(b.shape)}"
        )
    if k % BLOCK_K != 0 or f2 % (2 * BLOCK_F) != 0:
        raise ValueError(
            f"linear_geglu: needs K % {BLOCK_K} == 0 and F % {BLOCK_F} == 0, "
            f"got K={k} F={f2 // 2}"
        )
    m = x.numel() // k
    # TMA needs 16-byte aligned rows: K % 32 == 0 gives the stride, the
    # base pointer may still be off (a slice of a larger buffer)
    x2, w = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (x.reshape(m, k), w))
    # the kernel reads a bf16 or f32 bias as it lies and adds it in f32
    bias = b
    if b is not None and not (b.device == x.device and b.is_contiguous()
                              and b.dtype in (torch.bfloat16, torch.float32)):
        bias = b.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((m, f2 // 2), dtype=x.dtype, device=x.device)
    err = cuda_build.library().sfast_linear_geglu_bf16(
        x2.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        int(bias is not None and bias.dtype == torch.bfloat16),
        out.data_ptr(), m, k, f2 // 2, cuda_build.stream_ptr(x),
    )
    cuda_build.check(err, "linear_geglu")
    cuda_build.count_launch("linear_geglu")
    return out.reshape(*lead, f2 // 2)


def linear_geglu(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    backend: Optional[str] = None,  # None = auto rule | 'kernel' | 'plain'
) -> torch.Tensor:
    """``x: (..., K)``, ``w: (2F, K)``, ``b: (2F,)`` → ``(..., F)``."""
    if backend not in (None, "kernel", "plain"):
        raise ValueError(f"unknown geglu backend: {backend}")
    if backend == "kernel" or (
        backend is None and geglu_ok(x.shape, w.shape, x.dtype, x.device.type)
    ):
        return linear_geglu_fused(x, w, b)
    return linear_geglu_plain(x, w, b)
