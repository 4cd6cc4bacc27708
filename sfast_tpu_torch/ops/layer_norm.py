"""LayerNorm over the last dim with f32 statistics: the plain op and K7,
the one-pass LayerNorm kernel (``csrc/layer_norm.cu``).

Counterpart of ``sfast_tpu/ops/layer_norm.py``: the same one-pass
E[x²]−E[x]² formulation, so the two packages round alike.  JAX runs it as
jnp ops, which XLA fuses into one pass on the TPU; PyTorch runs the same
form as thirteen unfused kernels, most of them in f32, so on the card K7
is the counterpart of what XLA gives.  :func:`layer_norm` dispatches:

- ``backend=None``: the auto rule, :func:`layer_norm_ok`.  On the card a
  bf16 LayerNorm takes K7; everything else (the CPU, f32, other widths, a
  call autograd records) the plain form;
- ``'kernel'``: K7 (:func:`layer_norm_fused`); it raises where K7 cannot
  take the tensor;
- ``'plain'``: :func:`layer_norm_plain`, never a kernel.
"""

from typing import Optional

import torch

from sfast_tpu_torch.runtime import cuda_build

_MAX_C = 4096  # K7's widest row: one 16-byte vector a thread of a 512-thread block


def layer_norm_plain(
    x: torch.Tensor,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(ms - mean * mean + eps)
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype)


def row_stride(shape, stride) -> Optional[int]:
    """The distance in elements between the rows of x seen as (M, C): x's
    last dim contiguous and its leading dims one uniform run of rows.  None
    where they are not."""
    if not shape or (shape[-1] > 1 and stride[-1] != 1):
        return None
    lead = [(n, s) for n, s in zip(shape[:-1], stride[:-1]) if n != 1]
    for (_, outer), (n, inner) in zip(lead, lead[1:]):
        if outer != n * inner:
            return None
    return lead[-1][1] if lead else shape[-1]


def layer_norm_ok(x, grad: bool, gamma=None, beta=None) -> bool:
    """The auto rule: does a LayerNorm of ``x`` take K7?  Yes for a bf16
    tensor on CUDA whose last dim is contiguous and whose rows lie at a
    uniform stride, with C % 8 == 0 and C <= 4096 and f32 (or no) gamma and
    beta, unless autograd records the call (``grad``): K7 has no backward.
    It reads ``x``'s shape, strides, dtype and device alone."""
    c = x.shape[-1]
    return (
        x.device.type == "cuda"
        and x.dtype == torch.bfloat16
        and c % 8 == 0
        and c <= _MAX_C
        and row_stride(tuple(x.shape), tuple(x.stride())) is not None
        and all(t is None or t.dtype == torch.float32 for t in (gamma, beta))
        and not grad
    )


def layer_norm(
    x: torch.Tensor,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
    backend: Optional[str] = None,  # None = auto rule | 'kernel' | 'plain'
) -> torch.Tensor:
    """LayerNorm over the last dim.  On the card a bf16 call takes K7 by
    default (see the module's docstring)."""
    if backend is None:
        grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, gamma, beta))
        backend = "kernel" if layer_norm_ok(x, grad, gamma, beta) else "plain"
    if backend == "plain":
        return layer_norm_plain(x, gamma, beta, eps=eps)
    if backend != "kernel":
        raise ValueError(f"unknown layer_norm backend: {backend}")
    return layer_norm_fused(x, gamma, beta, eps=eps)


@cuda_build.no_backward("layer_norm")
def layer_norm_fused(
    x: torch.Tensor,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last dim in one launch: one read of x and one
    write of y.  bf16 with C % 8 == 0 and C <= 4096 on CUDA; rows that are
    not at a uniform 16-byte aligned stride are made contiguous first."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    c = x.shape[-1]
    if x.dtype != torch.bfloat16 or c % 8 != 0 or not 0 < c <= _MAX_C:
        raise ValueError(
            f"layer_norm: needs bf16 with C % 8 == 0 and C <= {_MAX_C}, got {x.dtype} C={c}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t is not None and t.numel() != c:
            raise ValueError(f"layer_norm: {name} has {t.numel()} elements, not C={c}")
    ld = row_stride(tuple(x.shape), tuple(x.stride()))
    if ld is None or ld % 8 or x.data_ptr() % 16:
        x, ld = x.clone(memory_format=torch.contiguous_format), c
    gamma, beta = (None if t is None else t.to(dtype=torch.float32, device=x.device).reshape(c)
                   .contiguous() for t in (gamma, beta))
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = cuda_build.library().sfast_layer_norm_bf16(
        x.data_ptr(), ld, None if gamma is None else gamma.data_ptr(),
        None if beta is None else beta.data_ptr(), out.data_ptr(), x.numel() // c, c,
        float(eps), cuda_build.stream_ptr(x),
    )
    cuda_build.check(err, "layer_norm")
    cuda_build.count_launch("layer_norm")
    return out
