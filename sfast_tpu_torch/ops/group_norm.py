"""GroupNorm over NHWC: the plain op, K3, the statistics kernel
(``csrc/group_norm_stats.cu``), and K5, the normalize kernel
(``csrc/group_norm_apply.cu``).

Counterpart of ``sfast_tpu/ops/group_norm.py``.  :func:`group_norm`
dispatches as JAX's ``group_norm`` (``:291-322``):

- ``backend=None`` or ``'plain'``: ``group_norm_xla`` (``:254-288``), the
  default in JAX, whose auto rule is XLA everywhere;
- ``'kernel'`` ≙ ``'pallas'`` (``group_norm_pallas``): K3 then K5, the
  route of every UNet GroupNorm under ``enable_fused_group_norm``;
- ``'hybrid'`` (``group_norm_hybrid``): K3 then the plain affine.

:func:`group_norm_stats` is the Pallas ``_stats_kernel`` entry point (K3,
and K3′ at ``group_norm_pallas``'s call site); it also serves the VAE
decoder's fused-resnet entries through ``fused_conv.gn_affine``.
:func:`group_norm_apply` is ``_norm_apply_kernel`` (K5).
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sfast_tpu_torch.ops.linear import apply_act
from sfast_tpu_torch.runtime import cuda_build

_TARGET_CHUNKS = 256  # partial-sum blocks per call: about 2 per SM
_ACTS = {None: 0, "silu": 1, "gelu": 2}  # K5's template parameter


def _act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """JAX's GroupNorm activations: none, SiLU, or the tanh GELU."""
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    return apply_act(y, act)


def _group_norm_plain(x, gamma, beta, *, groups, eps, act):
    """Plain GroupNorm (+activation) over NHWC with f32 statistics, in the
    one-pass sum/sum-of-squares form of JAX's ``group_norm_xla``."""
    n, h, w, c = x.shape
    cpg = c // groups
    xf = x.reshape(n, h * w, groups, cpg).float()
    cnt = float(h * w * cpg)
    mean = xf.sum(dim=(1, 3), keepdim=True) / cnt
    var = (xf * xf).sum(dim=(1, 3), keepdim=True) / cnt - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(n, h * w, c) * gamma.float() + beta.float()
    return _act(y, act).to(x.dtype).reshape(n, h, w, c)


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    groups: int = 32,
    eps: float = 1e-5,
    act: Optional[str] = None,
    backend: Optional[str] = None,  # None = plain | 'kernel' | 'hybrid' | 'plain'
) -> torch.Tensor:
    """GroupNorm (+activation: None, 'silu' or tanh 'gelu') over NHWC."""
    c = x.shape[-1]
    if c % groups != 0:
        raise ValueError(f"channels ({c}) must be divisible by groups ({groups})")
    if backend in (None, "plain"):
        return _group_norm_plain(x, gamma, beta, groups=groups, eps=eps, act=act)
    if backend not in ("kernel", "hybrid"):
        raise ValueError(f"unknown group_norm backend: {backend}")
    mean, rstd = group_norm_stats(x, groups=groups, eps=eps)
    if backend == "kernel":
        return group_norm_apply(x, mean, rstd, gamma, beta, act=act)
    scale = rstd * gamma.reshape(1, 1, 1, c).float()
    shift = beta.reshape(1, 1, 1, c).float() - mean * scale
    return _act(x.float() * scale + shift, act).to(x.dtype)


def group_norm_stats_ref(
    x: torch.Tensor, *, groups: int = 32, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: per-channel (mean, rstd) of each channel's
    group, each (N, 1, 1, C) f32, with var = E[x²] − E[x]²."""
    n, h, w, c = x.shape
    cpg = c // groups
    xf = x.reshape(n, h * w, groups, cpg).float()
    cnt = float(h * w * cpg)
    mean = xf.sum(dim=(1, 3)) / cnt
    var = (xf * xf).sum(dim=(1, 3)) / cnt - mean * mean
    rstd = torch.rsqrt(var + eps)
    return (
        mean.repeat_interleave(cpg, dim=1).reshape(n, 1, 1, c),
        rstd.repeat_interleave(cpg, dim=1).reshape(n, 1, 1, c),
    )


def group_norm_stats(
    x: torch.Tensor, *, groups: int = 32, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, rstd) of GroupNorm over NHWC x, each
    (N, 1, 1, C) f32: one read of x.  bf16 with C % 8 == 0 on CUDA."""
    if x.device.type == "cpu":
        return group_norm_stats_ref(x, groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_stats: unsupported device {x.device}")
    n, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or c % 8 != 0 or c % groups != 0:
        raise ValueError(
            f"group_norm_stats: needs bf16 with C % 8 == 0 and C % groups == 0, "
            f"got {x.dtype} C={c} groups={groups}"
        )
    x = x.contiguous()
    hw = h * w
    # at least one row per chunk: (2, 8, 8, C) gets 64 chunks of 1 row
    chunks = max(1, _TARGET_CHUNKS // n)
    rows_per_chunk = -(-hw // chunks)
    n_chunks = -(-hw // rows_per_chunk)
    partial = torch.empty((n, n_chunks, 2, c), dtype=torch.float32, device=x.device)
    mean = torch.empty((n, 1, 1, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    err = cuda_build.library().sfast_group_norm_stats_bf16(
        x.data_ptr(), partial.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        n, hw, c, groups, float(eps), rows_per_chunk, n_chunks,
        cuda_build.stream_ptr(x),
    )
    cuda_build.check(err, "group_norm_stats")
    cuda_build.launch_counts["group_norm_stats"] += 1
    return mean, rstd


def group_norm_apply_ref(
    x: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    act: Optional[str] = None,
) -> torch.Tensor:
    """Plain version of K5 (``_norm_apply_kernel``):
    ``act((x − mean)·rstd·γ + β)`` in f32, cast to x's dtype; mean and rstd
    are (N, 1, 1, C) f32, γ and β (C,)."""
    c = x.shape[-1]
    y = (x.float() - mean) * rstd * gamma.reshape(1, 1, 1, c).float()
    y = y + beta.reshape(1, 1, 1, c).float()
    return _act(y, act).to(x.dtype)


def group_norm_apply(
    x: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    act: Optional[str] = None,
) -> torch.Tensor:
    """Normalize, affine and activation of NHWC x from its GroupNorm
    statistics: one read and one write of x.  bf16 with C % 8 == 0 on CUDA."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation: {act}")
    if x.device.type == "cpu":
        return group_norm_apply_ref(x, mean, rstd, gamma, beta, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_apply: unsupported device {x.device}")
    n, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or c % 8 != 0:
        raise ValueError(
            f"group_norm_apply: needs bf16 with C % 8 == 0, got {x.dtype} C={c}"
        )
    x = x.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    mean, rstd = (t.to(**f32).reshape(n, c).contiguous() for t in (mean, rstd))
    gamma, beta = (t.to(**f32).reshape(c).contiguous() for t in (gamma, beta))
    out = torch.empty_like(x)
    err = cuda_build.library().sfast_group_norm_apply_bf16(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), out.data_ptr(), n, h * w, c, _ACTS[act],
        cuda_build.stream_ptr(x),
    )
    cuda_build.check(err, "group_norm_apply")
    cuda_build.launch_counts["group_norm_apply"] += 1
    return out
