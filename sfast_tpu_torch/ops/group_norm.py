"""GroupNorm over NHWC: the plain op, the fused GroupNorm
(``csrc/group_norm_fused.cu``), K3, the statistics kernel
(``csrc/group_norm_stats.cu``), and K5, the normalize kernel
(``csrc/group_norm_apply.cu``).

Counterpart of ``sfast_tpu/ops/group_norm.py``.  :func:`group_norm`
dispatches as JAX's ``group_norm`` (``:291-322``):

- ``backend=None``: the auto rule, :func:`group_norm_ok`.  On the card a
  bf16 GroupNorm takes the ``'kernel'`` route; everything else (the CPU,
  f32, other widths, a call autograd records) the plain one.  JAX's auto
  rule is ``group_norm_xla`` everywhere, which XLA fuses into one pass;
  PyTorch runs the same plain form as about ten unfused full-size passes,
  most of them in f32, so on the card the hand-written kernel is the
  counterpart of what XLA gives;
- ``'plain'``: ``group_norm_xla`` (``:254-288``), never a kernel;
- ``'kernel'`` ≙ ``'pallas'`` (``group_norm_pallas``, K3′ then K5): the
  fused GroupNorm, one launch, where :func:`fused_plan` accepts the shape,
  else K3 then K5; it raises where the kernels cannot take the tensor;
- ``'hybrid'`` (``group_norm_hybrid``): K3 then the plain affine.

:func:`group_norm_stats` is the Pallas ``_stats_kernel`` entry point (K3,
and K3′ at ``group_norm_pallas``'s call site); it also serves the VAE
decoder's fused-resnet entries through ``fused_conv.gn_affine``.
:func:`group_norm_apply` is ``_norm_apply_kernel`` (K5).
"""

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sfast_tpu_torch.ops.linear import apply_act
from sfast_tpu_torch.runtime import cuda_build

_STATS_BLOCKS = 256  # K3's most blocks a call: two an SM
_STATS_CHUNK_BYTES = 32 * 1024  # K3's bytes of x a block, at least
_STATS_THREADS = 512  # K3's most threads a block
_MAX_GROUPS = 512  # K3's per-group sums in shared memory
_ACTS = {None: 0, "silu": 1, "gelu": 2}  # the kernels' template parameter
# The fused GroupNorm on the H100: 227 KB of shared memory a CTA at most,
# clusters of up to 8 CTAs (16 with the non-portable attribute), 512 threads
_SMEM_LIMIT = 232448
_MAX_CLUSTER = 16  # the kernel's most; above 8 needs the non-portable attribute
_PORTABLE_CLUSTER = 8
_TWO_CTA_SMEM = 116 * 1024  # the most a CTA may hold with two CTAs an SM
_FUSED_THREADS = 512
# (device, stream) -> K3's per-sample counters of the eager calls on that
# stream (zero between calls).  A capture takes a set of its own instead
# (``_ticket``), so no graph shares its counters with another graph or with
# an eager call: replays of two graphs on two streams, or a warm-up on one
# thread beside a replay on another, never take each other's tickets.
_tickets = {}


class FusedPlan(NamedTuple):
    """How the fused GroupNorm splits a call: ``band_groups`` whole groups
    a band, ``cluster`` CTAs a (sample, band), ``rows`` rows a CTA, ``rp``
    row lanes a CTA (32 × m for m warps a band vector), ``threads`` = ``rp``
    × the band's 16-byte vectors, and ``smem`` bytes of dynamic shared
    memory a CTA."""

    band_groups: int
    cluster: int
    rows: int
    rp: int
    threads: int
    smem: int


def fused_smem_bytes(rows: int, vb: int, threads: int, band_groups: int) -> int:
    """Shared memory of one fused CTA, as ``csrc/group_norm_fused.cu``'s
    ``smem_bytes`` lays it out: the tile (rows × vb 16-byte vectors), 4 f32
    a warp, every cluster CTA's per-group sums and their total (17 × 2 f32
    a group) and the band's scale and shift."""
    return rows * vb * 16 + threads // 32 * 16 + (_MAX_CLUSTER + 1) * 8 * band_groups + 64 * vb


def fused_plan(n: int, hw: int, c: int, groups: int) -> Optional[FusedPlan]:
    """The fused GroupNorm's split of an (n, hw, c) call, or None where the
    kernel does not take it (the call then takes K3 then K5): fewer than 8
    channels a group, or a band tile that does not fit a CTA.

    A band is the fewest whole groups whose channels fill 16-byte vectors
    (four groups of 10 at C = 320), doubled while its rows are narrower
    than 64 bytes (two 32-byte sectors).  A cluster has 2 to 8 CTAs (a
    power of two, no more than the rows), as many as keep a CTA at 128 to
    256 rows or more, and more where the tile would not fit otherwise; 16
    (non-portable) where 8 would leave tiles too large for two an SM and 16
    do not (16 CTAs at one an SM would need 16 free SMs of one GPC).  A
    CTA has m warps for each band vector, one for every 256 of its rows
    (at most 512 threads).  Chosen from a sweep of bands, clusters and
    warps on the H100 at the UNet's 18 GroupNorm shapes (PERF.md)."""
    if c % 8 or c % groups or c // groups < 8:
        return None
    cpg = c // groups
    bg = 8 // math.gcd(cpg, 8)
    if groups % bg:
        return None
    while bg * cpg < 32 and groups % (2 * bg) == 0:
        bg *= 2
    vb = bg * cpg // 8
    if 32 * vb > _FUSED_THREADS:
        return None

    def plan(cl):
        rows = -(-hw // cl)
        m = max(1, min(-(-rows // 256), _FUSED_THREADS // (32 * vb)))
        threads = 32 * m * vb
        return FusedPlan(bg, cl, rows, 32 * m, threads, fused_smem_bytes(rows, vb, threads, bg))

    cluster = min(2, hw)
    while cluster < _PORTABLE_CLUSTER and 2 * cluster <= hw and (
            cluster * 256 <= hw or plan(cluster).smem > _SMEM_LIMIT):
        cluster *= 2
    best = plan(cluster)
    if best.smem > _TWO_CTA_SMEM and 16 * 128 <= hw:
        wide = plan(16)
        if wide.smem <= _TWO_CTA_SMEM:  # two CTAs an SM, not one
            best = wide
    return best if best.smem <= _SMEM_LIMIT else None


def group_norm_ok(x_shape, groups: int, dtype: torch.dtype, device_type: str,
                  grad: bool) -> bool:
    """The auto rule: does a GroupNorm of NHWC ``x_shape`` take the
    ``'kernel'`` route (the fused GroupNorm where :func:`fused_plan` takes
    the shape, else K3 then K5)?  Yes for a bf16 tensor on CUDA with C % 8
    == 0 and at most 512 groups, unless autograd records the call
    (``grad``): the kernels have no backward."""
    return (
        device_type == "cuda"
        and dtype == torch.bfloat16
        and x_shape[-1] % 8 == 0
        and groups <= _MAX_GROUPS
        and not grad
    )


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
    backend: Optional[str] = None,  # None = auto rule | 'kernel' | 'hybrid' | 'plain'
) -> torch.Tensor:
    """GroupNorm (+activation: None, 'silu' or tanh 'gelu') over NHWC.  On
    the card a bf16 call takes the fused GroupNorm by default (see the
    module's docstring)."""
    c = x.shape[-1]
    if c % groups != 0:
        raise ValueError(f"channels ({c}) must be divisible by groups ({groups})")
    if backend is None:
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta))
        ok = group_norm_ok(x.shape, groups, x.dtype, x.device.type, grad)
        backend = "kernel" if ok else "plain"
    if backend == "plain":
        return _group_norm_plain(x, gamma, beta, groups=groups, eps=eps, act=act)
    if backend not in ("kernel", "hybrid"):
        raise ValueError(f"unknown group_norm backend: {backend}")
    n, h, w, _ = x.shape
    if backend == "kernel" and fused_plan(n, h * w, c, groups) is not None:
        return group_norm_fused(x, gamma, beta, groups=groups, eps=eps, act=act)
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


def stats_chunks(n: int, hw: int, c: int, groups: int) -> Tuple[int, int]:
    """K3's (rows a block, blocks a sample): about 32 KB of x a block (four
    16-byte loads a thread), at most two blocks an SM in all, at least one
    row, and enough rows that a block's (2, groups) f32 partial is at most
    an eighth of the bytes of x it sums."""
    chunks = max(1, min(-(-_STATS_BLOCKS // n), -(-hw * c * 2 // _STATS_CHUNK_BYTES), hw))
    rows = max(-(-hw // chunks), -(-32 * groups // c))
    return rows, -(-hw // rows)


def _ticket(x: torch.Tensor, n: int) -> torch.Tensor:
    """K3's per-sample counters for a call on x's device and current
    stream, zero when the call starts; the block that folds a sample sets
    its counter back to zero.

    Inside a CUDA graph capture the call gets a set of its own, allocated
    in the graph's memory pool and zeroed by a node of the graph before
    the kernel: the graph shares it with nothing.  Eager calls share one
    set per (device, stream): calls on one stream run in turn.  A call of
    more samples than that set holds replaces it; the old set is freed in
    stream order after the calls that used it, since no graph holds it."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(max(n, 64), dtype=torch.int32, device=x.device)
    key = (x.device, cuda_build.stream_ptr(x))
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=x.device)
    return t


@cuda_build.no_backward("group_norm_stats")
def group_norm_stats(
    x: torch.Tensor, *, groups: int = 32, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, rstd) of GroupNorm over NHWC x, each
    (N, 1, 1, C) f32: one read of x in one launch
    (``csrc/group_norm_stats.cu``).  Its blocks write per-group partials,
    and the last block of a sample to take that sample's integer ticket
    adds them in chunk order.  The tickets belong to the device and the
    current stream, or to the graph being captured (:func:`_ticket`), so
    calls on different streams may overlap.  bf16 with C % 8 == 0 and at
    most 512 groups on CUDA."""
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
    if groups > _MAX_GROUPS:
        raise ValueError(f"group_norm_stats: at most {_MAX_GROUPS} groups, got {groups}")
    x = x.contiguous()
    hw = h * w
    mean = torch.empty((n, 1, 1, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    rows, n_chunks = stats_chunks(n, hw, c, groups)
    partial = torch.empty((n, n_chunks, 2, groups), dtype=torch.float32, device=x.device)
    ticket = _ticket(x, n)
    err = cuda_build.library().sfast_group_norm_stats_bf16(
        x.data_ptr(), partial.data_ptr(), ticket.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        n, hw, c, groups, float(eps), rows, n_chunks, min(c // 8, _STATS_THREADS),
        cuda_build.stream_ptr(x),
    )
    cuda_build.check(err, "group_norm_stats")
    cuda_build.count_launch("group_norm_stats")
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


@cuda_build.no_backward("group_norm_apply")
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
    cuda_build.count_launch("group_norm_apply")
    return out


def group_norm_fused_ref(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    groups: int = 32,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused GroupNorm: K3's then K5's, returning
    (y, mean, rstd)."""
    mean, rstd = group_norm_stats_ref(x, groups=groups, eps=eps)
    return group_norm_apply_ref(x, mean, rstd, gamma, beta, act=act), mean, rstd


@cuda_build.no_backward("group_norm_fused")
def group_norm_fused(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    groups: int = 32,
    eps: float = 1e-5,
    act: Optional[str] = None,
    stats: bool = False,
):
    """GroupNorm (+activation) over NHWC x in one launch: one read of x and
    one write of y.  Returns y, or (y, mean, rstd) with ``stats``, the
    statistics (N, 1, 1, C) f32 as K3 gives them.  bf16 with C % 8 == 0
    on CUDA, at a shape :func:`fused_plan` accepts."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation: {act}")
    if x.device.type == "cpu":
        out = group_norm_fused_ref(x, gamma, beta, groups=groups, eps=eps, act=act)
        return out if stats else out[0]
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_fused: unsupported device {x.device}")
    n, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or c % 8 != 0:
        raise ValueError(f"group_norm_fused: needs bf16 with C % 8 == 0, got {x.dtype} C={c}")
    plan = fused_plan(n, h * w, c, groups)
    if plan is None:
        raise ValueError(
            f"group_norm_fused: no band and cluster of ({n}, {h}, {w}, {c}) with {groups} "
            f"groups fits a CTA's shared memory"
        )
    x = x.contiguous()
    gamma, beta = (t.to(dtype=torch.float32, device=x.device).reshape(c).contiguous()
                   for t in (gamma, beta))
    out = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty((n, 1, 1, c), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    err = cuda_build.library().sfast_group_norm_fused_bf16(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        None if mean is None else mean.data_ptr(), None if rstd is None else rstd.data_ptr(),
        n, h * w, c, groups, float(eps), _ACTS[act], plan.band_groups, plan.cluster,
        plan.rp // 32,
        cuda_build.stream_ptr(x),
    )
    cuda_build.check(err, "group_norm_fused")
    cuda_build.count_launch("group_norm_fused")
    return (out, mean, rstd) if stats else out
