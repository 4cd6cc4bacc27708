"""K6: int8 flash attention forward (``csrc/flash_attention_int8.cu``) and
its plain version.

Counterpart of ``sfast_tpu/ops/flash_attention.py::flash_attention_int8``,
the SageAttention-style design of the Pallas kernel: q, k and v are
mean-centred and quantized to int8 outside the kernel
(:func:`quantize_qkv`, JAX ``:326-349``), q·kᵀ and p·v run int8 × int8 →
int32, and p is quantized per kv tile against that tile's row max.

:func:`flash_attention_int8` launches the kernel for CUDA tensors and takes
:func:`flash_attention_int8_ref` for CPU tensors; any other device raises.
Tensors are (B, H, S, D), as K1's.

The kernel's kv tile is 64 (:data:`KV_TILE`); JAX's default block is
1024.  Since p is quantized per tile, the two differ by int8 rounding
noise, within the same bound of exact attention.  The plain version takes
``block_k`` so that each comparison can use the other side's tile.
"""

import math
from typing import Optional

import torch

from sfast_tpu_torch.ops.flash_attention import LOG2E, MAX_HEAD_DIM
from sfast_tpu_torch.runtime import cuda_build

KV_TILE = 64  # K6's kv tile, over which p shares one row max
NEG_INF = -1e30  # the Pallas kernel's mask value


def _quantize_per_bh(x: torch.Tensor):
    """(BH, S, D) f32 → int8 with one dynamic scale per BH row (half to
    even, as ``jnp.round``)."""
    amax = x.abs().amax(dim=(1, 2), keepdim=True)
    scale = amax.clamp_min(1e-6) / 127.0
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale[:, 0, 0]


def _quantize_per_channel(x: torch.Tensor):
    """(BH, S, D) f32 → int8 with a dynamic scale per (BH, channel)."""
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = amax.clamp_min(1e-6) / 127.0
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale[:, 0, :]


def quantize_qkv(q, k, v, scale: float):
    """JAX's pre-processing of the int8 kernel, in plain torch.

    Returns ``(q8, k8, v8, sqk, sv, corr, vm)``: int8 (BH, S, D) q, k, v;
    the score scale s_q·s_k (BH,); the p·v scale s_v / 127 (BH, D); q's mean
    term q̄·kᵀ (BH, Sk); v's mean (BH, 1, D), all f32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bh = b * h
    # log₂e folded into q's scale: every exponential in the kernel is exp2
    qf = q.reshape(bh, sq, d).float() * (scale * LOG2E)
    kf = k.reshape(bh, sk, d).float()
    vf = v.reshape(bh, sk, d).float()
    kf = kf - kf.mean(dim=1, keepdim=True)  # a per-row score shift: dropped
    qm = qf.mean(dim=1, keepdim=True)
    qf = qf - qm
    corr = torch.matmul(qm, kf.transpose(1, 2))[:, 0]  # exact per-column term
    vm = vf.mean(dim=1, keepdim=True)  # added back after the normalize
    vf = vf - vm
    q8, s_q = _quantize_per_bh(qf)
    k8, s_k = _quantize_per_bh(kf)
    v8, s_v = _quantize_per_channel(vf)
    return q8, k8, v8, s_q * s_k, s_v / 127.0, corr, vm


def kernel_inputs(q, k, v, scale: float):
    """Everything K6 reads, each contiguous: ``(q8, k8, vt, sqk, sv, corr,
    vm)`` with v and corr as :func:`kernel_layout` gives them.  (With one
    batch, ``reshape`` turns a head-split view into a (BH, S, D) view
    without a copy, and the elementwise ops keep its strides, so contiguity
    has to be asked for.)"""
    q8, k8, v8, sqk, sv, corr, vm = quantize_qkv(q, k, v, scale)
    vt, corr = kernel_layout(v8, corr)
    return tuple(t.contiguous() for t in (q8, k8, vt, sqk, sv, corr, vm))


def kernel_layout(v8: torch.Tensor, corr: torch.Tensor):
    """v and corr as K6 reads them: kv padded with zeros to a multiple of
    :data:`KV_TILE`; v transposed to (BH, D, Skp) with each 16-wide kv group
    in the order (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15), the
    order in which a thread's quantized scores form its A fragments
    (``csrc/flash_attention_int8.cu``).  Position 4a + 2b + c of a group
    holds kv 8b + 2a + c."""
    bh, sk, d = v8.shape
    skp = -(-sk // KV_TILE) * KV_TILE
    vp = v8.new_zeros((bh, skp, d))
    vp[:, :sk] = v8
    vt = vp.view(bh, skp // 16, 2, 4, 2, d).permute(0, 5, 1, 3, 2, 4).reshape(bh, d, skp)
    cp = corr.new_zeros((bh, skp))
    cp[:, :sk] = corr
    return vt, cp


def flash_attention_int8_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
    block_k: int = KV_TILE,
) -> torch.Tensor:
    """Plain version of K6: the Pallas kernel's math, kv block by kv block
    in f32, with p quantized against each ``block_k``-wide block's row max.
    Products of int8 values are summed exactly in f32 up to block_k 1024."""
    if block_k > 1024:
        raise ValueError(f"block_k {block_k} > 1024: int8 sums would leave f32's exact range")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q8, k8, v8, sqk, sv, corr, vm = quantize_qkv(q, k, v, scale)
    qf, kf, vf = q8.float(), k8.float(), v8.float()
    bh = b * h
    m = torch.full((bh, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((bh, sq, 1), device=q.device)
    acc = torch.zeros((bh, sq, d), device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None]
    for j0 in range(0, sk, block_k):
        j1 = min(j0 + block_k, sk)
        s = torch.matmul(qf, kf[:, j0:j1].transpose(1, 2)) * sqk[:, None, None]
        s = s + corr[:, None, j0:j1]
        if causal:
            cols = torch.arange(j0, j1, device=q.device)[None, :]
            s = s.masked_fill(cols > rows, NEG_INF)
        m_cur = s.amax(dim=-1, keepdim=True)
        m_next = torch.maximum(m, m_cur)
        p2 = torch.exp2(s - m_cur)  # peaks at 1 in every block
        alpha = torch.exp2(m - m_next)
        beta = torch.exp2(m_cur - m_next)
        l = l * alpha + beta * p2.sum(dim=-1, keepdim=True)
        m = m_next
        p8 = (p2 * 127.0 + 0.5).to(torch.int8)  # truncation, as the cast in JAX
        pv = torch.matmul(p8.float(), vf[:, j0:j1])
        acc = acc * alpha + (pv * beta) * sv[:, None, :]
    out = (acc / l).to(q.dtype) + vm.to(q.dtype)
    return out.reshape(b, h, sq, d)


def flash_attention_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """int8-compute blockwise attention over (B, H, S, D): the contract of
    K1 with about 1e-2 relative error from the int8 quantization; on CUDA
    bf16 with d a multiple of 8 up to 160."""
    if q.device.type == "cpu":
        return flash_attention_int8_ref(q, k, v, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_int8: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or t.dim() != 4:
            raise ValueError(
                f"flash_attention_int8: {name} must be a 4-D bf16 tensor on {q.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"flash_attention_int8: shapes {q.shape} {k.shape} {v.shape}")
    if d % 8 != 0 or d > MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention_int8: head dim {d} is not a multiple of 8 up to {MAX_HEAD_DIM}"
        )
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q8, k8, vt, sqk, sv, corr, vm = kernel_inputs(q, k, v, scale)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    err = cuda_build.library().sfast_flash_attention_int8(
        q8.data_ptr(), k8.data_ptr(), vt.data_ptr(), sqk.data_ptr(), sv.data_ptr(),
        corr.data_ptr(), o.data_ptr(),
        b, h, sq, sk, vt.shape[-1], d, *o.stride()[:3], int(causal),
        cuda_build.stream_ptr(q),
    )
    cuda_build.check(err, "flash_attention_int8")
    cuda_build.launch_counts["flash_attention_int8"] += 1
    return o + vm.view(b, h, 1, d).to(o.dtype)
