"""K6: int8 flash attention forward — its pre-processing
(``csrc/quantize_qkv.cu``) and its body (``csrc/flash_attention_int8.cu``)
— and their plain versions.

Counterpart of ``sfast_tpu/ops/flash_attention.py::flash_attention_int8``,
the SageAttention-style design of the Pallas kernel: q, k and v are
mean-centred and quantized to int8 before the body (:func:`quantize_qkv`,
JAX ``:326-349``), q·kᵀ and p·v run int8 × int8 → int32, and p is quantized
per kv tile against that tile's row max.

:func:`flash_attention_int8` runs the pre-processing (two kernels) and the
body (one) for CUDA tensors, and no other device work, and takes
:func:`flash_attention_int8_ref` for CPU tensors; any other device raises.
Tensors are (B, H, S, D), as K1's.

The body's kv tile is :func:`kv_tile` (128 at d <= 64); JAX's
default block is 1024.  Since p is quantized per tile, the two differ by
int8 rounding noise, within the same bound of exact attention.  The plain
version takes ``block_k`` so that each comparison can use the other side's
tile.
"""

import math
from typing import NamedTuple, Optional

import torch

from sfast_tpu_torch.ops.flash_attention import LOG2E, MAX_HEAD_DIM, _aligned
from sfast_tpu_torch.runtime import cuda_build

NEG_INF = -1e30  # the Pallas kernel's mask value
PREP_ROWS = 256  # rows per block of the pre-processing (csrc/quantize_qkv.cu)


def kv_tile(d: int) -> int:
    """K6's kv tile at head dim ``d``, over which p shares one row max."""
    return 128 if d <= 64 else (64 if d <= 128 else 32)


class KernelInputs(NamedTuple):
    """What K6's body reads, in its layout (``csrc/flash_attention_int8.cu``):
    ``q8`` (BH, Sq, KP) and ``k8`` (BH, Sk, KP) int8, rows zero-padded to
    KP = D rounded up to 32; ``vt`` (BH, D, SKP) int8, vᵀ with kv in the
    permuted order of :func:`permute_kv`, zero past Sk; ``corr`` (BH, SKP)
    f32, zero past Sk, with SKP = Sk rounded up to 16; ``sqk`` (BH,),
    ``sv`` and ``vm`` (BH, D) f32."""

    q8: torch.Tensor
    k8: torch.Tensor
    vt: torch.Tensor
    sqk: torch.Tensor
    sv: torch.Tensor
    corr: torch.Tensor
    vm: torch.Tensor


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


def kernel_inputs(q, k, v, scale: float) -> KernelInputs:
    """Plain version of K6's pre-processing: :func:`quantize_qkv`, then
    :func:`kernel_layout`, each tensor contiguous."""
    q8, k8, v8, sqk, sv, corr, vm = quantize_qkv(q, k, v, scale)
    return kernel_layout(q8, k8, v8, sqk, sv, corr, vm)


def _pad_rows(x8: torch.Tensor) -> torch.Tensor:
    """(BH, S, D) int8 → (BH, S, KP): rows zero-padded to KP = D rounded up
    to 32, the depth of K6's q·kᵀ."""
    bh, s, d = x8.shape
    xp = x8.new_zeros((bh, s, -(-d // 32) * 32))
    xp[:, :, :d] = x8
    return xp


def permute_kv(x: torch.Tensor) -> torch.Tensor:
    """Reorder dim 1 (a multiple of 16) within each 16-wide group to (0, 1,
    8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15): position 4a + 2b + c
    holds kv 8b + 2a + c, the order in which a thread's quantized scores
    form its A registers of p·v (``csrc/flash_attention_int8.cu``)."""
    n, s = x.shape[:2]
    rest = x.shape[2:]
    return x.reshape(n, s // 16, 2, 4, 2, *rest).transpose(2, 3).reshape(n, s, *rest)


def kernel_layout(q8, k8, v8, sqk, sv, corr, vm) -> KernelInputs:
    """:func:`quantize_qkv`'s outputs in the layout K6's body reads
    (:class:`KernelInputs`)."""
    bh, sk, d = v8.shape
    skp = -(-sk // 16) * 16
    vp = v8.new_zeros((bh, skp, d))
    vp[:, :sk] = v8
    vt = permute_kv(vp).transpose(1, 2).contiguous()  # (BH, D, SKP)
    cp = corr.new_zeros((bh, skp))
    cp[:, :sk] = corr
    return KernelInputs(_pad_rows(q8), _pad_rows(k8), vt, sqk.contiguous(),
                        sv.contiguous(), cp, vm.reshape(bh, d).contiguous())


def flash_attention_int8_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
    block_k: int = 128,
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


@cuda_build.no_backward("quantize_qkv")
def quantize_qkv_cuda(q, k, v, scale: float) -> KernelInputs:
    """K6's pre-processing on the card, 2 launches: the same values as
    :func:`kernel_inputs` up to the order of the sums (a code may land one
    level off where a value sits on a rounding boundary).  q, k and v as
    :func:`flash_attention_int8` passes them: bf16 (B, H, S, D) with a unit
    D stride and rows on 16 bytes."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bh, kp, skp = b * h, -(-d // 32) * 32, -(-sk // 16) * 16
    nch = -(-max(sq, sk) // PREP_ROWS)
    dev = q.device
    out = KernelInputs(
        q8=torch.empty((bh, sq, kp), dtype=torch.int8, device=dev),
        k8=torch.empty((bh, sk, kp), dtype=torch.int8, device=dev),
        vt=torch.empty((bh, d, skp), dtype=torch.int8, device=dev),
        sqk=torch.empty((bh,), dtype=torch.float32, device=dev),
        sv=torch.empty((bh, d), dtype=torch.float32, device=dev),
        corr=torch.empty((bh, skp), dtype=torch.float32, device=dev),
        vm=torch.empty((bh, d), dtype=torch.float32, device=dev),
    )
    part = torch.empty((3, bh, nch, 3, d), dtype=torch.float32, device=dev)
    err = cuda_build.library().sfast_quantize_qkv_int8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), b, h, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale) * LOG2E,
        part.data_ptr(), out.q8.data_ptr(), out.k8.data_ptr(), out.vt.data_ptr(),
        out.corr.data_ptr(), out.sqk.data_ptr(), out.sv.data_ptr(), out.vm.data_ptr(),
        cuda_build.stream_ptr(q),
    )
    cuda_build.check(err, "quantize_qkv")
    cuda_build.count_launch("quantize_qkv")
    return out


@cuda_build.no_backward("flash_attention_int8")
def flash_attention_int8_body(
    inputs: KernelInputs, shape, *, causal: bool = False
) -> torch.Tensor:
    """K6's body on the card, 1 launch, over inputs in its layout; ``shape``
    is q's (B, H, Sq, D).  Returns a (B, H, Sq, D) view of a (B, Sq, H, D)
    bf16 buffer."""
    b, h, sq, d = shape
    sk = inputs.k8.shape[1]
    dev = inputs.q8.device
    o = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=dev).transpose(1, 2)
    err = cuda_build.library().sfast_flash_attention_int8(
        inputs.q8.data_ptr(), inputs.k8.data_ptr(), inputs.vt.data_ptr(),
        inputs.corr.data_ptr(), inputs.sqk.data_ptr(), inputs.sv.data_ptr(),
        inputs.vm.data_ptr(), o.data_ptr(), b, h, sq, sk, d, *o.stride()[:3], int(causal),
        cuda_build.stream_ptr(o),
    )
    cuda_build.check(err, "flash_attention_int8")
    cuda_build.count_launch("flash_attention_int8")
    return o


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
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_int8_ref(q, k, v, scale=scale, causal=causal, block_k=kv_tile(d))
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
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    return flash_attention_int8_body(quantize_qkv_cuda(q, k, v, scale), q.shape, causal=causal)
