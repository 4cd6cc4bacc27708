"""K1: flash attention forward (``csrc/flash_attention.cu``) and its plain
version.

Counterpart of ``sfast_tpu/ops/flash_attention.py::flash_attention``.
:func:`flash_attention` launches the CUDA kernel for CUDA tensors and
takes :func:`flash_attention_ref` for CPU tensors; any other device
raises.  Tensors are (B, H, S, D); the kernel reads them through their
strides (unit stride along D), so the head-split view of a (B, S, H·D)
projection needs no copy, and the output is a (B, H, S, D) view of a
(B, S, H, D) buffer, which the caller merges back into (B, S, H·D) for
free.
"""

import math
from typing import Optional

import torch

from sfast_tpu_torch.runtime import cuda_build

LOG2E = math.log2(math.e)
MAX_HEAD_DIM = 160  # largest instantiation in csrc/flash_attention.cu


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Plain version: the materializing ``softmax(q·kᵀ·scale)·v`` of
    ``sfast_tpu.ops.attention.xla_attention`` — f32 scores and softmax,
    p cast to the input dtype for the p·v product."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def _aligned(t: torch.Tensor) -> bool:
    """Every (b, h, s) row starts on 16 bytes, as the kernel's TMA tensor
    maps need (base and strides multiples of 16 bytes)."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        s % 8 == 0 for s in t.stride()[:3]
    )


@cuda_build.no_backward("flash_attention")
def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Blockwise ``softmax(q·kᵀ·scale)·v`` over (B, H, S, D) with O(S)
    memory; on CUDA bf16 with d a multiple of 8 up to 160."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or t.dim() != 4:
            raise ValueError(
                f"flash_attention: {name} must be a 4-D bf16 tensor on {q.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    if d % 8 != 0 or d > MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: head dim {d} is not a multiple of 8 up to {MAX_HEAD_DIM}"
        )
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not scale > 0:  # the kernel takes the row max before scaling
        raise ValueError(f"flash_attention: scale must be positive, got {scale}")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = cuda_build.library()
    err = lib.sfast_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, h, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale) * LOG2E, int(causal), cuda_build.stream_ptr(q),
    )
    cuda_build.check(err, "flash_attention")
    cuda_build.count_launch("flash_attention")
    return o
