"""Attention dispatch: the flash kernels (K1, K6) or the plain materializing
path.

Counterpart of ``sfast_tpu/ops/attention.py`` with the same routing rule
(``attention.py:30-37, 81-96``): flash only when both q and kv are long —
at least 1024 for head dim ≤ 64, 2048 otherwise — and, in place of "on
TPU", when the tensors lie on a CUDA device.  The kernels take bf16 with
d a multiple of 8 up to 160, so the rule asks for those as well.  For
SD1.5 at 512² that is the UNet's level-0 self-attention only (4096
tokens, 8 heads, d = 40).  Backends, as JAX's:

- ``None``: the rule picks K1;
- ``'int8'``: the rule picks K6, the int8 kernel
  (``enable_int8_attention``);
- ``'flash_int8'``: K6 whatever the shape;
- ``'plain'``: the materializing softmax of JAX's ``xla_attention``, which
  is K1's plain version, ``flash_attention_ref``;
- ``('ring', mesh, axis)``: sequence-parallel ring attention over ``axis``
  of the mesh (``parallel/ring_attention.py``), the route of every UNet
  attention when the mesh's ``sp`` axis has more than one rank
  (``attention.py:114-127``).  q, k and v are replicated, as the rest of
  the activations: each rank takes its S/n chunk of each, runs the ring,
  and all-gathers the output along S.  Where S or the kv length does not
  divide by n (the 77-token cross-attention) the call takes the plain
  path, as JAX's.  Non-causal only.
"""

from typing import Optional, Union

import torch

from sfast_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM,
    flash_attention,
    flash_attention_ref,
)
from sfast_tpu_torch.ops.flash_attention_int8 import flash_attention_int8

_FLASH_MIN_Q = 2048
_FLASH_MIN_Q_SMALL_D = 1024
_SMALL_D = 64
_BACKENDS = (None, "int8", "flash_int8", "plain")


def flash_ok(q_shape, k_shape, dtype: torch.dtype, device_type: str) -> bool:
    """The auto rule: does attention of these (B, H, S, D) shapes go to a
    flash kernel (K1, or K6 under ``'int8'``)?"""
    d = q_shape[-1]
    min_q = _FLASH_MIN_Q_SMALL_D if d <= _SMALL_D else _FLASH_MIN_Q
    return (
        q_shape[-2] >= min_q
        and k_shape[-2] >= min_q
        and device_type == "cuda"
        and dtype == torch.bfloat16
        and d % 8 == 0
        and d <= MAX_HEAD_DIM
    )


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
    backend: Union[None, str, tuple] = None,  # None | 'int8' | 'flash_int8' | 'plain' | ring
) -> torch.Tensor:
    """Attention over (batch, heads, seq, head_dim)."""
    if isinstance(backend, tuple) and backend and backend[0] == "ring":
        return _ring(q, k, v, backend, scale=scale, causal=causal)
    if backend not in _BACKENDS:
        raise ValueError(f"unknown attention backend: {backend}")
    if backend == "flash_int8":
        return flash_attention_int8(q, k, v, scale=scale, causal=causal)
    if backend != "plain" and flash_ok(q.shape, k.shape, q.dtype, q.device.type):
        kernel = flash_attention_int8 if backend == "int8" else flash_attention
        return kernel(q, k, v, scale=scale, causal=causal)
    return flash_attention_ref(q, k, v, scale=scale, causal=causal)


def _ring(q, k, v, backend, *, scale, causal):
    from sfast_tpu_torch.parallel.mesh import axis_rank, axis_size
    from sfast_tpu_torch.parallel.ring_attention import ring_attention
    from sfast_tpu_torch.parallel.tensor_parallel import all_gather

    if causal:
        raise NotImplementedError("ring attention is non-causal")
    _, mesh, axis = backend
    n = axis_size(mesh, axis)
    if q.shape[-2] % n or k.shape[-2] % n:
        return flash_attention_ref(q, k, v, scale=scale, causal=causal)
    r = axis_rank(mesh, axis)
    sq, sk = q.shape[-2] // n, k.shape[-2] // n
    out = ring_attention(q.narrow(-2, r * sq, sq), k.narrow(-2, r * sk, sk),
                         v.narrow(-2, r * sk, sk), mesh=mesh, axis=axis, scale=scale)
    return all_gather(out, mesh, axis, -2)
