"""Ring attention: non-causal attention over a sequence sharded on a mesh
axis.

Counterpart of ``sfast_tpu/parallel/ring_attention.py:30-91``.  Each rank
keeps its (B, H, S/n, D) shard of q and passes its shard of K and V around
the ring of the axis's n ranks, to rank + 1 and from rank − 1
(``batch_isend_irecv``), folding each into an online softmax: n steps, the
running max, sum and accumulator in f32, q prescaled by ``scale·log2 e`` so
that the exponentials are bare ``exp2``, the output cast back to q's dtype.
With n = 1 it takes one step and sends nothing.  JAX computes this body
with ``jnp.einsum`` and ``ppermute``, not in a Pallas kernel, so its
counterpart here is ``torch.matmul`` in f32: no hand-written kernel.

JAX's scan also rotates after its last step; the port sends n − 1 times,
the last rotation's shards being unused.

Differentiable, as JAX's is through ``ppermute``: the body is autograd's
ops, and the rotation's backward is its adjoint, sending each cotangent the
way back (to rank − 1, from rank + 1), so the K and V gradients that every
rank's queries produce reach the rank that holds the shard.
"""

import math
from typing import Optional

import torch
import torch.distributed as dist

from sfast_tpu_torch.parallel.mesh import check_device

NEG_INF = -1e30


def _shift(ts, group, shift: int):
    """Send each of ``ts`` to rank ``+ shift`` of ``group`` and receive its
    counterpart from rank ``− shift``."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + shift) % n)
    prv = dist.get_global_rank(group, (rank - shift) % n)
    ts = [t.contiguous() for t in ts]
    out = [torch.empty_like(t) for t in ts]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in ts]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


class _Rotate(torch.autograd.Function):
    """One step of the ring, ``ts`` to rank + 1; the backward sends the
    cotangents to rank − 1."""

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(_shift(ts, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift(grads, ctx.group, -1))


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis: str = "sp",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of this rank's (B, H, S/n, D) shard of q over every rank's
    shard of k and v, the sequence sharded on ``axis`` of ``mesh``.
    Non-causal (the diffusion use), and the same values as single-device
    attention."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_device(t, mesh, f"ring_attention {name}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    qf = q.float() * (scale * math.log2(math.e))
    b, h, s_loc, d = q.shape
    m = torch.full((b, h, s_loc, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for step in range(n):
        s = torch.matmul(qf, k_cur.float().transpose(-1, -2))
        # the max is a shift the result does not depend on: a constant to autograd
        m_new = torch.maximum(m, s.detach().amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, v_cur.float())
        m = m_new
        if step < n - 1:
            k_cur, v_cur = _Rotate.apply(group, k_cur, v_cur)
    return (acc / l).to(q.dtype)
