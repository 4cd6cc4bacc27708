"""Tensor parallelism as SPMD processes with explicit collectives.

JAX needs no such module: it places each weight by its ``PartitionSpec``
(``sharding.py``) and GSPMD inserts the collectives.  Here each rank of the
mesh's ``tp`` axis holds its shard of every split ``Linear`` and issues the
collectives itself (Megatron's layout):

- a **column-parallel** linear (spec ``("tp", None)``) holds its rows of the
  (out, in) weight and of the bias, and computes its slice of the outputs;
- a **row-parallel** linear (spec ``(None, "tp")``) holds its columns,
  computes on its slice of the inputs and all-reduces the partial sums over
  ``tp``.  The bias is added once, by the group's rank 0 inside its own
  GEMM before the reduce, so at ``tp = 1`` the layer computes today's
  ``F.linear`` call bit for bit (and the reduce of one rank copies it).

A module that can consume a shard declares a Megatron pair as its class's
``tp_pair = (columns, row, followers)``: ``layers.Attention`` (``to_q``,
``to_k``, ``to_v`` → ``to_out.0``, with an IP-Adapter's ``to_k_ip`` /
``to_v_ip`` as followers), ``clip_text.CLIPAttention``,
``layers.FeedForward`` (``net.0.proj`` → ``net.2``) and
``clip_text.CLIPMLP`` (``fc1`` → ``fc2``).  Where the spec makes every
column linear of a pair and every follower it has column-parallel, its row
linear row-parallel, and its ``heads`` split evenly, the pair runs on the
rank's shard: the columns keep their output shard, the attention holds
``heads / tp`` heads, and the row linear takes the shard as its input —
one all-reduce a pair.  Anywhere else (a custom rule; the VAE's
single-head attention, which declares no pair) a column-parallel linear
all-gathers its output and a row-parallel one slices its replicated input
first, so any rule keeps the values.  Which rows or columns a rank holds is
``sharding.split_plan``'s, whether or not the linear is paired: a GEGLU's
``proj`` holds its slice of *both* halves of its (2F, d) weight, so that a
paired rank's hidden and gate rows match, and its gather puts the halves
back in order.

The collectives are autograd Functions of the port's own, each with its
adjoint as its backward (an all-reduce's is an all-reduce, an all-gather's
a reduce-scatter), so the trainer's backward runs through them.  Every
rank runs the same modules in the same order, so the ranks issue their
collectives, and a CUDA graph captures them, in one order.
"""

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from sfast_tpu_torch.models.layers import Linear
from sfast_tpu_torch.ops.linear import apply_act, linear
from sfast_tpu_torch.parallel.mesh import axis_rank, axis_size, check_device
from sfast_tpu_torch.parallel.sharding import (
    Split,
    shard_params,
    split_plan,
    take_shard,
    unet_param_spec,
)


class _AllReduce(torch.autograd.Function):
    """The sum of the ranks' ``t``; the backward is its adjoint, the sum of
    the ranks' cotangents."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


def all_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` of ``mesh`` (autograd-aware)."""
    check_device(t, mesh, "all_reduce")
    return _AllReduce.apply(t, mesh.get_group(axis))


class _AllGather(torch.autograd.Function):
    """The ranks' ``t`` concatenated along ``dim``; the backward is its
    adjoint: the sum of the ranks' cotangents, of which each rank keeps its
    slice (a reduce-scatter, written as an all-reduce and a slice).
    ``torch.distributed.nn``'s all-gather is not used: its backward under
    gloo names a subgroup's ranks by their global numbers and fails on any
    group but the world (and the module is deprecated)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.part = dist.get_rank(group), t.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = _AllReduce.apply(g, ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.part, ctx.part), None, None


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``t`` over ``axis``, concatenated along ``dim`` in rank
    order (autograd-aware)."""
    check_device(t, mesh, "all_gather")
    return _AllGather.apply(t.contiguous(), mesh.get_group(axis), dim)


class ParallelLinear(Linear):
    """A ``Linear`` that holds this rank's shard of its weight over ``tp``,
    as ``split`` (``sharding.split_plan``) lays it out: its rows (column
    mode) or its columns (row mode).  ``local``: the shard is consumed
    (column) or produced (row) by a Megatron pair, so no gather or input
    slice."""

    def __init__(self, full: Linear, split: Split, mesh, *, local: bool):
        out_f, in_f = full.weight.shape
        super().__init__(in_f, out_f, bias=full.bias is not None, device="meta")
        self.mode, self.split_dim, self.chunks = split
        self.mesh, self.local = mesh, local
        self.rank, self.size = axis_rank(mesh, "tp"), axis_size(mesh, "tp")
        if self.mode == "column":
            self.out_features = out_f // self.size
        else:
            self.in_features = in_f // self.size
        self.weight = self._param(full.weight, self.split_dim)
        if full.bias is not None:
            self.bias = self._param(full.bias, 0 if self.mode == "column" else None)

    def _param(self, old: nn.Parameter, dim: Optional[int]) -> nn.Parameter:
        """The rank's part of ``old`` along ``dim`` (all of it for None): at
        ``tp = 1`` the same storage, else a copy, so the full tensor can go."""
        t = old.detach()
        part = t if dim is None else self.shard(t, dim)
        return nn.Parameter(part if part is t else part.clone(), requires_grad=old.requires_grad)

    @property
    def local_gemm(self) -> bool:
        return self.mode == "column" and self.local

    def shard(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part of ``t`` along ``dim`` in the layout of this
        weight's split dim (a LoRA factor, a full weight, a bias)."""
        return take_shard(t, dim, self.rank, self.size, self.chunks)

    def forward(self, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
        if self.weight is None:
            raise ValueError("a tensor-parallel linear takes no quantized weight")
        if self.mode == "column":
            y = linear(x, self.weight, self.bias, act=act)
            if self.local:
                return y
            y = all_gather(y, self.mesh, "tp", -1)  # per rank: its slice of each chunk
            if self.chunks == 1:
                return y
            return y.unflatten(-1, (self.size, self.chunks, -1)).transpose(-3, -2).flatten(-3)
        if not self.local:
            x = x.narrow(-1, self.rank * self.in_features, self.in_features)
        y = all_reduce(linear(x, self.weight, self.bias if self.rank == 0 else None),
                       self.mesh, "tp")
        return y if act is None else apply_act(y.float(), act).to(x.dtype)


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def shard_module(module: nn.Module, mesh, spec_fn: Callable = unet_param_spec) -> nn.Module:
    """Replace every ``Linear`` of ``module`` whose weight ``spec_fn(name,
    weight)`` splits over ``tp`` by a :class:`ParallelLinear` holding the
    rank's shard, in place; returns ``module``.  Runs on every rank of the
    mesh alike, once: a module already sharded over ``mesh`` (a VAE
    compiled for its decode and for its encode) is left as it is.  A mesh
    without a ``tp`` axis shards nothing."""
    done = module.__dict__.get("_tp_mesh")
    if done is not None:
        if done is not mesh:
            raise ValueError("the module is sharded over another mesh")
        return module
    module.__dict__["_tp_mesh"] = mesh
    module.__dict__["_tp_spec_fn"] = spec_fn
    if "tp" not in (mesh.mesh_dim_names or ()):
        return module
    tp = axis_size(mesh, "tp")
    linears = {n: m for n, m in module.named_modules() if isinstance(m, Linear)}
    for name, m in linears.items():
        if isinstance(m, ParallelLinear):
            raise ValueError(f"{name}: already sharded")
        if m.weight is None:
            raise ValueError(f"{name}: quantized; shard the bf16 or f32 model, without quantizing")
    plan = split_plan(module.state_dict(), spec_fn)
    splits = {}
    for key, split in plan.items():
        name = key.rpartition(".")[0]
        if key.endswith(".weight"):
            if name not in linears:
                raise ValueError(f"{key}: the spec splits it, but it is no Linear's weight")
            splits[name] = split

    local = set()
    for prefix, parent in module.named_modules():
        pair = getattr(type(parent), "tp_pair", None)
        if pair is None:
            continue
        cols, row, followers = ([_join(prefix, c) for c in pair[0]], _join(prefix, pair[1]),
                                [_join(prefix, f) for f in pair[2]])
        followers = [f for f in followers if f in linears]
        heads = getattr(parent, "heads", tp)
        if (all(c in splits and splits[c].mode == "column" for c in cols + followers)
                and row in splits and splits[row].mode == "row" and heads % tp == 0):
            local.update(cols, followers, [row])
            if hasattr(parent, "heads"):
                parent.heads = heads // tp
            parent.tp_local = True

    for name, split in splits.items():
        parent_name, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(parent_name), leaf,
                ParallelLinear(linears[name], split, mesh, local=name in local))
    return module


def parallel_linears(module: nn.Module) -> Dict[str, ParallelLinear]:
    """Module name → :class:`ParallelLinear` of every sharded linear."""
    return {n: m for n, m in module.named_modules() if isinstance(m, ParallelLinear)}


def local_state_dict(module: nn.Module, state_dict) -> Dict[str, torch.Tensor]:
    """A full state dict of ``module``'s unsharded model → this rank's
    tensors (views where contiguous) under ``module``'s names:
    ``sharding.shard_params`` with the mesh and rule ``module`` was sharded
    with."""
    return shard_params(state_dict, module.__dict__["_tp_mesh"], module.__dict__["_tp_spec_fn"])


def full_shapes(module: nn.Module) -> Dict[str, torch.Size]:
    """The shape of each state-dict entry of ``module`` in the unsharded
    model."""
    shapes = {k: t.shape for k, t in module.state_dict().items()}
    for name, m in parallel_linears(module).items():
        shapes[f"{name}.weight"] = torch.Size((m.out_features * (m.size if m.mode == "column"
                                                                  else 1),
                                               m.in_features * (m.size if m.mode == "row"
                                                                else 1)))
        if m.bias is not None:
            shapes[f"{name}.bias"] = torch.Size((shapes[f"{name}.weight"][0],))
    return shapes


def init_communicators(mesh) -> None:
    """One eager all-reduce on each axis group of ``mesh``: NCCL creates a
    communicator at its first collective, and that setup cannot run inside
    a CUDA graph's capture."""
    dev = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
           else torch.device("cpu"))
    for axis in mesh.mesh_dim_names:
        dist.all_reduce(torch.zeros(1, device=dev), group=mesh.get_group(axis))
