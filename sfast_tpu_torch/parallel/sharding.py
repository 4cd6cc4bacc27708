"""Sharding rules for the model families: which weight splits over ``tp``.

Counterpart of ``sfast_tpu/parallel/sharding.py:24-92``, the Megatron split
of the attention and MLP stacks.  JAX writes a rule as a ``PartitionSpec``
of its (in, out) weight; the port's weight is torch's (out, in), so its
spec is a tuple over the (out, in) dims:

==========================  ===========================  ==================
JAX spec on (in, out)       the port's spec on (out, in)  mode
==========================  ===========================  ==================
``P(None, "tp")``           ``("tp", None)``              column-parallel:
                                                          each rank holds
                                                          its rows (outputs)
``P("tp", None)``           ``(None, "tp")``              row-parallel: its
                                                          columns (inputs);
                                                          the outputs are
                                                          all-reduced
``P()``                     ``()``                        replicated
==========================  ===========================  ==================

:func:`unet_param_spec` is JAX's rule on JAX's key of each module
(``interop/from_jax.jax_key``, which maps ``to_out.0`` → ``to_out``,
``ff.net.0.proj`` → ``proj``, ``ff.net.2`` → ``out``), with transformers'
CLIP names read as the JAX CLIP's (``q_proj`` → ``to_q``, ``k_proj`` →
``to_k``, ``v_proj`` → ``to_v``, ``out_proj`` → ``to_out``: JAX's CLIP
attention is ``init_attention``'s, ``sfast_tpu/models/clip_text.py:80-82``):

- column-parallel: ``to_q``, ``to_k``, ``to_v``, ``proj`` (GEGLU), ``fc1``,
  and an IP-Adapter's ``to_k_ip`` / ``to_v_ip`` (JAX leaves those two
  replicated; the port's attention holds the rank's heads, so they split
  with ``to_q``);
- row-parallel: ``to_out``, ``out`` (the feed-forward's output), ``fc2``;
- everything else, and every tensor that is not a 2-D ``.weight``:
  replicated (convs, norms, embeddings).

A custom rule (``CompilationConfig.sharding_rules``) is a sequence of
``(pattern, spec)`` pairs: ``pattern`` an fnmatch glob over the port's
state-dict key, ``spec`` a tuple over the (out, in) weight, first match
wins, no match → replicated.  JAX's ``("*/to_q/w", P("tp", None))``, which
row-splits ``to_q``, is the port's ``("*.to_q.weight", (None, "tp"))``.

Only a linear's 2-D weight splits, on one dim; its bias follows it (a
column weight's bias splits with its rows, a row weight's stays whole).
A GEGLU's ``proj`` weight (``...net.0.proj``, (2F, d)) stacks the hidden
rows on the gate rows, and a rank's rows are its slice of each half
(:func:`out_chunks`), so that its hidden and gate rows pair up.
:func:`split_plan` is this layout, and :func:`shard_params` slices by it
with :func:`take_shard`: ``tensor_parallel.shard_module`` takes its shards
through the same two functions, so ``shard_params`` of a full state dict
is what the sharded module holds.  What a spec means for the module's
forward (a shard kept, a shard gathered, an input sliced) is
``tensor_parallel.py``'s business.
"""

import fnmatch
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from sfast_tpu_torch.interop.from_jax import jax_key
from sfast_tpu_torch.parallel.mesh import axis_rank, axis_size

Spec = Tuple
COLUMN: Spec = ("tp", None)
ROW: Spec = (None, "tp")
REPLICATED: Spec = ()

_COL = ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip", "proj", "fc1")
_ROW = ("to_out", "out", "fc2")
# transformers' CLIP attention names → JAX's (interop/from_jax._put_clip_layers)
_CLIP_KEYS = {"q_proj": "to_q", "k_proj": "to_k", "v_proj": "to_v", "out_proj": "to_out"}


class NamedSharding(NamedTuple):
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: object
    spec: Spec


def unet_param_spec(name: str, tensor: torch.Tensor) -> Spec:
    """The spec of the state-dict entry ``name`` (``...attn1.to_q.weight``)."""
    if not name.endswith(".weight") or tensor.dim() != 2:
        return REPLICATED
    key = jax_key(name[: -len(".weight")])
    key = _CLIP_KEYS.get(key, key)
    if key in _COL:
        return COLUMN
    if key in _ROW:
        return ROW
    return REPLICATED


def spec_fn_from_rules(rules) -> Callable[[str, torch.Tensor], Spec]:
    """A ``(name, tensor) -> spec`` function from ``(pattern, spec)`` pairs."""
    rules = tuple((pattern, tuple(spec)) for pattern, spec in rules)

    def spec_fn(name: str, tensor: torch.Tensor) -> Spec:
        for pattern, spec in rules:
            if fnmatch.fnmatch(name, pattern):
                return spec
        return REPLICATED

    return spec_fn


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, REPLICATED)


def batch_spec() -> Spec:
    """Activations: the batch over ``dp``."""
    return ("dp",)


def param_shardings(state_dict, mesh, spec_fn=unet_param_spec) -> Dict[str, NamedSharding]:
    """The :class:`NamedSharding` of every entry of ``state_dict``."""
    return {k: NamedSharding(mesh, tuple(spec_fn(k, t))) for k, t in state_dict.items()}


def take_shard(t: torch.Tensor, dim: int, rank: int, size: int, chunks: int = 1) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s part of ``t`` along ``dim``: of each of
    ``chunks`` equal pieces of the dim, its contiguous ``1/size``, the pieces
    concatenated.  ``t`` itself when ``size`` is 1."""
    if size == 1:
        return t
    n = t.shape[dim]
    if n % (chunks * size):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {chunks} × {size}")
    part = n // (chunks * size)
    pieces = [p.narrow(dim, rank * part, part) for p in t.chunk(chunks, dim)]
    return pieces[0] if chunks == 1 else torch.cat(pieces, dim)


def out_chunks(module_name: str) -> int:
    """How many stacked matrices a column split of the module's rows keeps
    apart: 2 for a GEGLU's ``proj`` (hidden rows, then gate rows), else 1."""
    return 2 if module_name == "net.0.proj" or module_name.endswith(".net.0.proj") else 1


def _spec_mode(spec) -> Optional[str]:
    """``'column'``, ``'row'`` or None (replicated) for a linear's spec."""
    spec = tuple(spec)
    if spec in (REPLICATED, (None, None)):
        return None
    if spec == COLUMN:
        return "column"
    if spec == ROW:
        return "row"
    raise ValueError(f"spec {spec}: a linear's weight splits over 'tp' on one dim, "
                     "('tp', None) or (None, 'tp')")


class Split(NamedTuple):
    """How a tensor splits over ``tp``: along ``dim``, a slice of each of
    ``chunks`` pieces (:func:`take_shard`)."""

    mode: str  # the linear's: 'column' or 'row'
    dim: int
    chunks: int


def split_plan(tensors, spec_fn=unet_param_spec) -> Dict[str, Split]:
    """The :class:`Split` of every entry of ``tensors`` (a state dict, or
    its names → tensors on the ``meta`` device) that splits: each 2-D
    ``.weight`` whose spec names ``tp``, and its ``.bias``.  Raises for a
    spec that splits anything else."""
    plan = {}
    for key, t in tensors.items():
        spec = tuple(spec_fn(key, t))
        if not (key.endswith(".weight") and t.dim() == 2):
            if any(axis is not None for axis in spec):
                raise ValueError(f"{key}: only a linear's 2-D weight splits over 'tp' "
                                 f"(its bias follows it); spec {spec}")
            continue
        mode = _spec_mode(spec)
        if mode is None:
            continue
        mod = key[: -len(".weight")]
        chunks = out_chunks(mod) if mode == "column" else 1
        plan[key] = Split(mode, 0 if mode == "column" else 1, chunks)
        if mode == "column" and f"{mod}.bias" in tensors:
            plan[f"{mod}.bias"] = Split(mode, 0, chunks)
    return plan


def shard_params(state_dict, mesh, spec_fn=unet_param_spec) -> Dict[str, torch.Tensor]:
    """This rank's slice of each tensor of ``state_dict`` (views where the
    slice is contiguous), by :func:`split_plan`: what a module sharded with
    the same ``spec_fn`` (``tensor_parallel.shard_module``) holds."""
    size = axis_size(mesh, "tp")
    rank = axis_rank(mesh, "tp") if size > 1 else 0
    out = dict(state_dict)
    for key, s in split_plan(state_dict, spec_fn).items():
        out[key] = take_shard(state_dict[key], s.dim, rank, size, s.chunks)
    return out
