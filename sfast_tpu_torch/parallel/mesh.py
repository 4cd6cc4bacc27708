"""The device mesh over an initialized ``torch.distributed`` world.

Counterpart of ``sfast_tpu/parallel/mesh.py:25-40``.  JAX lays a named
``Mesh`` over the devices of one program and lets GSPMD insert the
collectives; PyTorch has no GSPMD, so the port runs one process per device
(``torchrun --nproc-per-node N``, or ``init_process_group`` called by the
caller) and each process builds the same :class:`DeviceMesh` of named axes,
whose process groups the tensor-parallel layers (``tensor_parallel.py``)
and ring attention (``ring_attention.py``) issue their collectives on.

Axes, as JAX's:

- ``dp``: data parallel (each rank takes its slice of the batch);
- ``tp``: tensor parallel (attention heads, MLP columns);
- ``sp``: sequence parallel (ring attention over the self-attention's
  tokens).

The mesh's device type follows the process group's backend: ``cuda`` for
NCCL, ``cpu`` for gloo.  Nothing moves a tensor to the mesh's device: a
tensor on the other device raises at the first collective it meets.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_DEVICE_TYPES = {"nccl": "cuda", "gloo": "cpu"}


def _device_type() -> str:
    """``cuda`` under NCCL, ``cpu`` under gloo: the device every tensor that
    meets a collective of the world's default group must lie on."""
    backend = str(dist.get_backend())
    if backend not in _DEVICE_TYPES:
        raise ValueError(f"process group backend {backend!r}: the mesh takes nccl or gloo")
    return _DEVICE_TYPES[backend]


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("dp", "tp"),
    devices: Optional[Sequence[int]] = None,
) -> DeviceMesh:
    """A :class:`DeviceMesh` of ``shape`` with ``axis_names`` over the
    initialized world.

    ``shape=None`` puts every rank on the last axis (pure TP; pure DP with
    ``axis_names=('dp',)``).  ``devices`` are the global ranks to lay out,
    in order (every rank of the world when None); a shape whose product
    differs from their count raises :class:`ValueError`, as JAX's does.
    Without an initialized process group it raises: it never makes a world
    of its own."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no torch.distributed process group; call "
            "torch.distributed.init_process_group (nccl on the card, gloo on the CPU) "
            "or launch with torchrun first")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (len(ranks),)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes, names {axis_names}")
    n = 1
    for s in shape:
        n *= s
    if n != len(ranks):
        raise ValueError(f"mesh shape {shape} != device count {len(ranks)}")
    return DeviceMesh(_device_type(), torch.tensor(ranks, dtype=torch.int).reshape(shape),
                      mesh_dim_names=axis_names)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of ``axis`` of ``mesh``; 1 for no mesh or an axis it lacks."""
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    return mesh.mesh.shape[names.index(axis)] if axis in names else 1


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def check_device(t: torch.Tensor, mesh: DeviceMesh, what: str) -> None:
    """Raise unless ``t`` lies on the mesh's device type."""
    if t.device.type != mesh.device_type:
        raise ValueError(f"{what}: a {t.device.type} tensor on a {mesh.device_type} mesh "
                         f"({dist.get_backend()}); move it to the mesh's device first")
