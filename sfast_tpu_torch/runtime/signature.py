"""Input signatures: the key under which a captured CUDA graph is kept.

Counterpart of ``sfast_tpu/runtime/signature.py``, shape-sensitive only:
a graph replays one sequence of kernels on buffers of fixed shapes, so
one graph serves one signature (reference ``cuda/graphs.py:225-241``).

- tensors by dtype, shape, device and ``requires_grad``; a 0-d CPU tensor
  by value, as the reference keys CPU scalars (a graph bakes it in);
- numpy and Python scalars by value, other numpy arrays by dtype and shape;
- dicts whatever their key order, lists and tuples by structure,
  dataclasses field by field;
- any other object by its type.

:func:`call_signature` adds the grad and inference modes, since a graph is
captured under one of each.
"""

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch


def arg_signature(arg: Any) -> Tuple:
    """A hashable signature of one argument tree."""
    if isinstance(arg, torch.Tensor):
        if arg.dim() == 0 and arg.device.type == "cpu":
            return ("scalar_tensor", str(arg.dtype), arg.item())
        return ("tensor", str(arg.dtype), tuple(arg.shape), str(arg.device), arg.requires_grad)
    if isinstance(arg, np.generic) or (isinstance(arg, np.ndarray) and arg.ndim == 0):
        return ("scalar", str(arg.dtype), arg.item())
    if isinstance(arg, np.ndarray):
        return ("array", str(arg.dtype), arg.shape)
    if arg is None or isinstance(arg, (bool, int, float, str, bytes, torch.dtype, torch.device)):
        return ("prim", type(arg).__name__, arg)
    if isinstance(arg, (list, tuple)):
        return (type(arg).__name__, tuple(arg_signature(a) for a in arg))
    if isinstance(arg, dict):
        return ("dict", tuple((k, arg_signature(arg[k])) for k in sorted(arg, key=str)))
    if dataclasses.is_dataclass(arg) and not isinstance(arg, type):
        return ("dataclass", type(arg).__name__, tuple(
            (f.name, arg_signature(getattr(arg, f.name))) for f in dataclasses.fields(arg)))
    return ("opaque", type(arg).__name__)


def call_signature(args, kwargs) -> Tuple:
    """The key of one call: its arguments, keyword arguments and the
    autograd modes it runs under."""
    return (
        arg_signature(tuple(args)),
        arg_signature(kwargs),
        torch.is_grad_enabled(),
        torch.is_inference_mode_enabled(),
    )
