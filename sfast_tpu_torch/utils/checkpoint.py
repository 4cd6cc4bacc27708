"""Weights to and from ``.npz`` files, in the JAX package's format.

Counterpart of ``sfast_tpu/utils/checkpoint.py:23-94``.  One ``.npz`` per
tree: keys are the paths of the leaves joined by "/" (list items as
``[i]``), bf16 is stored as its raw uint16 bits, and every leaf's dtype
name goes in a ``__dtypes__`` JSON entry.  So a file either package writes
loads in the other bit for bit.  :func:`load_params` gives a flat dict
keyed as written (``"down_blocks.0...to_q/a"`` for a LoRA); :func:`nest`
rebuilds the dicts of a LoRA or any other tree.

A LoRA trained by ``training/`` is saved with ``save_params(path, lora)``
and read back with ``nest(load_params(path))``.
"""

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from sfast_tpu_torch.runtime.device import resolve_device


def _flatten(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}/[{i}]")
    else:
        yield path, tree


def _to_numpy(leaf):
    """A leaf as (numpy array to store, its dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_params(path: str, state_dict) -> None:
    """Write ``state_dict`` (a flat dict of tensors, or a nest of dicts and
    lists of them) to ``path``."""
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for key, leaf in _flatten(state_dict):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __dtypes__=json.dumps(dtypes), **arrays)


def load_params(path: str, *, device=None) -> Dict[str, torch.Tensor]:
    """The tensors of ``path`` keyed as written, on ``device`` (the card
    when None)."""
    dev = resolve_device(device)
    out = {}
    with np.load(path, allow_pickle=False) as data:
        dtypes = json.loads(str(data["__dtypes__"]))
        for key in data.files:
            if key == "__dtypes__":
                continue
            arr = data[key]
            if dtypes[key] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out[key] = t.to(dev)
    return out


def nest(flat: Dict[str, Any]):
    """A flat dict keyed by "/"-joined paths → the nested dicts (and lists,
    for ``[i]`` parts) they name."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _lists(root)


def _lists(node):
    """Dicts keyed ``[0]``, ``[1]``... → lists, bottom up."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.startswith("[") and k.endswith("]") for k in node):
        return [node[f"[{i}]"] for i in range(len(node))]
    return node


def device_memory_stats(device=None) -> Dict[str, Any]:
    """Device memory of ``device`` (the card when None): in use now, the
    peak, reserved by the caching allocator, and the card's size, in
    bytes (≙ JAX's ``device_memory_stats``; the reference's examples
    report peak VRAM)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_memory_stats: {dev} is not a CUDA device")
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }
