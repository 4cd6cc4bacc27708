"""Module surgery (the reference's ``utils/patch.py:1-19`` ``patch_module``;
the port's counterpart of JAX's ``patch_params``, which rewrites a parameter
tree where the port's weights live in modules)."""

from typing import Callable

import torch

from sfast_tpu_torch.runtime.tracing import bump_weights_version


def patch_module(module: torch.nn.Module, filter_fn: Callable[[str, torch.nn.Module], bool],
                 patch_fn: Callable[[str, torch.nn.Module], torch.nn.Module]) -> torch.nn.Module:
    """Replace, by ``setattr`` on its parent, every submodule of ``module``
    (``module`` itself excluded) for which ``filter_fn(name, submodule)``
    is true with ``patch_fn(name, submodule)``; a replaced submodule is not
    walked further.  Returns ``module``.

    ``module`` and every parent of a replaced submodule get a new
    ``weights_version`` (``runtime/tracing.bump_weights_version``): the
    graphs that read their old tensors are dropped at their next call."""
    touched = []

    def walk(parent: torch.nn.Module, prefix: str) -> None:
        for name, child in list(parent.named_children()):
            full = f"{prefix}{name}"
            if filter_fn(full, child):
                setattr(parent, name, patch_fn(full, child))
                touched.append(parent)
            else:
                walk(child, full + ".")

    walk(module, "")
    if touched:
        for m in {id(m): m for m in touched + [module]}.values():
            bump_weights_version(m)
    return module
