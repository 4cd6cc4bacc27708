"""Layouts at a compiled model's boundary (counterpart of
``sfast_tpu/utils/memory_format.py`` and ``sfast_tpu/models/module.py:66-91``).

The port's models are NHWC, as JAX's are.  ``memory_format='NCHW'`` lets a
caller hand a compiled model torch's channel-first tensors: its 4-D (N, C,
H, W) and 5-D (N, C, F, H, W) inputs are made NHWC before the call and its
outputs are given back channel-first.  An output comes back as a permuted
view of the NHWC result, that is a ``torch.channels_last`` tensor: no copy.
"""

import torch
import torch.utils._pytree as pytree

# dims -> the permutation from channel-first to the models' layout
_TO_NHWC = {4: (0, 2, 3, 1), 5: (0, 2, 3, 4, 1)}
_TO_NCHW = {4: (0, 3, 1, 2), 5: (0, 4, 1, 2, 3)}


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """A contiguous NHWC copy of a 4-D or 5-D channel-first tensor (no copy
    when it is already channels-last in memory)."""
    return x.permute(_TO_NHWC[x.dim()]).contiguous()


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """A 4-D or 5-D NHWC tensor as a channel-first view."""
    return x.permute(_TO_NCHW[x.dim()])


def _map_image_tensors(fn, tree):
    return pytree.tree_map(
        lambda x: fn(x) if isinstance(x, torch.Tensor) and x.dim() in (4, 5) else x, tree)


def tree_to_nhwc(tree):
    """Every 4-D and 5-D tensor of ``tree`` made NHWC."""
    return _map_image_tensors(nchw_to_nhwc, tree)


def tree_to_nchw(tree):
    """Every 4-D and 5-D tensor of ``tree`` given back channel-first."""
    return _map_image_tensors(nhwc_to_nchw, tree)
