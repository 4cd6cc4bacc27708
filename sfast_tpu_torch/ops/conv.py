"""NHWC convolution (plain PyTorch; cuDNN on the card).

Counterpart of ``sfast_tpu/ops/conv.py``.  Activations keep JAX's NHWC
layout; the weight is PyTorch's OIHW.  ``x.permute(0, 3, 1, 2)`` of a
contiguous NHWC tensor is already a channels_last NCHW view, so cuDNN
reads it without a copy and its output permutes back to contiguous NHWC.
"""

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: Union[int, Tuple[int, int]] = 0,
) -> torch.Tensor:
    """``conv(x, w) + b`` — x: (N, H, W, Cin), w: (Cout, Cin, kh, kw);
    ``padding`` per side, one for both axes or (H, W)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)
