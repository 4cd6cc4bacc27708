"""Batch-dimension buckets, which bound how many graphs exist.

Counterpart of ``sfast_tpu/runtime/shape_bucket.py``.  A CUDA graph serves
one shape, so a server that sees every batch size from 1 to 40 would hold
40 graphs of each model; padding the batch up to a bucket holds a few.
Only the leading batch dimension is padded: padded rows cannot change the
real rows of a per-sample model, and are dropped from the result.  Spatial
dimensions are never padded (zero borders change a conv's output).
"""

from typing import Optional, Sequence, Tuple

import torch

DEFAULT_BATCH_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)


def bucket_size(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    """The smallest bucket ≥ n; beyond the largest bucket, the next
    multiple of it."""
    buckets = tuple(sorted(buckets or DEFAULT_BATCH_BUCKETS))
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return -(-n // top) * top


def pad_batch(x: torch.Tensor, buckets: Optional[Sequence[int]] = None):
    """``(x padded with zero rows to its bucket, the real row count)``;
    ``x`` itself when it already fills its bucket."""
    n = x.shape[0]
    b = bucket_size(n, buckets)
    if b == n:
        return x, n
    return torch.cat([x, x.new_zeros((b - n,) + tuple(x.shape[1:]))]), n


def unpad_batch(x: torch.Tensor, real_n: int) -> torch.Tensor:
    return x if x.shape[0] == real_n else x[:real_n]
