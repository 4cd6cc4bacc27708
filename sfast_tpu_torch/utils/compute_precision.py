"""Matmul precision contexts (counterpart of
``sfast_tpu/utils/compute_precision.py``; the reference's TF32 toggles).

Both set PyTorch's three precision flags for the block and restore what
they were on exit: ``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` and
``torch.backends.cudnn.allow_tf32``.  The flags belong to the process, not
the thread.  A CUDA graph bakes in the kernels cuBLAS and cuDNN chose under
the flags of its capture.
"""

import contextlib

import torch


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            torch.backends.cudnn.allow_tf32)


def _set(tf32: bool, bf16_reduction: bool, cudnn_tf32: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bf16_reduction
    torch.backends.cudnn.allow_tf32 = cudnn_tf32


@contextlib.contextmanager
def _precision(on: bool):
    before = _flags()
    _set(on, on, on)
    try:
        yield
    finally:
        _set(*before)


def low_compute_precision():
    """TF32 matmuls and convolutions, reduced-precision bf16 sums."""
    return _precision(True)


def high_compute_precision():
    """f32 matmuls and convolutions in full f32, bf16 products summed in
    f32."""
    return _precision(False)
