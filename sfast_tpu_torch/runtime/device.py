"""Where the port's models are built when the caller names no device.

The port's entry points run on the card: a model built with ``device=None``
lands on ``cuda``.  Without a CUDA device that is an error that says how to
ask for the CPU, never a quiet CPU build on which every kernel wrapper would
take its plain version.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``, and
    raises :class:`RuntimeError` when no CUDA device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the models are built on the card by default; "
            'pass device="cpu" to build them on the CPU'
        )
    return torch.device("cuda")
