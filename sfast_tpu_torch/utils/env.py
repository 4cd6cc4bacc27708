"""Process setup (counterpart of ``sfast_tpu/utils/env.py``; the reference's
``utils/env.py:26-44, 96-115``).

:func:`setup_environment` runs once per process, from the package's
import, and honours ``SFAST_TPU_ENV_MODULE``: a module whose
``setup_environment()`` it calls, the user's hook.  JAX's other duty there,
its persistent compilation cache, has its counterpart in the hashed nvcc
build of ``runtime/cuda_build.py``: the kernel library is built once per
source state under ``build/sfast_tpu_torch/`` and loaded by later
processes, so there is nothing more to enable.  Nothing here builds or
loads a kernel.
"""

import importlib
import logging
import os
import random

logger = logging.getLogger(__name__)

_SETUP_DONE = False


def setup_environment() -> None:
    """Idempotent: the first call runs the ``SFAST_TPU_ENV_MODULE`` hook,
    if one is named; a hook that fails is logged, as in JAX."""
    global _SETUP_DONE
    if _SETUP_DONE:
        return
    _SETUP_DONE = True
    env_module = os.environ.get("SFAST_TPU_ENV_MODULE")
    if env_module:
        try:
            mod = importlib.import_module(env_module)
            if hasattr(mod, "setup_environment"):
                mod.setup_environment()
        except Exception:
            logger.exception("SFAST_TPU_ENV_MODULE=%s failed", env_module)


def seed_all_rng(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (every device's)."""
    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)
