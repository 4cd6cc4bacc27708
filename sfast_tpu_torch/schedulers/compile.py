"""Scheduler-step capture (the ``trace_scheduler`` knob).

Counterpart of ``sfast_tpu/schedulers/compile.py``: a delegating proxy
whose ``step`` replays a CUDA graph per signature.  Every port scheduler
reads its tables on the device by a 0-d device step index
(``common.table_at``), and a noisy step takes its noise as an input, so
one graph serves every step.  ``scale_model_input`` stays a plain call:
the identity for DPM++, DDIM and LCM, one division for Euler.
"""

import logging

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.runtime.executable_cache import global_executable_cache
from sfast_tpu_torch.runtime.tracing import LazyCompiledFunction

logger = logging.getLogger(__name__)


class CompiledScheduler:
    """Delegating proxy: ``step`` captured, everything else forwarded."""

    def __init__(self, scheduler, config: CompilationConfig = None):
        self._scheduler = scheduler
        self._step = global_executable_cache().register(
            "scheduler.step", LazyCompiledFunction(scheduler.step, name="scheduler.step"))
        self.set_compilation_config(config or CompilationConfig.Default())
        logger.info("sfast_tpu_torch: compiled scheduler.step")

    def set_compilation_config(self, config: CompilationConfig) -> None:
        """Steps replay graphs when ``enable_cuda_graph`` and
        ``trace_scheduler`` are both on; every graph is dropped."""
        self._enabled = config.enable_cuda_graph and config.trace_scheduler
        self.clear_cache()

    def step(self, *args, **kwargs):
        if self._enabled:
            return self._step(*args, **kwargs)
        return self._scheduler.step(*args, **kwargs)

    @property
    def cache_size(self) -> int:
        return self._step.cache_size

    def clear_cache(self) -> None:
        self._step.clear_cache()

    def __getattr__(self, name):
        if "_scheduler" not in self.__dict__:  # not yet initialised
            raise AttributeError(name)
        return getattr(self.__dict__["_scheduler"], name)


def compile_scheduler(scheduler, config: CompilationConfig = None):
    """Idempotent: a :class:`CompiledScheduler` proxy of ``scheduler``."""
    if isinstance(scheduler, CompiledScheduler):
        if config is not None:
            scheduler.set_compilation_config(config)
        return scheduler
    return CompiledScheduler(scheduler, config)
