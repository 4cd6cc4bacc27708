"""Profiling: wall and device time (``auto_profiler.py``), cProfile
(``cprofile.py``)."""

from sfast_tpu_torch.profile.auto_profiler import AutoProfiler, IterationProfiler, trace
from sfast_tpu_torch.profile.cprofile import with_cProfile

__all__ = ["AutoProfiler", "IterationProfiler", "trace", "with_cProfile"]
