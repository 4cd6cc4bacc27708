"""Profiling: wall and device time (``auto_profiler.py``), cProfile
(``cprofile.py``), and the program's own spans while a profiler session
records (``spans.py``)."""

from sfast_tpu_torch.profile import spans
from sfast_tpu_torch.profile.auto_profiler import AutoProfiler, IterationProfiler, trace
from sfast_tpu_torch.profile.cprofile import with_cProfile

__all__ = ["AutoProfiler", "IterationProfiler", "spans", "trace", "with_cProfile"]
