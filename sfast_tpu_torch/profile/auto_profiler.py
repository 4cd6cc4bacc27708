"""Profiling helpers.

Counterpart of ``sfast_tpu/profile/auto_profiler.py``: the reference's
cProfile context manager (``profile/auto_profiler.py:5-35``) and the
CUDA-event ``IterationProfiler`` of its examples
(``examples/optimize_stable_diffusion_pipeline.py:127-151``).  A CUDA call
returns before the device finishes, so a host clock alone measures the
enqueue (the reference's README warns that tqdm lies, ``README.md:312-313``):
:class:`AutoProfiler` waits for what it tracks on exit, and
:class:`IterationProfiler` times steps with CUDA events.

For kernel-level analysis :func:`trace` runs ``torch.profiler`` and writes
a Chrome trace, where JAX's writes a ``jax.profiler`` dump.
"""

import contextlib
import os
import time
from typing import Optional

import torch
from torch.utils._pytree import tree_leaves


class AutoProfiler:
    """Context manager: wall time of the block, waiting on exit for the
    CUDA tensors it tracks.

    >>> with AutoProfiler("unet step") as p:
    ...     out = p.track(model(x))   # waited for on exit
    """

    def __init__(self, name: str = "", echo=print):
        self.name = name
        self.echo = echo
        self.elapsed: Optional[float] = None
        self._tracked = []

    def track(self, value):
        """Wait on exit for every CUDA tensor in ``value`` (a tensor or a
        nest of them); returns ``value``."""
        self._tracked.append(value)
        return value

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        # one event per stream that made a tracked tensor: the current
        # stream of its device, where PyTorch queued the work
        streams = {}
        for leaf in tree_leaves(self._tracked):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                s = torch.cuda.current_stream(leaf.device)
                streams[(s.device, s.cuda_stream)] = s
        for s in streams.values():
            event = torch.cuda.Event()
            event.record(s)
            event.synchronize()
        self.elapsed = time.perf_counter() - self._t0
        if self.echo:
            self.echo(f"[sfast_tpu_torch] {self.name}: {self.elapsed * 1e3:.1f} ms")
        return False


class IterationProfiler:
    """Per-step device time of a denoising loop, as a pipeline's
    ``callback_on_step_end``: each call records a CUDA event on the stream
    of the step's latents (a host timestamp for CPU latents), and the times
    are the spans between consecutive calls, read when asked for."""

    def __init__(self):
        self._marks = []  # CUDA events, or perf_counter floats on the CPU

    def __call__(self, pipe, i, t, kwargs):
        latents = kwargs.get("latents")
        if isinstance(latents, torch.Tensor) and latents.is_cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(latents.device))
            self._marks.append(event)
        else:
            self._marks.append(time.perf_counter())

    @property
    def times(self):
        """Seconds between consecutive steps (waits for the last event)."""
        m = self._marks
        if len(m) < 2:
            return []
        if isinstance(m[0], torch.cuda.Event):
            m[-1].synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]

    @property
    def iterations_per_second(self) -> Optional[float]:
        times = self.times
        if not times:
            return None
        return len(times) / sum(times)

    def summary(self) -> str:
        ips = self.iterations_per_second
        return f"{ips:.2f} it/s" if ips else "n/a"


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the card's kernels too, where
    there is one); on exit writes ``<log_dir>/trace.json``, a Chrome trace,
    in which the program's ``sfast.*`` spans (``profile/spans.py``) stand
    above the kernels they launched.  Yields the profiler
    (``key_averages()`` for sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
