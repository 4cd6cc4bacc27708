"""What every driver of a run shares: the cell, the window's record, and
the traced stretch.

A driver (``drivers/<call>.py``, or its family's own) runs one cell:
set-up makes the weights on the device from the seed, builds the port's
models through the cell's family and loads them, compiles and warms up
every shape of the cell; the window then runs whole requests or steps
until the clock passes ``--seconds`` and ends at the last one's
completion.  With ``--trace 1`` the first requests or steps of the window
run under ``torch.profiler`` (:class:`Tracer`).  After the window the peak
memory is read and the program's state is freed, and the driver's
``check`` compares what the timed path produced with the family's
reference.
"""

import dataclasses
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

from hb.trace import OWN_SYNC, WINDOW, Trace, from_profile

TRIES = 5  # traces of a stretch before its lost rows are left standing


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    checkout: Path
    t0: float  # perf_counter at process start

    @property
    def family(self):
        """The configuration's model family (``families/<family>.py``)."""
        from hb.family import family
        return family(self.cfg)


@dataclasses.dataclass
class Window:
    """What the measured window and the traced stretch left."""
    setup_s: float
    window_s: float = 0.0
    done: int = 0  # images delivered to the host (a clip's frames each), or steps
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[Trace] = None
    traced: int = 0  # requests or steps in the traced stretch
    untraced_from: int = 0  # the first request after the traced stretches
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    graphs: list = dataclasses.field(default_factory=list)  # (capture s, instantiate s, nodes)
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)  # set-up's seconds


def phases(t0: float, marks: list) -> Dict[str, float]:
    """Seconds of each phase of set-up: from the process's start to the
    first mark (imports, the card's start), then between marks."""
    out, prev = {}, t0
    for name, t in marks:
        out["imports" if name == "start" else name] = t - prev
        prev = t
    return out


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_keys(traffic: dict, read: set) -> None:
    """Refuse a traffic mix with a key that its driver does not read: such
    a key would be written down and have no effect."""
    unread = sorted(set(traffic) - read - {"why"})
    if unread:
        raise ValueError(f"traffic keys {unread} are not read by the {traffic['call']!r} "
                         f"driver, which reads {sorted(read)}")


class Tracer:
    """The profiler around a stretch of requests or steps, and the program's
    counts over it."""

    def __init__(self, cell: Cell, counts: dict):
        self.cell, self.counts = cell, counts

    def warm(self) -> None:
        """One short session in set-up, so that the traced stretch does not
        pay the profiler's own start."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=self.cell.device).add_(1)
            synchronize(self.cell.device)

    def stretch(self, pre, run, n: int, w: Window) -> None:
        """Trace ``run()``, ``n`` requests or steps, inside one profiler
        session that ``pre()`` (one request or step) opens untimed, so that
        the profiler's first launches fall outside the window.  Where the
        trace lost rows of a kernel the program counted, the stretch is
        traced again, up to :data:`TRIES` times; everything read from a
        stretch is read anew from the last one.  Each try says on standard
        error which kernels lost rows, and how many of the window's device
        ops the profiler placed outside it (``Trace.misplaced``)."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from sfast_tpu_torch.runtime import cuda_build

        for attempt in range(1, TRIES + 1):
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            pre()
            synchronize(self.cell.device)
            cuda_build.reset_launch_counts()
            for k in self.counts:
                self.counts[k] = 0
            with record_function(WINDOW):
                run()
                with record_function(OWN_SYNC):
                    synchronize(self.cell.device)
            prof.stop()
            w.launches = dict(cuda_build.launch_counts)
            w.calls = dict(self.counts)
            w.traced = n
            w.trace = from_profile(prof, list(self.counts) + ["request", "train_step"])
            del prof
            lost, off = lost_rows(w), w.trace.misplaced()
            print(f"h100bench: traced stretch, try {attempt} of {TRIES}: "
                  + ("; ".join(f"{k} launched {count}, {rows} rows traced"
                               for k, (count, rows) in sorted(lost.items())) or "no rows lost")
                  + f"; {off} device ops placed outside the window that launched them",
                  file=sys.stderr)
            if not lost:
                return


def lost_rows(w: Window) -> dict:
    """{kernel: (launches counted, rows traced)} of the port's kernels
    whose rows in the trace's window do not match the launches."""
    from hb.roofline import KERNEL_ROWS

    ops = w.trace.window_ops()
    out = {}
    for kernel, pieces in KERNEL_ROWS.items():
        n = w.launches.get(kernel, 0)
        for piece in pieces:
            rows = sum(1 for o in ops if piece in o.name)
            if rows != n:
                out[kernel] = (n, rows)
    return out
