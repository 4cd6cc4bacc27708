"""The traced stretch of a ``--trace 1`` run, and what is read from it.

A ``torch.profiler`` session (CPU and CUDA activities) covers the first
requests or steps of the window, inside a range named :data:`WINDOW`
that ends after a sync.  From the profiler's events this keeps:

- the device's activities (kernels, copies, memsets; never the device
  side of a user range), each with the host time of the call that
  launched it and the innermost benchmark range that was open on the host
  then: a CUDA graph's kernels come with the correlation id of its
  ``cudaGraphLaunch``;
- the benchmark's ranges on the host, with their times;
- the host's calls into the CUDA runtime that block it until the device
  has done its work (:data:`SYNC_CALLS`), with their start times;
- the window's length, and the union of the device's busy intervals in it.

An activity belongs to the window when the call that launched it was made
in the window, on the host's clock, as the window's range is.  The device
times of the profiler's activities can sit off that clock: on an H100 with
PyTorch 2.11 a traced SDXL stretch placed tens to thousands of the
window's activities outside it, by a few ms up to a whole request, so the
device times of an activity say how long it ran, not which window
launched it.  :meth:`Trace.misplaced` counts them.
"""

import bisect
import collections
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

WINDOW = "h100bench_window"
OWN_SYNC = "h100bench_sync"  # the range of the sync that ends the window: not the program's
# runtime calls that wait for the device (the synchronous copies and sets among them)
SYNC_CALLS = {"cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cudaMemset"}
VERSION = re.compile(r"_v\d+$")  # the suffix some CUDA versions give a runtime call's name


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    range: str  # the innermost benchmark range that launched it, or "" for none
    launch_ns: Optional[int] = None  # the host time of its launching call, where found


@dataclasses.dataclass
class Trace:
    ops: List[DeviceOp]
    ranges: List[Tuple[int, int, str]]  # host ranges (start, end, name), sorted by start
    window_ns: Tuple[int, int]
    unattributed: int  # device ops whose launching call was not found
    syncs: List[int] = dataclasses.field(default_factory=list)  # start ns of each sync call
    runtime_calls: int = 0  # the host's CUDA runtime calls the trace holds

    def window_ops(self) -> List[DeviceOp]:
        """The ops launched in the window (by their device start where the
        launching call was not found)."""
        lo, hi = self.window_ns
        return [o for o in self.ops
                if lo <= (o.start_ns if o.launch_ns is None else o.launch_ns) < hi]

    def misplaced(self) -> int:
        """The window's activities whose device times lie outside the
        window: no work starts before the window's first launch or ends
        after the sync that closes it, so their times are off the host's
        clock."""
        lo, hi = self.window_ns
        return sum(1 for o in self.window_ops() if o.start_ns < lo or o.end_ns > hi)

    def host_syncs(self) -> int:
        """The syncs the host made in the window, leaving out the one that
        ends it (:data:`OWN_SYNC`)."""
        lo, hi = self.window_ns
        return sum(1 for t in self.syncs
                   if lo <= t < hi and innermost(self.ranges, t) != OWN_SYNC)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the window's device ops' intervals, clipped to the
        window."""
        lo, hi = self.window_ns
        spans = sorted((max(o.start_ns, lo), min(o.end_ns, hi)) for o in self.window_ops()
                       if o.end_ns > lo and o.start_ns < hi)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def host_range_at(self, t_ns: int) -> str:
        """The innermost benchmark range open on the host at ``t_ns``."""
        return innermost(self.ranges, t_ns) or "none"

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the longest idle gaps in
        the window by the range the host was in when each began."""
        lo, hi = self.window_ns
        by_name: Dict[str, int] = collections.defaultdict(int)
        for o in self.window_ops():
            by_name[o.name] += o.end_ns - o.start_ns
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": [[self.host_range_at(s), (e - s) / 1e9] for s, e in gaps[:top]]}


def innermost(ranges: List[Tuple[int, int, str]], t_ns: int) -> Optional[str]:
    best = None
    for s, e, name in ranges:
        if s > t_ns:
            break
        if e >= t_ns and name != WINDOW and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else None


def from_profile(prof, range_names) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile`` whose
    session held one :data:`WINDOW` range and the ``range_names``."""
    from torch.autograd import DeviceType

    wanted = set(range_names) | {WINDOW, OWN_SYNC}
    ranges, launch_at, device, syncs = [], {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            if name in wanted:
                ranges.append((e.start_ns(), e.end_ns(), name))
            elif name.startswith(("cuda", "cu")):
                launch_at[e.correlation_id()] = e.start_ns()
                if VERSION.sub("", name) in SYNC_CALLS:
                    syncs.append(e.start_ns())
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append(e)
    ranges.sort()
    windows = [(s, e) for s, e, n in ranges if n == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW} ranges, not one")
    starts = [r[0] for r in ranges]
    cache: Dict[int, str] = {}
    ops, unattributed = [], 0
    for e in device:
        corr = e.correlation_id()
        at = launch_at.get(corr)
        if at is None:
            unattributed += 1
            label = ""
        else:
            label = cache.get(corr)
            if label is None:
                hi = bisect.bisect_right(starts, at)
                label = cache[corr] = innermost(ranges[:hi], at) or ""
        ops.append(DeviceOp(e.name(), e.start_ns(), e.end_ns(), label, at))
    return Trace(ops, ranges, windows[0], unattributed, sorted(syncs), len(launch_at))
