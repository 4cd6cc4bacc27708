"""The program's own spans over the traced stretch, and the device's idle
time split by what the serving thread was doing during it.

The port records spans (``sfast_tpu_torch.profile.spans``) while a profiler
session records, stamped on the clock of the profiler's host events, so
they lie over the trace's device activity as they were.  Every instant of
the serving thread (the one that opened the most ``sfast.request`` spans
in the window) takes the class of the innermost program span open at that
instant: ``sfast.wait`` is waiting, ``sfast.replay`` and ``sfast.capture``
are replay, any other program span is the request path, and no span is
outside the program (the benchmark's loop, the caller's iterator).  The
device's idle intervals in the window (the complement of its busy ones)
are cut along that timeline, so the four classes partition the idle time
exactly.

A program without the span recorder, or a stretch whose trace holds no
device op or whose serving thread opened no request, reads nothing.
"""

import collections
import dataclasses
import functools
import json
import sys
from typing import Dict, List, Optional, Tuple

WAITING, REPLAY, REQUEST, OUTSIDE = "waiting", "replay", "request path", "outside"
CLASS = {"sfast.wait": WAITING, "sfast.replay": REPLAY, "sfast.capture": REPLAY}


@dataclasses.dataclass
class Split:
    """What the spans of one traced stretch say, summed over its window."""
    images: int
    replays: Dict[str, int]  # sfast.replay spans starting in the window, by graph
    waits: int  # sfast.wait spans starting in the window
    replay_host_ns: int  # innermost in an sfast.replay: replay less its captures
    idle_ns: Dict[str, int]  # by class; sums to the window's idle time
    replay_idle_ns: Dict[str, int]  # the replay class's idle by graph

    def per_image_ms(self, ns: int) -> float:
        return ns / self.images / 1e6


def program_spans() -> Optional[list]:
    """The program's finished spans, or None where it has no recorder."""
    try:
        from sfast_tpu_torch.profile import spans
    except ImportError:
        return None
    return spans.snapshot()


def timeline(spans: list, lo: int, hi: int) -> list:
    """[(start, end, span name or None, graph)] covering [lo, hi): at each
    instant the innermost of ``spans`` (one thread's, which nest) open
    there, None where none is."""
    out: list = []
    stack: list = []  # (end, name, graph) of the open spans
    cur = lo

    def emit(upto: int) -> None:
        nonlocal cur
        upto = min(upto, hi)
        if upto > cur:
            _, name, graph = stack[-1] if stack else (None, None, None)
            out.append((cur, upto, name, graph))
            cur = upto

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1][0] <= s.start_ns:
            emit(stack[-1][0])
            stack.pop()
        emit(s.start_ns)
        end = min(s.end_ns, stack[-1][0]) if stack else s.end_ns
        stack.append((end, s.name, s.graph))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(hi)
    return out


def idle_intervals(busy: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The complement of the sorted, disjoint ``busy`` intervals in [lo, hi)."""
    out, cur = [], lo
    for s, e in busy:
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def split_spans(spans: list, busy: List[Tuple[int, int]], window: Tuple[int, int],
                images: int) -> Split:
    """The :class:`Split` of one thread's ``spans`` over a window whose
    device was busy in ``busy`` (sorted, disjoint)."""
    lo, hi = window
    starting = [s for s in spans if lo <= s.start_ns < hi]
    replays = collections.Counter(s.graph for s in starting if s.name == "sfast.replay")
    segs = timeline(spans, lo, hi)
    idle = idle_intervals(busy, lo, hi)
    idle_ns = {c: 0 for c in (WAITING, REPLAY, REQUEST, OUTSIDE)}
    replay_idle: Dict[str, int] = collections.defaultdict(int)
    j = 0
    for a, b in idle:  # both lists sorted: one pass over the segments
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, name, graph = segs[k]
            cls = OUTSIDE if name is None else CLASS.get(name, REQUEST)
            idle_ns[cls] += min(b, e) - max(a, s)
            if cls == REPLAY:
                replay_idle[graph] += min(b, e) - max(a, s)
            k += 1
    replay_host = sum(e - s for s, e, name, _ in segs if name == "sfast.replay")
    return Split(images, dict(replays), sum(s.name == "sfast.wait" for s in starting),
                 replay_host, idle_ns, dict(replay_idle))


def serving_thread(spans: list, lo: int, hi: int) -> Optional[int]:
    """The thread that opened the most ``sfast.request`` spans in [lo, hi)."""
    n = collections.Counter(s.thread for s in spans
                            if s.name == "sfast.request" and lo <= s.start_ns < hi)
    return n.most_common(1)[0][0] if n else None


@functools.lru_cache(maxsize=1)
def split(r) -> Optional[Split]:
    """The :class:`Split` of a reading's traced stretch (printed on standard
    error once, with the outside class and the replay class by graph), or
    None where there is nothing to read."""
    found = program_spans()
    if found is None or not r.in_window():
        return None
    lo, hi = r.trace.window_ns
    thread = serving_thread(found, lo, hi)
    if thread is None:
        return None
    mine = [s for s in found if s.thread == thread and s.end_ns > lo and s.start_ns < hi]
    out = split_spans(mine, r.trace.busy_intervals(), (lo, hi), r.win.traced)
    per = out.per_image_ms
    print("spans " + json.dumps({
        "images": out.images, "replays_per_image": {g: n / out.images
                                                    for g, n in sorted(out.replays.items())},
        "waits_per_image": out.waits / out.images,
        "idle_ms_per_image": {c: per(ns) for c, ns in out.idle_ns.items()},
        "idle_total_ms_per_image": per((hi - lo) - sum(e - s for s, e in
                                                       r.trace.busy_intervals())),
        "replay_idle_ms_per_image": {g: per(ns) for g, ns in sorted(out.replay_idle_ns.items())},
        "replay_host_ms_per_image": per(out.replay_host_ns)}), file=sys.stderr)
    return out
