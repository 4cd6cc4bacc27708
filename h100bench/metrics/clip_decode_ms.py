"""Device ms to decode one clip's frames with the temporal decoder: the
device time of the ops launched inside the program's ``sfast.replay`` spans
of the pipeline's decode graph (``svd_decode_u8``, one a chunk of frames)
that start in the traced stretch, per traced clip (``hb/spans.py``).
Reads nothing where the program recorded no such span."""

import bisect

from hb import spans

LAYER = "models"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "image_ms"
GRAPH = "svd_decode_u8"


def read(r):
    found = spans.program_spans()
    if found is None or not r.in_window():
        return None
    lo, hi = r.trace.window_ns
    replays = sorted((s.start_ns, s.end_ns) for s in found
                     if s.name == "sfast.replay" and s.graph == GRAPH and lo <= s.start_ns < hi)
    if not replays:
        return None
    starts = [a for a, _ in replays]

    def inside(op):
        if op.launch_ns is None:
            return False
        j = bisect.bisect_right(starts, op.launch_ns) - 1
        return j >= 0 and op.launch_ns <= replays[j][1]

    return r.device_s(inside) / r.win.traced * 1e3
