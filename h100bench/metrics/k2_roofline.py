"""K2, the fused GroupNorm+SiLU 3x3 conv of csrc/conv3x3.cu: the sum of its
calls' bounds over the sum of its rows' device time in the traced stretch.
The calls are reckoned from the cell's shapes; where their count differs
from the launches the program counted or from the kernel's rows in the
trace, the reckoning is stale and this reads nothing."""

from hb import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "image_ms"


def read(r):
    calls = roofline.k2_calls(r.cfg, r.traffic)
    n = sum(calls.values()) * r.win.traced
    rows = r.in_window(lambda op: roofline.KERNEL_ROWS["conv3x3"][0] in op.name)
    if n == 0 or len(rows) != n or r.win.launches.get("conv3x3") != n:
        return None
    busy = sum(o.end_ns - o.start_ns for o in rows) / 1e9
    return 100.0 * roofline.k2_bound_s(calls) * r.win.traced / busy
