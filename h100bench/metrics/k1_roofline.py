"""K1, the flash attention of csrc/flash_attention.cu: the sum of its calls'
bounds over the sum of its rows' device time in the traced stretch. The
calls are reckoned from the cell's shapes; where their count differs from
the launches the program counted or from the kernel's rows in the trace, the
reckoning is stale and this reads nothing."""

from hb import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "image_ms"


def read(r):
    calls = roofline.k1_calls(r.cfg, r.traffic)
    n = sum(calls.values()) * r.win.traced
    rows = r.in_window(lambda op: roofline.KERNEL_ROWS["flash_attention"][0] in op.name)
    if n == 0 or len(rows) != n or r.win.launches.get("flash_attention") != n:
        return None
    busy = sum(o.end_ns - o.start_ns for o in rows) / 1e9
    return 100.0 * roofline.k1_bound_s(calls) * r.win.traced / busy
