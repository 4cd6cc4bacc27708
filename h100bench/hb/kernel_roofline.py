"""A port kernel's share of its roofline in the traced stretch: the sum of
its calls' bounds (``hb/roofline.py``) over the sum of its rows' device
time.  The calls are the family's reckoning from the cell's shapes
(``kernel_calls``); where their count times the traced requests differs
from the launches the program counted or from the kernel's rows in the
trace, the reckoning is stale or the trace lost rows, and the share reads
nothing and says why on standard error."""

import sys
from typing import Optional

from hb import roofline


def share(r, kernel: str, metric: str) -> Optional[float]:
    calls = r.kernel_calls.get(kernel, {})
    n = sum(calls.values()) * r.win.traced
    piece = roofline.KERNEL_ROWS[kernel][0]
    rows = r.in_window(lambda op: piece in op.name)
    launched = r.win.launches.get(kernel, 0)
    if n == 0 or len(rows) != n or launched != n:
        print(f"h100bench: {metric} reads nothing: {kernel} reckoned "
              f"{sum(calls.values())} calls a request x {r.win.traced} traced = {n}, launched "
              f"{launched}, {len(rows)} rows '{piece}' traced", file=sys.stderr)
        return None
    busy = sum(o.end_ns - o.start_ns for o in rows) / 1e9
    return 100.0 * roofline.BOUNDS[kernel](calls) * r.win.traced / busy
