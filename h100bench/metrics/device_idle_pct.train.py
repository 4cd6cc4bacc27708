"""Share of the traced window in which no operation ran on the device:
1 − the union of the device's busy intervals ÷ the window."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_step_ms"


def read(r):
    if not r.in_window():  # no device op was traced
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
