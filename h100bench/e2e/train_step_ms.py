"""Milliseconds of the window's wall time per train step completed, the
window ending in a sync."""

UNIT = "ms"
SOURCE = "host_clock"


def read(win):
    return win.window_s / win.done * 1e3
