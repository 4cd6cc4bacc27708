"""Milliseconds of the window's wall time per image delivered to the host
as a uint8 array."""

UNIT = "ms"
SOURCE = "host_clock"


def read(win):
    return win.window_s / win.done * 1e3
