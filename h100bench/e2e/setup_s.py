"""Seconds from the process's start to the window's first request:
imports, the kernel library's build or load, the weights, the captures
and the warm-up."""

UNIT = "s"
SOURCE = "host_clock"


def read(win):
    return win.setup_s
