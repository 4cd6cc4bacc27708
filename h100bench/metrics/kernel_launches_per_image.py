"""Launches of the port's hand-written kernels a request makes:
``cuda_build.launch_counts`` over the traced stretch (a graph's replay adds
the launches its capture recorded), per request."""

LAYER = "routing"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "image_ms"


def read(r):
    return sum(r.win.launches.values()) / r.win.traced
