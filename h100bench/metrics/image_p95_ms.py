"""The 95th percentile (nearest rank) of the latencies of the window's
requests after the traced stretches, in ms: from ``map`` taking a request
from the benchmark's iterator to ``map`` yielding its image.  The cell
serves a backlog at the rate ``map`` pulls it, so its tail is a per-layer
reading beside ``image_ms`` and holds no bound."""

import math

LAYER = "request path"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "image_ms"


def read(r):
    lat = sorted(r.win.latencies_s[r.win.untraced_from:])
    if len(lat) < 200:  # a tail wants some hundreds of requests
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
