"""Host syncs a request makes: the host's calls into the CUDA runtime that
wait for the device (``hb.trace.SYNC_CALLS``) in the traced stretch, per
request, leaving out the sync that ends the stretch.  Reads nothing where
the trace holds no runtime call (no device was traced)."""

LAYER = "request path"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "image_ms"


def read(r):
    if r.trace.runtime_calls == 0:
        return None
    return r.trace.host_syncs() / r.win.traced
