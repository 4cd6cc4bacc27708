"""Device ms of one VAE decode: the device time of the ops launched under
the benchmark's ``vae`` range, over the decodes of the traced stretch."""

LAYER = "models"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "image_ms"


def read(r):
    n = r.win.calls.get("vae", 0)
    ops = r.in_window(lambda op: op.range == "vae")
    if not n or not ops:
        return None
    return sum(o.end_ns - o.start_ns for o in ops) / n / 1e6
