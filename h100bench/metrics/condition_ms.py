"""Device ms a clip spends on its conditioning image: the device time of the
ops launched under the benchmark's ``image_encoder`` and ``vae_encode``
ranges (the CLIP image embedding and the VAE encode of the noise-augmented
image), per traced clip."""

LAYER = "models"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "image_ms"
RANGES = ("image_encoder", "vae_encode")


def read(r):
    if not all(r.win.calls.get(name, 0) for name in RANGES):
        return None
    ops = r.in_window(lambda op: op.range in RANGES)
    if not ops:
        return None
    return sum(o.end_ns - o.start_ns for o in ops) / r.win.traced / 1e6
