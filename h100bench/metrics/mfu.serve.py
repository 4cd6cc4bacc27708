"""The whole request's share of the H100's bf16 peak: the model FLOPs of
the traced requests (counted once from the reference on the meta device)
over the traced window's seconds × 989 TFLOP/s."""

from hb.roofline import PEAK_BF16_FLOPS

LAYER = "whole step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "image_ms"


def read(r):
    if not r.in_window():  # no device op was traced
        return None
    return 100.0 * r.request_flops * r.win.traced / (r.trace.window_s * PEAK_BF16_FLOPS)
