"""The train step's share of the H100's bf16 peak: the forward and the
backward that the LoRA's gradients need (counted once from the reference
on the meta device) over the traced window's seconds × 989 TFLOP/s."""

from hb.roofline import PEAK_BF16_FLOPS

LAYER = "whole step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_step_ms"


def read(r):
    if not r.in_window():  # no device op was traced
        return None
    return 100.0 * r.step_flops * r.win.traced / (r.trace.window_s * PEAK_BF16_FLOPS)
