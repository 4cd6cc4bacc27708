"""Device ms a train step spends in PyTorch's own elementwise and reduction
kernels (the plain ops' passes), over the traced stretch."""

LAYER = "plain ops"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_step_ms"
PIECES = ("elementwise_kernel", "reduce_kernel")


def read(r):
    if not r.in_window():  # no device op was traced
        return None
    return r.device_s(lambda op: any(p in op.name for p in PIECES)) / r.win.traced * 1e3
