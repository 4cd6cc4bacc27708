"""K1, the flash attention of csrc/flash_attention.cu: the sum of its calls'
bounds over the sum of its rows' device time in the traced stretch. The
calls are the cell's family's reckoning from its shapes; where their count
differs from the launches the program counted or from the kernel's rows in
the trace, this reads nothing and says why (``hb/kernel_roofline.py``)."""

from hb.kernel_roofline import share

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "image_ms"


def read(r):
    return share(r, "flash_attention", "k1_roofline")
