"""Device-idle ms a request while the serving thread was blocked in a
program ``sfast.wait`` span (the image's copy to the host, ``map``'s
fetch), over the traced stretch: idle while the host had handed over all
the work it had and waited for it (``hb/spans.py``)."""

from hb import spans

LAYER = "device"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "image_ms"


def read(r):
    s = spans.split(r)
    return None if s is None else s.per_image_ms(s.idle_ns[spans.WAITING])
