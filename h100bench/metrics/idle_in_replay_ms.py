"""Device-idle ms a request while the serving thread was inside a program
``sfast.replay`` or ``sfast.capture`` span, over the traced stretch: the
graphs' launch and their copies in and out (``hb/spans.py``)."""

from hb import spans

LAYER = "compile layer"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "image_ms"


def read(r):
    s = spans.split(r)
    return None if s is None else s.per_image_ms(s.idle_ns[spans.REPLAY])
