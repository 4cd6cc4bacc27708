"""Device-idle ms a request while the serving thread was in the program's
request path (an ``sfast.request`` span, outside its replays and waits),
over the traced stretch (``hb/spans.py``)."""

from hb import spans

LAYER = "request path"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "image_ms"


def read(r):
    s = spans.split(r)
    return None if s is None else s.per_image_ms(s.idle_ns[spans.REQUEST])
