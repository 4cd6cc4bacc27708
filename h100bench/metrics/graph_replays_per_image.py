"""CUDA graph replays a request makes: the program's ``sfast.replay`` spans
(one a graphed call of a compiled model, scheduler step or loop) that start
in the traced stretch, per request (``hb/spans.py``)."""

from hb import spans

LAYER = "compile layer"
UNIT = "count"
SOURCE = "program_span"
MOVES = "image_ms"


def read(r):
    s = spans.split(r)
    return None if s is None else sum(s.replays.values()) / s.images
