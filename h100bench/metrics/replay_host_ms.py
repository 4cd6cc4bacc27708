"""Host ms a request spends inside the program's ``sfast.replay`` spans
(the signature lookup, the copy-in, ``graph.replay()``, the clone-out),
less their ``sfast.capture`` children, over the traced stretch
(``hb/spans.py``)."""

from hb import spans

LAYER = "compile layer"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "image_ms"


def read(r):
    s = spans.split(r)
    return None if s is None else s.per_image_ms(s.replay_host_ns)
