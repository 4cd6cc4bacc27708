"""The ``map`` traffic: one stream of requests through ``pipe.map``, served
by the ``call`` driver's class (``drivers/call.py``), which reads ``map``'s
``window`` besides its own keys."""

from hb.family import BENCH, by_path

DRIVER = by_path(BENCH / "drivers" / "call.py").DRIVER
