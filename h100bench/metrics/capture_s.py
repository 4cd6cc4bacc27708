"""Seconds of set-up spent capturing and instantiating CUDA graphs: the sum
of ``capture_seconds`` and ``instantiate_seconds`` of every graph the
program holds after set-up."""

LAYER = "compile layer"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(r):
    if not r.win.graphs:
        return None
    return sum(c + i for c, i, _ in r.win.graphs)
