"""cProfile decorator: host-side Python overhead analysis (≙ the
reference's ``profile/cprofile.py:7-33`` and ``pretty_profile.py``; a copy
of ``sfast_tpu/profile/cprofile.py``, which cannot be imported without JAX)."""

import cProfile
import functools
import io
import pstats


def with_cProfile(fn=None, *, top: int = 30, sort: str = "cumulative", echo=print):
    """Decorator: profile each call of ``fn`` and ``echo`` its ``top``
    entries by ``sort``."""
    if fn is None:
        return functools.partial(with_cProfile, top=top, sort=sort, echo=echo)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prof = cProfile.Profile()
        prof.enable()
        try:
            return fn(*args, **kwargs)
        finally:
            prof.disable()
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats(sort).print_stats(top)
            echo(buf.getvalue())

    return wrapper
