"""A named registry of the lazily captured functions.

Counterpart of ``sfast_tpu/runtime/executable_cache.py``: tools and tests
enumerate what was captured, and for how many signatures, by name.  The
reference's per-device ``GraphExecutionEnv`` (mempool, stream, lock,
``cuda/graphs.py:188-222``) has no counterpart here: each graph owns its
memory pool, ``runtime/tracing.capture_stream`` gives the stream, and each
function its lock.

A name is a slot (``unet``, ``scheduler.step``, ``denoise_loop_30``...),
and every pipeline of a process registers its own function under it: the
registry keeps all of them, so ``stats`` and ``clear`` cover every
pipeline.  It holds them weakly: a pipeline that is dropped takes its
functions, and their graphs' memory pools, with it.
"""

import threading
import weakref
from typing import Dict, List, Optional

from sfast_tpu_torch.runtime.tracing import LazyCompiledFunction


class ExecutableCache:
    """Named registry of :class:`LazyCompiledFunction` objects, any number
    of them under one name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, List[weakref.ref]] = {}

    def register(self, name: str, fn: LazyCompiledFunction) -> LazyCompiledFunction:
        with self._lock:
            others = [f for f in self._live(name) if f is not fn]
            self._entries[name] = [weakref.ref(f) for f in others + [fn]]
        return fn

    def _live(self, name: str) -> List[LazyCompiledFunction]:
        return [fn for fn in (r() for r in self._entries.get(name, ())) if fn is not None]

    def get_all(self, name: str) -> List[LazyCompiledFunction]:
        """The live functions under ``name``, oldest first."""
        with self._lock:
            return self._live(name)

    def get(self, name: str) -> Optional[LazyCompiledFunction]:
        """The live function registered last under ``name``."""
        fns = self.get_all(name)
        return fns[-1] if fns else None

    def stats(self) -> Dict[str, int]:
        """Graphs captured, by name, summed over the live functions under it."""
        with self._lock:
            live = {name: self._live(name) for name in self._entries}
        return {name: sum(fn.cache_size for fn in fns) for name, fns in live.items() if fns}

    def clear(self) -> None:
        """Drop every graph of every function, and the registry."""
        with self._lock:
            fns = [fn for name in self._entries for fn in self._live(name)]
            self._entries.clear()
        for fn in fns:
            fn.clear_cache()


_GLOBAL_CACHE = ExecutableCache()


def global_executable_cache() -> ExecutableCache:
    return _GLOBAL_CACHE
