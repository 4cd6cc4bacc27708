"""A named registry of the lazily captured functions.

Counterpart of ``sfast_tpu/runtime/executable_cache.py``: tools and tests
enumerate what was captured, and for how many signatures, by name.  The
reference's per-device ``GraphExecutionEnv`` (mempool, stream, lock,
``cuda/graphs.py:188-222``) has no counterpart here: each graph owns its
memory pool, ``runtime/tracing.capture_stream`` gives the stream, and each
function its lock.
"""

import threading
from typing import Dict, Optional

from sfast_tpu_torch.runtime.tracing import LazyCompiledFunction


class ExecutableCache:
    """Named registry of :class:`LazyCompiledFunction` objects."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, LazyCompiledFunction] = {}

    def register(self, name: str, fn: LazyCompiledFunction) -> LazyCompiledFunction:
        with self._lock:
            self._entries[name] = fn
        return fn

    def get(self, name: str) -> Optional[LazyCompiledFunction]:
        return self._entries.get(name)

    def stats(self) -> Dict[str, int]:
        """Graphs captured, by name."""
        return {name: fn.cache_size for name, fn in self._entries.items()}

    def clear(self) -> None:
        with self._lock:
            for fn in self._entries.values():
                fn.clear_cache()
            self._entries.clear()


_GLOBAL_CACHE = ExecutableCache()


def global_executable_cache() -> ExecutableCache:
    return _GLOBAL_CACHE
