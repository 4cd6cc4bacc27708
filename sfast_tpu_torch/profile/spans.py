"""Program spans: where the port's host time goes, on the profiler's clock.

The port records a span at each boundary where its host work happens, and
only while a ``torch.profiler`` session records (``profile.trace()``, or any
``torch.profiler.profile``): the one switch is the profiler's own flag,
``torch.autograd.profiler._is_profiler_enabled``.  With no session a span
site reads that flag and takes a shared no-op context: no clock read, no
allocation.

The spans:

- ``sfast.request`` (``request``: a process-wide id): a pipeline's
  ``__call__`` (:func:`as_request`); under ``map`` each item from the moment it is taken from
  the caller's iterator to its copy to the host being queued, and again
  around its fetch.  Every span opened inside one carries its id;
- ``sfast.replay`` (``graph``: the ``LazyCompiledFunction``'s name, or
  ``lora_train_step``): one graphed call at the compile layer's boundary,
  the signature lookup, the copy-in, ``graph.replay()`` and the clone-out;
- ``sfast.capture`` (``graph``): ``runtime.tracing.capture_graph``, its
  warm-up calls, capture and instantiation; inside the replay that missed;
- ``sfast.wait``: the host blocked on the device (the image's copy to the
  host, ``map``'s fetch).

Each span is stamped with ``time.time_ns()``, the clock the profiler stamps
its host events with (``tests/test_torch_spans.py`` holds them to each
other), so a span can be laid over the trace's device activity.  Each is
also opened as a profiler range of its own name, which puts it above the
kernels it launched in ``profile.trace()``'s Chrome trace.  The finished
spans of the process are kept in a ring of the last :data:`RING_SPANS`;
:func:`snapshot` reads them.
"""

import collections
import functools
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

RING_SPANS = 1 << 16  # finished spans kept: some hundred images' worth

# the cheapest profiler range: a record function without the dispatcher
# op that ``torch.profiler.record_function`` goes through
_range = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    """One finished span; times in ns of ``time.time_ns()``."""
    name: str
    start_ns: int
    end_ns: int
    request: Optional[int]  # the request it serves, None outside one
    graph: Optional[str]  # a replay's or capture's graph
    id: int
    parent: Optional[int]  # the id of the span it was opened in
    thread: int


_ring = collections.deque(maxlen=RING_SPANS)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_local = threading.local()  # per thread: "stack", its open spans


class _NoSpan:
    """What a span site takes with no profiler session: enters as None."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """An open span: pushed on its thread's stack, stamped, mirrored by a
    profiler range; recorded when it closes.  Enters as its request id."""
    __slots__ = ("name", "request", "graph", "id", "parent", "start_ns", "_mirror")

    def __init__(self, name: str, request: Optional[int], graph: Optional[str]):
        self.name, self.request, self.graph = name, request, graph

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        if self.request is None and stack:
            self.request = stack[-1].request
        self.id = next(_span_ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        self._mirror = _range(self.name)
        self._mirror.__enter__()
        return self.request

    def __exit__(self, *exc):
        self._mirror.__exit__(None, None, None)
        end = time.time_ns()
        _stack().pop()
        _ring.append(Span(self.name, self.start_ns, end, self.request, self.graph, self.id,
                          self.parent, threading.get_ident()))
        return False


def request(request_id: Optional[int] = None):
    """``with request() as rid:`` a new request, with a new id (``rid``; None
    with no session).  Inside a request already open on this thread it
    opens nothing: a pipeline call that ``map`` makes serves ``map``'s
    request.  ``request(rid)`` opens a span of the request ``rid`` again
    (``map``'s fetch)."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    if request_id is None:
        stack = getattr(_local, "stack", None)
        if stack and stack[-1].request is not None:
            return _NO_SPAN
        request_id = next(_request_ids)
    return _Open("sfast.request", request_id, None)


def as_request(fn):
    """Decorate a pipeline's ``__call__``: each call is a :func:`request`."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with request():
            return fn(*args, **kwargs)

    return call


def replay(graph: str):
    """A graphed call of ``graph``."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Open("sfast.replay", None, graph)


def capture(graph: str):
    """A capture of ``graph``: warm-up calls, capture, instantiation."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Open("sfast.capture", None, graph)


def wait():
    """The host blocked until the device has done its work."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Open("sfast.wait", None, None)


def snapshot() -> List[Span]:
    """The finished spans in the ring, in the order they closed."""
    return list(_ring)
