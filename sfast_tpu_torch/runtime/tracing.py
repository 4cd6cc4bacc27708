"""Lazy capture: one CUDA graph per input signature.

Counterpart of ``sfast_tpu/runtime/tracing.py`` (``LazyCompiledFunction``,
``:157-269``), where one AOT-compiled XLA executable per signature plays
the role the reference gives its CUDA-graph cache (``cuda/graphs.py:16-157``,
SURVEY.md §3.3).  Here it is that cache again, in the reference's order:

- **miss**: three warm-up calls (``warmup_calls``) on the capture stream,
  static copies of the tensor inputs, then the capture under
  double-checked locking, logged with its seconds as JAX logs each
  compile.  The launches the capture recorded
  (``cuda_build.recording_launches``) are kept and never counted: a
  capture launches nothing;
- **hit**: ``copy_`` the inputs into the static inputs, ``replay()``, add
  the recorded launches, and return clones of the static outputs (the
  reference's ``tree_copy``): a caller that keeps an output across two
  replays, as DPM++ keeps ``x0_prev``, must not see it overwritten.

Calls whose tensors all lie on the CPU run the function directly and
cache nothing, as every kernel wrapper takes its plain version there.  A
capture that fails raises: unlike JAX's ``CompiledModel._cannot_compile``
this falls back to nothing.  Each graph has its own memory pool, so two
graphs never share the buffers of their outputs.

A graph reads the tensors of the modules it ran by address, so it is
stale once a module's tensors are replaced rather than copied into (int8
quantization swaps a weight for new buffers; ``update_params`` copies and
keeps them).  Whoever replaces them calls :func:`bump_weights_version` on
the module, and every function that lists the module in ``reads`` drops
its graphs at its next call: every pipeline that holds the module, not
only the one that changed it.

A tensor-parallel model's collectives (``parallel/tensor_parallel.py``:
NCCL all-reduces and all-gathers) are captured like its kernels, and its
warm-up calls issue them too.  NCCL creates a communicator at its first
collective, which no capture may do: ``CompiledModel`` runs one eager
collective on each of the mesh's groups when it shards its module, before
any capture.

Everything one-time (the nvcc build and load, ``cudaFuncSetAttribute``
behind statics, the driver entry lookup of ``cuTensorMapEncodeTiled``)
first happens in the warm-up calls, which run on the stream the capture
then uses.  K3 takes a ticket set of the graph's own inside a capture
(``ops/group_norm._ticket``), so no graph shares one with another graph
or with an eager call.

Under concurrent use (a thread that serves images beside one that warms
up other shapes, ``StableDiffusionPipeline.warmup(background=True)``):

- each thread warms up and captures on a side stream of its own
  (:func:`capture_stream`), in ``capture_error_mode="thread_local"``, so
  that another thread's allocations and host syncs do not break the
  capture; the other thread's allocations stay out of the capture's pool,
  which takes only what the capturing stream allocates;
- the launches a capture records are those of its own thread
  (``cuda_build.recording_launches``): replays on another thread during
  the capture keep their counts;
- every replay runs on the device's default stream (the current stream of
  a thread that sets none).  :meth:`CapturedGraph.run` releases its lock
  once the replay is enqueued, not once it has run, so two threads that
  replay one graph are safe only on one stream: there the second copy into
  the static inputs waits for the first replay;
- the warm-up calls end with the default stream waiting for them, so the
  images served while another thread warms up are slower by that much.
"""

import ctypes
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.utils._pytree as pytree

from sfast_tpu_torch.runtime import cuda_build
from sfast_tpu_torch.runtime.signature import call_signature

logger = logging.getLogger(__name__)

WARMUP_CALLS = 3  # the reference's count (cuda/graphs.py:87-92)

_local = threading.local()  # per thread: "streams", its capture stream per device


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream on which the calling thread warms up and captures
    the graphs of ``device``: one per (device, thread), so that two threads
    that capture at once never capture into one stream."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    s = streams.get(device)
    if s is None:
        s = streams[device] = torch.cuda.Stream(device)
    return s


def _canonical(tree):
    """``tree`` with every dict's keys in sorted order, so that two calls
    with one signature flatten to their leaves in one order."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree, key=str)}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_canonical(x) for x in tree)
    return tree


def _clone_tensors(tree):
    return pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _node_count(graph: "torch.cuda.CUDAGraph") -> int:
    """Nodes of a captured graph (``cuGraphGetNodes`` of the driver)."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {err}")
    return n.value


def weights_version(module: torch.nn.Module) -> int:
    """How many times ``module``'s tensors were replaced."""
    return module.__dict__.get("_weights_version", 0)


def bump_weights_version(module: torch.nn.Module) -> None:
    """Record that ``module``'s tensors were replaced: the graphs of every
    function that reads it are dropped at that function's next call."""
    module.__dict__["_weights_version"] = weights_version(module) + 1


class CapturedGraph:
    """One captured graph: its static inputs and outputs, the kernel
    launches one replay makes, and what its capture cost.

    :meth:`run` copies the inputs in, replays and clones the outputs on the
    calling thread's current stream, under a lock that it releases once
    the work is enqueued.  Every caller replays on the device's default
    stream: a replay on another stream could run beside one still in
    flight, whose static inputs the second copy would overwrite."""

    def __init__(self, graph, static_leaves, static_out, launches,
                 capture_seconds, instantiate_seconds, nodes):
        self.graph = graph
        self.static_leaves = static_leaves
        self.static_out = static_out
        self.launches = launches
        self.capture_seconds = capture_seconds
        self.instantiate_seconds = instantiate_seconds
        self.nodes = nodes
        self._lock = threading.Lock()  # one copy-in / replay / clone-out at a time

    def run(self, leaves):
        with self._lock:
            for static, x in zip(self.static_leaves, leaves):
                if isinstance(static, torch.Tensor):
                    static.copy_(x)
            self.graph.replay()
            cuda_build.add_launch_counts(self.launches)
            return _clone_tensors(self.static_out)


class LazyCompiledFunction:
    """A callable that captures ``fn`` into one CUDA graph per input
    signature on first use and replays it after.  ``warmup_calls`` calls of
    ``fn`` run before each capture (the reference's three by default); one
    does every first-call setup, and a function that is itself many model
    evals (a video's fused denoising loop) may take one.  ``reads``: the
    modules whose tensors the graphs read (a module's bound method reads
    its module where None); a new :func:`weights_version` of one of them
    drops every graph."""

    def __init__(self, fn: Callable, *, name: Optional[str] = None,
                 warmup_calls: int = WARMUP_CALLS,
                 reads: Optional[Sequence[torch.nn.Module]] = None):
        if warmup_calls < 1:
            raise ValueError(f"warmup_calls must be at least 1, got {warmup_calls}")
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")
        self.warmup_calls = warmup_calls
        if reads is None:
            owner = getattr(fn, "__self__", None)
            reads = (owner,) if isinstance(owner, torch.nn.Module) else ()
        self.reads = tuple(m for m in reads if m is not None)
        self._versions = self._read_versions()
        self._lock = threading.Lock()
        self._cache: Dict[tuple, CapturedGraph] = {}

    def _read_versions(self) -> tuple:
        return tuple(weights_version(m) for m in self.reads)

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def graphs(self) -> List[CapturedGraph]:
        return list(self._cache.values())

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()

    def warmup(self, *args, **kwargs):
        """Capture for this signature without replaying (the three warm-up
        calls still run).  Does nothing for CPU tensors."""
        args, kwargs = _canonical((args, kwargs))
        leaves, spec = pytree.tree_flatten((args, kwargs))
        if self._uses_graph(leaves):
            self._get_graph(args, kwargs, leaves, spec)
        return self

    def __call__(self, *args, **kwargs):
        args, kwargs = _canonical((args, kwargs))
        leaves, spec = pytree.tree_flatten((args, kwargs))
        if not self._uses_graph(leaves):
            return self.fn(*args, **kwargs)
        return self._get_graph(args, kwargs, leaves, spec).run(leaves)

    @staticmethod
    def _uses_graph(leaves) -> bool:
        """True for a call with a CUDA tensor."""
        return any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves)

    def _get_graph(self, args, kwargs, leaves, spec) -> CapturedGraph:
        versions = self._read_versions()
        if versions != self._versions:  # a module's tensors were replaced
            with self._lock:
                self._cache.clear()
                self._versions = versions
        key = call_signature(args, kwargs)
        entry = self._cache.get(key)
        if entry is None:
            with self._lock:
                entry = self._cache.get(key)
                if entry is None:
                    entry = self._cache[key] = self._capture(leaves, spec)
        return entry

    def _capture(self, leaves, spec) -> CapturedGraph:
        device = next(x.device for x in leaves if isinstance(x, torch.Tensor) and x.is_cuda)
        for x in leaves:
            if isinstance(x, torch.Tensor) and not x.is_cuda and x.dim() > 0:
                raise ValueError(
                    f"{self.name}: a CPU tensor of shape {tuple(x.shape)} beside CUDA "
                    "tensors; a graph would bake it in"
                )
        static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        args, kwargs = pytree.tree_unflatten(static, spec)
        stream = capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(self.warmup_calls):
                self.fn(*args, **kwargs)
        torch.cuda.current_stream(device).wait_stream(stream)

        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        # thread_local: another thread's allocations and syncs (a replay, a
        # copy to the host) do not invalidate this capture
        with cuda_build.recording_launches() as launches:
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(), stream=stream,
                                  capture_error_mode="thread_local"):
                out = self.fn(*args, **kwargs)
        capture_s = time.perf_counter() - t0
        nodes = _node_count(graph)
        t1 = time.perf_counter()
        graph.instantiate()
        instantiate_s = time.perf_counter() - t1
        logger.info(
            "sfast_tpu_torch: captured %s for a new input signature in %.2f s (%d nodes, "
            "instantiated in %.2f s; cache size %d)",
            self.name, capture_s, nodes, instantiate_s, len(self._cache) + 1,
        )
        return CapturedGraph(graph, static, out, launches, capture_s, instantiate_s, nodes)


def lazy_jit(fn: Optional[Callable] = None, *, name: Optional[str] = None,
             warmup_calls: int = WARMUP_CALLS,
             reads: Optional[Sequence[torch.nn.Module]] = None):
    """Wrap any function in a :class:`LazyCompiledFunction`: ``lazy_jit(fn)``
    or ``@lazy_jit(name=..., warmup_calls=..., reads=...)``.  Counterpart of
    JAX's ``lazy_jit`` (``sfast_tpu/runtime/tracing.py``), the generic entry
    of the per-signature cache; its ``donate_argnums``, ``mode`` and
    shardings have no meaning for a CUDA graph."""
    def wrap(f: Callable) -> LazyCompiledFunction:
        return LazyCompiledFunction(f, name=name, warmup_calls=warmup_calls, reads=reads)

    return wrap if fn is None else wrap(fn)
