"""Lazy capture: one CUDA graph per input signature.

Counterpart of ``sfast_tpu/runtime/tracing.py`` (``LazyCompiledFunction``,
``:157-269``), where one AOT-compiled XLA executable per signature plays
the role the reference gives its CUDA-graph cache (``cuda/graphs.py:16-157``,
SURVEY.md §3.3).  Here it is that cache again, in the reference's order:

- **miss**: three warm-up calls on the capture stream, static copies of the
  tensor inputs, then the capture under double-checked locking, logged
  with its seconds as JAX logs each compile.  The launches the capture
  recorded (``cuda_build.launch_counts``) are kept, and taken back out of
  the counts: a capture launches nothing;
- **hit**: ``copy_`` the inputs into the static inputs, ``replay()``, add
  the recorded launches, and return clones of the static outputs (the
  reference's ``tree_copy``): a caller that keeps an output across two
  replays, as DPM++ keeps ``x0_prev``, must not see it overwritten.

Calls whose tensors all lie on the CPU run the function directly and
cache nothing, as every kernel wrapper takes its plain version there.  A
capture that fails raises: unlike JAX's ``CompiledModel._cannot_compile``
this falls back to nothing.  Each graph has its own memory pool, so two
graphs never share the buffers of their outputs.

Everything one-time (the nvcc build and load, ``cudaFuncSetAttribute``
behind statics, the driver entry lookup of ``cuTensorMapEncodeTiled``,
K3's ticket buffer, allocated per stream) first happens in the warm-up
calls, which run on the stream the capture then uses.
"""

import ctypes
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.utils._pytree as pytree

from sfast_tpu_torch.runtime import cuda_build
from sfast_tpu_torch.runtime.signature import call_signature

logger = logging.getLogger(__name__)

WARMUP_CALLS = 3  # the reference's count (cuda/graphs.py:87-92)

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream on which every graph of ``device`` warms up and is
    captured."""
    with _streams_lock:
        s = _streams.get(device)
        if s is None:
            s = _streams[device] = torch.cuda.Stream(device)
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


class CapturedGraph:
    """One captured graph: its static inputs and outputs, the kernel
    launches one replay makes, and what its capture cost."""

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
    signature on first use and replays it after."""

    def __init__(self, fn: Callable, *, name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")
        self._lock = threading.Lock()
        self._cache: Dict[tuple, CapturedGraph] = {}

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
            for _ in range(WARMUP_CALLS):
                self.fn(*args, **kwargs)
        torch.cuda.current_stream(device).wait_stream(stream)

        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = dict(cuda_build.launch_counts)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(), stream=stream):
                out = self.fn(*args, **kwargs)
            launches = {k: n - before[k] for k, n in cuda_build.launch_counts.items()
                        if n != before[k]}
        finally:
            cuda_build.launch_counts.update(before)
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
