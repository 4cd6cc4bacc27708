"""Graph and op debugging aids.

Counterparts of ``sfast_tpu/utils/debug.py`` and, through it, of the
reference's AOT graph printer (``utils/aot_printer.py:36-44``) and
TorchDispatch ``LoggingMode`` (``utils/torch_dispatch.py:26-71``):

- :func:`print_graph` prints the aten graph of a function at given
  arguments (``make_fx``), where JAX prints the jaxpr (``print_jaxpr``) or
  the lowered StableHLO (``print_lowered``);
- :func:`count_ops` runs the function and counts the aten ops it
  dispatches, with the hand-written kernels it launched under their own
  names (``runtime/cuda_build.launch_counts``'): a quick answer to "did
  this call take the kernel route?".
"""

from collections import Counter
from typing import Callable, Dict

from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import TorchDispatchMode

from sfast_tpu_torch.runtime import cuda_build


def print_graph(fn: Callable, *args, echo=print):
    """Trace ``fn(*args)`` to an aten graph, ``echo`` its code and return
    the ``GraphModule``.  A kernel launch runs through ctypes, which the
    trace cannot see: trace CPU tensors, whose ops take the plain
    versions."""
    gm = make_fx(fn)(*args)
    echo(gm.code)
    return gm


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` and return how many times it dispatched
    each aten op (``"aten.mm"``...) and launched each hand-written kernel
    (``"flash_attention"``...), counted on this thread."""
    before = cuda_build.thread_launch_counts()
    with _OpCounter() as counter:
        fn(*args, **kwargs)
    after = cuda_build.thread_launch_counts()
    counts = dict(counter.counts)
    for name, n in after.items():
        if n > before[name]:
            counts[name] = n - before[name]
    return counts
