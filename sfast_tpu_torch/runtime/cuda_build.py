"""Build and load the hand-written CUDA kernels of ``sfast_tpu_torch/csrc``.

Counterpart of ``sfast_tpu/runtime/native_build.py``.  The kernels have a
plain C interface and are compiled with ``nvcc`` at first use, then loaded
with :mod:`ctypes` — no PyTorch headers, so a build takes seconds, not
minutes.  Each source compiles to an object in its own ``nvcc`` process,
all started together, and one more call links them into one library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -c csrc/<kernel>.cu -o <kernel>.o          # one per source, in parallel
    nvcc -shared -o build/sfast_tpu_torch/libsfast_kernels-<hash>.so *.o

The library lands in ``build/sfast_tpu_torch/`` under the checkout (or in
the directory :func:`set_build_dir` names, once a process:
``CompilationConfig.cache_dir``),
named by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing file.  Every C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises on anything
but 0.  Each kernel wrapper adds one to its entry of :data:`launch_counts`
where it launches (:func:`count_launch`), which lets a run show that its
main path went through the kernels.  A CUDA graph's replay launches
without passing through the wrappers, so ``runtime/tracing.py`` records
the counts its capture made (:func:`recording_launches`) and adds them on
each replay (:func:`add_launch_counts`).

The counts are shared by every thread and kept under a lock; each thread
also keeps its own (:func:`thread_launch_counts`), so that a thread
serving images beside a thread that warms up other shapes can count what
its own images launched.

No kernel has a backward, as no Pallas kernel of the JAX package has one.
A launch writes into a buffer through ctypes, so its output would carry no
``grad_fn`` and a backward pass would drop the gradient behind it without
a word.  Each wrapper is therefore decorated with :func:`no_backward`:
where autograd records (grad mode on and a tensor off the CPU that
requires grad) the wrapper runs as the forward of :class:`NoBackward`,
whose backward raises; anywhere else (the CPU's plain versions,
``no_grad``, ``inference_mode``, the graphed paths) it is a plain call.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch
from torch.utils import _pytree as pytree

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "sfast_tpu_torch"
_build_dir = BUILD_DIR  # where build() writes and library_path() looks
_build_dir_fixed = False  # a cache_dir named it, or the library was loaded from it
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset_launch_counts()
launch_counts = {
    "flash_attention": 0,
    "quantize_qkv": 0,
    "flash_attention_int8": 0,
    "conv3x3": 0,
    "group_norm_stats": 0,
    "group_norm_apply": 0,
    "group_norm_fused": 0,
    "linear_geglu": 0,
    "layer_norm": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "sfast_flash_attention_bf16": [_P] * 4 + [_I] * 5 + [_L] * 12 + [_F, _I, _P],
    "sfast_conv3x3_bf16": [_P] * 8 + [_I] * 5 + [_F, _P],
    "sfast_group_norm_stats_bf16": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "sfast_group_norm_fused_bf16": [_P] * 6 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
    "sfast_group_norm_apply_bf16": [_P] * 6 + [_I] * 4 + [_P],
    "sfast_linear_geglu_bf16": [_P] * 3 + [_I, _P] + [_I] * 3 + [_P],
    "sfast_quantize_qkv_int8": [_P] * 3 + [_I] * 5 + [_L] * 9 + [_F] + [_P] * 9,
    "sfast_flash_attention_int8": [_P] * 8 + [_I] * 5 + [_L] * 3 + [_I, _P],
    "sfast_layer_norm_bf16": [_P, _L, _P, _P, _P, _L, _I, _F, _P],
}

_counts_lock = threading.Lock()
# per thread: "counts", its own launches since it last reset them, and
# "recording", the launches of the capture it runs (None outside one)
_local = threading.local()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _own_counts() -> dict:
    counts = getattr(_local, "counts", None)
    if counts is None:
        counts = _local.counts = dict.fromkeys(launch_counts, 0)
    return counts


def reset_launch_counts() -> None:
    """Zero the shared counts and the calling thread's own."""
    with _counts_lock:
        for name in launch_counts:
            launch_counts[name] = 0
    _local.counts = dict.fromkeys(launch_counts, 0)


def thread_launch_counts() -> dict:
    """The launches the calling thread made since it last called
    :func:`reset_launch_counts` (a copy)."""
    return dict(_own_counts())


def count_launch(name: str, n: int = 1) -> None:
    """Count ``n`` launches of kernel ``name``; inside a capture on this
    thread, record them for the graph's replays instead, since a capture
    launches nothing."""
    recording = getattr(_local, "recording", None)
    if recording is not None:
        recording[name] = recording.get(name, 0) + n
        return
    with _counts_lock:
        launch_counts[name] += n
    _own_counts()[name] += n


def add_launch_counts(delta) -> None:
    """Add a graph's captured launches (kernel name -> count) on a replay."""
    for name, n in delta.items():
        count_launch(name, n)


@contextlib.contextmanager
def recording_launches():
    """``with recording_launches() as rec:`` — the launches counted on this
    thread inside the block go to ``rec`` (kernel name -> count), not to
    the counts: what a capture records."""
    if getattr(_local, "recording", None) is not None:
        raise RuntimeError("a capture is already recording on this thread")
    _local.recording = rec = {}
    try:
        yield rec
    finally:
        _local.recording = None


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def set_build_dir(path) -> None:
    """Build into and load from ``path`` (``CompilationConfig.cache_dir``).
    The directory is the process's, as the library is: the first request
    fixes it, and so does loading the library; a request for another
    directory after that raises."""
    global _build_dir, _build_dir_fixed
    path = Path(path).resolve()
    with _lock:
        if _build_dir_fixed and path != _build_dir:
            raise ValueError(f"the kernels' build directory is {_build_dir} for this process "
                             f"(named by an earlier cache_dir, or the library is loaded from "
                             f"it); cache_dir {str(path)!r} cannot change it")
        _build_dir, _build_dir_fixed = path, True


def library_path(extra_flags=()) -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + list(extra_flags)).encode())
    return _build_dir / f"libsfast_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of the first
    that fails, else print what they said."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]  # waits for every process
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{text}")
    said = "".join(o for o in outs if o.strip())
    if said:
        print(said, end="", flush=True)


def build(extra_flags=()) -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists.

    Returns its path.  ``extra_flags`` go to every compile as given (for
    example ``["-Xptxas", "-v"]``, whose report is printed)."""
    out = library_path(extra_flags)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sorted(SRC_DIR.glob("*.cu"))
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        _run_all([
            [nvcc] + NVCC_FLAGS + list(extra_flags) + ["-c", str(src), "-o", str(obj)]
            for src, obj in zip(srcs, objs)
        ])
        _run_all([[nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp)] + [str(o) for o in objs]])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def load(path: Path) -> ctypes.CDLL:
    """The kernel library at ``path``, its entry points typed."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sfast_error_string.argtypes = [ctypes.c_int]
    lib.sfast_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, _build_dir_fixed
    with _lock:
        if _lib is None:
            _lib = load(build())
            _build_dir_fixed = True
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().sfast_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as the C interface takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


class NoBackward(torch.autograd.Function):
    """A kernel launch as autograd records it: the forward returns
    ``launch(*inputs)``, the backward raises."""

    @staticmethod
    def forward(ctx, kernel, launch, *inputs):
        ctx.kernel = kernel
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"{ctx.kernel}: the hand-written CUDA kernel has no backward, so autograd cannot "
            "differentiate through it (neither can the JAX package differentiate its Pallas "
            "counterpart: pallas_call has no JVP rule). To train, send every op to its plain "
            "PyTorch version with CompilationConfig(enable_kernels=False).")


def no_backward(kernel: str):
    """Decorator for the launch wrapper of kernel ``kernel``: where autograd
    would record the call, it runs as the forward of :class:`NoBackward`, so
    that a backward pass through the kernel raises instead of losing the
    gradient.  Tensors are found in the arguments' tuples too (K6's
    ``KernelInputs``), and the result keeps its structure."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not torch.is_grad_enabled():
                return fn(*args, **kwargs)
            leaves, spec = pytree.tree_flatten((args, kwargs))
            if not any(isinstance(t, torch.Tensor) and t.requires_grad
                       and t.device.type != "cpu" for t in leaves):
                return fn(*args, **kwargs)  # the CPU's plain versions keep their gradients
            out_spec = []

            def launch(*leaves):
                a, kw = pytree.tree_unflatten(list(leaves), spec)
                out, s = pytree.tree_flatten(fn(*a, **kw))
                out_spec.append(s)
                return tuple(out)

            out = NoBackward.apply(kernel, launch, *leaves)
            return pytree.tree_unflatten(list(out), out_spec[0])

        return wrapper

    return wrap
