"""Build and load the hand-written CUDA kernels of ``sfast_tpu_torch/csrc``.

Counterpart of ``sfast_tpu/runtime/native_build.py``.  The kernels have a
plain C interface and are compiled with ``nvcc`` at first use, then loaded
with :mod:`ctypes` — no PyTorch headers, so a build takes seconds, not
minutes.  Each source compiles to an object in its own ``nvcc`` process,
all started together, and one more call links them into one library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -c csrc/<kernel>.cu -o <kernel>.o          # one per source, in parallel
    nvcc -shared -o build/sfast_tpu_torch/libsfast_kernels-<hash>.so *.o

The library lands in ``build/sfast_tpu_torch/`` under the checkout, named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing file.  Every C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises on anything
but 0.  Each kernel wrapper adds one to its entry of :data:`launch_counts`
where it launches, which lets a run show that its main path went through
the kernels.  A CUDA graph's replay launches without passing through the
wrappers, so ``runtime/tracing.py`` records the counts its capture made
and adds them on each replay (:func:`add_launch_counts`).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "sfast_tpu_torch"
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
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the build this process ran


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def add_launch_counts(delta) -> None:
    """Add a graph's captured launches (kernel name -> count) on a replay."""
    for name, n in delta.items():
        launch_counts[name] += n


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


def library_path(extra_flags=()) -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + list(extra_flags)).encode())
    return BUILD_DIR / f"libsfast_kernels-{h.hexdigest()[:16]}.so"


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
    global build_seconds
    out = library_path(extra_flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sorted(SRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
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
        build_seconds = time.perf_counter() - t0
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
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().sfast_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as the C interface takes it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
