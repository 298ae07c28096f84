"""Build, load and count the hand-written CUDA kernels of csrc/.

Each source is compiled on first use by `nvcc` for sm_90a into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), named by a hash of the source and of the shared headers
(csrc/*.cuh) and loaded with ctypes as a PyDLL (the entry points only
enqueue launches, so they keep the interpreter lock rather than pay to
release and take it back); kernels that share a source share its
library. Every C entry point launches on the stream it is given and
returns cudaGetLastError(); `check` raises when that is not 0. `entry`
resolves an entry point and sets its ctypes signature once, so a
wrapper's call costs its argument checks, the pointer conversions and
the ctypes call.

`use` is the one rule by which every wrapper chooses between its kernel
and its plain twin: a CUDA tensor takes the kernel, any other tensor the
twin. `plain()` sends the card to the twins too, for checks that hold a
kernel path to the plain one. An autograd Function decides in its forward,
keeps the decision on its ctx, and runs its backward `following` it.

`launches` counts, per kernel, the calls that launched it. Each wrapper
adds one where it launches, and nowhere else, so a caller can reset the
counts, drive a path and read which kernels it went through.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "adgs_tpu_torch"

# kernel -> source file in csrc/
SOURCES = {
    "compact_live": "compact.cu",
    "expand": "expand.cu",
    "composite_fwd": "composite.cu",
    "composite_bwd": "composite_bwd.cu",
    "segment_sum": "segment_sum.cu",
    "pad_lanes": "pad_lanes.cu",
    "grid_sample": "grid_sample.cu",
    "grid_sample_bwd": "grid_sample_bwd.cu",
    "lab_cm": "lab_rowmajor.cu",
    "lab_rm": "lab_rowmajor.cu",
    "adam": "adam.cu",
    "preprocess": "preprocess.cu",
    "preprocess_bwd": "preprocess.cu",
    "deform": "deform.cu",
    "deform_bwd": "deform.cu",
}

launches = {name: 0 for name in SOURCES}

# depth of nested plain() blocks: process-wide, not thread-local, since
# autograd runs a CUDA backward on a thread of its own
_plain = 0
_plain_lock = threading.Lock()
# the decision a backward running on this thread follows (`following`)
_backward = threading.local()

_libs: dict[str, ctypes.PyDLL] = {}
_entries: dict[tuple[str, str], object] = {}
# argument codes of `entry` signatures
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong}


def use(t: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel on operand t (else it runs
    its plain twin): t is on the card and no plain() block is open, or,
    inside `following`, its forward took the kernels."""
    kernel = getattr(_backward, "kernel", None)
    return t.is_cuda and (not _plain if kernel is None else kernel)


@contextlib.contextmanager
def plain():
    """Every wrapper runs its plain twin inside the block, on the card
    too, in every thread of the process. Nests; the state before it comes
    back on exit, after an exception too."""
    global _plain
    with _plain_lock:
        _plain += 1
    try:
        yield
    finally:
        with _plain_lock:
            _plain -= 1


@contextlib.contextmanager
def following(kernel: bool):
    """Inside an autograd Function's backward: the wrappers take the
    kernels exactly when its forward did (`kernel`, kept on its ctx),
    whatever plain() says meanwhile."""
    before = getattr(_backward, "kernel", None)
    _backward.kernel = kernel
    try:
        yield
    finally:
        _backward.kernel = before


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(source: str) -> Path:
    h = hashlib.sha1((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def _start_build(source: str):
    """Start nvcc for one source unless its library is already built.
    Returns (process, temporary output, final path, log path) or None."""
    out = _lib_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(CSRC / source)]
    logf = open(log, "w")
    try:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT)
    finally:
        logf.close()
    return proc, tmp, out, log


def _finish_build(source: str, job) -> None:
    proc, tmp, out, log = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n" + log.read_text())
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every source, one nvcc each, all at once. Returns the wall
    seconds taken (0 when everything was already built)."""
    t0 = time.perf_counter()
    jobs = {src: _start_build(src) for src in dict.fromkeys(SOURCES.values())}
    for src, job in jobs.items():
        if job is not None:
            _finish_build(src, job)
    return time.perf_counter() - t0


def build_log(source: str) -> str:
    """The compiler's output for one source (ptxas register and
    shared-memory use)."""
    log = _lib_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.PyDLL:
    """The loaded library of one kernel, built first if needed."""
    source = SOURCES[name]
    lib = _libs.get(source)
    if lib is None:
        job = _start_build(source)
        if job is not None:
            _finish_build(source, job)
        lib = ctypes.PyDLL(str(_lib_path(source)))
        _libs[source] = lib
    return lib


def entry(name: str, symbol: str, signature: str):
    """The C function `symbol` of kernel `name`'s library, returning int,
    with one argument per letter of `signature` ("p" pointer or stream,
    "i" int, "q" long long); resolved and typed on the first call only."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [_CTYPES[c] for c in signature]
        _entries[(name, symbol)] = fn
    return fn


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of CUDA tensor t's
    device. torch.cuda.current_stream builds a Stream object first, which
    costs the host more than the launch it feeds."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple | None = None) -> None:
    """Validate a kernel argument before its pointer is passed (shape: a
    tuple)."""
    if (t.is_cuda and t.dtype == dtype and t.is_contiguous()
            and (shape is None or t.shape == shape)):
        return
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
