"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each ``.cu`` compiles with its own ``nvcc`` process, all started together,
into an object for ``sm_90a``; one more ``nvcc`` links them into a shared
library with a plain C interface, which ``ctypes`` loads.  The library is
named by a hash of the sources and flags and lives in ``build/`` beside
this module (listed in ``.gitignore``), so a checkout builds it at first
use and an edited source never loads a stale build.

Nothing here runs at import: :func:`library` builds on its first call.

:func:`call` is every wrapper's launch path.  At the main path's small
shapes a call's time is the host's, so it does little: the launchers are
bound once when the library loads, the current device and stream come from
PyTorch's raw getters (no ``Stream`` object, no device guard unless the
tensor lies on another device than the current one), and the launch
counters take a lock of their own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ["library", "call", "map_elements", "current_stream", "check_bytes",
           "output", "require_aligned", "BUILD_DIR"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# name -> argtypes of the launcher's arguments before its last, the stream
# (a void* or cudaStream_t); every launcher returns a CUDA error code as int.
# tests/test_torch_launch.py holds these against the sources' extern "C"
# declarations.
_SIGNATURES = {
    "rt_bitshuffle": [_P, _P, _I64, _I, _I64],
    "rt_bitunshuffle": [_P, _P, _I64, _I, _I64],
    "rt_byteshuffle": [_P, _P, _I64, _I, _I64],
    "rt_byteunshuffle": [_P, _P, _I64, _I, _I64],
    "rt_delta": [_P, _P, _I64, _I, _I64],
    "rt_undelta": [_P, _P, _I64, _I, _I64, _P, _I64],
    "rt_zigzag": [_P, _P, _I64, _I, _I64],
    "rt_unzigzag": [_P, _P, _I64, _I, _I64],
    "rt_qpack": [_P, _P, _P, _I64, _I64, _I, _F],
    "rt_qunpack": [_P, _P, _P, _I64, _I64, _I64, _I],
    "rt_selective_scan": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I64,
                          _I64, _I],
    "rt_flash_attention": [_P] * 6 + [_I64] * 5 + [_I, _I] + [_I64] * 11 + [_F],
}

_lock = threading.Lock()           # the build and the load
_count_lock = threading.Lock()     # launch counters: wrappers run on several threads
_lib = None
_fns: dict = {}                    # symbol -> bound launcher, filled by library()
build_seconds = None      # wall time of this process's build (None: cached)

# the calling thread's current device, and the raw handle of a device's
# current stream: PyTorch's own getters where the build has them, else its
# public API (the same answers, each a few microseconds slower)
_current_device = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *_ARCH, *_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib = Path(tmp) / target.name
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(lib),
                               *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(lib, target)   # atomic: a concurrent loader sees all or nothing


def library():
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libkernels-{_digest()}.so"
            if not target.exists():
                t0 = time.perf_counter()
                _build(target)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = [*argtypes, _P], ctypes.c_int
                _fns[name] = fn
            lib.rt_error_string.argtypes = [_I]
            lib.rt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_bytes(buf: torch.Tensor, what: str) -> None:
    """A basket's bytes: a contiguous 1-D uint8 tensor on the CPU or a GPU."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 1-D uint8 tensor, "
                         f"got {buf.dtype} {tuple(buf.shape)}")
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {buf.device}")


def output(out, size: int, like: torch.Tensor, what: str) -> torch.Tensor:
    """``out`` checked against the result's size, or a new tensor."""
    if out is None:
        return torch.empty(size, dtype=torch.uint8, device=like.device)
    check_bytes(out, what)
    if out.numel() != size or out.device != like.device:
        raise ValueError(f"{what}: out must hold {size} bytes on {like.device}, "
                         f"got {out.numel()} on {out.device}")
    return out


def require_aligned(itemsize: int, what: str, *tensors: torch.Tensor) -> None:
    """The kernels move whole elements: their element-side pointers must be
    multiples of ``itemsize``."""
    for t in tensors:
        if t.data_ptr() % itemsize:
            raise ValueError(f"{what}: pointer not aligned to {itemsize} bytes")


def current_stream(index: int) -> int:
    """The raw handle of the calling thread's current stream on CUDA device
    ``index``."""
    return _raw_stream(index)


def call(wrapper, symbol: str, index: int, *args, stream: int | None = None,
         counted: bool = True) -> None:
    """Run launcher ``symbol`` with ``args`` on CUDA device ``index``, on
    ``stream`` (default: that device's current stream); raise on a CUDA
    error, and add one to ``wrapper.launches`` when ``counted`` (a kernel
    ran)."""
    fn = _fns.get(symbol)
    if fn is None:
        library()
        fn = _fns[symbol]
    if stream is None:
        stream = _raw_stream(index)
    if index == _current_device():
        code = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            code = fn(*args, stream)
    if code:
        msg = _lib.rt_error_string(code).decode()
        raise RuntimeError(f"{symbol} failed: {msg} (CUDA error {code})")
    if counted:
        with _count_lock:
            wrapper.launches += 1


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous byte tensors share any byte of memory."""
    if a.device != b.device or not a.numel() or not b.numel():
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() and b0 < a0 + a.numel()


def map_elements(wrapper, symbol: str, plain, buf: torch.Tensor, itemsize: int,
                 out: Optional[torch.Tensor]) -> torch.Tensor:
    """A preconditioner that maps a basket's elements to as many of the same
    width, its tail passed through (delta, zigzag, unzigzag; the vector path
    of ``csrc/vector_map.cuh``): ``plain`` for a CPU tensor, else launcher
    ``symbol``, one launch a call.  ``out`` may not overlap ``buf``: the
    kernels read through the non-coherent cache, and the delta reads each
    element's neighbour from another thread."""
    what = wrapper.__name__
    check_bytes(buf, what)
    dst = output(out, buf.numel(), buf, what)
    if _overlaps(buf, dst):
        raise ValueError(f"{what}: out overlaps the input")
    if buf.device.type == "cpu":
        return dst.copy_(plain(buf, itemsize))
    require_aligned(itemsize, what, buf, dst)
    if buf.numel():
        n, tail = divmod(buf.numel(), itemsize)
        call(wrapper, symbol, buf.get_device(), buf.data_ptr(), dst.data_ptr(),
             n, itemsize, tail)
    return dst
