"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each ``.cu`` compiles with its own ``nvcc`` process, all started together,
into an object for ``sm_90a``; one more ``nvcc`` links them into a shared
library with a plain C interface, which ``ctypes`` loads.  The library is
named by a hash of the sources and flags and lives in ``build/`` beside
this module (listed in ``.gitignore``), so a checkout builds it at first
use and an edited source never loads a stale build.

Nothing here runs at import: :func:`library` builds on its first call.
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

import torch

__all__ = ["library", "call", "launch", "check_bytes", "output",
           "require_aligned", "BUILD_DIR"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# name -> argtypes; every launcher returns a cudaError_t as int
_SIGNATURES = {
    "rt_bitshuffle": [_P, _P, _I64, _I, _I64, _P],
    "rt_bitunshuffle": [_P, _P, _I64, _I, _I64, _P],
    "rt_byteshuffle": [_P, _P, _I64, _I, _I64, _P],
    "rt_byteunshuffle": [_P, _P, _I64, _I, _I64, _P],
    "rt_delta": [_P, _P, _I64, _I, _I64, _P],
    "rt_undelta": [_P, _P, _I64, _I, _I64, _P, _P],
    "rt_qpack": [_P, _P, _P, _I64, _I64, _I, _F, _P],
    "rt_qunpack": [_P, _P, _P, _I64, _I64, _I64, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of this process's build (None: cached)


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
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            lib.rt_undelta_tiles.argtypes = [_I64]
            lib.rt_undelta_tiles.restype = _I64
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


def call(wrapper, symbol: str, device: torch.device, *args,
         counted: bool = True) -> None:
    """Run launcher ``symbol`` with ``args`` on the current stream of
    ``device``, raise on a CUDA error, and add one to ``wrapper.launches``
    when ``counted`` (a kernel ran)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, symbol)(*args, stream)
    if code:
        msg = lib.rt_error_string(code).decode()
        raise RuntimeError(f"{symbol} failed: {msg} (cudaError {code})")
    if counted:
        with _lock:       # wrappers run on several threads
            wrapper.launches += 1


def launch(wrapper, symbol: str, src: torch.Tensor, dst: torch.Tensor,
           n: int, itemsize: int, tail: int, *extra) -> None:
    """A preconditioner launcher over ``n`` elements and ``tail`` bytes from
    ``src`` into ``dst``; counted when a kernel ran (``n > 0``: a tail
    alone is a plain copy)."""
    call(wrapper, symbol, src.device, src.data_ptr(), dst.data_ptr(), n,
         itemsize, tail, *extra, counted=n > 0)
