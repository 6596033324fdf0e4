"""Per-row int8 quantization on the GPU (``csrc/qpack.cu``).

Replaces the Pallas kernels ``repro/kernels/qpack.py:qpack`` and
``:qunpack``: the payload stage of the compressed tensor-parallel reduction
(``parallel/compressed.py``).  A CPU tensor goes to the plain version in
``ref``; a CUDA tensor always launches the kernel.

The serve path calls both at the decode shape, a few kilobytes, where the
time of a call is the host's: each checks what guards memory (dtype,
contiguity, device, shape) in one expression on the fast path, and reports
which check failed only when one did.
"""

from __future__ import annotations

import torch

from . import ref
from ._build import call

__all__ = ["qpack", "qunpack"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(t: torch.Tensor, what: str, dims: tuple, dtypes) -> None:
    if t.dim() not in dims or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {'/'.join(map(str, dims))}"
                         f"-D tensor of {[str(d) for d in dtypes]}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def _qpack_other(x: torch.Tensor, zero_scale: float):
    """``qpack`` of what its fast path does not take: a CPU tensor goes to
    the plain version; anything else raises the error of the first check
    it fails."""
    _check(x, "qpack", (2,), _DTYPE_CODE)
    if x.shape[1] == 0:
        raise ValueError("qpack: a row needs at least one column")
    if x.is_cpu:
        return ref.qpack(x, zero_scale)
    raise ValueError(f"qpack: unsupported device {x.device}")


def qpack(x: torch.Tensor, zero_scale: float = 0.0):
    """``x`` (R, C) float32/bf16 -> (q int8 (R, C), scale float32 (R, 1)),
    ``scale = amax * float32(1/127)`` per row, with subnormal elements
    and scales flushed to 0 as XLA flushes them.  A row left without a
    scale follows the reference ``zero_scale`` stands for (``ref.qpack``):
    0, the Pallas kernel's, where a zero scale stores 0 and q = 0; 1.0, the
    compressed reduction's, where a zero amax stores 1.0 and q = 0.  A row
    holding a NaN scales NaN, one holding an infinity inf, and its q are 0."""
    shape = x.shape
    code = _DTYPE_CODE.get(x.dtype)
    if (code is None or len(shape) != 2 or not shape[1] or not x.is_cuda
            or not x.is_contiguous()):
        return _qpack_other(x, zero_scale)
    rows, cols = shape
    q = x.new_empty(shape, dtype=torch.int8)
    scale = x.new_empty((rows, 1), dtype=torch.float32)
    if rows:
        call(qpack, "rt_qpack", x.get_device(), x.data_ptr(), q.data_ptr(),
             scale.data_ptr(), rows, cols, code, float(zero_scale))
    return q, scale


def _qunpack_error(q: torch.Tensor, scale: torch.Tensor, dtype) -> None:
    """Raise the error of the first check that ``qunpack``'s arguments fail
    (a CPU tensor beside one on a GPU, at the latest)."""
    _check(q, "qunpack", (2, 3), (torch.int8,))
    _check(scale, "qunpack scale", (q.dim(),), (torch.float32,))
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"qunpack: dtype must be float32 or bfloat16, got {dtype}")
    *lead, rows, _ = q.shape
    if tuple(scale.shape) != (*lead, rows, 1) or scale.device != q.device:
        raise ValueError(f"qunpack: scale {tuple(scale.shape)} on {scale.device} "
                         f"does not match q {tuple(q.shape)} on {q.device}")
    if lead and lead[0] == 0:
        raise ValueError("qunpack: no payload to sum (k = 0)")
    raise ValueError(f"qunpack: unsupported devices {q.device} and {scale.device}")


def qunpack(q: torch.Tensor, scale: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q`` int8 (R, C) with ``scale`` (R, 1) -> ``q * scale`` as ``dtype``;
    or k stacked payloads, ``q`` (k, R, C) with ``scale`` (k, R, 1) ->
    their sum over k in float32, cast to ``dtype``."""
    shape = q.shape
    code = _DTYPE_CODE.get(dtype)
    if (code is None or q.dtype != torch.int8 or scale.dtype != torch.float32
            or len(shape) not in (2, 3) or scale.shape != (*shape[:-1], 1)
            or shape[0] == 0 and len(shape) == 3
            or not (q.is_contiguous() and scale.is_contiguous())
            or q.get_device() != scale.get_device()):
        _qunpack_error(q, scale, dtype)
    if q.is_cuda:
        rows, cols = shape[-2:]
        out = q.new_empty((rows, cols), dtype=dtype)
        if rows and cols:
            call(qunpack, "rt_qunpack", q.get_device(), q.data_ptr(),
                 scale.data_ptr(), out.data_ptr(), shape[0] if len(shape) == 3 else 1,
                 rows, cols, code)
        return out
    if q.is_cpu and scale.is_cpu:
        return ref.qunpack(q, scale, dtype)
    _qunpack_error(q, scale, dtype)


qpack.launches = 0
qunpack.launches = 0
