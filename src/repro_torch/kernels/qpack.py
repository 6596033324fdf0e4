"""Per-row int8 quantization on the GPU (``csrc/qpack.cu``).

Replaces the Pallas kernels ``repro/kernels/qpack.py:qpack`` and
``:qunpack``: the payload stage of the compressed tensor-parallel reduction
(``parallel/compressed.py``).  A CPU tensor goes to the plain version in
``ref``; a CUDA tensor always launches the kernel.
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


def qpack(x: torch.Tensor, zero_scale: float = 0.0):
    """``x`` (R, C) float32/bf16 -> (q int8 (R, C), scale float32 (R, 1)),
    ``scale = amax * float32(1/127)`` per row; a row whose scale is 0 stores
    ``zero_scale`` (0 as in the Pallas kernel, 1.0 in the compressed
    reduction) and q = 0."""
    _check(x, "qpack", (2,), _DTYPE_CODE)
    rows, cols = x.shape
    if cols == 0:
        raise ValueError("qpack: a row needs at least one column")
    if x.device.type == "cpu":
        return ref.qpack(x, zero_scale)
    q = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows:
        call(qpack, "rt_qpack", x.device, x.data_ptr(), q.data_ptr(),
             scale.data_ptr(), rows, cols, _DTYPE_CODE[x.dtype],
             float(zero_scale))
    return q, scale


def qunpack(q: torch.Tensor, scale: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q`` int8 (R, C) with ``scale`` (R, 1) -> ``q * scale`` as ``dtype``;
    or k stacked payloads, ``q`` (k, R, C) with ``scale`` (k, R, 1) ->
    their sum over k in float32, cast to ``dtype``."""
    _check(q, "qunpack", (2, 3), (torch.int8,))
    _check(scale, "qunpack scale", (q.dim(),), (torch.float32,))
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"qunpack: dtype must be float32 or bfloat16, got {dtype}")
    *lead, rows, cols = q.shape
    if tuple(scale.shape) != (*lead, rows, 1) or scale.device != q.device:
        raise ValueError(f"qunpack: scale {tuple(scale.shape)} on {scale.device} "
                         f"does not match q {tuple(q.shape)} on {q.device}")
    k = lead[0] if lead else 1
    if k == 0:
        raise ValueError("qunpack: no payload to sum (k = 0)")
    if q.device.type == "cpu":
        return ref.qunpack(q, scale, dtype)
    out = torch.empty((rows, cols), dtype=dtype, device=q.device)
    if out.numel():
        call(qunpack, "rt_qunpack", q.device, q.data_ptr(), scale.data_ptr(),
             out.data_ptr(), k, rows, cols, _DTYPE_CODE[dtype])
    return out


qpack.launches = 0
qunpack.launches = 0
