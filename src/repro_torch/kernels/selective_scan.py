"""The Mamba-1 selective scan on the GPU (``csrc/selective_scan.cu``).

Replaces no Pallas kernel: the reference runs the scan as
``lax.associative_scan`` (``repro/models/ssm.py``), which the port's eager
path reproduces (``models/ssm.py:_chunk_scan``).  That eager scan is the
plain version: ``models/ssm.py`` takes it for a tensor on the CPU, under
autograd, for fake tensors and for what the kernel is not built for (an x
type outside ``DTYPES``, a d_state outside ``STATES``), and this wrapper for
a real CUDA tensor with autograd off, one launch a call over the whole
sequence.  The wrapper takes CUDA tensors alone and raises on anything
else; its checks (dtypes, shapes, strides, one device) are one ordered
list, :func:`refusal`.
"""

from __future__ import annotations

import torch

from ._build import call

__all__ = ["selective_scan", "refusal", "DTYPES", "STATES"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
DTYPES = tuple(_DTYPE_CODE)  # x's types the kernel is built for
STATES = (8, 16)             # the d_state sizes the kernel is built for: jamba's and
                             # its reduced config's
_MAX_BATCH = 65535           # the grid's y


def refusal(dt, x, bc, a, h0, cuda: bool = True) -> str | None:
    """Why the kernel cannot take these arguments (the first check they
    fail), or None.  ``cuda=False`` leaves the device check out."""
    if x.dim() != 3 or x.dtype not in _DTYPE_CODE:
        return (f"x must be (B, S, d_inner) float32 or bfloat16, got {x.dtype} "
                f"{tuple(x.shape)}")
    B, S, di = x.shape
    n = a.shape[-1] if a.dim() == 2 else -1
    for what, t, shape, dtype in (("a", a, (di, n), torch.float32),
                                  ("dt", dt, (B, S, di), torch.float32),
                                  ("bc", bc, (B, S, 2 * n), x.dtype),
                                  ("h0", h0, (B, di, n), torch.float32)):
        if t.shape != shape or t.dtype != dtype:
            return f"{what} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
    if n not in STATES:
        return f"d_state {n} is none of {STATES}"
    if B > _MAX_BATCH:
        return f"at most {_MAX_BATCH} batch rows, got {B}"
    if bc.stride(2) != 1:
        return "bc's last dim must have unit stride"
    if not (dt.is_contiguous() and x.is_contiguous() and a.is_contiguous()
            and h0.is_contiguous()):
        return "dt, x, a and h0 must be contiguous"
    if cuda and not (x.is_cuda and dt.get_device() == bc.get_device() == a.get_device()
                     == h0.get_device() == x.get_device()):
        return (f"every tensor must lie on one CUDA device, got {dt.device}, "
                f"{x.device}, {bc.device}, {a.device}, {h0.device}")
    return None


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bc: torch.Tensor,
                   a: torch.Tensor, h0: torch.Tensor):
    """``h = exp(dt * a) * h + (dt * x) * B``, ``y = C . h`` over the sequence.

    dt (B, S, d_inner) float32, after the softplus and bias; x (B, S,
    d_inner) float32 or bf16; bc (B, S, 2 n) of x's type, B then C in the
    last dim, which has unit stride (the other two may be any); a (d_inner,
    n) float32, ``-exp(a_log)``; h0 (B, d_inner, n) float32.  Returns y (B,
    S, d_inner) float32 and the last state (B, d_inner, n) float32."""
    why = refusal(dt, x, bc, a, h0)
    if why is not None:
        raise ValueError(f"selective_scan: {why}")
    B, S, di = x.shape
    y = dt.new_empty((B, S, di))
    h = h0.new_empty(h0.shape)
    call(selective_scan, "rt_selective_scan", x.get_device(), dt.data_ptr(),
         x.data_ptr(), bc.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
         h.data_ptr(), B, S, di, a.shape[1], bc.stride(0), bc.stride(1),
         _DTYPE_CODE[x.dtype])
    return y, h


selective_scan.launches = 0
