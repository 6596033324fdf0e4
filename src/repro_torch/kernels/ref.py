"""Plain PyTorch versions of the preconditioner kernels.

Each function takes one basket's bytes as a 1-D ``uint8`` tensor and
returns a new ``uint8`` tensor, with exactly the per-basket semantics of
``core/precond.py``: ``len % itemsize`` tail bytes pass through, bit planes
are padded to ``ceil(N/8)`` bytes with zero bits, and delta restarts at the
basket's first element, mod ``2**(8*itemsize)``.

They run on any device.  The kernel wrappers call them only for CPU
tensors; ``chip_smoke.py`` runs them on the card to check the kernels.
"""

from __future__ import annotations

import torch

__all__ = ["bitshuffle", "bitunshuffle", "byteshuffle", "byteunshuffle",
           "delta", "undelta"]

# wraparound arithmetic runs in the signed type of the same width: the bits
# mod 2**k are those of the unsigned result, and torch covers signed types
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _split(buf: torch.Tensor, body_len: int):
    return buf[:body_len], buf[body_len:]


def _bit_weights(device) -> tuple[torch.Tensor, torch.Tensor]:
    shifts = torch.arange(8, dtype=torch.uint8, device=device)
    return shifts, (torch.ones(8, dtype=torch.int32, device=device)
                    << shifts.to(torch.int32))


def _pack_bits(bits: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(..., 8) 0/1 bytes -> (...) bytes, bit k from index k."""
    return (bits.to(torch.int32) * weights).sum(-1).to(torch.uint8)


def _aligned(t: torch.Tensor, itemsize: int) -> torch.Tensor:
    """``t`` itself when a ``view`` as ``itemsize``-byte elements is legal."""
    return t if t.storage_offset() % itemsize == 0 else t.clone()


def bitshuffle(buf: torch.Tensor, itemsize: int) -> torch.Tensor:
    n = buf.numel() // itemsize
    body, tail = _split(buf, n * itemsize)
    if n == 0:
        return tail.clone()
    shifts, weights = _bit_weights(buf.device)
    bits = (body.view(n, itemsize).unsqueeze(-1) >> shifts) & 1  # (N, I, 8)
    planes = bits.reshape(n, 8 * itemsize).t()                   # (8I, N)
    pad = -n % 8
    if pad:
        planes = torch.cat([planes, planes.new_zeros(8 * itemsize, pad)], 1)
    packed = _pack_bits(planes.reshape(8 * itemsize, -1, 8), weights)
    return torch.cat([packed.reshape(-1), tail])


def bitunshuffle(buf: torch.Tensor, itemsize: int, nbytes: int) -> torch.Tensor:
    """Invert :func:`bitshuffle`; ``nbytes`` is the original body length
    (the basket's length less its tail)."""
    n = nbytes // itemsize
    per_plane = (n + 7) // 8
    body, tail = _split(buf, 8 * itemsize * per_plane)
    if n == 0:
        return tail.clone()
    shifts, weights = _bit_weights(buf.device)
    bits = (body.view(8 * itemsize, per_plane).unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(8 * itemsize, 8 * per_plane)[:, :n].t()  # (N, 8I)
    elems = _pack_bits(bits.reshape(n, itemsize, 8), weights)    # (N, I)
    return torch.cat([elems.reshape(-1), tail])


def byteshuffle(buf: torch.Tensor, itemsize: int) -> torch.Tensor:
    n = buf.numel() // itemsize
    body, tail = _split(buf, n * itemsize)
    return torch.cat([body.view(n, itemsize).t().reshape(-1), tail])


def byteunshuffle(buf: torch.Tensor, itemsize: int) -> torch.Tensor:
    n = buf.numel() // itemsize
    body, tail = _split(buf, n * itemsize)
    return torch.cat([body.view(itemsize, n).t().reshape(-1), tail])


def delta(buf: torch.Tensor, itemsize: int) -> torch.Tensor:
    n = buf.numel() // itemsize
    body, tail = _split(buf, n * itemsize)
    if n == 0:
        return tail.clone()
    v = _aligned(body, itemsize).view(_SIGNED[itemsize])
    out = v.clone()
    out[1:] = v[1:] - v[:-1]
    return torch.cat([out.view(torch.uint8), tail])


def undelta(buf: torch.Tensor, itemsize: int) -> torch.Tensor:
    n = buf.numel() // itemsize
    body, tail = _split(buf, n * itemsize)
    if n == 0:
        return tail.clone()
    sdt = _SIGNED[itemsize]
    v = _aligned(body, itemsize).view(sdt)
    # cumsum of a narrow int type accumulates in int64; casting back keeps
    # the low bits, i.e. the sum mod 2**k
    out = torch.cumsum(v, 0).to(sdt)
    return torch.cat([out.view(torch.uint8), tail])
