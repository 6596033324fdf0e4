"""Plain PyTorch versions of the port's kernels.

Each preconditioner takes one basket's bytes as a 1-D ``uint8`` tensor and
returns a new ``uint8`` tensor, with exactly the per-basket semantics of
``core/precond.py``: ``len % itemsize`` tail bytes pass through, bit planes
are padded to ``ceil(N/8)`` bytes with zero bits, delta restarts at the
basket's first element, and delta and zigzag wrap mod ``2**(8*itemsize)``.  ``qpack``/``qunpack`` are
the per-row int8 quantizer of ``repro/kernels/ref.py:qpack_ref`` and its
inverse, rounding at the same steps.

They run on any device.  The kernel wrappers call them only for CPU
tensors; ``chip_smoke.py`` runs them on the card to check the kernels.
"""

from __future__ import annotations

import torch

__all__ = ["bitshuffle", "bitunshuffle", "byteshuffle", "byteunshuffle",
           "delta", "undelta", "zigzag", "unzigzag", "qpack", "qunpack"]

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


def zigzag(buf: torch.Tensor, itemsize: int) -> torch.Tensor:
    """(v << 1) ^ (v >> (8*itemsize - 1)) on the signed view: small
    magnitudes of either sign become small unsigned values."""
    n = buf.numel() // itemsize
    body, tail = _split(buf, n * itemsize)
    if n == 0:
        return tail.clone()
    v = _aligned(body, itemsize).view(_SIGNED[itemsize])
    out = (v << 1) ^ (v >> (8 * itemsize - 1))
    return torch.cat([out.view(torch.uint8), tail])


def unzigzag(buf: torch.Tensor, itemsize: int) -> torch.Tensor:
    """(u >> 1) ^ -(u & 1), inverting :func:`zigzag`; ``u >> 1`` is the
    unsigned shift, the signed one with the sign bit masked off."""
    n = buf.numel() // itemsize
    body, tail = _split(buf, n * itemsize)
    if n == 0:
        return tail.clone()
    sdt = _SIGNED[itemsize]
    v = _aligned(body, itemsize).view(sdt)
    out = ((v >> 1) & torch.iinfo(sdt).max) ^ -(v & 1)
    return torch.cat([out.view(torch.uint8), tail])


def qpack(x: torch.Tensor, zero_scale: float = 0.0):
    """(R, C) float -> (q int8 (R, C), scale float32 (R, 1)): scale =
    amax * float32(1/127), q = clip(round_half_even(x / scale), -127, 127).
    The scale is a product, not ``amax / 127``, because that is what the
    reference computes once XLA has compiled it (it rewrites a division by
    a constant); ``x / scale`` stays a true division.

    Subnormal elements and a subnormal scale count as 0, as in XLA (on the
    CPU and the TPU alike).  A row left without a scale follows the
    reference that ``zero_scale`` stands for.  With 0, the Pallas kernel and
    ``qpack_ref``: a row whose scale is 0 stores 0 and q = 0.  With any
    other value, ``_quantize_rows``, which tests the amax: a row whose amax
    is 0 stores ``zero_scale`` and q = 0; one whose scale alone flushed
    stores 0 and divides by it, so q = sign(x) * 127, and 0 where x is 0.
    A NaN quotient converts to 0."""
    xf = x.float()
    tiny = torch.finfo(torch.float32).tiny
    xf = torch.where(xf.abs() < tiny, 0.0, xf)
    amax = xf.abs().amax(dim=1, keepdim=True)
    # the Python float is rounded to float32, the op's type: XLA's constant
    s = amax * (1.0 / 127.0)
    s = torch.where(s < tiny, 0.0, s)
    zero = (s if zero_scale == 0 else amax) == 0
    q = torch.round(xf / torch.where(zero, 1.0, s)).clamp_(-127, 127)
    q = torch.nan_to_num_(q, nan=0.0)
    return q.to(torch.int8), torch.where(zero, zero_scale, s)


def qunpack(q: torch.Tensor, scale: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q (R, C) * scale (R, 1) as ``dtype``; for (k, R, C) payloads the sum
    over k of each product, in float32 and in k order."""
    if q.dim() == 2:
        q, scale = q[None], scale[None]
    acc = q[0].float() * scale[0]
    for j in range(1, q.shape[0]):
        acc = acc + q[j].float() * scale[j]
    return acc.to(dtype)
