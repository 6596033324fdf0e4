"""BitShuffle of one basket on the GPU (``csrc/bitshuffle.cu``).

Replaces the Pallas kernels ``repro/kernels/bitshuffle.py:bitshuffle`` and
``:bitunshuffle`` with the container's semantics (any element count, planes
padded to ``ceil(N/8)`` bytes, tail passed through).  A CPU tensor goes to
the plain version in ``ref``; a CUDA tensor always launches the kernel.

Each call is one launch, its tail included.  A warp owns a tile of
``TILE_ELEMS`` elements and transposes them in registers; :func:`grid` is
the launcher's rule for its blocks.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from ._build import call, check_bytes, output, require_aligned

__all__ = ["bitshuffle", "bitunshuffle", "grid", "TILE_ELEMS"]

TILE_ELEMS = 1024          # a warp's tile: csrc/bitshuffle.cu kTileElems


def grid(n: int) -> int:
    """Blocks of a launch over ``n`` elements, one warp each: block ``b``
    owns tile ``b``, elements ``[b * TILE_ELEMS, (b + 1) * TILE_ELEMS)``;
    a tail alone takes one block."""
    return max(1, -(-n // TILE_ELEMS))


def _planes(n: int, itemsize: int) -> int:
    return 8 * itemsize * ((n + 7) // 8)


def bitshuffle(buf: torch.Tensor, itemsize: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Basket bytes -> ``8*itemsize`` bit planes of ``ceil(N/8)`` bytes,
    then the ``len % itemsize`` tail."""
    check_bytes(buf, "bitshuffle")
    n, tail = divmod(buf.numel(), itemsize)
    dst = output(out, _planes(n, itemsize) + tail, buf, "bitshuffle")
    if buf.device.type == "cpu":
        return dst.copy_(ref.bitshuffle(buf, itemsize))
    require_aligned(itemsize, "bitshuffle", buf)
    if buf.numel():
        call(bitshuffle, "rt_bitshuffle", buf.get_device(), buf.data_ptr(),
             dst.data_ptr(), n, itemsize, tail)
    return dst


def bitunshuffle(buf: torch.Tensor, itemsize: int, nbytes: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Invert :func:`bitshuffle`.  ``nbytes`` is the original length less
    its tail (the planes' padding hides the element count)."""
    check_bytes(buf, "bitunshuffle")
    n = nbytes // itemsize
    tail = buf.numel() - _planes(n, itemsize)
    if not 0 <= tail < itemsize or nbytes % itemsize:
        raise ValueError(f"bitunshuffle: {buf.numel()} bytes cannot hold the "
                         f"planes of {nbytes} bytes of {itemsize}-byte elements "
                         f"and a tail shorter than an element")
    dst = output(out, n * itemsize + tail, buf, "bitunshuffle")
    if buf.device.type == "cpu":
        return dst.copy_(ref.bitunshuffle(buf, itemsize, nbytes))
    require_aligned(itemsize, "bitunshuffle", dst)
    if buf.numel():
        call(bitunshuffle, "rt_bitunshuffle", buf.get_device(), buf.data_ptr(),
             dst.data_ptr(), n, itemsize, tail)
    return dst


bitshuffle.launches = 0
bitunshuffle.launches = 0
