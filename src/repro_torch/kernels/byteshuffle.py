"""Byte Shuffle of one basket on the GPU (``csrc/byteshuffle.cu``).

Replaces the Pallas kernel ``repro/kernels/byteshuffle.py:_t_kernel`` (as
``byteshuffle`` and ``byteunshuffle``) with the container's semantics (any
element count, tail passed through).  A CPU tensor goes to the plain
version in ``ref``; a CUDA tensor always launches the kernel.

Each call is one launch, its tail included.  A warp owns a tile of
``TILE_ELEMS`` elements and transposes its bytes in registers; :func:`grid`
is the launcher's rule for its blocks.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from ._build import call, check_bytes, output, require_aligned

__all__ = ["byteshuffle", "byteunshuffle", "grid", "TILE_ELEMS"]

TILE_ELEMS = 512           # a warp's tile: csrc/byteshuffle.cu kTileElems
WIDE_WARPS = 4             # warps a block from WIDE_TILES tiles on: kWideWarps
WIDE_TILES = 2 * 132       # two tiles an SM of an H100 SXM: kWideTiles


def grid(n: int, itemsize: int) -> tuple[int, int, int]:
    """(blocks, warps a block, shared bytes a block) of a launch over ``n``
    elements of ``itemsize`` bytes: warp ``w`` of block ``b`` owns tile
    ``t = b * warps + w``, elements ``[t * TILE_ELEMS, (t + 1) * TILE_ELEMS)``,
    and stages it in ``TILE_ELEMS * itemsize`` bytes of shared memory; a
    tail alone takes one block."""
    tiles = -(-n // TILE_ELEMS)
    warps = WIDE_WARPS if tiles >= WIDE_TILES else 1
    return max(1, -(-tiles // warps)), warps, warps * TILE_ELEMS * itemsize


def byteshuffle(buf: torch.Tensor, itemsize: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, itemsize) bytes -> (itemsize, N), then the tail."""
    check_bytes(buf, "byteshuffle")
    n, tail = divmod(buf.numel(), itemsize)
    dst = output(out, buf.numel(), buf, "byteshuffle")
    if buf.device.type == "cpu":
        return dst.copy_(ref.byteshuffle(buf, itemsize))
    require_aligned(itemsize, "byteshuffle", buf)
    if buf.numel():
        call(byteshuffle, "rt_byteshuffle", buf.get_device(), buf.data_ptr(),
             dst.data_ptr(), n, itemsize, tail)
    return dst


def byteunshuffle(buf: torch.Tensor, itemsize: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(itemsize, N) bytes -> (N, itemsize), then the tail."""
    check_bytes(buf, "byteunshuffle")
    n, tail = divmod(buf.numel(), itemsize)
    dst = output(out, buf.numel(), buf, "byteunshuffle")
    if buf.device.type == "cpu":
        return dst.copy_(ref.byteunshuffle(buf, itemsize))
    require_aligned(itemsize, "byteunshuffle", dst)
    if buf.numel():
        call(byteunshuffle, "rt_byteunshuffle", buf.get_device(), buf.data_ptr(),
             dst.data_ptr(), n, itemsize, tail)
    return dst


byteshuffle.launches = 0
byteunshuffle.launches = 0
