"""Byte Shuffle of one basket on the GPU (``csrc/byteshuffle.cu``).

Replaces the Pallas kernel ``repro/kernels/byteshuffle.py:_t_kernel`` (as
``byteshuffle`` and ``byteunshuffle``) with the container's semantics (any
element count, tail passed through).  A CPU tensor goes to the plain
version in ``ref``; a CUDA tensor always launches the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from ._build import check_bytes, launch, output, require_aligned

__all__ = ["byteshuffle", "byteunshuffle"]


def byteshuffle(buf: torch.Tensor, itemsize: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, itemsize) bytes -> (itemsize, N), then the tail."""
    check_bytes(buf, "byteshuffle")
    n, tail = divmod(buf.numel(), itemsize)
    dst = output(out, buf.numel(), buf, "byteshuffle")
    if buf.device.type == "cpu":
        return dst.copy_(ref.byteshuffle(buf, itemsize))
    require_aligned(itemsize, "byteshuffle", buf)
    launch(byteshuffle, "rt_byteshuffle", buf, dst, n, itemsize, tail)
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
    launch(byteunshuffle, "rt_byteunshuffle", buf, dst, n, itemsize, tail)
    return dst


byteshuffle.launches = 0
byteunshuffle.launches = 0
