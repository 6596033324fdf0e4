"""Delta of one basket on the GPU (``csrc/delta.cu``).

Replaces the Pallas kernels ``repro/kernels/delta.py:delta_block`` and
``:undelta_block``.  The basket is the block: every basket restarts at its
own first element, as ``core/precond.py`` defines it, and the inverse is one
scan over the whole basket however large.  A CPU tensor goes to the plain
version in ``ref``; a CUDA tensor always launches the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from ._build import check_bytes, launch, library, output, require_aligned

__all__ = ["delta", "undelta"]


def delta(buf: torch.Tensor, itemsize: int,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[0] = x[0], out[i] = x[i] - x[i-1] mod 2**(8*itemsize); tail kept."""
    check_bytes(buf, "delta")
    n, tail = divmod(buf.numel(), itemsize)
    dst = output(out, buf.numel(), buf, "delta")
    if buf.device.type == "cpu":
        return dst.copy_(ref.delta(buf, itemsize))
    require_aligned(itemsize, "delta", buf, dst)
    launch(delta, "rt_delta", buf, dst, n, itemsize, tail)
    return dst


def undelta(buf: torch.Tensor, itemsize: int,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inclusive prefix sum mod 2**(8*itemsize), inverting :func:`delta`."""
    check_bytes(buf, "undelta")
    n, tail = divmod(buf.numel(), itemsize)
    dst = output(out, buf.numel(), buf, "undelta")
    if buf.device.type == "cpu":
        return dst.copy_(ref.undelta(buf, itemsize))
    require_aligned(itemsize, "undelta", buf, dst)
    # per-tile carries of the multi-block scan (none for a single tile)
    tiles = library().rt_undelta_tiles(n)
    scratch = torch.empty(tiles, dtype=torch.int64, device=buf.device) \
        if tiles > 1 else None
    launch(undelta, "rt_undelta", buf, dst, n, itemsize, tail,
           scratch.data_ptr() if scratch is not None else None)
    return dst


delta.launches = 0
undelta.launches = 0
