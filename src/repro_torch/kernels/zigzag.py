"""Zigzag of one basket on the GPU (``csrc/zigzag.cu``).

Replaces no Pallas kernel: the reference preconditions ``zigzag{N}``
branches on the host (``core/precond.py:zigzag_encode``/``zigzag_decode``).
These put the stage on the tensor's device, as every other stage of a
precond spec is, with the same bytes.  A CPU tensor goes to the plain
version in ``ref``; a CUDA tensor always launches the kernel, one launch a
call, its tail included.  ``out`` may not overlap the input.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from ._build import map_elements

__all__ = ["zigzag", "unzigzag"]


def zigzag(buf: torch.Tensor, itemsize: int,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(v << 1) ^ (v >> (8*itemsize - 1)) on the signed view; tail kept."""
    return map_elements(zigzag, "rt_zigzag", ref.zigzag, buf, itemsize, out)


def unzigzag(buf: torch.Tensor, itemsize: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(u >> 1) ^ -(u & 1), inverting :func:`zigzag`; tail kept."""
    return map_elements(unzigzag, "rt_unzigzag", ref.unzigzag, buf, itemsize,
                        out)


zigzag.launches = 0
unzigzag.launches = 0
