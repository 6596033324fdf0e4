"""Delta of one basket on the GPU (``csrc/delta.cu``).

Replaces the Pallas kernels ``repro/kernels/delta.py:delta_block`` and
``:undelta_block``.  The basket is the block: every basket restarts at its
own first element, as ``core/precond.py`` defines it, and the inverse is one
scan over the whole basket however large.  A CPU tensor goes to the plain
version in ``ref``; a CUDA tensor always launches the kernel.

The forward delta is one launch a call, its tail included: 16-byte
vectors, each element's left neighbour from the previous lane
(``csrc/vector_map.cuh``, shared with ``zigzag``).  Its ``out`` may not
overlap its input.

The inverse is one launch a call, its ragged tail included: a single-pass
scan with decoupled look-back.  Its ticket and tile statuses live in a
workspace kept for each (device, stream), zeroed when it is made or grown
and never reset by the host: the kernel readies it for the next launch
itself.  So a call allocates nothing but its output, and two streams never
share a workspace.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from . import ref
from ._build import (call, check_bytes, current_stream, map_elements, output,
                     require_aligned)

__all__ = ["delta", "undelta", "TILE_BYTES", "tiles", "capacity",
           "workspace_words", "workspaces"]

TILE_BYTES = 32768        # one undelta block's tile: csrc/delta.cu kTileBytes
HEADER_WORDS = 4          # epoch, ticket, blocks done, unused: kHeaderWords
MIN_CAPACITY = 64         # tiles of the smallest workspace (2 MiB baskets)


def tiles(n: int, itemsize: int) -> int:
    """Tiles of an undelta over ``n`` elements of ``itemsize`` bytes: one
    block each, and one for a tail alone."""
    per = TILE_BYTES // itemsize
    return max(1, (n + per - 1) // per)


def capacity(need: int) -> int:
    """Tiles a workspace is made for: a power of two, at least
    ``MIN_CAPACITY``, so that growing baskets regrow it seldom."""
    return max(MIN_CAPACITY, 1 << (need - 1).bit_length())


def workspace_words(cap: int) -> int:
    """64-bit words of a workspace for ``cap`` tiles: the header, then a
    flag, an aggregate and an inclusive prefix per tile."""
    return HEADER_WORDS + 3 * cap


# (device index, raw stream handle) -> (tensor, its pointer, capacity)
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, int, int]] = {}
_ws_lock = threading.Lock()


def _workspace(index: int, stream: int, need: int) -> tuple:
    """The workspace of ``stream`` on CUDA device ``index`` for at least
    ``need`` tiles, made (zeroed on that stream, the current one) or grown
    at first need."""
    ws = _workspaces.get((index, stream))
    if ws is not None and ws[2] >= need:
        return ws
    with _ws_lock:
        ws = _workspaces.get((index, stream))
        if ws is None or ws[2] < need:
            cap = capacity(need)
            t = torch.zeros(workspace_words(cap), dtype=torch.int64,
                            device=torch.device("cuda", index))
            ws = _workspaces[(index, stream)] = (t, t.data_ptr(), cap)
    return ws


def workspaces() -> dict[tuple[int, int], tuple[int, int]]:
    """(device index, stream handle) -> (pointer, capacity) of every
    workspace made so far."""
    return {k: (v[1], v[2]) for k, v in _workspaces.items()}


def delta(buf: torch.Tensor, itemsize: int,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[0] = x[0], out[i] = x[i] - x[i-1] mod 2**(8*itemsize); tail kept."""
    return map_elements(delta, "rt_delta", ref.delta, buf, itemsize, out)


def undelta(buf: torch.Tensor, itemsize: int,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inclusive prefix sum mod 2**(8*itemsize), inverting :func:`delta`."""
    check_bytes(buf, "undelta")
    nbytes = buf.numel()
    dst = output(out, nbytes, buf, "undelta")
    if not buf.is_cuda:
        return dst.copy_(ref.undelta(buf, itemsize))
    require_aligned(itemsize, "undelta", buf, dst)
    if nbytes:
        n, tail = divmod(nbytes, itemsize)
        index = buf.get_device()
        stream = current_stream(index)
        _, ptr, cap = _workspace(index, stream, tiles(n, itemsize))
        call(undelta, "rt_undelta", index, buf.data_ptr(), dst.data_ptr(), n,
             itemsize, tail, ptr, cap, stream=stream)
    return dst


delta.launches = 0
undelta.launches = 0
