"""Precond spec strings applied to one basket's bytes on its device.

A spec names the stages the container records per branch (``"bitshuffle4"``,
``"shuffle2"``, ``"delta8+shuffle8"``, ...; grammar of
``core/precond.py``).  :func:`precondition` runs them forward over a basket
held as a 1-D ``uint8`` tensor; :func:`unprecondition_into` runs them
backwards and lands the last stage in the destination slice.  Each stage is
one kernel wrapper: on a CUDA tensor it launches the kernel, on a CPU tensor
it runs the plain version, with no fallback between the two.
"""

from __future__ import annotations

import torch

from ..core.precond import _parse
from .bitshuffle import bitshuffle, bitunshuffle
from .byteshuffle import byteshuffle, byteunshuffle
from .delta import delta, undelta

__all__ = ["precondition", "unprecondition_into", "KERNELS",
           "launch_counts", "reset_launch_counts"]

# the six kernel wrappers, by the name chip_smoke.py reports them under
KERNELS = {fn.__name__: fn for fn in (bitshuffle, bitunshuffle, byteshuffle,
                                      byteunshuffle, delta, undelta)}

_FORWARD = {"bitshuffle": bitshuffle, "shuffle": byteshuffle, "delta": delta}


def _stages(spec: str) -> list[tuple[str, int]]:
    stages = _parse(spec)
    for name, itemsize in stages:
        if name not in _FORWARD:
            raise ValueError(f"precond stage {name!r} of {spec!r} has no "
                             "GPU kernel (bitshuffle, shuffle, delta)")
        if itemsize not in (1, 2, 4, 8):
            raise ValueError(f"precond {spec!r}: itemsize must be 1, 2, 4 or 8")
    return stages


def precondition(spec: str, raw: torch.Tensor) -> torch.Tensor:
    """Forward stages of ``spec`` over one basket; ``raw`` itself when the
    spec has none."""
    cur = raw
    for name, itemsize in _stages(spec):
        if cur.data_ptr() % itemsize:     # a basket that is not element-aligned
            cur = cur.clone()
        cur = _FORWARD[name](cur, itemsize)
    return cur


def unprecondition_into(spec: str, staged: torch.Tensor, out: torch.Tensor,
                        orig_len: int) -> None:
    """Invert :func:`precondition` from the codec's output ``staged`` into
    ``out`` (``orig_len`` bytes, the basket's slice of its tensor)."""
    stages = list(reversed(_stages(spec)))
    cur = staged
    for i, (name, itemsize) in enumerate(stages):
        last = i == len(stages) - 1
        dst = out if last and out.data_ptr() % itemsize == 0 else None
        if name == "bitshuffle":
            cur = bitunshuffle(cur, itemsize, orig_len - orig_len % itemsize,
                               out=dst)
        elif name == "shuffle":
            cur = byteunshuffle(cur, itemsize, out=dst)
        else:
            cur = undelta(cur, itemsize, out=dst)
    if cur is not out:
        out.copy_(cur)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
