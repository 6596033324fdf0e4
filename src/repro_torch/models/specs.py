"""ParamSpec: one parameter definition -> initialised tensor.

Every model parameter is declared once as a ``ParamSpec(shape, axes)``
where ``axes`` names each dimension with a *logical* axis ("embed",
"heads", "ff", "vocab", ...), as in the reference's ``repro/models/specs.py``.
The port keeps the same nested-dict trees and dotted paths, so a checkpoint
written by either package loads into either model by name.

``init_params`` follows the reference's rules (sorted paths; ``zeros``;
"ones" = the constant ``scale``; normal x ``scale / sqrt(fan_in)``) but
draws from a ``torch.Generator``, whose numbers are not ``jax.random``'s:
parity with the reference comes from carrying its weights across.
``abstract_params`` gives the tree on the meta device (the dry run's
stand-in) and ``map_logical`` maps a function over the specs, keeping the
nesting (the sharding rules of :mod:`repro_torch.parallel.sharding`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

__all__ = ["ParamSpec", "init_params", "abstract_params", "map_logical",
           "tree_paths"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                 # logical axis name (or None) per dim
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0          # stddev multiplier (normal) / constant (ones)
    dtype: Any = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_paths(tree, prefix=""):
    """Flatten a nested-dict tree to {dotted.path: leaf}."""
    out = {}
    if not isinstance(tree, dict):
        out[prefix.rstrip(".")] = tree
        return out
    for k, v in tree.items():
        out.update(tree_paths(v, f"{prefix}{k}."))
    return out


def init_params(spec_tree, generator: torch.Generator, param_dtype=None):
    """Real tensors from a spec tree, on ``generator``'s device.  Normal
    leaves are drawn in float32 and then cast, as the reference does."""
    device = generator.device
    out_flat = {}
    for path, spec in sorted(tree_paths(spec_tree).items()):
        dtype = param_dtype or spec.dtype
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            t = torch.full(spec.shape, spec.scale, dtype=dtype, device=device)
        else:
            fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
            std = spec.scale / math.sqrt(max(fan_in, 1))
            t = (torch.randn(spec.shape, generator=generator, device=device,
                             dtype=torch.float32) * std).to(dtype)
        out_flat[path] = t
    return _unflatten(out_flat)


def abstract_params(spec_tree, param_dtype=None):
    """The tree as tensors on the meta device: shapes and types, no
    storage (the reference's ShapeDtypeStruct tree)."""
    return _unflatten({
        p: torch.empty(s.shape, dtype=param_dtype or s.dtype, device="meta")
        for p, s in tree_paths(spec_tree).items()})


def map_logical(spec_tree, fn: Callable[[ParamSpec], Any]):
    """``fn(spec)`` for every leaf, in the tree's nesting."""
    return _unflatten({p: fn(s) for p, s in tree_paths(spec_tree).items()})


def _unflatten(flat: dict):
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
