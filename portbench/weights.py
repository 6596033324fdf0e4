"""Model weights drawn from the seed, on the device, in a few large calls.

Every normal leaf of the program's parameter tree is a slice of one
``torch.randn`` draw in the type the weights are used in (bfloat16 to
serve, the float32 masters to train), scaled by the leaf's own factor
over sqrt(d_model); constant leaves are filled.  The program's own
``init_params`` divides by the number of groups of a stacked leaf (its
fan-in), which makes its full-width weights chaotic; these are not.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.model import unflatten


def seeded_params(model, seed: int, dtype, device) -> dict:
    """The parameter tree of ``model`` (a ``repro_torch`` Model) drawn from
    ``seed``: the same seed gives the same weights."""
    from repro_torch.models.specs import tree_paths
    specs = tree_paths(model.param_specs())
    paths = sorted(specs)
    n = sum(math.prod(specs[p].shape) for p in paths if specs[p].init == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(n, generator=gen, dtype=dtype, device=device)
    scale = 1.0 / math.sqrt(model.cfg.d_model)
    out, at = {}, 0
    for p in paths:
        s = specs[p]
        if s.init == "normal":
            k = math.prod(s.shape)
            out[p] = flat[at:at + k].view(s.shape).mul_(s.scale * scale)
            at += k
        else:
            out[p] = torch.full(s.shape, s.scale if s.init == "ones" else 0.0,
                                dtype=dtype, device=device)
    return unflatten(out)
