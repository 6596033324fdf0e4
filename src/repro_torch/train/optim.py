"""AdamW and its utilities, the port of ``repro/train/optim.py``.

Plain functions on nested-dict tensor trees, written from the reference's
formulas rather than with ``torch.optim.AdamW``, which places eps and the
bias correction elsewhere and so rounds differently.  The arithmetic is
the compiled reference's:

* every scalar is a float32 0-d tensor, as JAX's weakly typed Python
  floats are float32 beside a float32 array (Python floats would compute
  ``b1 ** count`` in float64);
* leaves are walked in sorted key order, ``jax.tree.flatten``'s, so the
  global norm sums them in the reference's order;
* a division by a constant is a product with the constant's float32
  reciprocal, which is what XLA compiles the reference's into; a Python
  float divided by a tensor is a true division (PyTorch's ``c / t``
  multiplies by a rounded reciprocal).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm", "warmup_cosine"]


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted key order; ``None`` has none."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping ``tree``'s structure (``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(tree, leaves: list):
    """``tree``'s structure with ``leaves`` in sorted key order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    assert next(it, None) is None, "more leaves than the tree holds"
    return out


def reciprocal(c) -> float:
    """float32(1 / float32(c)): XLA's rewrite of ``x / c``, c a constant."""
    return float(np.float32(1.0) / np.float32(c))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def adamw_init(params, bf16_moments: bool = False):
    mdt = torch.bfloat16 if bf16_moments else torch.float32
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def adamw_update(grads, opt, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """(new params, new opt): one AdamW step with decoupled weight decay.
    ``lr`` is a float or a float32 0-d tensor."""
    count = opt["count"] + 1
    dev = count.device
    cf = count.float()
    bc1 = 1.0 - torch.pow(_f32(b1, dev), cf)
    bc2 = 1.0 - torch.pow(_f32(b2, dev), cf)
    lr = _f32(lr, dev)

    def upd(g, m, v, p):
        gf = g.float()
        pf = p.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        step = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        step = step + lr * weight_decay * pf
        return (pf - step).to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(opt["m"]), tree_leaves(opt["v"]),
        tree_leaves(params))]
    return (tree_unflatten(params, [o[0] for o in out]),
            {"m": tree_unflatten(params, [o[1] for o in out]),
             "v": tree_unflatten(params, [o[2] for o in out]),
             "count": count})


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(torch.div(_f32(max_norm, gn.device),
                                  torch.clamp_min(gn, 1e-12)), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def warmup_cosine(step, *, peak_lr=3e-4, warmup=100, total=10_000,
                  min_ratio=0.1):
    """Linear warm-up to ``peak_lr``, then a cosine to ``min_ratio`` of it;
    ``step`` an integer 0-d tensor, the result a float32 0-d tensor."""
    s = step.float()
    warm = peak_lr * s * reciprocal(max(warmup, 1))
    prog = torch.clamp((s - warmup) * reciprocal(max(total - warmup, 1)),
                       0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
