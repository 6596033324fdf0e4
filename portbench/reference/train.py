"""One plain float32 training step after another, as the trainer defines it.

Each step: the mean next-token cross-entropy (``Reference.loss`` of the
configuration's architecture module) and its float32 gradients by
autograd; where gradients are compressed, the int8 error-feedback
quantizer over each leaf (per-tensor amax, scale amax / 127 or 1 for a
zero leaf, rounding half to even, the residual kept in bfloat16 as the
configuration stores it); the clip to a global norm of 1; AdamW (b1 0.9,
b2 0.95, eps 1e-8, decoupled weight decay 0.1) at the warm-up-then-cosine
rate of step ``count``.  Written from those definitions, not from the
program's functions.
"""

from __future__ import annotations

import math

import torch

from portbench import harness

from .model import flatten, float32_matmuls, unflatten

B1, B2, EPS, WEIGHT_DECAY, CLIP = 0.9, 0.95, 1e-8, 0.1, 1.0


def learning_rate(step: int, peak: float, warmup: int, total: int,
                  min_ratio: float = 0.1) -> float:
    """Linear warm-up from 0 to ``peak``, then a cosine down to
    ``min_ratio`` of it at ``total``."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


def int8_error_feedback(g: torch.Tensor, err: torch.Tensor):
    """(what the optimizer sees, the new residual) for one leaf."""
    gf = g + err.float()
    amax = gf.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    deq = torch.clamp(torch.round(gf / scale), -127, 127) * scale
    return deq, (gf - deq).to(torch.bfloat16)


def train_steps(conf: dict, params0: dict, batches: list, *, peak_lr: float,
                warmup: int, total_steps: int, compress_grads: bool,
                fp8: bool = False) -> dict:
    """Steps from ``params0`` (a float32 tree) over ``batches`` ((tokens,
    targets) pairs of int64 tensors).  Returns each step's loss, each leaf's
    norm of the first raw gradient and of the first gradient as the
    optimizer gets it, and of the parameters' change after the last step."""
    Reference = harness.architecture(conf).Reference
    p0 = {k: v.detach().float() for k, v in flatten(params0).items()}
    p = {k: v.clone() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    err = {k: torch.zeros(v.shape, dtype=torch.bfloat16, device=v.device)
           for k, v in p.items()}
    out = {"loss": [], "raw_grad_norms": {}, "grad_norms": {}, "update_norms": {}}
    with float32_matmuls():
        for count, (tokens, targets) in enumerate(batches, start=1):
            leaves = {k: t.detach().requires_grad_() for k, t in p.items()}
            loss = Reference(conf, unflatten(leaves), fp8=fp8).loss(tokens, targets)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                         allow_unused=True)))
            out["loss"].append(float(loss.detach()))
            del loss, leaves
            with torch.no_grad():
                grads = {k: torch.zeros_like(p[k]) if g is None else g
                         for k, g in grads.items()}
                if count == 1:
                    out["raw_grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
                if compress_grads:
                    for k in grads:
                        grads[k], err[k] = int8_error_feedback(grads[k], err[k])
                gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
                clip = torch.clamp(CLIP / torch.clamp_min(gn, 1e-12), max=1.0)
                grads = {k: g * clip for k, g in grads.items()}
                if count == 1:
                    out["grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
                lr = learning_rate(count - 1, peak_lr, warmup, total_steps)
                bc1, bc2 = 1 - B1 ** count, 1 - B2 ** count
                for k, g in grads.items():
                    m[k] = B1 * m[k] + (1 - B1) * g
                    v2[k] = B2 * v2[k] + (1 - B2) * g * g
                    p[k] = p[k] - lr * ((m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + EPS)
                                        + WEIGHT_DECAY * p[k])
            del grads
    out["update_norms"] = {k: float((p[k] - p0[k]).norm()) for k in p}
    return out
