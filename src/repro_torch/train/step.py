"""Mixed-precision train step, the port of ``repro/train/step.py``: float32
master params, compute in ``cfg.dtype``, float32 grads, AdamW; optional
microbatch accumulation, bf16 gradients and the int8 error-feedback
gradient compression.

The step runs eagerly.  Gradients come from ``torch.autograd``: the loss
casts the float32 leaves to the compute type inside the graph, so their
gradients arrive in float32, as ``jax.value_and_grad`` gives them through
the reference's cast.  The optimizer and the compression run under
``torch.no_grad`` and return new tensors; the state passed in is not
written.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models.model import _DTYPES
from .optim import (adamw_init, adamw_update, clip_by_global_norm,
                    reciprocal, tree_leaves, tree_map, tree_unflatten,
                    warmup_cosine)

__all__ = ["TrainState", "init_train_state", "abstract_train_state",
           "make_train_step"]

_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    step: torch.Tensor       # int32, 0-d
    err: Any = None          # error-feedback residual (grad compression)


def init_train_state(model, generator: torch.Generator, *,
                     bf16_moments: bool = False,
                     compress_grads: bool = False) -> TrainState:
    """A fresh state on ``generator``'s device."""
    params = model.init(generator, dtype=torch.float32)
    opt = adamw_init(params, bf16_moments=bf16_moments)
    err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                         device=p.device), params) \
        if compress_grads else None
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=generator.device), err=err)


def abstract_train_state(model, *, bf16_moments: bool = False,
                         compress_grads: bool = False) -> TrainState:
    """init_train_state's tree on the meta device: shapes and types, no
    storage (a restore template, the reference's ShapeDtypeStruct twin)."""
    params = model.abstract(dtype=torch.float32)
    mdt = torch.bfloat16 if bf16_moments else torch.float32
    like = lambda dt: (lambda p: torch.empty(p.shape, dtype=dt, device="meta"))
    scalar = lambda: torch.empty((), dtype=torch.int32, device="meta")
    opt = {"m": tree_map(like(mdt), params), "v": tree_map(like(mdt), params),
           "count": scalar()}
    err = tree_map(like(torch.bfloat16), params) if compress_grads else None
    return TrainState(params=params, opt=opt, step=scalar(), err=err)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to a zero of their sign, as XLA treats float32 inputs and
    results (the CPU runtime and the TPU alike)."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def _sub_product(a, q, s, chunk: int = 1 << 24):
    """float32(a - q * s) rounded once, as the fused multiply-add that XLA
    compiles the reference's ``gf - deq`` into.  q is an integer of at most
    127 and a within half a quantum of q * s, so float64 holds the product
    and the difference exactly (Sterbenz); the work goes in chunks to bound
    the float64 temporaries.  DTensors are computed shard by shard (the
    product is elementwise)."""
    if type(a) is not torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(a, DTensor):
            mesh, pl = a.device_mesh, a.placements
            out = _sub_product(a.to_local(), q.redistribute(mesh, pl).to_local(),
                               s.full_tensor() if isinstance(s, DTensor) else s, chunk)
            return DTensor.from_local(out, mesh, pl, run_check=False,
                                      shape=a.shape, stride=a.stride())
    out = torch.empty_like(a)
    a1, q1, o1 = a.reshape(-1), q.reshape(-1), out.view(-1)
    s64 = s.double()
    for lo in range(0, a1.numel(), chunk):
        o1[lo:lo + chunk] = (a1[lo:lo + chunk].double()
                             - q1[lo:lo + chunk].double() * s64).float()
    return out


def _quantize_ef(g, e):
    """int8 error-feedback quantization of one gradient tensor: the value
    the optimizer sees is dequant(quant(g + err)); the residual carries to
    the next step.  A per-tensor amax, scale ``amax * float32(1/127)`` (the
    compiled ``amax / 127.0``) or 1.0 for a zero tensor, rounding half to
    even.  Subnormal inputs, sums, scales and residuals are flushed, as
    XLA flushes them: a tensor whose amax is below 127 * FLT_MIN gets a
    zero scale, so its zeros quantize to NaN as the reference's do.  The
    residual is one fused multiply-add, as XLA computes it."""
    gf = _flush(_flush(g.float()) + _flush(e.float()))
    amax = torch.max(torch.abs(gf))
    scale = torch.where(amax == 0, 1.0, _flush(amax * reciprocal(127.0)))
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    deq = q * scale
    return deq.to(g.dtype), _flush(_sub_product(gf, q, scale)).to(e.dtype)


def make_train_step(model, *, peak_lr=3e-4, warmup=100, total_steps=10_000,
                    clip_norm: float = 1.0, accum: int = 1,
                    bf16_moments: bool = False,
                    compress_grads: bool = False,
                    bf16_grads: bool = False,
                    weight_decay: float = 0.1) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``accum > 1``: batch leaves are shaped (accum, micro, ...); the
    microbatches' float32 gradients are averaged in order.
    ``bf16_grads``: differentiate with respect to the compute-type cast of
    the params (the optimizer still updates the float32 masters).
    ``bf16_moments`` is accepted for the reference's signature; the
    moments' type is the state's."""
    del bf16_moments
    compute_dtype = _DTYPES[model.cfg.dtype]

    def cast(p):
        return p.to(compute_dtype) if p.dtype == torch.float32 else p

    def one_micro(params, mb):
        if bf16_grads:
            leaves = tree_map(lambda p: cast(p).detach().requires_grad_(), params)
        else:
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = tree_leaves(leaves)
        with torch.enable_grad():
            inputs = leaves if bf16_grads else tree_map(cast, leaves)
            loss, metrics = model.loss(inputs, mb)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, flat)]
        return (tree_unflatten(params, grads),
                {k: v.detach() for k, v in metrics.items()})

    def train_step(state: TrainState, batch):
        params = state.params
        if accum == 1:
            grads, metrics = one_micro(params, batch)
        else:
            inv = reciprocal(accum)
            with torch.no_grad():
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
            ms = []
            for i in range(accum):
                g, m = one_micro(params, {k: v[i] for k, v in batch.items()})
                with torch.no_grad():
                    grads = tree_map(lambda a, b: a + b.float() * inv, grads, g)
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}

        with torch.no_grad():
            if compress_grads:
                pairs = [_quantize_ef(g, e) for g, e in zip(
                    tree_leaves(grads), tree_leaves(state.err))]
                grads = tree_unflatten(params, [p[0] for p in pairs])
                new_err = tree_unflatten(params, [p[1] for p in pairs])
            else:
                new_err = state.err
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            lr = warmup_cosine(state.step, peak_lr=peak_lr, warmup=warmup,
                               total=total_steps)
            new_params, new_opt = adamw_update(grads, state.opt, params, lr,
                                               weight_decay=weight_decay)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        new_state = TrainState(params=new_params, opt=new_opt,
                               step=state.step + 1, err=new_err)
        return new_state, metrics

    return train_step
