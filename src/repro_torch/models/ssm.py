"""Mamba (selective SSM) mixer — jamba's attention-free layer.

The port of ``repro/models/ssm.py``, op for op and cast for cast.
Recurrence (Mamba-1, per channel c and state n):
    h_t = exp(dt_t[c] * A[c, n]) * h_{t-1} + dt_t[c] * B_t[n] * x_t[c]
    y_t[c] = sum_n C_t[n] * h_t[c, n] + D[c] * x_t[c]

The full-sequence pass is the reference's chunked scan: a loop over
chunks of 64 tokens (one chunk of S tokens where S % 64) carries the
(B, d_inner, d_state) float32 state, and within a chunk the recurrence
is ``jax.lax.associative_scan``'s odd-even recursion, reproduced step for
step (``_associative_scan``), so the float32 products associate as the
reference's do.  The causal conv accumulates in float32 over the full
sequence; the decode step's conv over the carried tail is a compute-type
einsum with float32 sums, as the reference's.  The decode state's
``conv`` leaf is float32 by default (``init_mamba_state``) while
``mamba(return_state=True)`` returns the compute-type tail; the step
casts back to the state's type.  Each chunk's step (its parameters, the
scan and the output einsum) is recomputed in the backward, as the
reference's checkpointed scan step: only the (B, d_inner, d_state)
carries are kept.  ``PERF_FLAGS["mamba_bf16_y"]`` rounds each chunk's y
to the compute type, as the reference's §Perf variant.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.actctx import constrain, shard_map
from ..parallel.meshed import shift_time
from .layers import recompute
from .specs import ParamSpec

__all__ = ["mamba_specs", "mamba", "mamba_step", "init_mamba_state"]

# the reference's §Perf variant, off by default as there: each chunk's y
# rounded to the compute type
PERF_FLAGS = {"mamba_bf16_y": False}


def mamba_specs(cfg) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = max(d // 16, 1)
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "inner2")),
        "conv_w": ParamSpec((cfg.ssm_conv, di), (None, "inner"), scale=0.5),
        "conv_b": ParamSpec((di,), ("inner",), init="zeros"),
        "x_proj": ParamSpec((di, dt_rank + 2 * n), ("inner", None)),
        "dt_proj": ParamSpec((dt_rank, di), (None, "inner")),
        "dt_bias": ParamSpec((di,), ("inner",), init="ones", scale=0.01),
        "a_log": ParamSpec((di, n), ("inner", None), init="ones"),
        "d_skip": ParamSpec((di,), ("inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("inner", "embed")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)), with no threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_params(p, x, cfg):
    """x: (B, S, di) -> a=exp(dt*A) (B,S,di,n), bx (B,S,di,n), c (B,S,n)."""
    n = cfg.ssm_state
    dt_rank = p["x_proj"].shape[1] - 2 * n
    # row-parallel over di: the partial sums reduced here, under a mesh
    xp = constrain(torch.matmul(x, p["x_proj"].to(x.dtype)), ("dp", None, None))
    dt_in, b_in, c_in = torch.split(xp, [dt_rank, n, n], dim=-1)
    dt = _softplus(torch.matmul(dt_in, p["dt_proj"].to(x.dtype)).float()
                   + p["dt_bias"].float())                               # (B,S,di)
    a_mat = -torch.exp(p["a_log"].float())                               # (di,n)
    a = torch.exp(dt[..., None] * a_mat)                                 # (B,S,di,n)
    bx = (dt * x.float())[..., None] * b_in.float()[:, :, None, :]
    return a, bx, c_in.float()


def _combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along dim 0."""
    out = even.new_empty((even.shape[0] + odd.shape[0],) + tuple(even.shape[1:]))
    out[0::2] = even
    out[1::2] = odd
    return out


def _associative_scan(elems):
    """Inclusive scan of ``_combine`` along dim 0, in the order of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the
    half-length sequence recursively (the odd results), then combine each
    with the next even element."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = _associative_scan(_combine([e[0:-1:2] for e in elems],
                                     [e[1::2] for e in elems]))
    if n % 2 == 0:
        even = _combine([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = _combine(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _chunk_scan(a, bx, h0):
    """One chunk of the recurrence.  a, bx: (L, B, di, n) float32; h0:
    (B, di, n).  Returns (h_all (L,B,di,n), h_last)."""
    a_s, b_s = _associative_scan([a, bx])
    h_all = a_s * h0[None] + b_s
    return h_all, h_all[-1]


def _conv1d(p, x, cfg):
    """Depthwise causal conv via shifted adds, float32 sums.  x: (B, S, di)."""
    w = p["conv_w"].float()                                              # (K, di)
    K = w.shape[0]
    xf = x.float()
    out = xf * w[K - 1]
    for k in range(1, K):
        shifted = shift_time(xf, k)
        out = out + shifted * w[K - 1 - k]
    return (out + p["conv_b"].float()).to(x.dtype)


def mamba(p: dict, x: torch.Tensor, cfg, chunk: int = 64,
          return_state: bool = False):
    """Full-sequence mamba mixer.  x: (B, S, d) -> (B, S, d)
    (+ decode-ready state when ``return_state``)."""
    B, S, _ = x.shape
    cdt = x.dtype
    di = cfg.d_inner
    xz = constrain(torch.matmul(x, p["in_proj"].to(cdt)), ("dp", None, "tp"))
    xin_pre, z = torch.chunk(xz, 2, dim=-1)                              # (B,S,di)
    xin = F.silu(_conv1d(p, xin_pre, cfg).float()).to(cdt)
    xin = constrain(xin, ("dp", None, "tp"))

    chunk = min(chunk, S)
    if S % chunk:
        chunk = S  # fallback: single chunk (smoke-test sizes)
    h = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32, device=x.device)

    def scan(a, bx, c, h):
        h_all, h = _chunk_scan(a.transpose(0, 1), bx.transpose(0, 1), h)  # (L,B,di,n)
        return torch.einsum("lbcn,bln->blc", h_all, c), h                # (B,L,di)

    def step(xc, h):
        a, bx, c = _ssm_params(p, xc, cfg)                               # (B,L,di,n)
        # local over batch and d_inner: under a mesh, on this rank's shards
        y_c, h = shard_map(scan, (a, bx, c, h),
                           (("dp", None, "tp"), ("dp", None, "tp"), ("dp",),
                            ("dp", "tp")),
                           out_like=(((B, a.shape[1], di), ("dp", None, "tp")), 3))
        if PERF_FLAGS["mamba_bf16_y"]:
            y_c = y_c.to(cdt)
        return y_c, h

    ys = []
    for lo in range(0, S, chunk):
        y_c, h = recompute(step, xin[:, lo:lo + chunk], h)
        ys.append(y_c)
    y = torch.cat(ys, dim=1).float()
    y = y + xin.float() * p["d_skip"].float()
    y = y.to(cdt) * F.silu(z.float()).to(cdt)
    out = torch.matmul(y, p["out_proj"].to(cdt))
    if not return_state:
        return out
    ktail = cfg.ssm_conv - 1
    conv_state = xin_pre[:, S - ktail:] if S >= ktail else \
        F.pad(xin_pre, (0, 0, ktail - S, 0))
    return out, {"conv": conv_state, "ssm": h}


def init_mamba_state(cfg, batch: int, dtype=torch.float32, device=None):
    """Decode-time carried state: causal-conv tail + SSM hidden."""
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def mamba_step(p: dict, x: torch.Tensor, state: dict, cfg):
    """One decode step.  x: (B, 1, d); state from init_mamba_state."""
    cdt = x.dtype
    xz = torch.matmul(x, p["in_proj"].to(cdt))
    xin, z = torch.chunk(xz, 2, dim=-1)                                  # (B,1,di)

    # conv over (tail ++ current): compute-type operands, float32 sums
    window = torch.cat([state["conv"].to(cdt), xin], dim=1)              # (B,K,di)
    w = p["conv_w"].to(cdt)
    conv = (window.float() * w.float()).sum(1).to(cdt) + p["conv_b"].to(cdt)
    xin1 = F.silu(conv.float()).to(cdt)[:, None]                         # (B,1,di)
    new_conv = window[:, 1:]

    a, bx, c = _ssm_params(p, xin1, cfg)                                 # (B,1,di,n)
    h = a[:, 0] * state["ssm"] + bx[:, 0]                                # (B,di,n)
    y = torch.einsum("bcn,bn->bc", h, c[:, 0]) \
        + xin1[:, 0].float() * p["d_skip"].float()
    y = y.to(cdt) * F.silu(z[:, 0].float()).to(cdt)
    out = torch.matmul(y, p["out_proj"].to(cdt))[:, None]
    return out, {"conv": new_conv.to(state["conv"].dtype), "ssm": h}
