"""RWKV-6 ("Finch") mixer — data-dependent decay linear attention.

The port of ``repro/models/rwkv.py``, op for op and cast for cast.
Recurrence per head (state S is (d_k, d_v)):
    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
with w_t = exp(-exp(w0 + tanh(x̂_t W_a) W_b)).

Chunked linear attention: within a chunk of L tokens the pairwise decay
products are exp(cum[t] - cum[i]), so the intra-chunk part is two
decay-weighted products; the (H, D, D) state carries from chunk to chunk
in a loop.  float32 throughout the decay algebra, with the reference's
per-step log-decay floor.  The chunk rule is part of the numerics: L =
min(32, S), or S when S % L, and decode runs L = 1.

Token shift: x̂_t = x_t + mu * (x_{t-1} - x_t)  (x_{-1} = 0, or the carry).

With ``PERF_FLAGS["compressed_tp"]`` the row-parallel projections (time-mix
``w_o``, channel-mix ``w_v``) reduce through the int8 wire of
``parallel/compressed.py`` whenever an activation context is active.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import compressed
from ..parallel.actctx import constrain, shard_map
from ..parallel.meshed import shift_time
from .specs import ParamSpec

_LW_FLOOR = -25.0 / 32.0   # per-step log-decay floor (see rwkv_time_mix)

# int8-compressed TP reduction on the row-parallel projections
PERF_FLAGS = {"compressed_tp": False}

__all__ = [
    "rwkv_time_specs", "rwkv_channel_specs",
    "rwkv_time_mix", "rwkv_time_step",
    "rwkv_channel_mix", "rwkv_channel_step",
    "init_rwkv_state",
]


def rwkv_time_specs(cfg) -> dict:
    d = cfg.d_model
    lora = cfg.rwkv_decay_lora
    return {
        "mu": ParamSpec((5, d), (None, "embed"), init="zeros"),   # r,k,v,w,g shifts
        "w_r": ParamSpec((d, d), ("embed", "heads_d")),
        "w_k": ParamSpec((d, d), ("embed", "heads_d")),
        "w_v": ParamSpec((d, d), ("embed", "heads_d")),
        "w_g": ParamSpec((d, d), ("embed", "heads_d")),
        "w_o": ParamSpec((d, d), ("heads_d", "embed")),
        "decay_base": ParamSpec((d,), ("embed",), init="ones", scale=-6.0),
        "decay_a": ParamSpec((d, lora), ("embed", None), scale=0.1),
        "decay_b": ParamSpec((lora, d), (None, "embed"), scale=0.1),
        "bonus_u": ParamSpec((d,), ("embed",), init="zeros"),
        "ln_scale": ParamSpec((d,), ("embed",), init="ones"),     # per-head groupnorm
    }


def rwkv_channel_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": ParamSpec((2, d), (None, "embed"), init="zeros"),   # k, r shifts
        "w_k": ParamSpec((d, f), ("embed", "ff")),
        "w_v": ParamSpec((f, d), ("ff", "embed")),
        "w_r": ParamSpec((d, d), ("embed", "embed_o")),
    }


def _shift(x: torch.Tensor, carry: torch.Tensor | None = None) -> torch.Tensor:
    """x_{t-1}; the first position takes ``carry`` (decode) or zeros."""
    if carry is None:
        return shift_time(x)
    return torch.cat([carry[:, None], x[:, :-1]], dim=1)


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """log-decay lw_t = -exp(w0 + tanh(xw A) B)  (negative, float32)."""
    lora = torch.matmul(xw.float(), p["decay_a"].float())
    lw = p["decay_base"].float() + torch.matmul(torch.tanh(lora),
                                                p["decay_b"].float())
    return -torch.exp(lw)


def _heads(x, H, D):
    return x.reshape(*x.shape[:-1], H, D)


def _group_norm(x, scale, eps):
    """Per-head layernorm on (..., H, D)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    return xn * scale.float().reshape(*([1] * (x.dim() - 2)), *x.shape[-2:])


def _chunk(S_in, rc, kc, vc, lwc, u, causal):
    """One chunk: (B, L, H, D) inputs, state (B, H, D, D) -> (state, y)."""
    # the floor keeps the factored exp(-cum) in float32 range; it is a fixed
    # per-step constant, so every chunk length computes the same recurrence
    lwc = torch.clamp(lwc, min=_LW_FLOOR)
    cum = torch.cumsum(lwc, dim=1)                                   # inclusive
    cum_ex = cum - lwc                                               # exclusive
    r_dec = rc * torch.exp(cum_ex)
    k_dec = kc * torch.exp(-cum)
    scores = torch.einsum("blhd,bmhd->bhlm", r_dec, k_dec) * causal
    diag = torch.einsum("blhd,blhd->bhl", rc, u * kc)
    y = (torch.einsum("bhlm,bmhd->blhd", scores, vc)
         + diag.permute(0, 2, 1)[..., None] * vc)
    y = y + torch.einsum("blhk,bhkv->blhv", r_dec, S_in)             # inter-chunk
    decay_all = torch.exp(cum[:, -1])                                # (B,H,D)
    k_tail = kc * torch.exp(cum[:, -1][:, None] - cum)               # to chunk end
    S_out = (decay_all[..., None] * S_in
             + torch.einsum("blhk,blhv->bhkv", k_tail, vc))
    return S_out, y


def rwkv_time_mix(p: dict, x: torch.Tensor, cfg, chunk: int = 32,
                  shift_carry=None, state0=None):
    """x: (B, S, d) -> (out (B, S, d), (last_x, last_state))."""
    B, S, d = x.shape
    D = cfg.rwkv_head_dim
    H = d // D
    cdt = x.dtype

    xprev = _shift(x, shift_carry)
    mu = p["mu"].to(cdt)                                                 # (5, d)
    xr, xk, xv, xw, xg = (x + mu[i] * (xprev - x) for i in range(5))

    def proj(xi, w):
        return _heads(constrain(torch.matmul(xi, w.to(cdt)),
                                ("dp", None, "tp")), H, D)

    r = proj(xr, p["w_r"]).float()
    k = proj(xk, p["w_k"]).float()
    v = proj(xv, p["w_v"]).float()
    g = constrain(torch.matmul(xg, p["w_g"].to(cdt)), ("dp", None, "tp"))
    lw = _heads(constrain(_decay(p, xw), ("dp", None, "tp")), H, D)    # f32 <0
    u = _heads(p["bonus_u"].float(), H, D)                              # (H,D)

    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    nc = S // chunk

    def scan(r, k, v, lw, u, state):
        b, h = r.shape[0], r.shape[2]

        def c5(t):                                     # -> (nc, b, L, h, D)
            return t.reshape(b, nc, chunk, h, D).transpose(0, 1)

        r_c, k_c, v_c, lw_c = c5(r), c5(k), c5(v), c5(lw)
        causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                       device=r.device), -1)  # strictly lower
        ys = []
        for i in range(nc):
            state, y_i = _chunk(state, r_c[i], k_c[i], v_c[i], lw_c[i], u, causal)
            ys.append(y_i)
        return torch.stack(ys).transpose(0, 1).reshape(b, S, h, D), state

    state = state0 if state0 is not None else torch.zeros(
        (B, H, D, D), dtype=torch.float32, device=x.device)
    # local over batch and heads: under a mesh, on this rank's shards
    heads = ("dp", None, "tp")
    y, state = shard_map(scan, (r, k, v, lw, u, state),
                         (heads, heads, heads, heads, ("tp",), ("dp", "tp")),
                         out_like=(0, 5))
    y = _group_norm(y, _heads(p["ln_scale"], H, D), cfg.norm_eps)
    y = y.reshape(B, S, d).to(cdt) * F.silu(g.float()).to(cdt)
    if PERF_FLAGS["compressed_tp"]:
        out = compressed.rowparallel_einsum_compressed(y, p["w_o"])
    else:
        out = torch.matmul(y, p["w_o"].to(cdt))
    # row-parallel: the partial sums reduced here, under a mesh
    return constrain(out, ("dp", None, None)), (x[:, -1], state)


def rwkv_time_step(p: dict, x: torch.Tensor, cfg, shift_carry, state):
    """One decode step: x (B, 1, d)."""
    return rwkv_time_mix(p, x, cfg, chunk=1, shift_carry=shift_carry,
                         state0=state)


def rwkv_channel_mix(p: dict, x: torch.Tensor, cfg, shift_carry=None):
    """Squared-ReLU channel mix.  Returns (out, last_x)."""
    cdt = x.dtype
    xprev = _shift(x, shift_carry)
    mu = p["mu"].to(cdt)
    xk = x + mu[0] * (xprev - x)
    xr = x + mu[1] * (xprev - x)
    k = constrain(torch.matmul(xk, p["w_k"].to(cdt)), ("dp", None, "tp"))
    k = torch.square(F.relu(k.float())).to(cdt)
    if PERF_FLAGS["compressed_tp"]:
        kv = compressed.rowparallel_einsum_compressed(k, p["w_v"])
    else:
        kv = torch.matmul(k, p["w_v"].to(cdt))
    kv = constrain(kv, ("dp", None, None))          # row-parallel, as above
    rgate = torch.sigmoid(
        torch.matmul(xr, p["w_r"].to(cdt)).float()).to(cdt)
    return rgate * kv, x[:, -1]


def rwkv_channel_step(p, x, cfg, shift_carry):
    return rwkv_channel_mix(p, x, cfg, shift_carry=shift_carry)


def init_rwkv_state(cfg, batch: int, dtype=torch.bfloat16, device=None):
    d = cfg.d_model
    D = cfg.rwkv_head_dim
    H = d // D
    return {
        "tm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "tm_state": torch.zeros((batch, H, D, D), dtype=torch.float32,
                                device=device),
        "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
    }
