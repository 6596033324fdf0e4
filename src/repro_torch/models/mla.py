"""Multi-head latent attention (MLA, DeepSeek-V2) with YaRN RoPE, the
port's own mixer (the reference package has none).

Per layer, with R = ``kv_lora_rank``, n = ``qk_nope_dim``, r =
``qk_rope_dim`` and values ``d_head`` wide:

* q = x·W_q, H heads of n + r columns, split into q_nope and q_pe;
* x·W_kv_a gives R + r columns: the latent c (then RMSNorm ``kv_norm``)
  and k_pe, one rotary key shared by every head;
* W_k_b and W_v_b expand c into per-head k_nope (n) and v (d_head);
* scores [q_nope, rope(q_pe)]·[k_nope, rope(k_pe)] over n + r dims, times
  ``softmax_scale``; values then W_o.

Two paths compute it.  The prefill (and training) expands the latent
into per-head keys and values and runs the float32 attention core of
:func:`layers.attend`; it builds the latent cache, (B, max_len, R + r):
the normed c and the roped k_pe of each position.  A decode step never
expands the cache: W_k_b is absorbed into the query (q_lat = q_nope·W_k_b,
R wide), so the scores are [q_lat, q_pe]·cacheᵀ, one product over R + r
columns, the context p·c stays in latent space and W_v_b and W_o follow.
The score and value products of both paths are float32 sums over float32
operands (the bf16 values upcast, exact), the softmax the explicit one
of ``layers``; the cache is bf16.

RoPE is HF's ``DeepseekV2YarnRotaryEmbedding`` and ``apply_rotary_pos_emb``:
the rotary columns de-interleaved (pairs (2i, 2i+1) to i and r/2 + i),
then rotated by halves at YaRN's inverse frequencies (:func:`yarn_freqs`).
The softmax scale is (n + r)^-0.5 times (0.1 · mscale_all_dim · ln factor
+ 1)²; a cos/sin factor other than 1 (``yarn_mscale`` unequal to
``yarn_mscale_all_dim``) is refused.
"""

from __future__ import annotations

import functools
import math

import torch

from ..parallel.actctx import write_slots
from .layers import _project, _scores_softmax_values, attend, rms_norm, rope
from .specs import ParamSpec

__all__ = ["mla_specs", "mla", "yarn_freqs", "softmax_scale", "init_latent_cache"]


def mla_specs(cfg) -> dict:
    d, H, R = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    n, r, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.d_head
    return {
        "wq": ParamSpec((d, H, n + r), ("embed", "heads", "head_dim")),
        "wkv_a": ParamSpec((d, R + r), ("embed", None)),
        "kv_norm": ParamSpec((R,), (None,), init="ones"),
        "wk_b": ParamSpec((R, H, n), (None, "heads", "head_dim")),
        "wv_b": ParamSpec((R, H, dv), (None, "heads", "head_dim")),
        "wo": ParamSpec((H, dv, d), ("heads", "head_dim", "embed")),
    }


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def softmax_scale(cfg) -> float:
    s = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        s *= _mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return s


def yarn_freqs(cfg, device=None):
    """The (r/2,) float32 inverse frequencies of the rotary columns:
    theta's, or with ``yarn_factor`` YaRN's blend of theta's (below the
    correction range) and theta's over the factor (above it), by a linear
    ramp between the correction dims of ``yarn_beta_fast`` and
    ``yarn_beta_slow`` rotations over ``yarn_original_len`` positions.
    Made once a device (every layer of every step reads them)."""
    f = cfg.yarn_factor
    if f and _mscale(f, cfg.yarn_mscale) != _mscale(f, cfg.yarn_mscale_all_dim):
        raise ValueError("a YaRN cos/sin factor other than 1 is not supported")
    return _freqs(cfg.qk_rope_dim, cfg.rope_theta, f, cfg.yarn_original_len,
                  cfg.yarn_beta_fast, cfg.yarn_beta_slow, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=16)
def _freqs(dim, base, f, original_len, beta_fast, beta_slow, device):
    def arange(lo, hi, step=1):
        return torch.arange(lo, hi, step, dtype=torch.float32, device=device)

    extra = 1.0 / base ** (arange(0, dim, 2) / dim)
    if not f:
        return extra
    inter = 1.0 / (f * base ** (arange(0, dim, 2) / dim))

    def corr(rotations):
        return dim * math.log(original_len / (rotations * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(corr(beta_fast)), 0)
    hi = min(math.ceil(corr(beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    keep = 1.0 - ((arange(0, dim // 2) - lo) / (hi - lo)).clamp(0, 1)  # 1: theta's
    return inter * (1 - keep) + extra * keep


def _rope(x, positions, cfg):
    """HF's de-interleave of the rotary columns, then rotation by halves at
    :func:`yarn_freqs`.  x: (B, S, H, r)."""
    x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    return rope(x, positions, cfg.rope_theta, yarn_freqs(cfg, x.device))


def init_latent_cache(cfg, batch_size: int, max_len: int, dtype, device):
    return torch.zeros((batch_size, max_len, cfg.kv_lora_rank + cfg.qk_rope_dim),
                       dtype=dtype, device=device)


def mla(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
        cache=None, cache_pos=None, build_cache: int = 0,
        cache_dtype=torch.bfloat16, q_chunk: int = 0):
    """Causal latent attention.  Returns (out (B, S, d), latent cache or
    None).

    * training: cache None, build_cache 0 -> the expanded pass over x.
    * prefill: build_cache = max_len -> also the (B, max_len, R + r) latent
      cache, zero but for this sequence's positions 0..S-1.
    * decode: cache (B, T, R + r), x (B, 1, d), cache_pos a Python int: this
      step's latent is written at that slot in place (the cache returned is
      the one given), and the step attends over slots 0..cache_pos by the
      absorbed path, reading those cache_pos + 1 rows and no others.
    """
    B, S, d = x.shape
    H, R, n, r = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
    cdt = x.dtype
    scale = softmax_scale(cfg)

    q_nope, q_pe = _project(x, p["wq"]).split([n, r], dim=-1)
    c, k_pe = torch.matmul(x, p["wkv_a"].to(cdt)).split([R, r], dim=-1)
    c = rms_norm({"scale": p["kv_norm"]}, c, cfg.norm_eps)
    q_pe = _rope(q_pe, positions, cfg)
    k_pe = _rope(k_pe[:, :, None], positions, cfg)                  # (B,S,1,r)

    if cache is not None:                                           # absorbed
        T = cache_pos + 1
        write_slots(cache, cache_pos, torch.cat([c, k_pe[:, :, 0]], -1).to(cache.dtype))
        lat = cache[:, :T, None].float()                            # (B,T,1,R+r)
        q_lat = torch.einsum("bshn,chn->bshc", q_nope.float(), p["wk_b"].float())
        qa = torch.cat([q_lat, q_pe.float()], dim=-1)[:, :, None]   # (B,S,1,H,R+r)
        # one key head of R + r columns whose value is its first R; every
        # row read is valid, so the bias is a broadcast zero
        ctx = _scores_softmax_values(qa, lat, lat[..., :R], lat.new_zeros(1, 1, 1),
                                     0.0, scale)[:, :, 0]           # (B,S,H,R)
        out = torch.einsum("bshc,chv->bshv", ctx, p["wv_b"].float())
        new_cache = cache
    else:                                                           # expanded
        k_nope = _project(c, p["wk_b"])
        v = _project(c, p["wv_b"])
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, S, H, r)], dim=-1)
        out = attend(q, k, v, positions, positions, mode="causal", window=0,
                     prefix_len=0, q_chunk=q_chunk, softcap=0.0, scale=scale)
        new_cache = None
        if build_cache:
            new_cache = init_latent_cache(cfg, B, build_cache, cache_dtype, x.device)
            new_cache[:, :S] = torch.cat([c, k_pe[:, :, 0]], -1).to(cache_dtype)

    dv = out.shape[-1]
    out = out.to(cdt).reshape(B, S, H * dv)
    return torch.matmul(out, p["wo"].to(cdt).reshape(H * dv, d)), new_cache
