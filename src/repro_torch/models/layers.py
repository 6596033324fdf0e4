"""Transformer building blocks of the port: norms, RoPE, GQA attention and
the dense FFN.

The port of ``repro/models/layers.py``, op for op and cast for cast.  All
functions are pure: ``(params, inputs, cfg) -> outputs``; each block has a
``*_specs`` twin with the reference's parameter layouts and paths (``wq``
is ``(d, H, Dh)``, ``wo`` ``(H, Dh, d)``), so a checkpoint of either
package loads into either model by name.

Attention covers every variant behind the reference's flags: GQA with any
number of kv heads (head h reads kv head ``h // G``, MQA with one), qk-norm,
QKV bias, the logit softcap, the causal, sliding-window, prefix-LM and
bidirectional masks, a KV cache built by the prefill and written by each
decode step, the static cross cache (``update_cache=False``) and
query-chunked scoring for long prefills.  The softmax is the reference's
explicit one, in float32 over float32 scores: a fully masked row gives
zeros (``F.scaled_dot_product_attention`` gives NaN) and the softcap sits
between the scores and the mask.  The scores are float32 products, so they
need TF32 off, PyTorch's default (``torch.backends.cuda.matmul.allow_tf32``).
Each query chunk's scores and probabilities are recomputed in the backward
(:func:`recompute`, the reference's ``jax.checkpoint`` of its scan step),
so no (chunk, T) tensor is kept for it.  A causal self-attention prefill
on the card with autograd off (bf16, head widths the kernel is built for)
runs instead as one launch of the attention kernel
(``kernels/flash_attention.py``), which keeps these float32 semantics and
writes no score to device memory.

The reference's §Perf variants (``PERF_FLAGS``, off by default) take bf16
operands to float32 sums: products of bf16 values are exact in float32, so
the port upcasts the operands and multiplies in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.utils.checkpoint import checkpoint

from ..kernels import flash_attention as fa
from ..parallel.actctx import constrain, tp_size, write_slots
from ..parallel.meshed import attention_core
from .specs import ParamSpec

__all__ = ["rms_norm", "norm_specs", "rope", "attn_specs", "attend", "attention",
           "ffn_specs", "ffn", "recompute"]


def recompute(fn, *args, context_fn=None):
    """``fn(*args)`` with its activations dropped after the forward and
    recomputed in the backward (the reference's ``jax.checkpoint``);
    ``context_fn`` selects what is saved instead (a selective-checkpoint
    policy).  A plain call where no gradient is recorded.  The model draws
    no random numbers, so no RNG state is stashed."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def norm_specs(d_model: int) -> dict:
    return {"scale": ParamSpec((d_model,), ("embed",), init="ones")}


# the reference's §Perf variants, off by default as there: rms_norm's
# variance from bf16 products with float32 sums, the result x times the
# inverse in bf16; the attention products on bf16 operands with float32
# sums and the probabilities stored in bf16
PERF_FLAGS = {"rms_einsum": False, "softmax_bf16_probs": False}


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm with float32 statistics over a float32 copy of ``x``, or
    (``rms_einsum``, ``x`` not float32) over exact bf16 products."""
    dt = x.dtype
    scale = p["scale"].float()
    if zero_centered:
        scale = 1.0 + scale
    xf = x.float()
    if PERF_FLAGS["rms_einsum"] and dt != torch.float32:
        inv = torch.rsqrt(torch.sum(xf * xf, dim=-1) / x.shape[-1] + eps)[..., None]
        return x * (inv * scale).to(dt)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    return (xn * scale).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotary embedding in float32, the halves rotated (NeoX).  x: (B, S,
    H, D) (D even), positions: (B, S); ``freqs`` (D/2,) float32 in place
    of theta's (YaRN's blend)."""
    half = x.shape[-1] // 2
    if freqs is None:
        exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
        freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                          exps)
    ang = positions[..., None].float() * freqs                  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attn_specs(cfg, cross: bool = False) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    sp = {
        "wq": ParamSpec((d, H, Dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, Dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        sp["bq"] = ParamSpec((H, Dh), ("heads", "head_dim"), init="zeros")
        sp["bk"] = ParamSpec((KV, Dh), ("kv_heads", "head_dim"), init="zeros")
        sp["bv"] = ParamSpec((KV, Dh), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        sp["q_norm"] = ParamSpec((Dh,), (None,), init="ones")
        sp["k_norm"] = ParamSpec((Dh,), (None,), init="ones")
    return sp


def _mask_bias(mode: str, q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int = 0, prefix_len: int = 0,
               k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive mask (B?, S_q, S_k) in float32: 0 = attend, -inf = blocked."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    if mode == "bidir":
        ok = torch.ones_like(q + k, dtype=torch.bool)
    elif mode == "causal":
        ok = k <= q
    elif mode == "sliding":
        ok = (k <= q) & (k > q - window)
    elif mode == "prefix":
        # bidirectional within the first prefix_len positions, causal after
        ok = (k <= q) | (k < prefix_len)
    else:
        raise ValueError(mode)
    if k_valid is not None:
        ok = ok & k_valid[..., None, :]
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill_(~ok, float("-inf"))


def _scores(q, k, bias, softcap: float, scale: float):
    """q: (B,S,KV,G,D), k: (B,T,KV,D), bias: (B,S,T).  Returns the biased,
    capped scores (B,KV,G,S,T) float32.  ``softmax_bf16_probs`` (q not
    float32): q·scale rounded to q's type first."""
    qs = q.float() * scale
    if PERF_FLAGS["softmax_bf16_probs"] and q.dtype != torch.float32:
        qs = qs.to(q.dtype).float()
    s = torch.einsum("bskgd,btkd->bkgst", qs, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    return s + bias[:, None, None, :, :]


def _scores_softmax_values(q, k, v, bias, softcap: float, scale: float):
    """q: (B,S,KV,G,D), k/v: (B,T,KV,D), bias: (B,S,T).  Returns
    (B,S,KV,G,D) float32."""
    s = _scores(q, k, bias, softcap, scale)
    m = torch.amax(s, dim=-1, keepdim=True).clamp_min(-1e30)  # fully masked rows
    p = torch.exp(s - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = p / denom.clamp_min(1e-30)
    return weighted_values(p, v)


def weighted_values(p, v):
    """p (B,KV,G,S,T) float32 @ v (B,T,KV,D) -> (B,S,KV,G,D) float32;
    ``softmax_bf16_probs`` (v not float32): p rounded to v's type."""
    if PERF_FLAGS["softmax_bf16_probs"] and v.dtype != torch.float32:
        p = p.to(v.dtype).float()
    return torch.einsum("bkgst,btkd->bskgd", p, v.float())


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, dk = w.shape
    out = torch.matmul(x, w.to(x.dtype).reshape(d, h * dk))
    # under a mesh, the flat heads split over TP only whole (a no-op on a
    # plain tensor)
    out = constrain(out, ("dp", None, "tp" if h % tp_size() == 0 else None))
    return out.unflatten(-1, (h, dk))


def _real_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda and not is_fake(t)


def _on_flash_kernel(q5, k, v, mode: str, window: int, softcap: float) -> bool:
    """The attention kernel's rule, on what the call observes alone: real
    CUDA tensors with autograd off, bf16 q, k and v, the causal mask with no
    window, softcap or bf16-probability variant, self-attention, and head
    widths the kernel is built for."""
    return (_real_cuda(q5) and not torch.is_grad_enabled()
            and q5.dtype == k.dtype == v.dtype == torch.bfloat16
            and mode == "causal" and not window and not softcap
            and not PERF_FLAGS["softmax_bf16_probs"] and k.shape[1] == q5.shape[1]
            and (q5.shape[-1], v.shape[-1]) in fa.WIDTHS)


def attend(q, k, v, q_pos, k_pos, *, mode: str, window: int, prefix_len: int,
           q_chunk: int, softcap: float, scale: float) -> torch.Tensor:
    """Every query of q (B, S, H, Dk) against every key of k (B, T, KV, Dk)
    under ``mode``'s mask, as float32 scores and an explicit softmax;
    values v (B, T, KV, Dv).  Returns (B, S, H, Dv) float32.  Where
    :func:`_on_flash_kernel` holds, one launch of the attention kernel
    (``kernels/flash_attention.py``) over the whole sequence; else the
    eager core, and with ``q_chunk`` dividing S, the queries go a chunk at
    a time."""
    S = q.shape[1]

    def full_pass(q5, k, v, q_pos, k_pos):
        if _on_flash_kernel(q5, k, v, mode, window, softcap):
            out = fa.flash_attention(q5.flatten(2, 3), k, v, q_pos.to(torch.int32),
                                     k_pos.to(torch.int32), scale)
            return out.unflatten(2, q5.shape[2:4])
        if q_chunk and S > q_chunk and S % q_chunk == 0:
            # flash-style: a bias a chunk, so no (S, S) mask
            # materializes; each chunk recomputed in the backward, so
            # no (c, T) scores are kept
            def step(qq, pp, k, v, k_pos):
                bb = _mask_bias(mode, pp, k_pos, window=window,
                                prefix_len=prefix_len)               # (B,c,T)
                return _scores_softmax_values(qq, k, v, bb, softcap, scale)

            out = torch.empty(q5.shape[:-1] + v.shape[-1:], dtype=torch.float32,
                              device=q5.device)
            for lo in range(0, S, q_chunk):
                hi = lo + q_chunk
                out[:, lo:hi] = recompute(step, q5[:, lo:hi],
                                          q_pos[:, lo:hi], k, v, k_pos)
            return out
        bias = _mask_bias(mode, q_pos, k_pos, window=window,
                          prefix_len=prefix_len)                     # (B,S,T)
        return _scores_softmax_values(q5, k, v, bias, softcap, scale)

    return attention_core(full_pass, q, k, v, (q_pos, k_pos), (("dp",), ("dp",)))


def attention(p: dict, x: torch.Tensor, cfg, *,
              mode: str = "causal",
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None,
              cache_pos: Optional[int] = None,
              update_cache: bool = True,
              build_cache: int = 0,
              cache_dtype=torch.bfloat16,
              kv_input: Optional[torch.Tensor] = None,
              window: int = 0,
              prefix_len: int = 0,
              q_chunk: int = 0) -> tuple[torch.Tensor, Optional[dict]]:
    """GQA attention.  Returns (out (B,S,d), cache-or-None).

    * training: cache None, build_cache 0 -> full self-attention over x.
    * prefill: build_cache = max_len -> also returns {"k","v"} of
      (B, max_len, KV, D), zero but for this sequence's (roped) kv at
      positions 0..S-1.
    * decode: cache {"k","v"} (B, T, KV, D); x is (B, 1, d); cache_pos a
      Python int — this step's kv is written into the cache at that slot,
      in place (the cache returned is the one given), and the step attends
      over slots 0..cache_pos.
    * cross-attention: kv_input (B, T, d) (encoder output, training) or
      cache given with update_cache=False (decode over a static encoder kv:
      no rope, every slot valid).
    """
    B, S, d = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cdt = x.dtype
    scale = Dh ** -0.5
    static = cache is not None and not update_cache
    is_cross = kv_input is not None or static

    q = constrain(_project(x, p["wq"]), ("dp", None, "tp", None))
    k = v = None                          # a static cross cache: kv precomputed
    if not static:
        kv_src = kv_input if kv_input is not None else x
        k = constrain(_project(kv_src, p["wk"]), ("dp", None, "tp", None))
        v = constrain(_project(kv_src, p["wv"]), ("dp", None, "tp", None))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        if k is not None:
            k = k + p["bk"].to(cdt)
            v = v + p["bv"].to(cdt)
    if cfg.qk_norm:
        q = rms_norm({"scale": p["q_norm"]}, q, cfg.norm_eps)
        if k is not None:
            k = rms_norm({"scale": p["k_norm"]}, k, cfg.norm_eps)

    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    if not is_cross and cfg.rope_theta > 0:           # no rope on cross-attn
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        T = ck.shape[1]
        k_pos = torch.arange(T, device=x.device)[None]               # (1, T)
        if update_cache:
            # decode: this step's kv into the cache at cache_pos
            write_slots(ck, cache_pos, k.to(ck.dtype))
            write_slots(cv, cache_pos, v.to(cv.dtype))
            k_valid = k_pos <= cache_pos
            if mode == "sliding" and window:
                k_valid = k_valid & (k_pos > cache_pos - window)
        else:
            k_valid = torch.ones_like(k_pos, dtype=torch.bool)
        new_cache = cache
        bias = torch.zeros(k_valid.shape, dtype=torch.float32, device=x.device)
        bias = bias.masked_fill_(~k_valid, float("-inf"))[:, None, :]
        # under a mesh, a cache split by time is attended slice by slice
        out = attention_core(
            lambda *a: _scores_softmax_values(*a, cfg.attn_softcap, scale),
            q, ck.to(cdt), cv.to(cdt), (bias.expand(B, S, T),), (("dp",),),
            scores=lambda *a: _scores(*a, cfg.attn_softcap, scale))
    else:
        k_pos_full = positions if kv_input is None else torch.arange(
            k.shape[1], dtype=torch.int32, device=x.device)[None].expand(B, -1)
        out = attend(q, k, v, positions, k_pos_full, mode=mode, window=window,
                     prefix_len=prefix_len, q_chunk=q_chunk,
                     softcap=cfg.attn_softcap, scale=scale)
        if build_cache:
            shape = (B, build_cache, KV, Dh)
            zk = k.new_zeros(shape, dtype=cache_dtype)
            zv = v.new_zeros(shape, dtype=cache_dtype)
            zk[:, :k.shape[1]] = k.to(cache_dtype)
            zv[:, :v.shape[1]] = v.to(cache_dtype)
            new_cache = {"k": zk, "v": zv}

    out = out.to(cdt).reshape(B, S, H * Dh)
    proj = torch.matmul(out, p["wo"].to(cdt).reshape(H * Dh, d))
    # row-parallel: the partial sums reduced here, under a mesh
    return constrain(proj, ("dp", None, None)), new_cache


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def ffn_specs(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "ff")),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "ff")),
        "w_down": ParamSpec((d_ff, d_model), ("ff", "embed")),
    }


def ffn(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    cdt = x.dtype
    g = constrain(torch.matmul(x, p["w_gate"].to(cdt)), ("dp", None, "tp"))
    u = constrain(torch.matmul(x, p["w_up"].to(cdt)), ("dp", None, "tp"))
    if act == "gelu":
        g = F.gelu(g.float(), approximate="tanh").to(cdt)
    else:
        g = F.silu(g.float()).to(cdt)
    return constrain(torch.matmul(g * u, p["w_down"].to(cdt)), ("dp", None, None))
