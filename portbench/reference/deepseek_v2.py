"""Plain float32 forward pass of DeepSeek-V2 (``model_type`` "deepseek_v2"),
the architecture module of ``configs/deepseek-v2-lite.json`` (the
contract is in ``reference/__init__.py``).

Written from the published configuration's keys and from the model's
description (arXiv:2405.04434; HF ``modeling_deepseek.py``), with plain
``torch`` operations: no kernel, cache or batching of the program, and
nothing imported from it.  TF32 is off while it runs
(``model.float32_matmuls``).  Pre-norm decoder, RMSNorm, an untied head;
every layer's mixer is multi-head latent attention, expanded at every
position:

* q = x·W_q (``q_lora_rank`` null: no query latent), heads of
  ``qk_nope_head_dim`` + ``qk_rope_head_dim`` columns;
* x·W_kv_a gives ``kv_lora_rank`` + ``qk_rope_head_dim`` columns: the
  latent (then RMSNorm) and one rotary key shared by every head;
* the latent times W_k_b and W_v_b gives each head's non-rotary key and
  its value (``v_head_dim``);
* the rotary columns of q and k de-interleaved and rotated by halves at
  YaRN's frequencies (``rope_scaling``: theta's below the correction range
  of ``beta_fast`` rotations, theta's over ``factor`` above that of
  ``beta_slow``, a linear ramp between), scores times
  (q width)^-0.5 · (0.1 · ``mscale_all_dim`` · ln ``factor`` + 1)², a
  causal softmax, values, W_o.

The first ``first_k_dense_replace`` layers have a SwiGLU FFN of
``intermediate_size``; every later one (``moe_layer_freq`` 1) DeepSeekMoE:
a float32 softmax router over ``n_routed_experts``, the top
``num_experts_per_tok`` (greedy), gates the probabilities themselves
(``norm_topk_prob`` false) times ``routed_scaling_factor``, each chosen
expert a SwiGLU of ``moe_intermediate_size``, plus ``n_shared_experts``
shared experts taking every token, one SwiGLU of ``n_shared_experts`` x
``moe_intermediate_size``.

Departures from the published model, which the program makes and the
reference follows so that the two compute the same function:

* the MoE drops an assignment past its expert's capacity (Switch
  semantics, ``capacity_factor`` of the file's ``assumed`` keys, counted
  per batch row over the tokens of one call in token-major order), as
  ``model.py``'s jamba MoE does; the published model drops none.  A call's
  capacity is given as ``cap_len``: the first ``cap_len`` tokens of each
  row compete for it (the prefill), every later token is its own call of
  one token and never drops (a decode step);
* the routers' auxiliary losses are the program's Switch load-balance and
  z losses (training only; the published model's sequence-wise balance
  loss is not computed).

Weights are the benchmark's nested tree, layer ``i`` at index ``i // P``
of group entry ``l{i % P}``; here P is the whole depth (the dense first
layer breaks every shorter period), so every layer is index 0 of its
own entry.  ``fp8=True`` is the float8 control of ``model.Reference``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import model


def layer_kinds(conf: dict) -> list:
    """(mixer, ffn) of each layer: latent attention throughout, the first
    ``first_k_dense_replace`` FFNs dense, the rest MoE."""
    if conf["model_type"] != "deepseek_v2":
        raise ValueError(f"{conf.get('name')}: the deepseek_v2 reference has no "
                         f"model_type {conf['model_type']!r}")
    k, freq = conf["first_k_dense_replace"], conf["moe_layer_freq"]
    return [("mla", "moe" if i >= k and i % freq == 0 else "dense")
            for i in range(conf["num_hidden_layers"])]


def period(conf: dict) -> int:
    kinds = layer_kinds(conf)
    n = len(kinds)
    return next(p for p in range(1, n + 1)
                if n % p == 0 and kinds == kinds[:p] * (n // p))


# published key -> the program's ModelConfig field, beyond the harness's
# generic ones
_FIELDS = {
    "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_dim",
    "qk_rope_head_dim": "qk_rope_dim", "v_head_dim": "d_head",
    "n_routed_experts": "n_experts", "moe_intermediate_size": "d_ff_expert",
    "norm_topk_prob": "norm_topk_prob",
}
_YARN = {"factor": "yarn_factor", "original_max_position_embeddings": "yarn_original_len",
         "beta_fast": "yarn_beta_fast", "beta_slow": "yarn_beta_slow",
         "mscale": "yarn_mscale", "mscale_all_dim": "yarn_mscale_all_dim"}


def check_program(conf: dict, cfg) -> None:
    """Raises where the program's ModelConfig ``cfg`` departs from the file:
    the latent-attention dims, YaRN, the experts and their gates, the
    shared experts' width, the layer kinds."""
    name = conf["name"]
    kinds = layer_kinds(conf)
    bad = [f"{k}={conf[k]} but the program runs {f}={getattr(cfg, f)}"
           for k, f in _FIELDS.items() if getattr(cfg, f) != conf[k]]
    rs = conf["rope_scaling"]
    if rs["type"] != "yarn":
        bad.append(f"rope_scaling {rs['type']}: the program has YaRN only")
    bad += [f"rope_scaling.{k}={rs[k]} but the program runs {f}={getattr(cfg, f)}"
            for k, f in _YARN.items() if getattr(cfg, f) != rs[k]]
    if conf["q_lora_rank"] is not None:
        bad.append("q_lora_rank: the program has no query latent")
    shared = conf["n_shared_experts"] * conf["moe_intermediate_size"]
    width = (cfg.d_ff_shared or cfg.d_ff_expert) if cfg.shared_expert else 0
    if width != shared:
        bad.append(f"{conf['n_shared_experts']} shared experts are one SwiGLU {shared} "
                   f"wide; the program's shared expert is {width} wide")
    if conf["routed_scaling_factor"] != 1 or conf["scoring_func"] != "softmax" \
            or conf["topk_method"] != "greedy" or conf["n_group"] != 1:
        bad.append("the program's router is a greedy softmax top-k, gates unscaled")
    program = [(p.mixer, p.ffn) for p in cfg.pattern] * cfg.n_groups
    if program != kinds or len(cfg.pattern) != period(conf):
        bad.append(f"the program's layers {program} are not the published {kinds}")
    if bad:
        raise ValueError(f"{name}: " + "; ".join(bad))


# -- model FLOPs (model.py's counting: the matrices at the experts a token
# is routed to, attention's two products over the whole context, the head)

def _mla_params(c: dict) -> int:
    d, H, R = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    n, r, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    return d * H * (n + r) + d * (R + r) + R * H * (n + dv) + H * dv * d


def _ffn_params(c: dict, ffn: str) -> int:
    d = c["hidden_size"]
    if ffn == "dense":
        return 3 * d * c["intermediate_size"]
    f = c["moe_intermediate_size"]
    return d * c["n_routed_experts"] + 3 * d * f * (c["num_experts_per_tok"]
                                                    + c["n_shared_experts"])


def _attention_width(c: dict) -> int:
    """H · (score width + value width): one position pair's products."""
    return c["num_attention_heads"] * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
                                       + c["v_head_dim"])


def active_matrix_params(conf: dict) -> int:
    return sum(_mla_params(conf) + _ffn_params(conf, f) for _, f in layer_kinds(conf))


def prefill_flops(conf: dict, prompt_len: int) -> int:
    T, L = prompt_len, conf["num_hidden_layers"]
    return (2 * active_matrix_params(conf) * T
            + 2 * conf["hidden_size"] * conf["vocab_size"]
            + 2 * L * _attention_width(conf) * T * T)


def train_flops_per_token(conf: dict, seq_len: int) -> int:
    n = active_matrix_params(conf) + conf["hidden_size"] * conf["vocab_size"]
    return 6 * n + 6 * conf["num_hidden_layers"] * _attention_width(conf) * seq_len


def yarn_inv_freq(conf: dict) -> torch.Tensor:
    """The rotary columns' inverse frequencies (float64), from
    ``rope_theta`` and ``rope_scaling``."""
    dim, base = conf["qk_rope_head_dim"], conf["rope_theta"]
    rs = conf["rope_scaling"]
    f, orig = rs["factor"], rs["original_max_position_embeddings"]
    extra = base ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)

    def corr(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(corr(rs["beta_fast"])), 0)
    hi = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - lo)
            / (hi - lo if hi > lo else 0.001)).clamp(0, 1)
    return extra / f * ramp + extra * (1 - ramp)


def yarn_mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def softmax_scale(conf: dict) -> float:
    rs = conf["rope_scaling"]
    width = conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"]
    return width ** -0.5 * yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2


def rope_yarn(x: torch.Tensor, conf: dict) -> torch.Tensor:
    """x: (B, S, H, r) at positions 0..S-1: HF's de-interleave of the pairs,
    then the halves rotated at :func:`yarn_inv_freq`, the cos and sin times
    mscale over mscale_all_dim's (1 where the two are equal)."""
    S, r = x.shape[1], x.shape[-1]
    x = x.unflatten(-1, (r // 2, 2)).transpose(-1, -2).flatten(-2)
    rs = conf["rope_scaling"]
    amp = yarn_mscale(rs["factor"], rs["mscale"]) / yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    ang = torch.arange(S, dtype=torch.float64)[:, None] * yarn_inv_freq(conf)
    cos = (ang.cos() * amp).float().to(x.device)[:, None]
    sin = (ang.sin() * amp).float().to(x.device)[:, None]
    x1, x2 = x[..., :r // 2], x[..., r // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference(model.Reference):
    """DeepSeek-V2 over the weight tree ``params``."""

    def __init__(self, conf: dict, params: dict, fp8: bool = False):
        self.c, self.p, self.fp8 = conf, params, fp8
        self.kinds, self.P = layer_kinds(conf), period(conf)
        self.d, self.H = conf["hidden_size"], conf["num_attention_heads"]
        self.eps = conf["rms_norm_eps"]

    def mla(self, i, h):
        B, S, d = h.shape
        c, H = self.c, self.H
        R, n, r, dv = (c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                       c["v_head_dim"])
        q = self.mm(h, self.w(i, "mla", "wq").reshape(d, H * (n + r))).view(B, S, H, n + r)
        q_nope, q_pe = q.split([n, r], dim=-1)
        lat, k_pe = self.mm(h, self.w(i, "mla", "wkv_a")).split([R, r], dim=-1)
        lat = model.rms_norm(lat, self.w(i, "mla", "kv_norm"), self.eps)
        k_nope = self.mm(lat, self.w(i, "mla", "wk_b").reshape(R, H * n)).view(B, S, H, n)
        v = self.mm(lat, self.w(i, "mla", "wv_b").reshape(R, H * dv)).view(B, S, H, dv)
        q = torch.cat([q_nope, rope_yarn(q_pe, c)], dim=-1)
        k = torch.cat([k_nope, rope_yarn(k_pe[:, :, None], c).expand(B, S, H, r)], dim=-1)
        s = self.einsum("bqhd,bkhd->bhqk", q, k) * softmax_scale(c)
        causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = self.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * dv)
        return self.mm(o, self.w(i, "mla", "wo").reshape(H * dv, d))

    def moe(self, i, h, cap_len=None):
        """Top-k softmax gates as they are (or renormalised, as the file
        says), times the routed scaling; the first ``cap_len`` tokens of a
        row compete for ``capacity`` slots an expert in token-major order,
        later ones never drop; plus the shared experts.  Returns the
        output and the Switch load-balance and router z losses."""
        B, S, d = h.shape
        E, K = self.c["n_routed_experts"], self.c["num_experts_per_tok"]
        logits = h @ self.w(i, "moe", "router")                       # router in float32
        probs = torch.softmax(logits, dim=-1)
        gate, idx = torch.topk(probs, K, dim=-1)
        if self.c["norm_topk_prob"]:
            gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        gate = gate * self.c["routed_scaling_factor"]
        keep = torch.ones_like(idx, dtype=torch.bool)
        Sc = S if cap_len is None else min(cap_len, S)
        cap = int(min(max(1, round(Sc * K / E * self.c["capacity_factor"])), Sc * K))
        oh = F.one_hot(idx[:, :Sc].reshape(B, Sc * K), E)
        arrived = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1)
        keep[:, :Sc] = (arrived < cap).view(B, Sc, K)
        out = torch.zeros_like(h)
        wg, wu, wd = (self.w(i, "moe", k) for k in ("w_gate", "w_up", "w_down"))
        for e in range(E):
            sel = (idx == e) & keep
            rows = sel.any(-1)
            if not bool(rows.any()):
                continue
            xe = h[rows]
            ye = self.mm(F.silu(self.mm(xe, wg[e])) * self.mm(xe, wu[e]), wd[e])
            g = (gate * sel).sum(-1)[rows]
            out = out.index_put((rows.nonzero(as_tuple=True)),
                                g[:, None] * ye, accumulate=True)
        sg, su, sd = (self.w(i, "moe", "shared", k) for k in ("w_gate", "w_up", "w_down"))
        out = out + self.mm(F.silu(self.mm(h, sg)) * self.mm(h, su), sd)
        onehot = F.one_hot(idx, E).float()
        lb = E * torch.sum(probs.mean(dim=(0, 1)) * onehot.mean(dim=(0, 1, 2)))
        zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        return out, lb, zl

    def hidden(self, tokens: torch.Tensor, cap_len=None):
        """tokens (B, S) -> (final-normed hidden (B, S, d), lb, z)."""
        x = self.p["embed"].float()[tokens]
        lb = zl = torch.zeros((), device=x.device)
        for i, (_, ffn) in enumerate(self.kinds):
            x = x + self.mla(i, model.rms_norm(x, self.w(i, "ln1", "scale"), self.eps))
            h = model.rms_norm(x, self.w(i, "ln2", "scale"), self.eps)
            if ffn == "moe":
                f, a, b = self.moe(i, h, cap_len)
                lb, zl = lb + a, zl + b
                x = x + f
            else:
                x = x + self.ffn(i, h)
        return model.rms_norm(x, self.p["final_norm"]["scale"].float(), self.eps), lb, zl
