"""Mixture-of-Experts FFN (llama4-scout/maverick top-1, jamba top-2,
DeepSeekMoE top-6 with shared experts).

The port of ``repro/models/moe.py``: the same *per-row* capacity dispatch,
op for op.  Every batch row routes its own S tokens:

  1. router in float32, softmax, top-k; the k gates renormalised over
     their sum (at least 1e-9), unless ``norm_topk_prob`` is off
     (DeepSeek-V2: the softmax's probabilities as they are)
  2. position-in-expert = exclusive cumsum of the expert one-hots over
     the row's (token, k) assignments in token-major order
  3. an assignment past its expert's capacity C drops (Switch semantics,
     ``capacity_factor``); the source index of each of an expert's C
     slots is found as the C smallest arrival scores
  4. expert_in = a gather (B, E, C, d); the experts' FFNs as batched
     matmuls in the compute type
  5. combine: each (token, k) reads its slot back, gate-weighted, summed
     over k; plus the shared expert where the config has one, as wide as
     a routed one or ``d_ff_shared`` (DeepSeek-V2's 2 shared experts are
     one SwiGLU of twice the width)

Ties break toward the lower index, as ``jax.lax.top_k`` breaks them: the
selections are stable sorts (``torch.topk`` promises no order among
equal values), so a row whose router probabilities tie picks the
reference's experts.

The reference gives both gathers a ``custom_vjp`` whose backward is the
other direction's gather (a gather by ``slot`` for dispatch, by ``src``
for combine), so that GSPMD need not shard a scatter.  Plain autograd of
the forward gathers is a scatter-add over the same terms, at most
``experts_per_token`` of them a token, which sums them to the same values.

Aux outputs: the Switch load-balance loss and the router z-loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.actctx import constrain
from .specs import ParamSpec

__all__ = ["moe_specs", "moe_ffn"]


def moe_specs(cfg) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff_expert or cfg.d_ff, cfg.n_experts
    sp = {
        "router": ParamSpec((d, E), ("embed", "experts_r"), scale=0.1),
        "w_gate": ParamSpec((E, d, f), ("experts", "embed", "ff")),
        "w_up": ParamSpec((E, d, f), ("experts", "embed", "ff")),
        "w_down": ParamSpec((E, f, d), ("experts", "ff", "embed")),
    }
    if cfg.shared_expert:
        fs = cfg.d_ff_shared or f
        sp["shared"] = {
            "w_gate": ParamSpec((d, fs), ("embed", "ff")),
            "w_up": ParamSpec((d, fs), ("embed", "ff")),
            "w_down": ParamSpec((fs, d), ("ff", "embed")),
        }
    return sp


def _top_k(x: torch.Tensor, k: int, largest: bool):
    """The k largest (or smallest) values along the last dim and their
    indices, equal values in index order (``lax.top_k``'s tie rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=largest, stable=True)
    return vals[..., :k], idx[..., :k]


def _act(g: torch.Tensor, act: str, cdt) -> torch.Tensor:
    if act == "silu":
        return F.silu(g.float()).to(cdt)
    return F.gelu(g.float(), approximate="tanh").to(cdt)


def _dense_ffn(p, x, act):
    g = torch.matmul(x, p["w_gate"].to(x.dtype))
    u = torch.matmul(x, p["w_up"].to(x.dtype))
    return torch.matmul(_act(g, act, x.dtype) * u, p["w_down"].to(x.dtype))


def _dispatch_gather(K: int, x, src, slot_valid):
    """x: (B,S,d) token stream; src: (B,EC) flat assignment index (t*K+k)
    or sentinel; returns (B,EC,d)."""
    tok = torch.clamp_max(src // K, x.shape[1] - 1)
    out = torch.gather(x, 1, tok[..., None].expand(-1, -1, x.shape[-1]))
    return torch.where(slot_valid[..., None], out, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))


def _combine_gather(y, slot, valid):
    """y: (B,EC,d) expert outputs; slot: (B,SK); returns (B,SK,d)."""
    safe = torch.clamp_max(slot, y.shape[1] - 1)
    out = torch.gather(y, 1, safe[..., None].expand(-1, -1, y.shape[-1]))
    return torch.where(valid[..., None], out, torch.zeros((), dtype=y.dtype,
                                                          device=y.device))


def _expert_ffn(p, expert_in, act):
    """The experts' FFNs, one batched matmul a weight over E.
    expert_in: (B, E, C, d) -> (B, E, C, d)."""
    B, E, C, d = expert_in.shape
    cdt = expert_in.dtype
    ein = expert_in.transpose(0, 1).reshape(E, B * C, d)
    g = torch.bmm(ein, p["w_gate"].to(cdt))                            # (E,BC,f)
    u = torch.bmm(ein, p["w_up"].to(cdt))
    eout = torch.bmm(_act(g, act, cdt) * u, p["w_down"].to(cdt))
    return eout.reshape(E, B, C, d).transpose(0, 1)


def moe_ffn(p: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (out (B, S, d), {"lb_loss", "z_loss"})."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    cdt = x.dtype
    C = int(min(max(1, round(S * K / E * cfg.capacity_factor)), S * K))

    logits = constrain(torch.matmul(x.float(), p["router"].float()),
                       ("dp", None, None))                             # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_k, idx_k = _top_k(probs, K, largest=True)               # (B,S,K)
    if cfg.norm_topk_prob:
        gate_k = gate_k / torch.clamp_min(gate_k.sum(-1, keepdim=True), 1e-9)

    # --- aux losses (Switch): load balance + z-loss
    me = probs.mean(dim=(0, 1))                                        # (E,)
    onehot = F.one_hot(idx_k, E).float()                               # (B,S,K,E)
    ce = onehot.mean(dim=(0, 1, 2))
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # --- position of each (s, k) assignment within its expert, per row:
    # exclusive cumsum of the one-hots in token-major order (exact
    # integers in float32, as the reference counts them)
    oh_flat = onehot.reshape(B, S * K, E)                              # (B,SK,E)
    pos = torch.cumsum(oh_flat, dim=1) - oh_flat
    pos_k = (pos * oh_flat).sum(-1).to(torch.int32)                    # (B,SK)
    e_flat = idx_k.reshape(B, S * K).to(torch.int32)
    valid = pos_k < C
    slot = torch.where(valid, e_flat * C + pos_k, E * C).long()        # (B,SK)

    # --- expert-major source indices (first come, first served): the C
    # smallest of score[b,e,t] = t if assignment t chose e else SK
    tpos = torch.arange(S * K, dtype=torch.int32, device=x.device)
    score = torch.where(oh_flat.transpose(1, 2) > 0, tpos, S * K)      # (B,E,SK)
    vals, src = _top_k(score, C, largest=False)                  # (B,E,C)
    src = src.reshape(B, E * C)
    slot_valid = vals.reshape(B, E * C) < S * K

    # --- gather tokens -> (B, E, C, d)
    xg = _dispatch_gather(K, x, src, slot_valid)                       # (B,EC,d)
    expert_in = constrain(xg.reshape(B, E, C, d), ("dp", None, None, None))

    # --- expert FFN: every expert's weights, batched over E
    expert_out = _expert_ffn(p, expert_in, cfg.ffn_act)
    out_flat = constrain(expert_out.reshape(B, E * C, d), ("dp", None, None))

    # --- combine: per (token, k) read its slot back, gate-weight, sum over k
    back = _combine_gather(out_flat, slot, valid)                      # (B,SK,d)
    back = back.reshape(B, S, K, d) * gate_k[..., None].to(cdt)
    out = back.sum(dim=2)

    if cfg.shared_expert:
        out = out + _dense_ffn(p["shared"], x, cfg.ffn_act)
    return out, {"lb_loss": lb_loss, "z_loss": z_loss}
