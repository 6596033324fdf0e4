"""Plain float32 forward passes of qwen3 and jamba, the architecture module
of every configuration file without a ``reference`` key (the contract is in
``reference/__init__.py``), and the module the shared helpers live in.

Written from the configurations' published keys (``configs/*.json``) and
from the architecture the port runs, with plain ``torch`` operations:
no kernel, cache or batching of the program, and nothing imported from
it.  TF32 is off while it runs (``float32_matmuls``).

* qwen3 (``model_type`` "qwen3"): pre-norm decoder, RMSNorm, GQA attention
  with per-head RMSNorm on q and k and NeoX-style RoPE, a SwiGLU FFN, an
  untied head.
* jamba (``model_type`` "jamba"): layer i attends when ``i % period ==
  offset`` and is a Mamba-1 mixer otherwise; its FFN is a top-2 MoE when
  ``i % expert_period == expert_offset``.  No positional encoding.

Departures from the published models, which the port makes and the
reference follows so that the two compute the same function: jamba's
Mamba has no RMSNorm on dt, B and C, its dt rank is d_model // 16, and
its MoE drops an assignment past its expert's capacity (Switch
semantics, ``capacity_factor`` of the file's ``assumed`` keys, counted
per batch row over the tokens of one call in token-major order).  A
call's capacity is given as ``cap_len``: the first ``cap_len`` tokens of
each row compete for it (the prefill), every later token is its own
call of one token and never drops (a decode step).

Weights are the nested tree the benchmark draws (the layout the program
takes: layer ``i`` at index ``i // P`` of group entry ``l{i % P}``, P the
period of the layer kinds).  ``fp8=True`` is the control: every product's
operands rounded to float8 e4m3 with a per-tensor scale (amax / 448), the
lower precision a later change to the bf16 program would reach for.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def layer_kinds(conf: dict) -> list:
    """(mixer, ffn) of each layer, from the published keys."""
    n = conf["num_hidden_layers"]
    if conf["model_type"] == "qwen3":
        return [("attn", "dense")] * n
    if conf["model_type"] == "jamba":
        return [("attn" if i % conf["attn_layer_period"] == conf["attn_layer_offset"]
                 else "mamba",
                 "moe" if conf["num_experts"] > 1
                 and i % conf["expert_layer_period"] == conf["expert_layer_offset"]
                 else "dense") for i in range(n)]
    raise ValueError(f"no reference for model_type {conf['model_type']!r}")


def period(conf: dict) -> int:
    """The shortest run of layer kinds the whole stack repeats."""
    kinds = layer_kinds(conf)
    n = len(kinds)
    return next(p for p in range(1, n + 1)
                if n % p == 0 and kinds == kinds[:p] * (n // p))


def check_program(conf: dict, cfg) -> None:
    """Raises where the program's ModelConfig ``cfg`` departs from the
    file: jamba's dt rank, qwen3's q and k norms, the layer kinds."""
    if "mamba_dt_rank" in conf and cfg.d_model // 16 != conf["mamba_dt_rank"]:
        raise ValueError(f"{conf['name']}: the program's dt rank is d_model // 16")
    if conf["model_type"] == "qwen3" and not cfg.qk_norm:
        raise ValueError(f"{conf['name']}: qwen3 normalises q and k; the program does not")
    program = [(p.mixer, p.ffn) for p in cfg.pattern] * cfg.n_groups
    if program != layer_kinds(conf) or len(cfg.pattern) != period(conf):
        raise ValueError(f"{conf['name']}: the program's layers {program} are "
                         f"not the published {layer_kinds(conf)}")


# -- model FLOPs ---------------------------------------------------------
#
# The products of the model's matrices at the experts a token is routed to
# (top-k, not the capacity the program computes), and attention's two
# score products over the whole context (PaLM, appendix B: 6N + 12 L H Q T
# a trained token; a forward is a third of it).  N counts the layers'
# matrices and the unembedding, not the embedding lookup, the norms or the
# convolution; recomputation is not counted.

def _dims(conf: dict) -> dict:
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    return {"d": d, "H": H, "KV": conf["num_key_value_heads"],
            "Dh": conf.get("head_dim") or d // H, "f": conf["intermediate_size"],
            "V": conf["vocab_size"], "E": conf.get("num_experts", 1),
            "K": conf.get("num_experts_per_tok", 1),
            "di": conf.get("mamba_expand", 0) * d, "n": conf.get("mamba_d_state", 0),
            "R": conf.get("mamba_dt_rank", 0)}


def mixer_params(conf: dict, mixer: str) -> int:
    s = _dims(conf)
    if mixer == "attn":
        return s["d"] * (2 * s["H"] + 2 * s["KV"]) * s["Dh"]
    di = s["di"]
    return s["d"] * 2 * di + di * (s["R"] + 2 * s["n"]) + s["R"] * di + di * s["d"]


def ffn_params(conf: dict, ffn: str, active: bool = True) -> int:
    """A dense FFN's matrices, or a MoE's router and its experts (the
    top-k a token reaches when ``active``, else all)."""
    s = _dims(conf)
    one = 3 * s["d"] * s["f"]
    if ffn == "dense":
        return one
    return s["d"] * s["E"] + (s["K"] if active else s["E"]) * one


def active_matrix_params(conf: dict) -> int:
    """The layers' matrices a token runs through."""
    return sum(mixer_params(conf, m) + ffn_params(conf, f)
               for m, f in layer_kinds(conf))


def attention_layers(conf: dict) -> int:
    return sum(m == "attn" for m, _ in layer_kinds(conf))


def train_flops_per_token(conf: dict, seq_len: int) -> int:
    s = _dims(conf)
    n = active_matrix_params(conf) + s["d"] * s["V"]
    return 6 * n + 12 * attention_layers(conf) * s["H"] * s["Dh"] * seq_len


def prefill_flops(conf: dict, prompt_len: int) -> int:
    """One request's prefill: its prompt through the layers, attention over
    the prompt, and the logits of its last position."""
    s = _dims(conf)
    T = prompt_len
    return (2 * active_matrix_params(conf) * T + 2 * s["d"] * s["V"]
            + 4 * attention_layers(conf) * s["H"] * s["Dh"] * T * T)


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for the reference's products, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale; the gradient
    passes through unchanged."""
    s = t.detach().abs().amax().float().clamp_min(1e-30) / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t).detach() if t.requires_grad else q


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x: (B, S, H, D) at positions 0..S-1; halves rotated (NeoX)."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    """The architecture of ``conf`` over the weight tree ``params``."""

    def __init__(self, conf: dict, params: dict, fp8: bool = False):
        self.c = conf
        self.p = params
        self.fp8 = fp8
        self.kinds = layer_kinds(conf)
        self.P = period(conf)
        self.d = conf["hidden_size"]
        self.H = conf["num_attention_heads"]
        self.KV = conf["num_key_value_heads"]
        self.Dh = conf.get("head_dim") or self.d // self.H
        self.eps = conf["rms_norm_eps"]

    # -- weights and products ------------------------------------------

    def w(self, i: int, *path) -> torch.Tensor:
        t = self.p["layers"][f"l{i % self.P}"]
        for k in path:
            t = t[k]
        return t[i // self.P].float()

    def mm(self, x, w):
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        return x @ w

    def einsum(self, eq, a, b):
        if self.fp8:
            a, b = fp8_round(a), fp8_round(b)
        return torch.einsum(eq, a, b)

    # -- layers ---------------------------------------------------------

    def attention(self, i, h):
        B, S, d = h.shape
        H, KV, Dh = self.H, self.KV, self.Dh
        q = self.mm(h, self.w(i, "attn", "wq").reshape(d, H * Dh)).view(B, S, H, Dh)
        k = self.mm(h, self.w(i, "attn", "wk").reshape(d, KV * Dh)).view(B, S, KV, Dh)
        v = self.mm(h, self.w(i, "attn", "wv").reshape(d, KV * Dh)).view(B, S, KV, Dh)
        if self.c["model_type"] == "qwen3":
            q = rms_norm(q, self.w(i, "attn", "q_norm"), self.eps)
            k = rms_norm(k, self.w(i, "attn", "k_norm"), self.eps)
        theta = self.c.get("rope_theta") or 0
        if theta:
            q, k = rope(q, theta), rope(k, theta)
        k = k.repeat_interleave(H // KV, dim=2)        # head h reads kv head h // G
        v = v.repeat_interleave(H // KV, dim=2)
        s = self.einsum("bqhd,bkhd->bhqk", q, k) * Dh ** -0.5
        causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = self.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * Dh)
        return self.mm(o, self.w(i, "attn", "wo").reshape(H * Dh, d))

    def ffn(self, i, h):
        g = self.mm(h, self.w(i, "ffn", "w_gate"))
        u = self.mm(h, self.w(i, "ffn", "w_up"))
        return self.mm(F.silu(g) * u, self.w(i, "ffn", "w_down"))

    def mamba(self, i, h, chunk: int = 16):
        """Mamba-1: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t
        + D x_t, by chunks in closed form (cumulative log-decays)."""
        B, S, _ = h.shape
        di = self.c["mamba_expand"] * self.d
        n = self.c["mamba_d_state"]
        K = self.c["mamba_d_conv"]
        R = self.c["mamba_dt_rank"]
        x, z = self.mm(h, self.w(i, "mamba", "in_proj")).split(di, dim=-1)
        conv_w = self.w(i, "mamba", "conv_w")                          # (K, di)
        xc = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), conv_w.t()[:, None, :],
                      bias=self.w(i, "mamba", "conv_b"), groups=di)
        xs = F.silu(xc.transpose(1, 2))                               # (B, S, di)
        dt_in, b_in, c_in = self.mm(xs, self.w(i, "mamba", "x_proj")).split([R, n, n], -1)
        dt = F.softplus(self.mm(dt_in, self.w(i, "mamba", "dt_proj"))
                        + self.w(i, "mamba", "dt_bias"))              # (B, S, di)
        A = -torch.exp(self.w(i, "mamba", "a_log"))                   # (di, n)
        state = torch.zeros(B, di, n, device=h.device)
        ys = []
        for lo in range(0, S, chunk):
            dtc, xsc = dt[:, lo:lo + chunk], xs[:, lo:lo + chunk]
            L = dtc.shape[1]
            cum = torch.cumsum(dtc[..., None] * A, dim=1)             # (B, L, di, n)
            bx = (dtc * xsc)[..., None] * b_in[:, lo:lo + chunk, None, :]
            later = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()
            diff = (cum[:, :, None] - cum[:, None, :]).masked_fill(
                ~later[None, :, :, None, None], float("-inf"))
            hs = torch.einsum("btsdn,bsdn->btdn", diff.exp(), bx) \
                + cum.exp() * state[:, None]
            ys.append(torch.einsum("btdn,btn->btd", hs, c_in[:, lo:lo + chunk]))
            state = hs[:, -1]
        y = torch.cat(ys, dim=1) + xs * self.w(i, "mamba", "d_skip")
        return self.mm(y * F.silu(z), self.w(i, "mamba", "out_proj"))

    def moe(self, i, h, cap_len=None):
        """Top-k routing, gates renormalised over the k; the first
        ``cap_len`` tokens of a row compete for ``capacity`` slots an
        expert in token-major order, later ones never drop.  Returns the
        output and the Switch load-balance and router z losses."""
        B, S, d = h.shape
        E, K = self.c["num_experts"], self.c["num_experts_per_tok"]
        logits = h @ self.w(i, "moe", "router")                       # router in float32
        probs = torch.softmax(logits, dim=-1)
        gate, idx = torch.topk(probs, K, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
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
        onehot = F.one_hot(idx, E).float()
        lb = E * torch.sum(probs.mean(dim=(0, 1)) * onehot.mean(dim=(0, 1, 2)))
        zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        return out, lb, zl

    # -- the model ------------------------------------------------------

    def hidden(self, tokens: torch.Tensor, cap_len=None):
        """tokens (B, S) -> (final-normed hidden (B, S, d), lb, z)."""
        x = self.p["embed"].float()[tokens]
        lb = zl = torch.zeros((), device=x.device)
        for i, (mixer, ffn) in enumerate(self.kinds):
            h = rms_norm(x, self.w(i, "ln1", "scale"), self.eps)
            x = x + (self.attention(i, h) if mixer == "attn" else self.mamba(i, h))
            h = rms_norm(x, self.w(i, "ln2", "scale"), self.eps)
            if ffn == "moe":
                f, a, b = self.moe(i, h, cap_len)
                lb, zl = lb + a, zl + b
                x = x + f
            else:
                x = x + self.ffn(i, h)
        return rms_norm(x, self.p["final_norm"]["scale"].float(), self.eps), lb, zl

    def logits(self, h):
        return self.mm(h, self.p["lm_head"].float())

    def loss(self, tokens, targets, aux_weight: float = 0.01, z_weight: float = 0.001):
        """Mean next-token cross-entropy over every position, plus the
        router losses where the model routes."""
        h, lb, zl = self.hidden(tokens)
        logits = self.logits(h)
        tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
        xent = (torch.logsumexp(logits, dim=-1) - tgt).mean()
        return xent + aux_weight * lb + z_weight * zl


def flatten(tree: dict, prefix: str = "") -> dict:
    """{dotted.path: leaf} of a nested dict, in sorted order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parts, last = path.split(".")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def token_gap(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's logit lies below the row's best."""
    return logits.max(-1).values - torch.gather(logits, -1, tokens[..., None])[..., 0]

