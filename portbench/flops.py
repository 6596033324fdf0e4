"""FLOP and byte arithmetic from a configuration's published shapes.

Model FLOPs count the products of the model's matrices at the experts a
token is routed to (top-k, not the capacity the program computes), and
attention's two score products over the whole context (PaLM, appendix B:
6N + 12 L H Q T a trained token; a forward is a third of it).  N counts
the layers' matrices and the unembedding, not the embedding lookup, the
norms or the convolution; recomputation is not counted.
"""

from __future__ import annotations

from portbench.reference.model import layer_kinds

# H100 SXM data sheet: dense bf16 and float32 (no tensor cores), HBM3
BF16_FLOPS = 989.4e12   # the rate every mfu divides by (chip_smoke.py rounds to 989e12)
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


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


def train_flops_per_token(conf: dict, seq_len: int) -> float:
    s = _dims(conf)
    n = active_matrix_params(conf) + s["d"] * s["V"]
    return 6 * n + 12 * attention_layers(conf) * s["H"] * s["Dh"] * seq_len


def prefill_flops(conf: dict, prompt_len: int) -> float:
    """One request's prefill: its prompt through the layers, attention over
    the prompt, and the logits of its last position."""
    s = _dims(conf)
    T = prompt_len
    return (2 * active_matrix_params(conf) * T + 2 * s["d"] * s["V"]
            + 4 * attention_layers(conf) * s["H"] * s["Dh"] * T * T)


def train_step_bound(conf: dict, n_params: int, tokens: int) -> dict:
    """The least time of one train step, copied from ``chip_smoke.py``'s
    ``_step_flops_bytes``: the float32 unembedding's GEMMs (forward and
    two backward) at the float32 peak, the layers' bf16 GEMMs at the bf16
    peak, and the optimizer's bytes (read p, g, m, v in float32 and the
    bf16 residual; write p, m, v and the residual) at the HBM rate."""
    s = _dims(conf)
    unembed = 6 * s["d"] * s["V"] * tokens
    layer = 6 * (n_params - 2 * s["d"] * s["V"]) * tokens
    opt_bytes = n_params * (4 * 4 + 2 + 3 * 4 + 2)
    ms = {"unembed_f32": unembed / F32_FLOPS * 1e3,
          "layer_bf16": layer / BF16_FLOPS * 1e3,
          "optimizer_bytes": opt_bytes / HBM_BYTES_PER_S * 1e3}
    return {"bound_ms": ms, "bound_ms_total": sum(ms.values())}
