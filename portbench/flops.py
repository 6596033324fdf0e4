"""FLOP and byte arithmetic from a configuration's published shapes.

A configuration's model FLOPs are counted by its architecture module
(``reference/<stem>.py``, ``harness.architecture``), which knows its
layers; this module holds the chip's peaks and asks that module.
"""

from __future__ import annotations

from portbench import harness

# H100 SXM data sheet: dense bf16 and float32 (no tensor cores), HBM3
BF16_FLOPS = 989.4e12   # the rate every mfu divides by (chip_smoke.py rounds to 989e12)
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def train_flops_per_token(conf: dict, seq_len: int) -> float:
    """Model FLOPs of one trained token at ``seq_len``: forward and backward."""
    return harness.architecture(conf).train_flops_per_token(conf, seq_len)


def prefill_flops(conf: dict, prompt_len: int) -> float:
    """One request's prefill: its prompt through the layers, attention over
    the prompt, and the logits of its last position."""
    return harness.architecture(conf).prefill_flops(conf, prompt_len)


def train_step_bound(conf: dict, n_params: int, tokens: int) -> dict:
    """The least time of one train step, copied from ``chip_smoke.py``'s
    ``_step_flops_bytes``: the float32 unembedding's GEMMs (forward and
    two backward) at the float32 peak, the layers' bf16 GEMMs at the bf16
    peak, and the optimizer's bytes (read p, g, m, v in float32 and the
    bf16 residual; write p, m, v and the residual) at the HBM rate."""
    d, V = conf["hidden_size"], conf["vocab_size"]
    unembed = 6 * d * V * tokens
    layer = 6 * (n_params - 2 * d * V) * tokens
    opt_bytes = n_params * (4 * 4 + 2 + 3 * 4 + 2)
    ms = {"unembed_f32": unembed / F32_FLOPS * 1e3,
          "layer_bf16": layer / BF16_FLOPS * 1e3,
          "optimizer_bytes": opt_bytes / HBM_BYTES_PER_S * 1e3}
    return {"bound_ms": ms, "bound_ms_total": sum(ms.values())}
