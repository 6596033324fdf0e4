"""Config registry: ``--arch <id>`` lookup, input shapes, reduced smokes.

The port's copy of ``repro.configs``, whose package imports ``repro.models``
and with it JAX; the values are the reference's, field for field.

Every assigned architecture is one module exposing ``CONFIG``;
``get_config(name)`` resolves it, ``reduced(cfg)`` shrinks it to a
CPU-smoke scale preserving every structural flag (pattern, MoE, softcaps,
prefix, enc-dec), and ``SHAPES``/``shapes_for`` define the assigned
(arch x input-shape) grid.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "list_archs", "reduced",
           "SHAPES", "shapes_for", "ShapeSpec"]

ARCHS = {
    "qwen3-8b": "qwen3_8b",
    "qwen2.5-14b": "qwen2_5_14b",
    "gemma2-9b": "gemma2_9b",
    "stablelm-12b": "stablelm_12b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "paligemma-3b": "paligemma_3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "deepseek-v2-lite": "deepseek_v2_lite",          # the port's own
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG


def list_archs():
    return sorted(ARCHS)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> list[ShapeSpec]:
    """The assigned shape set for an arch.  ``long_500k`` needs a
    sub-quadratic decode path, so pure full-attention archs skip it
    (DESIGN.md §6); ssm/hybrid archs run all four."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out


def _short_pattern(pattern: tuple) -> tuple:
    """``pattern`` with each run of equal consecutive entries cut to two:
    a one-group stack of leading layers and a long run (DeepSeek-V2's dense
    first layer, then 26 MoE layers) keeps one of the first and two of the
    run; every other pattern has no run longer than one."""
    out: list = []
    for p in pattern:
        if not (len(out) >= 2 and out[-1] == out[-2] == p):
            out.append(p)
    return tuple(out)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke variant: tiny dims, same structure (pattern incl. MoE /
    local-global / mamba-attn interleave, softcaps, prefix, enc-dec,
    latent attention, YaRN, shared-expert width over the experts')."""
    # keep the GQA group structure but cap the ratio at 4
    n_kv = min(cfg.n_kv_heads, 2)
    n_heads = n_kv * min(cfg.n_heads // cfg.n_kv_heads, 4)
    pattern = _short_pattern(cfg.pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        pattern=pattern,
        n_layers=len(pattern) * min(cfg.n_groups, 2),
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=16,
        d_ff=128,
        d_ff_expert=96 if cfg.n_experts else None,
        vocab=512,
        n_experts=min(cfg.n_experts, max(4, 2 * cfg.experts_per_token)),
        d_ff_shared=cfg.d_ff_shared and 96 * cfg.d_ff_shared // cfg.d_ff_expert,
        kv_lora_rank=min(cfg.kv_lora_rank, 32),
        qk_nope_dim=min(cfg.qk_nope_dim, 16),
        qk_rope_dim=min(cfg.qk_rope_dim, 8),
        rwkv_head_dim=16,
        rwkv_decay_lora=8,
        ssm_state=8,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_img_tokens=8 if cfg.n_img_tokens else 0,
        local_window=min(cfg.local_window, 8) if cfg.local_window else 0,
    )
