"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave (one attention layer
per 8-layer block, at index 4), MoE every other layer, no positional
embeddings (mamba carries position).  [arXiv:2403.19887]"""

from repro_torch.models.config import ModelConfig, LayerPattern

_M, _A = "mamba", "attn"
_D, _E = "dense", "moe"

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=65536,
    rope_theta=0.0,             # jamba: no explicit positional encoding
    n_experts=16,
    experts_per_token=2,
    d_ff_expert=14336,
    capacity_factor=1.25,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=False,
    # 8-layer jamba block: attention at index 4, MoE on odd layers
    pattern=(
        LayerPattern(_M, _D), LayerPattern(_M, _E),
        LayerPattern(_M, _D), LayerPattern(_M, _E),
        LayerPattern(_A, _D), LayerPattern(_M, _E),
        LayerPattern(_M, _D), LayerPattern(_M, _E),
    ),
)
