"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1, shared expert, MoE every layer.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""

from repro_torch.models.config import ModelConfig, LayerPattern

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    experts_per_token=1,
    d_ff_expert=8192,
    shared_expert=True,
    capacity_factor=1.25,
    rope_theta=500_000.0,
    tie_embeddings=False,
    pattern=(LayerPattern("attn", "moe"),),
)
