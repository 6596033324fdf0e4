"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 —
Finch: data-dependent decay.  [arXiv:2404.05892]"""

from repro_torch.models.config import ModelConfig, LayerPattern

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                 # 2048 / rwkv_head_dim
    n_kv_heads=32,
    d_head=64,
    d_ff=7168,
    vocab=65536,
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    tie_embeddings=False,
    pattern=(LayerPattern("rwkv", "rwkv_cm"),),
)
