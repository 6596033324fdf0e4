"""paligemma-3b [vlm] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma backbone.  The SigLIP frontend is a STUB:
``input_specs()`` provides precomputed patch embeddings (B, 256, d_model);
image tokens get bidirectional (prefix-LM) attention.  [arXiv:2407.07726]"""

from repro_torch.models.config import ModelConfig, LayerPattern

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab=257216,
    n_img_tokens=256,           # 224px / 14 patch -> 16 x 16
    embed_scale=True,
    ffn_act="gelu",
    tie_embeddings=True,
    pattern=(LayerPattern("attn", "dense"),),
)
