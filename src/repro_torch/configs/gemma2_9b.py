"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating, logit softcap.  [arXiv:2408.00118]"""

from repro_torch.models.config import ModelConfig, LayerPattern

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=14336,
    vocab=256_000,
    attn_softcap=50.0,
    final_softcap=30.0,
    local_window=4096,
    post_norm=True,
    embed_scale=True,
    ffn_act="gelu",
    tie_embeddings=True,
    # alternating sliding-window ("local") and full ("global") attention
    pattern=(LayerPattern("local", "dense"), LayerPattern("attn", "dense")),
)
