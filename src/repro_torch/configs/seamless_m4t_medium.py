"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16, i.e. MHA)
d_ff=4096 vocab=256206 — enc-dec, multimodal.  The audio frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, T, d_model).
[arXiv:2308.11596]"""

from repro_torch.models.config import ModelConfig, LayerPattern

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,                # decoder layers
    n_enc_layers=12,            # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=256206,
    cross_attn=True,
    ffn_act="gelu",
    tie_embeddings=True,
    pattern=(LayerPattern("attn", "dense"),),
)
