"""deepseek-v2-lite [moe] — 27L d_model=2048 16H vocab=102400 — latent
attention (MLA: kv_lora_rank 512, no q_lora, qk 128 + rope 64, v 128)
with YaRN RoPE (x40 over 4096), DeepSeekMoE (64 routed experts of 1408,
top-6 softmax gates not renormalised, 2 shared experts as one SwiGLU of
2816), a dense first layer of 10944.  The first layer's FFN differs from
the rest, so the stack is one group of all 27 layers.
[hf:deepseek-ai/DeepSeek-V2-Lite, arXiv:2405.04434]"""

from repro_torch.models.config import ModelConfig, LayerPattern

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,                 # v_head_dim
    d_ff=10944,                 # the dense first layer
    vocab=102400,
    rope_theta=10000.0,
    yarn_factor=40.0,
    yarn_original_len=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    n_experts=64,
    experts_per_token=6,
    d_ff_expert=1408,
    shared_expert=True,
    d_ff_shared=2816,
    norm_topk_prob=False,
    capacity_factor=1.25,
    tie_embeddings=False,
    pattern=(LayerPattern("mla", "dense"),) + (LayerPattern("mla", "moe"),) * 26,
)
