"""ModelConfig — one dataclass describing every assigned architecture.

The layer stack is expressed as a repeating ``pattern`` of ``(mixer, ffn)``
pairs (see model.py): the pattern is unrolled inside one "group", and the
groups run one after another over group-stacked parameters, so
heterogeneous stacks (gemma2 local/global, jamba 1:7 mamba:attn with
alternating MoE) share one group function; a stack with leading layers of
their own (DeepSeek-V2's dense first layer) is one group of its whole
depth.  A copy of the reference's ``repro/models/config.py``, field for
field, plus the port's own fields (latent attention, YaRN, the DeepSeekMoE
gates and shared width), whose defaults leave every architecture of the
reference as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "LayerPattern"]


@dataclasses.dataclass(frozen=True)
class LayerPattern:
    mixer: str = "attn"       # attn | local | mla | mamba | rwkv
    ffn: str = "dense"        # dense | moe | none (rwkv channel-mix is its own)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | encdec | vlm

    # --- core dims
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 32000

    # --- attention variants
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: float = 0.0      # gemma2: 50.0
    final_softcap: float = 0.0     # gemma2: 30.0
    rope_theta: float = 10000.0
    # YaRN (DeepSeek-V2): inv_freq blended between theta's and theta's
    # over ``yarn_factor`` by a ramp over the correction dims of
    # ``yarn_original_len`` positions; 0 = plain RoPE
    yarn_factor: float = 0.0
    yarn_original_len: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    local_window: int = 0          # sliding-window size for "local" mixers
    norm_eps: float = 1e-6
    post_norm: bool = False        # gemma2: post-ffn/attn extra norms
    embed_scale: bool = False      # gemma: x *= sqrt(d_model)

    # --- latent attention ("mla" mixers; DeepSeek-V2): keys and values
    # from a kv_lora_rank latent, queries and keys of qk_nope_dim + the
    # qk_rope_dim rotary part shared by all heads, values d_head wide
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0

    # --- layer pattern (repeated n_layers // len(pattern) times)
    pattern: tuple = (LayerPattern(),)

    # --- FFN / MoE
    ffn_act: str = "silu"
    n_experts: int = 0
    experts_per_token: int = 1
    d_ff_expert: Optional[int] = None
    capacity_factor: float = 1.25
    shared_expert: bool = False
    d_ff_shared: Optional[int] = None      # the shared expert's width (default the experts')
    norm_topk_prob: bool = True            # the k gates renormalised over their sum
    router_aux_weight: float = 0.01
    router_z_weight: float = 0.001

    # --- SSM (mamba) dims
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- RWKV dims
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # --- enc-dec
    n_enc_layers: int = 0          # >0 => encoder-decoder
    cross_attn: bool = False

    # --- VLM
    n_img_tokens: int = 0          # >0 => image-prefix prefix-LM

    # --- global
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: str = "full"            # full | dots | none
    q_chunk: int = 0               # flash-style query chunking for long prefill

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.name}: n_layers={self.n_layers} not divisible by pattern {len(self.pattern)}"
        assert self.n_heads % self.n_kv_heads == 0

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(p.mixer in ("mamba", "rwkv") for p in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token decode shape? True when no mixer
        needs an O(seq) KV cache *scan over full history per step* — i.e.
        recurrent-state mixers.  Hybrids qualify (attn layers keep a KV cache
        but decode cost is O(S) memory, O(S) attention per step on 1/8 of
        layers; the spec assigns long_500k to ssm/hybrid)."""
        return any(p.mixer in ("mamba", "rwkv") for p in self.pattern)
