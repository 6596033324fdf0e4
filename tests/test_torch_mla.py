"""Latent attention (MLA), YaRN and DeepSeekMoE on the CPU against the plain
reference ``portbench/reference/deepseek_v2.py``, at the reduced
deepseek-v2-lite preset with seeded random weights (the reference package
has no such architecture).

Tolerances.  In float32 the program and the reference compute the same
function with sums in another order: the expanded MLA layer, the MoE and
the whole model's logits agree to about 1e-6 of their largest value, held
at ``F32_TOL`` = 1e-5 (the whole model 1e-4, as ``portbench``'s own test
of the qwen3 and jamba references).  The absorbed decode step with a
float32 latent cache is the expanded pass at that position reassociated
(q_nope·W_k_b before the product with the cache): the same 1e-5; with the
bf16 cache, 3e-2 (bf16's 2^-8 a rounding, the cache's and the step's).
The bf16 program served through ``ServeEngine`` (bf16 weights and
activations, a bf16 latent cache, float32 scores) holds each request's
logits, relative Frobenius error, to ``SERVED_TOL`` = 5e-2 of the float32
reference's: measured 1.3-2.5 % on four seeds (d_model 64 and three
layers of bf16 roundings, no averaging over width); the reference's
float8 control, whose products round their operands to e4m3, lies
21-27 % away and fails it.
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.reference import deepseek_v2 as ref_mod  # noqa: E402
from portbench.reference.model import float32_matmuls  # noqa: E402
from portbench.weights import seeded_params  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import _index  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

SEED = 2 ** 31 + 17
F32_TOL = 1e-5
BF16_TOL = 3e-2
SERVED_TOL = 5e-2
B, S = 2, 24
FULL = get_config("deepseek-v2-lite")


def published(cfg) -> dict:
    """A deepseek ModelConfig as a configuration file's published keys."""
    return {
        "name": cfg.name, "model_type": "deepseek_v2", "hidden_size": cfg.d_model,
        "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab,
        "num_hidden_layers": cfg.n_layers, "rms_norm_eps": cfg.norm_eps,
        "rope_theta": cfg.rope_theta, "kv_lora_rank": cfg.kv_lora_rank,
        "q_lora_rank": None, "qk_nope_head_dim": cfg.qk_nope_dim,
        "qk_rope_head_dim": cfg.qk_rope_dim, "v_head_dim": cfg.d_head,
        "rope_scaling": {"type": "yarn", "factor": cfg.yarn_factor,
                         "original_max_position_embeddings": cfg.yarn_original_len,
                         "beta_fast": cfg.yarn_beta_fast, "beta_slow": cfg.yarn_beta_slow,
                         "mscale": cfg.yarn_mscale, "mscale_all_dim": cfg.yarn_mscale_all_dim},
        "first_k_dense_replace": 1, "moe_layer_freq": 1, "n_routed_experts": cfg.n_experts,
        "num_experts_per_tok": cfg.experts_per_token,
        "moe_intermediate_size": cfg.d_ff_expert,
        "n_shared_experts": cfg.d_ff_shared // cfg.d_ff_expert,
        "norm_topk_prob": cfg.norm_topk_prob, "routed_scaling_factor": 1,
        "scoring_func": "softmax", "topk_method": "greedy", "n_group": 1,
        "capacity_factor": cfg.capacity_factor}


def _setup(dtype=torch.float32, **over):
    cfg = dataclasses.replace(reduced(FULL), remat="none",
                              dtype="float32" if dtype == torch.float32 else "bfloat16",
                              **over)
    model = Model(cfg)
    params = seeded_params(model, SEED, dtype, torch.device("cpu"))
    return cfg, published(cfg), model, params


def _gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def _hidden(seed=1, d=None):
    d = d or reduced(FULL).d_model
    return torch.randn(B, S, d, generator=torch.Generator().manual_seed(seed))


def _positions(n, lo=0):
    return torch.arange(lo, lo + n, dtype=torch.int32)[None].expand(B, n)


def _hf_yarn(dim, base, factor, orig, beta_fast, beta_slow):
    """HF ``DeepseekV2YarnRotaryEmbedding``'s inv_freq, as written there."""
    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))
    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), dim - 1)
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


@pytest.mark.parametrize("cfg", [FULL, reduced(FULL)], ids=["full", "reduced"])
def test_yarn_inv_freq_and_softmax_scale_follow_the_formula(cfg):
    want = _hf_yarn(cfg.qk_rope_dim, cfg.rope_theta, cfg.yarn_factor, cfg.yarn_original_len,
                    cfg.yarn_beta_fast, cfg.yarn_beta_slow)
    got = MLA.yarn_freqs(cfg)
    assert got.dtype == torch.float32 and got.shape == (cfg.qk_rope_dim // 2,)
    assert torch.allclose(got, want, rtol=1e-6, atol=0)
    ref = ref_mod.yarn_inv_freq(published(cfg))
    assert torch.allclose(ref.float(), want, rtol=1e-6, atol=0)
    theta = cfg.rope_theta ** (-torch.arange(0, cfg.qk_rope_dim, 2, dtype=torch.float64)
                               / cfg.qk_rope_dim)
    if cfg is FULL:
        # correction dims 10.47 -> 10 and 22.51 -> 23: theta's frequency up to
        # index 10, theta's over 40 from 23, a ramp between
        assert torch.allclose(ref[:11], theta[:11], rtol=1e-15)
        assert torch.allclose(ref[23:], theta[23:] / 40, rtol=1e-15)
        assert bool(((ref[11:23] < theta[11:23]) & (ref[11:23] > theta[11:23] / 40)).all())
    scale = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
    width = cfg.qk_nope_dim + cfg.qk_rope_dim
    want_scale = width ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
    assert MLA.softmax_scale(cfg) == pytest.approx(want_scale, rel=1e-12)
    assert ref_mod.softmax_scale(published(cfg)) == pytest.approx(want_scale, rel=1e-12)
    if cfg is FULL:
        assert MLA.softmax_scale(cfg) == pytest.approx(scale, rel=1e-12)


def test_a_yarn_cos_sin_factor_other_than_one_is_refused():
    with pytest.raises(ValueError, match="cos/sin"):
        MLA.yarn_freqs(dataclasses.replace(FULL, yarn_mscale=1.0))


def test_the_rotary_columns_are_de_interleaved_as_hf_does():
    """q_pe's pair (2i, 2i+1) is rotated as (i, r/2 + i) at position p."""
    cfg = reduced(FULL)
    r = cfg.qk_rope_dim
    x = torch.randn(1, 3, 1, r, generator=torch.Generator().manual_seed(4))
    got = MLA._rope(x, _positions(3)[:1], cfg)
    f = MLA.yarn_freqs(cfg)
    ang = torch.arange(3, dtype=torch.float32)[:, None] * f
    even, odd = x[0, :, 0, 0::2], x[0, :, 0, 1::2]
    want = torch.cat([even * ang.cos() - odd * ang.sin(), odd * ang.cos() + even * ang.sin()], -1)
    assert torch.allclose(got[0, :, 0], want, atol=1e-6)


@pytest.mark.parametrize("layer", [0, 1])
def test_the_mla_prefill_matches_the_reference(layer):
    cfg, conf, model, params = _setup()
    h = _hidden(d=cfg.d_model)
    with torch.no_grad(), float32_matmuls():
        got, cache = MLA.mla(_index(params["layers"], 0)[f"l{layer}"]["mla"], h, cfg,
                             positions=_positions(S), build_cache=S + 4,
                             cache_dtype=torch.float32)
        want = ref_mod.Reference(conf, params).mla(layer, h)
    assert _gap(got, want) < F32_TOL
    assert cache.shape == (B, S + 4, cfg.kv_lora_rank + cfg.qk_rope_dim)
    assert not bool(cache[:, S:].any()) and bool(cache[:, :S].any())


def test_the_whole_models_prefill_and_forward_match_the_reference():
    cfg, conf, model, params = _setup()
    tok = torch.randint(2, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), float32_matmuls():
        h, _ = model.forward(params, {"tokens": tok})
        fwd = model.unembed(params, h)
        last, cache = model.prefill(params, {"tokens": tok}, S + 4)
        ref = ref_mod.Reference(conf, params)
        hr, _, _ = ref.hidden(tok)
        want = ref.logits(hr)
    assert _gap(fwd, want) < 1e-4
    assert _gap(last, want[:, -1]) < 1e-4
    assert cache["l0"]["latent"].shape == (1, B, S + 4, cfg.kv_lora_rank + cfg.qk_rope_dim)


@pytest.mark.parametrize("cache_dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
def test_each_absorbed_decode_step_matches_the_expanded_pass(cache_dtype, tol):
    """The prefill's latent cache of 8 positions, then one decode step a
    position: each step's output against the expanded pass over the whole
    sequence at that position."""
    cfg, conf, model, params = _setup()
    p = _index(params["layers"], 0)["l1"]["mla"]
    h = _hidden(d=cfg.d_model)
    S0 = 8
    with torch.no_grad():
        full, _ = MLA.mla(p, h, cfg, positions=_positions(S))
        _, cache = MLA.mla(p, h[:, :S0], cfg, positions=_positions(S0), build_cache=S,
                           cache_dtype=cache_dtype)
        for t in range(S0, S):
            step, back = MLA.mla(p, h[:, t:t + 1], cfg, positions=_positions(1, t),
                                 cache=cache, cache_pos=t)
            assert back is cache
            assert _gap(step[:, 0], full[:, t]) < tol, t


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.shapes.append(tuple(o.shape))
        return out


def test_a_decode_step_at_the_published_widths_reads_the_latent_cache_and_expands_nothing():
    """The whole 27-layer model on the meta device: the cache is (B, max_len,
    576) a layer, and no operation of a decode step at position 3000 makes
    a per-head key or value over the cached positions."""
    model = Model(FULL)
    params = model.abstract(torch.bfloat16)
    Bs, T, pos = 8, 4104, 3000
    cache = model.init_cache(Bs, T, device="meta")
    assert cache["l5"]["latent"].shape == (1, Bs, T, 512 + 64)
    assert cache["l5"]["latent"].dtype == torch.bfloat16
    tok = torch.zeros(Bs, 1, dtype=torch.int64, device="meta")
    with torch.no_grad(), _Shapes() as seen:
        logits, new = model.decode_step(params, cache, tok, pos)
    assert logits.shape == (Bs, FULL.vocab) and new["l5"]["latent"] is cache["l5"]["latent"]
    widths = {FULL.qk_nope_dim, FULL.qk_rope_dim, FULL.qk_nope_dim + FULL.qk_rope_dim,
              FULL.d_head}
    over_cache = {s for s in seen.shapes if pos + 1 in s or T in s}
    assert (Bs, pos + 1, 576) in over_cache              # the rows read
    assert not [s for s in over_cache if FULL.n_heads in s and s[-1] in widths], over_cache


class _Logged:
    """The program's model as the engine is given it, keeping each
    prefill's and decode step's logits."""

    def __init__(self, model):
        self._m = model
        self.logits = []

    def __getattr__(self, name):
        return getattr(self._m, name)

    def prefill(self, params, batch, max_len):
        out = self._m.prefill(params, batch, max_len)
        self.logits.append(out[0].float())
        return out

    def decode_step(self, params, cache, token, pos):
        out = self._m.decode_step(params, cache, token, pos)
        self.logits.append(out[0].float())
        return out


def _served_gaps(fp8_control: bool = False):
    """Two requests of 19 and 13 tokens through ServeEngine (bf16 weights,
    the prefill then 8 decode steps), and each request's logits at its
    served positions against the float32 reference's on the row the engine
    built.  Returns the worse request's relative error, or the float8
    control's with ``fp8_control``."""
    cfg, conf, model, params = _setup(torch.bfloat16)
    log = _Logged(model)
    eng = ServeEngine(log, params, batch_slots=2, max_len=32, eos_id=-1)
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(2, cfg.vocab, (n,), generator=g).numpy() for n in (19, 13)]
    ids = [eng.submit(p, 9) for p in prompts]
    out = eng.run()
    assert len(log.logits) == 9 and all(len(out[i]) == 9 for i in ids)
    plen = max(len(p) for p in prompts)
    worst = 0.0
    with torch.no_grad(), float32_matmuls():
        ref = ref_mod.Reference(conf, params, fp8=fp8_control)
        base = ref_mod.Reference(conf, params)
        for slot, (i, p) in enumerate(zip(ids, prompts)):
            served = out[i]
            row = np.concatenate([np.zeros(plen - len(p), np.int64), p, served[:-1]])
            toks = torch.from_numpy(row.astype(np.int64))[None]
            at = slice(plen - 1, plen - 1 + len(served))
            want = base.logits(base.hidden(toks, cap_len=plen)[0][0, at])
            if fp8_control:
                got = ref.logits(ref.hidden(toks, cap_len=plen)[0][0, at])
            else:
                got = torch.stack([lg[slot] for lg in log.logits])
            worst = max(worst, _rel(got, want))
    return worst


def test_serve_engine_prefill_then_eight_decode_steps_match_the_reference_logits():
    assert _served_gaps() < SERVED_TOL


def test_the_float8_control_fails_the_served_tolerance():
    assert _served_gaps(fp8_control=True) > SERVED_TOL


def test_spans_name_the_mla_path_and_the_rows_read():
    cfg, conf, model, params = _setup()
    tok = torch.randint(2, cfg.vocab, (B, 6), generator=torch.Generator().manual_seed(6))
    prev = obs.metrics.set_enabled(True)
    trace.clear()
    try:
        with torch.no_grad():
            _, cache = model.prefill(params, {"tokens": tok}, 10)
            model.decode_step(params, cache, tok[:, :1], 6)
        spans = [e for e in trace.events() if e["name"] == "model.attention"]
    finally:
        trace.clear()
        obs.metrics.set_enabled(prev)
    args = [{k: e["args"][k] for k in ("kind", "path", "cache_len") if k in e["args"]}
            for e in spans]
    n = cfg.n_layers
    assert args == [{"kind": "mla", "path": "expand"}] * n + \
        [{"kind": "mla", "path": "absorb", "cache_len": 7}] * n


@pytest.mark.parametrize("drops", [True, False])
def test_deepseek_moe_gates_are_not_renormalised_and_shared_experts_are_one_wide_swiglu(drops):
    specs = moe.moe_specs(FULL)
    assert specs["shared"]["w_gate"].shape == (2048, 2816)
    assert specs["shared"]["w_down"].shape == (2816, 2048)
    assert specs["w_gate"].shape == (64, 2048, 1408) and specs["router"].shape == (2048, 64)
    cf = 1.25 if drops else 64.0
    cfg, conf, model, params = _setup(capacity_factor=cf)
    assert cfg.d_ff_shared == 2 * cfg.d_ff_expert
    p = _index(params["layers"], 0)["l1"]["moe"]
    h = _hidden(d=cfg.d_model)
    with torch.no_grad(), float32_matmuls():
        got, _ = moe.moe_ffn(p, h, cfg)
        ref = ref_mod.Reference(conf, params)
        want, _, _ = ref.moe(1, h)
        renorm, _ = moe.moe_ffn(p, h, dataclasses.replace(cfg, norm_topk_prob=True))
        narrow = {k: v for k, v in p.items() if k != "shared"}
        routed, _ = moe.moe_ffn(narrow, h, dataclasses.replace(cfg, shared_expert=False))
    assert _gap(got, want) < F32_TOL
    assert _gap(renorm, want) > 0.1                 # the gates summing to 1 is another model
    sh = p["shared"]
    shared = (torch.nn.functional.silu(h @ sh["w_gate"]) * (h @ sh["w_up"])) @ sh["w_down"]
    assert _gap(got - routed, shared) < F32_TOL


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "llama4-scout-17b-a16e",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_default_flags_leave_jamba_and_llama4_moe_bit_identical(arch, dtype):
    """The new flags' defaults are the gating these configurations always
    had: gates renormalised over the top k, a shared expert as wide as a
    routed one.  Their output with the defaults is bit for bit the output
    with those two set explicitly, and unrenormalised gates differ."""
    cfg = reduced(get_config(arch))
    assert cfg.norm_topk_prob is True and cfg.d_ff_shared is None
    legacy = dataclasses.replace(cfg, norm_topk_prob=True,
                                 d_ff_shared=cfg.d_ff_expert if cfg.shared_expert else None)
    assert moe.moe_specs(cfg).keys() == moe.moe_specs(legacy).keys()
    from repro_torch.models.specs import init_params
    p = init_params(moe.moe_specs(cfg), torch.Generator().manual_seed(1), dtype)
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(2)).to(dtype)
    with torch.no_grad():
        a, aux_a = moe.moe_ffn(p, x, cfg)
        b, aux_b = moe.moe_ffn(p, x, legacy)
        c, _ = moe.moe_ffn(p, x, dataclasses.replace(cfg, norm_topk_prob=False))
    assert torch.equal(a, b) and all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)
    assert not torch.equal(a, c)


def test_check_program_refuses_other_mla_dims_gates_and_shared_width():
    from portbench import harness
    conf = harness.config("deepseek-v2-lite")
    harness.model_config(conf)                             # as the file states
    for over, word in [({"kv_lora_rank": 256}, "kv_lora_rank"),
                       ({"norm_topk_prob": True}, "norm_topk_prob"),
                       ({"d_ff_shared": 1408}, "shared"),
                       ({"qk_rope_dim": 32}, "qk_rope_head_dim"),
                       ({"yarn_factor": 4.0}, "factor"),
                       ({"n_experts": 32}, "n_routed_experts")]:
        bad = dict(conf, overrides=over)
        with pytest.raises(ValueError, match=word):
            harness.model_config(harness.Configuration(bad, conf.root))
    cfg = get_config("deepseek-v2-lite")
    dense_all = dataclasses.replace(cfg, pattern=(cfg.pattern[0],) * 27)
    with pytest.raises(ValueError, match="layers"):
        ref_mod.check_program(conf, dense_all)
