"""The port's attention and FFN layers on the CPU, case by case against the
JAX package's functions (``repro.models.layers``) on the same float32
inputs: RoPE, the four mask modes and ``k_valid``, a fully masked row, the
softcap, GQA head grouping, sliding-window decode past the window, query
chunking, the static cross cache and the FFN's activations.

Tolerance: float32 in both packages, so what differs is the rounding
inside transcendentals and sums (about 1e-7 relative); ``RTOL`` = 1e-5.
Masks are compared exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro.models.config import ModelConfig as JaxConfig  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

RTOL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cfgs(**kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=48,
                vocab=64, dtype="float32")
    base.update(kw)
    return JaxConfig(**base), ModelConfig(**base)


def _attn_params(jcfg, rng, cross=False):
    """float32 attention weights, biases and norm scales drawn with numpy."""
    specs = jlayers.attn_specs(jcfg, cross=cross)
    out = {}
    for name, spec in specs.items():
        if spec.init == "normal":
            arr = rng.standard_normal(spec.shape) / np.sqrt(jcfg.d_model)
        else:
            arr = spec.scale * (spec.init == "ones") + 0.1 * rng.standard_normal(spec.shape)
        out[name] = arr.astype(np.float32)
    return out


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# RoPE and masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta, rng):
    x = _x(rng, 2, 5, 3, 16)
    pos = rng.integers(0, 40_000, (2, 5)).astype(np.int32)
    want = jax.jit(jlayers.rope, static_argnums=2)(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert got.dtype == torch.float32 and _rel(got, want) < RTOL
    # positions 0 rotate nothing
    zero = layers.rope(torch.from_numpy(x), torch.zeros((2, 5), dtype=torch.int32), theta)
    assert torch.equal(zero, torch.from_numpy(x))


@pytest.mark.parametrize("mode", ["bidir", "causal", "sliding", "prefix"])
@pytest.mark.parametrize("valid", [False, True], ids=["all", "k_valid"])
def test_mask_bias_matches_reference(mode, valid, rng):
    q_pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    k_pos = q_pos.copy()
    k_valid = rng.random((2, 9)) < 0.7 if valid else None
    kw = dict(window=3, prefix_len=4)
    want = jlayers._mask_bias(mode, jnp.asarray(q_pos), jnp.asarray(k_pos),
                              k_valid=None if k_valid is None else jnp.asarray(k_valid), **kw)
    got = layers._mask_bias(mode, torch.from_numpy(q_pos.copy()), torch.from_numpy(k_pos),
                            k_valid=None if k_valid is None else torch.from_numpy(k_valid),
                            **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) <= {0.0, -np.inf}


def test_mask_bias_rejects_unknown_mode():
    pos = torch.arange(3)[None]
    with pytest.raises(ValueError):
        layers._mask_bias("diagonal", pos, pos)


# ---------------------------------------------------------------------------
# the softmax core
# ---------------------------------------------------------------------------

def _core_inputs(rng, S=5, T=7, KV=2, G=2, D=8):
    q, k, v = _x(rng, 2, S, KV, G, D), _x(rng, 2, T, KV, D), _x(rng, 2, T, KV, D)
    return q, k * 4, v        # scores of a few units: the softcap matters


@pytest.mark.parametrize("softcap", [0.0, 2.0, 50.0])
def test_scores_softmax_values_match_reference(softcap, rng):
    q, k, v = _core_inputs(rng)
    bias = np.asarray(jlayers._mask_bias("causal", jnp.arange(5)[None] + 2,
                                         jnp.arange(7)[None]))
    bias = np.broadcast_to(bias, (2, 5, 7)).copy()
    want = jlayers._scores_softmax_values(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(bias), softcap, 8 ** -0.5)
    got = layers._scores_softmax_values(*map(torch.from_numpy, (q, k, v, bias)),
                                        softcap, 8 ** -0.5)
    assert got.shape == (2, 5, 2, 2, 8) and _rel(got, want) < RTOL


def test_softcap_bounds_the_scores():
    """Scores 10 and 0 over values 1 and 0: the softmax puts weight
    e^10 / (e^10 + 1) on the first; capped at 1, tanh(10) ~ 1 against 0,
    only e / (e + 1).  The cap acts before the mask, as in the reference."""
    q = torch.ones((1, 1, 1, 1, 1))
    k = torch.tensor([10.0, 0.0]).reshape(1, 2, 1, 1)
    v = torch.tensor([1.0, 0.0]).reshape(1, 2, 1, 1)
    bias = torch.zeros((1, 1, 2))
    plain = layers._scores_softmax_values(q, k, v, bias, 0.0, 1.0).item()
    capped = layers._scores_softmax_values(q, k, v, bias, 1.0, 1.0).item()
    e = np.e
    assert abs(plain - e ** 10 / (e ** 10 + 1)) < 1e-6
    assert abs(capped - e ** np.tanh(10) / (e ** np.tanh(10) + 1)) < 1e-6
    want = jlayers._scores_softmax_values(*(jnp.asarray(t.numpy()) for t in (q, k, v, bias)),
                                          1.0, 1.0)
    assert abs(capped - float(want.reshape(()))) < 1e-6


def test_fully_masked_row_gives_zeros(rng):
    q, k, v = _core_inputs(rng)
    bias = np.zeros((2, 5, 7), np.float32)
    bias[0, 2] = -np.inf                          # one query row sees nothing
    want = np.asarray(jlayers._scores_softmax_values(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), 0.0, 0.3))
    got = layers._scores_softmax_values(*map(torch.from_numpy, (q, k, v, bias)), 0.0, 0.3)
    assert torch.isfinite(got).all() and not got[0, 2].any()
    assert not want[0, 2].any() and _rel(got, want) < RTOL


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn(jcfg, cfg, jp, tp, x, **kw):
    tkw = {k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want, wcache = jlayers.attention(jp, jnp.asarray(x), jcfg, **jkw)
    got, gcache = layers.attention(tp, torch.from_numpy(x), cfg, **tkw)
    return got, np.asarray(want), gcache, wcache


@pytest.mark.parametrize("flags", [{}, {"qk_norm": True}, {"qkv_bias": True},
                                   {"attn_softcap": 5.0}, {"n_kv_heads": 1}],
                         ids=["plain", "qk_norm", "qkv_bias", "softcap", "mqa"])
@pytest.mark.parametrize("mode", ["causal", "prefix", "bidir"])
def test_attention_matches_reference(flags, mode, rng):
    jcfg, cfg = _cfgs(**flags)
    jp, tp = _both(_attn_params(jcfg, rng))
    x = _x(rng, 2, 6, 32)
    got, want, _, _ = _attn(jcfg, cfg, jp, tp, x, mode=mode, prefix_len=3)
    assert got.shape == (2, 6, 32) and _rel(got, want) < RTOL


def test_gqa_groups_heads_as_the_reference(rng):
    """KV = 2, G = 2 with unequal heads: query head h reads kv head h // G
    (``repeat_interleave``), which the reference's reshape implies; reading
    kv head h % KV (``repeat``) gives another answer."""
    jcfg, cfg = _cfgs(n_heads=4, n_kv_heads=2)
    jp, tp = _both(_attn_params(jcfg, rng))
    x = _x(rng, 1, 5, 32)
    got, want, _, _ = _attn(jcfg, cfg, jp, tp, x)
    assert _rel(got, want) < RTOL
    # the same attention written out head by head
    xt = torch.from_numpy(x)
    q = layers.rope(torch.einsum("bsd,dhk->bshk", xt, tp["wq"]), torch.arange(5)[None], 1e4)
    k = layers.rope(torch.einsum("bsd,dhk->bshk", xt, tp["wk"]), torch.arange(5)[None], 1e4)
    v = torch.einsum("bsd,dhk->bshk", xt, tp["wv"])
    causal = torch.tril(torch.ones(5, 5, dtype=torch.bool))

    def by_head(kv_of):
        heads = []
        for h in range(4):
            s = torch.einsum("sd,td->st", q[0, :, h], k[0, :, kv_of(h)]) * 8 ** -0.5
            p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
            heads.append(p @ v[0, :, kv_of(h)])
        return torch.einsum("shk,hkd->sd", torch.stack(heads, 1), tp["wo"])[None]

    assert _rel(by_head(lambda h: h // 2), want) < RTOL
    assert _rel(by_head(lambda h: h % 2), want) > 1e-2


def test_prefill_cache_then_decode_matches_reference(rng):
    """``build_cache``: the roped k and v at slots 0..S-1 of a zero cache;
    then a decode step over it at slot S."""
    jcfg, cfg = _cfgs(qk_norm=True)
    jp, tp = _both(_attn_params(jcfg, rng))
    x = _x(rng, 2, 5, 32)
    want, wcache = jlayers.attention(jp, jnp.asarray(x), jcfg, build_cache=8,
                                     cache_dtype=jnp.float32)
    got, gcache = layers.attention(tp, torch.from_numpy(x), cfg, build_cache=8,
                                   cache_dtype=torch.float32)
    assert _rel(got, want) < RTOL
    for name in ("k", "v"):
        assert gcache[name].shape == (2, 8, 2, 8)
        assert _rel(gcache[name], wcache[name]) < RTOL
        assert not gcache[name][:, 5:].any()
    x1 = _x(rng, 2, 1, 32)
    pos = np.full((2, 1), 5, np.int32)
    want, _ = jlayers.attention(jp, jnp.asarray(x1), jcfg, positions=jnp.asarray(pos),
                                cache=wcache, cache_pos=jnp.asarray(5, jnp.int32))
    got, _ = layers.attention(tp, torch.from_numpy(x1), cfg,
                              positions=torch.from_numpy(pos), cache=gcache, cache_pos=5)
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("mode,pos", [("causal", 3), ("causal", 11),
                                      ("sliding", 3), ("sliding", 11)])
def test_decode_step_matches_reference(mode, pos, rng):
    """One decode step over a filled cache at ``pos``; with the sliding
    window (4) past the window, the oldest slots drop out."""
    jcfg, cfg = _cfgs()
    jp, tp = _both(_attn_params(jcfg, rng))
    ck, cv = _x(rng, 2, 12, 2, 8), _x(rng, 2, 12, 2, 8)
    x = _x(rng, 2, 1, 32)
    positions = np.full((2, 1), pos, np.int32)
    jcache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
    tcache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    want, wnew = jlayers.attention(jp, jnp.asarray(x), jcfg, mode=mode,
                                   positions=jnp.asarray(positions), cache=jcache,
                                   cache_pos=jnp.asarray(pos, jnp.int32), window=4)
    got, gnew = layers.attention(tp, torch.from_numpy(x), cfg, mode=mode,
                                 positions=torch.from_numpy(positions), cache=tcache,
                                 cache_pos=pos, window=4)
    assert _rel(got, want) < RTOL
    assert gnew is tcache                                  # written in place
    for name in ("k", "v"):
        assert _rel(gnew[name], wnew[name]) < RTOL
        assert torch.equal(gnew[name][:, pos + 1:], torch.from_numpy(ck if name == "k"
                                                                     else cv)[:, pos + 1:])
    if mode == "sliding" and pos > 4:
        # the slots before the window do not matter
        tcache["k"][:, :pos - 3] = 1e3
        again, _ = layers.attention(tp, torch.from_numpy(x), cfg, mode=mode,
                                    positions=torch.from_numpy(positions),
                                    cache=tcache, cache_pos=pos, window=4)
        assert torch.equal(again, got)


def test_q_chunk_matches_unchunked_and_reference(rng):
    jcfg, cfg = _cfgs(attn_softcap=5.0)
    jp, tp = _both(_attn_params(jcfg, rng))
    x = _x(rng, 2, 16, 32)
    for mode in ("causal", "sliding", "prefix"):
        kw = dict(mode=mode, window=5, prefix_len=6)
        chunked, want, _, _ = _attn(jcfg, cfg, jp, tp, x, q_chunk=4, **kw)
        plain, _, _, _ = _attn(jcfg, cfg, jp, tp, x, q_chunk=0, **kw)
        assert _rel(chunked, want) < RTOL, mode
        assert _rel(chunked, plain) < RTOL, mode


def test_static_cross_cache_matches_reference(rng):
    """Decode over a precomputed encoder kv: no rope, every slot valid, no
    write (``update_cache=False``); and the training-time cross path over
    ``kv_input``."""
    jcfg, cfg = _cfgs()
    jp, tp = _both(_attn_params(jcfg, rng, cross=True))
    ck, cv = _x(rng, 2, 9, 2, 8), _x(rng, 2, 9, 2, 8)
    x = _x(rng, 2, 1, 32)
    tcache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    want, wc = jlayers.attention(jp, jnp.asarray(x), jcfg, mode="bidir",
                                 cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                                 update_cache=False)
    got, gc = layers.attention(tp, torch.from_numpy(x), cfg, mode="bidir",
                               cache=tcache, update_cache=False)
    assert _rel(got, want) < RTOL and gc is tcache
    assert np.array_equal(gc["k"].numpy(), ck) and np.array_equal(gc["v"].numpy(), cv)
    enc = _x(rng, 2, 9, 32)
    x = _x(rng, 2, 4, 32)
    got, want, _, _ = _attn(jcfg, cfg, jp, tp, x, mode="bidir", kv_input=enc)
    assert _rel(got, want) < RTOL


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ffn_matches_reference(act, dtype, rng):
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
         for k, s in jlayers.ffn_specs(32, 48).items()}
    x = _x(rng, 2, 3, 32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    want = jax.jit(jlayers.ffn, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x).astype(jdt), act)
    got = layers.ffn({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x).to(tdt), act)
    assert got.dtype == tdt
    # bf16: one rounding of g, u, g * u and the output apart at most
    assert _rel(got, np.asarray(want, np.float32)) < (RTOL if dtype == "f32" else 2e-2)
