"""The port's optimizer and train step on the CPU against the JAX package.

The JAX side runs jitted, as the reference's own tests run it; inputs are
drawn with numpy and the reference's initial state is carried across with
``tree_from_numpy``.

Tolerance.  The optimizer functions agree with the jitted reference to a
few float32 ulps (``OPT_RTOL`` on scalars, ``ULPS`` of a leaf's largest
value on tensors): XLA contracts some of AdamW's multiply-adds into fused
ones, which round once.  The int8 error-feedback
quantizer is bit-equal, its residual carried over three steps included.

A whole step differs by the float32 gradients: the two frameworks'
backward passes sum in different orders, and their gradients of these
weights differ by 3-7e-5 (relative Frobenius error), each as far from the
reference run with float64 params (both 2-6e-5); the reference's jitted
and eager gradients differ by 1e-5 between themselves.  Losses agree to
3e-7 and parameters after three steps to 2.6e-6 (bound ``F32_RTOL``,
1e-5); Adam's moments, squares and sums of those gradients, to 6e-4
(``MOMENT_RTOL``, 2e-3).  With compressed gradients, a gradient that
differs near the edge of an int8 bin dequantizes a whole quantum away, so
parameters differ by 7.6e-5 where the reference's jitted and eager runs
differ by 1.1e-5 (``COMPRESSED_RTOL``, 2e-4), and the residuals
themselves are not compared step by step.  In bf16 compute the reference's
own bf16 run is 1.6e-3 (losses) and 8.2e-3 (parameters) from its float32
run; the port is 5e-4 and 3.6e-3 from the reference's bf16 run.  The
bounds are 2.5 times the reference's own spread: 4e-3 and 2e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import Model as JaxModel, ModelConfig as JaxConfig  # noqa: E402
from repro.train import (adamw_init as jadamw_init,  # noqa: E402
                         adamw_update as jadamw_update,
                         clip_by_global_norm as jclip,
                         init_train_state as jinit_state,
                         make_train_step as jmake_step,
                         warmup_cosine as jwarmup_cosine)
from repro.train.step import _quantize_ef as jquantize_ef  # noqa: E402
from repro_torch.checkpoint import tree_from_numpy  # noqa: E402
from repro_torch.checkpoint.manager import _flatten_with_paths  # noqa: E402
from repro_torch.models import Model, ModelConfig  # noqa: E402
from repro_torch.train import (TrainState, abstract_train_state,  # noqa: E402
                               adamw_init, adamw_update, clip_by_global_norm,
                               init_train_state, make_train_step,
                               warmup_cosine)
from repro_torch.train.step import _quantize_ef  # noqa: E402

OPT_RTOL = 1e-6
F32_RTOL = 1e-5
MOMENT_RTOL = 2e-3
COMPRESSED_RTOL = 2e-4
BF16_LOSS_RTOL = 4e-3
BF16_RTOL = 2e-2
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128, vocab=128, remat="none")
HP = dict(peak_lr=1e-3, warmup=1, total_steps=10)
METRIC_KEYS = {"loss", "xent", "accuracy", "lb_loss", "z_loss", "tokens",
               "grad_norm", "lr"}
K = 3


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _np(x):
    """A JAX leaf as float64 numpy (bf16 through float32)."""
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
                      np.float64)


def _tree(rng, shapes: dict) -> dict:
    return {k: (rng.standard_normal(s) * 0.02).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (32, 48), "b": (48,), "emb": (64, 16), "a": (7, 3, 5)}
ULPS = 4


def _assert_ulps(got, want, rtol: float = 0.0):
    """Every element within ``ULPS`` float32 ulps of the leaf's largest
    magnitude (a fused multiply-add rounds once where two roundings are
    made otherwise), plus ``rtol`` of its own value."""
    got = got.float().numpy().astype(np.float64)
    bound = ULPS * 2.0 ** -23 * np.abs(want).max() + rtol * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# optimizer functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(5, 40), (1, 10), (0, 30), (40, 40)])
def test_warmup_cosine_matches_the_reference(warmup, total):
    f = jax.jit(lambda s: jwarmup_cosine(s, peak_lr=3e-4, warmup=warmup,
                                         total=total))
    for s in range(total + 3):
        want = np.float32(f(jnp.int32(s)))
        got = warmup_cosine(torch.tensor(s, dtype=torch.int32), peak_lr=3e-4,
                            warmup=warmup, total=total)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(), want, rtol=OPT_RTOL, atol=0)


@pytest.mark.parametrize("factor", [0.5, 1.0, 2.0], ids=["above", "at", "below"])
def test_clip_by_global_norm_matches_the_reference(factor):
    rng = np.random.default_rng(3)
    g = _tree(rng, SHAPES)
    norm = float(np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                             for v in g.values())))
    max_norm = norm * factor
    jc, jn = jax.jit(lambda t: jclip(t, max_norm))({k: jnp.asarray(v)
                                                    for k, v in g.items()})
    tc, tn = clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()},
                                 max_norm)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=OPT_RTOL)
    for k in g:
        assert tc[k].dtype == torch.float32
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=OPT_RTOL, atol=1e-12)
    if factor >= 1.0:                      # at and below the norm: unchanged
        for k in g:
            np.testing.assert_allclose(tc[k].numpy(), g[k], rtol=OPT_RTOL)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("bf16_moments", [False, True], ids=["f32", "bf16"])
def test_adamw_matches_the_reference(weight_decay, bf16_moments):
    """Three updates with a changing learning rate, moments carried."""
    rng = np.random.default_rng(4)
    p = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES) for _ in range(3)]
    lrs = [1e-3, 5e-4, 2e-4]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jopt = jadamw_init(jp, bf16_moments=bf16_moments)
    upd = jax.jit(lambda g, o, q, lr: jadamw_update(g, o, q, lr,
                                                    weight_decay=weight_decay))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    topt = adamw_init(tp, bf16_moments=bf16_moments)
    for g, lr in zip(grads, lrs):
        jp, jopt = upd({k: jnp.asarray(v) for k, v in g.items()}, jopt, jp,
                       jnp.float32(lr))
        tp, topt = adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                                topt, tp, torch.tensor(lr, dtype=torch.float32),
                                weight_decay=weight_decay)
    assert topt["count"].dtype == torch.int32 and int(topt["count"]) == 3
    mdt = torch.bfloat16 if bf16_moments else torch.float32
    for k in p:
        assert tp[k].dtype == torch.float32 and topt["m"][k].dtype == mdt
        _assert_ulps(tp[k], _np(jp[k]))
        for mv in ("m", "v"):
            # a moment that differs in its last float32 bit can round to
            # the neighbouring bf16 value: one bf16 ulp
            _assert_ulps(topt[mv][k], _np(jopt[mv][k]),
                         rtol=2 ** -7 if bf16_moments else 0.0)


def test_adamw_decoupled_weight_decay():
    params = {"w": torch.ones(4)}
    opt = adamw_init(params)
    p2, _ = adamw_update({"w": torch.zeros(4)}, opt, params, lr=0.1,
                         weight_decay=0.5)
    # zero grads: the update is pure decay, p -= lr * wd * p
    np.testing.assert_allclose(p2["w"].numpy(), 0.95, rtol=1e-5)


def test_adamw_leaves_the_state_passed_in_unchanged():
    rng = np.random.default_rng(5)
    p = {k: torch.from_numpy(v) for k, v in _tree(rng, SHAPES).items()}
    before = {k: v.clone() for k, v in p.items()}
    opt = adamw_init(p)
    adamw_update(p, opt, p, 1e-3)
    assert all(torch.equal(p[k], before[k]) for k in p)
    assert int(opt["count"]) == 0


# ---------------------------------------------------------------------------
# the int8 error-feedback quantizer: bit for bit
# ---------------------------------------------------------------------------

def _bits(x) -> np.ndarray:
    """Bit patterns (NaN included) of a float32/bf16 JAX array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    return np.asarray(x).view(np.int16 if x.dtype == jnp.bfloat16 else np.int32)


def _same_bits(t, j) -> bool:
    """Bit-equal, with NaN in the same places (its payload is not
    compared: XLA's canonical NaN is not PyTorch's)."""
    tn, jn = np.isnan(t.float().numpy()), np.isnan(_np(j))
    return np.array_equal(tn, jn) and np.array_equal(_bits(t)[~tn], _bits(j)[~jn])


@pytest.mark.parametrize("shape", [(64, 64), (1000,), (3, 5, 7)])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_quantize_ef_is_bit_equal_over_three_steps(shape, gdtype):
    rng = np.random.default_rng(6)
    jq = jax.jit(jquantize_ef)
    je = jnp.zeros(shape, jnp.bfloat16)
    te = torch.zeros(shape, dtype=torch.bfloat16)
    for step in range(3):
        g = (rng.standard_normal(shape) * 10.0 ** -(step + 2)).astype(np.float32)
        jg = jnp.asarray(g).astype(gdtype)
        tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(
            getattr(torch, gdtype))
        jd, je = jq(jg, je)
        td, te = _quantize_ef(tg, te)
        assert td.dtype == tg.dtype and te.dtype == torch.bfloat16
        assert np.array_equal(_bits(td), _bits(jd)), step
        assert np.array_equal(_bits(te), _bits(je)), step
    assert np.abs(_np(je)).sum() > 0           # the residual is carried


@pytest.mark.parametrize("g", [
    [1e-39, 2e-39, -5e-40, 0.0],               # all subnormal: flushed to 0
    [1.0, 1e-39, 3e-3, -0.5],                  # a subnormal beside normals
    [1e-37, 0.0, 0.0, 0.0],                    # a subnormal scale: NaN zeros
    [1e-37, 5e-38, -3e-38, 2e-38],
    [2e-36, 1e-38, 1.5e-38, 0.0],              # a subnormal residual
    [0.0, 0.0, 0.0, 0.0],                      # zero tensor: scale 1.0
], ids=["subnormal", "mixed", "scale-flushed", "small", "residual", "zero"])
def test_quantize_ef_flushes_subnormals_as_xla(g):
    """XLA treats subnormal float32 inputs and results as zero; its flush
    reaches g + e, the scale and the residual, and the port's does too."""
    g = np.asarray(g, np.float32)
    for e in (np.zeros(4, np.float32), np.asarray([1e-39, 0, 0, 0], np.float32)):
        je = jnp.asarray(e).astype(jnp.bfloat16)
        jd, jr = jax.jit(jquantize_ef)(jnp.asarray(g), je)
        td, tr = _quantize_ef(torch.from_numpy(g),
                              torch.from_numpy(np.array(je.astype(jnp.float32)))
                              .to(torch.bfloat16))
        assert _same_bits(td, jd), (td, jd)
        assert _same_bits(tr, jr), (tr, jr)


# ---------------------------------------------------------------------------
# the train step against the reference's, K steps from one state
# ---------------------------------------------------------------------------

def _batches(rng, accum: int = 1):
    out = []
    for _ in range(K):
        tok = rng.integers(0, TINY["vocab"], (4, 32)).astype(np.int32)
        b = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
        if accum > 1:
            b = {k: v.reshape((accum, 4 // accum) + v.shape[1:]) for k, v in b.items()}
        out.append(b)
    return out


CASES = {
    "f32": ("float32", {}),
    "f32-accum2": ("float32", {"accum": 2}),
    "f32-compressed": ("float32", {"compress_grads": True}),
    "f32-bf16-grads": ("float32", {"bf16_grads": True}),
    "bf16": ("bfloat16", {}),
    "bf16-bf16-grads": ("bfloat16", {"bf16_grads": True}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def stepped(request):
    """Both packages' states and metrics after K steps from the reference's
    initial state, on the same batches."""
    dtype, kw = CASES[request.param]
    cfg = dict(TINY, dtype=dtype)
    jm, tm = JaxModel(JaxConfig(**cfg)), Model(ModelConfig(**cfg))
    cg = kw.get("compress_grads", False)
    js = jinit_state(jm, jax.random.key(0), compress_grads=cg)
    host = jax.tree.map(np.asarray, {"params": js.params, "opt": js.opt,
                                     "step": js.step, "err": js.err})
    t = tree_from_numpy(host, device="cpu")
    ts = TrainState(t["params"], t["opt"], t["step"], t["err"])
    jstep = jax.jit(jmake_step(jm, **HP, **kw))
    tstep = make_train_step(tm, **HP, **kw)
    jms, tms = [], []
    for b in _batches(np.random.default_rng(0), kw.get("accum", 1)):
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        jms.append(jmet)
        tms.append(tmet)
    return request.param, js, ts, jms, tms


def test_train_step_matches_the_reference(stepped):
    name, js, ts, jms, tms = stepped
    bf16 = name.startswith("bf16")
    loss_tol = BF16_LOSS_RTOL if bf16 else F32_RTOL
    param_tol = BF16_RTOL if bf16 else (
        COMPRESSED_RTOL if "compressed" in name else F32_RTOL)
    for jm, tm in zip(jms, tms):
        for k in ("loss", "xent"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=loss_tol)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=OPT_RTOL)
        assert float(tm["tokens"]) == float(jm["tokens"])
    jp = _flatten_with_paths(jax.tree.map(_np, js.params))
    tp = _flatten_with_paths(ts.params)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tp[k].dtype == torch.float32
        assert _rel(tp[k], jp[k]) < param_tol, (k, _rel(tp[k], jp[k]))
    assert int(ts.step) == int(js.step) == K and ts.step.dtype == torch.int32
    assert int(ts.opt["count"]) == K
    if not bf16 and "compressed" not in name:
        for mv in ("m", "v"):
            jm_ = _flatten_with_paths(jax.tree.map(_np, js.opt[mv]))
            tm_ = _flatten_with_paths(ts.opt[mv])
            for k in jm_:
                assert _rel(tm_[k], jm_[k]) < MOMENT_RTOL, (mv, k)
    if "compressed" in name:
        for k, e in _flatten_with_paths(ts.err).items():
            assert e.dtype == torch.bfloat16 and torch.isfinite(e.float()).all()
        assert sum(float(e.float().abs().sum())
                   for e in _flatten_with_paths(ts.err).values()) > 0
    else:
        assert ts.err is None and js.err is None


def test_metrics_have_the_reference_keys_and_types(stepped):
    _, _, _, jms, tms = stepped
    for jm, tm in zip(jms, tms):
        assert set(tm) == set(jm) == METRIC_KEYS
        for k, v in tm.items():
            assert isinstance(v, torch.Tensor) and v.shape == ()
            assert v.dtype == torch.float32 and np.isfinite(float(v)), k
            assert not v.requires_grad, k


# ---------------------------------------------------------------------------
# the reference's behavioural tests, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return Model(ModelConfig(**TINY))


def _batch(model, seed=7, B=4, S=32):
    tok = torch.randint(0, model.cfg.vocab, (B, S),
                        generator=torch.Generator().manual_seed(seed))
    return {"tokens": tok, "targets": torch.roll(tok, -1, dims=1)}


def test_overfits_fixed_batch(tiny):
    state = init_train_state(tiny, torch.Generator().manual_seed(0))
    step = make_train_step(tiny, peak_lr=1e-2, warmup=5, total_steps=60)
    batch = _batch(tiny)
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0, losses


def test_accum_matches_single_batch_grads(tiny):
    """accum=2 over two half-batches == one full batch (same update)."""
    batch = _batch(tiny)
    s0 = init_train_state(tiny, torch.Generator().manual_seed(0))
    step1 = make_train_step(tiny, peak_lr=1e-3, warmup=1, total_steps=10,
                            clip_norm=1e9)
    s1, _ = step1(s0, batch)
    step2 = make_train_step(tiny, peak_lr=1e-3, warmup=1, total_steps=10,
                            accum=2, clip_norm=1e9)
    b2 = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in batch.items()}
    s2, _ = step2(s0, b2)
    a, b = _flatten_with_paths(s1.params), _flatten_with_paths(s2.params)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=5e-5,
                                   rtol=5e-4)


def test_compressed_grads_still_learn(tiny):
    state = init_train_state(tiny, torch.Generator().manual_seed(0),
                             compress_grads=True)
    step = make_train_step(tiny, peak_lr=1e-2, warmup=5, total_steps=60,
                           compress_grads=True)
    batch = _batch(tiny)
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0
    # error-feedback buffers are being used (nonzero)
    assert sum(float(e.float().abs().sum())
               for e in _flatten_with_paths(state.err).values()) > 0


def test_abstract_train_state_is_the_fresh_states_shape(tiny):
    for cg in (False, True):
        live = init_train_state(tiny, torch.Generator().manual_seed(0),
                                compress_grads=cg)
        meta = abstract_train_state(tiny, compress_grads=cg)
        a = _flatten_with_paths(dataclasses.asdict(live))
        b = _flatten_with_paths(dataclasses.asdict(meta))
        assert sorted(a) == sorted(b)
        for k, v in a.items():
            if v is None:
                continue
            assert b[k].is_meta and b[k].shape == v.shape and b[k].dtype == v.dtype, k
