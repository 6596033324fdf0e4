"""The port's Mamba mixer on the CPU against the JAX package's.

At the reduced jamba config (d_inner 128, d_state 8, conv 4): the
selective scan's pieces (softplus, the associative scan, the float32
causal conv), ``mamba`` over one chunk, over several chunks and over the
single-chunk fallback, with ``return_state``, ``mamba_step`` from a state
in either conv type, ``init_mamba_state``, and the ``mamba_bf16_y``
variant.  Inputs are drawn with numpy; the JAX side runs
jitted.

Tolerance.  The port reproduces ``lax.associative_scan``'s order of
combination step for step, so the float32 products associate as the
reference's; what is left is XLA's contraction of ``a * h + b`` into one
fused multiply-add (a single step, L = 1, differs as much as 64) and the
sums of the matmuls.  Measured: the scan 4-6e-8, ``mamba`` in float32
1.4e-7 (outputs) and 2.3e-7 (states), relative Frobenius errors;
``F32_RTOL`` = 1e-5 holds them.  In bf16 the outputs are bit-equal and
the float32 states 6e-8 apart (every bf16 rounding is the reference's:
the full pass's conv accumulates in float32, the step's conv is a bf16
einsum with float32 sums); ``BF16_RTOL`` is the dense path's 3 %."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.specs import _unflatten  # noqa: E402
from repro.models.specs import tree_paths as jax_tree_paths  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.specs import tree_paths  # noqa: E402

F32_RTOL = 1e-5
BF16_RTOL = 3e-2
B = 2
ARCH = "jamba-v0.1-52b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _cfgs():
    return (jconfigs.reduced(jconfigs.get_config(ARCH)),
            configs.reduced(configs.get_config(ARCH)))


def _draw(cfg, S: int, seed: int = 0):
    """(weights as float32 numpy by path, x (B, S, d) at unit scale)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, spec in sorted(jax_tree_paths(jssm.mamba_specs(cfg)).items()):
        if spec.init == "ones":
            arr = spec.scale + 0.1 * rng.standard_normal(spec.shape)
        elif spec.init == "zeros":
            arr = 0.1 * rng.standard_normal(spec.shape)
        else:
            arr = rng.standard_normal(spec.shape) * spec.scale / np.sqrt(cfg.d_model)
        flat[path] = arr.astype(np.float32)
    return flat, rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _jax(tree, dt):
    return jax.tree.map(lambda v: jnp.asarray(v).astype(dt), tree)


def _torch(tree, dt):
    if isinstance(tree, dict):
        return {k: _torch(v, dt) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32)).to(dt)


def test_specs_match_reference():
    cfg, port = _cfgs()
    want = jax_tree_paths(jssm.mamba_specs(cfg))
    got = tree_paths(ssm.mamba_specs(port))
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        ref = want[path]
        assert (spec.shape, spec.axes, spec.init, spec.scale) == \
            (ref.shape, ref.axes, ref.init, ref.scale), path


def test_softplus_matches_jax():
    """The port's formula is the reference's (no threshold): within two
    float32 ulps of the jitted reference, whose subnormal results XLA
    flushes to zero.  ``F.softplus`` (x itself above 20, where the
    reference adds log1p(exp(-x)) < 2e-9) agrees as closely."""
    x = np.concatenate([np.linspace(-120, 120, 4001),
                        np.random.default_rng(0).standard_normal(1000) * 30,
                        [0.0, -0.0, 19.99, 20.0, 20.01, 88.7, -88.7]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    got = ssm._softplus(torch.tensor(x)).numpy()
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=tiny)
    np.testing.assert_allclose(torch.nn.functional.softplus(torch.tensor(x)).numpy(),
                               want, rtol=2 ** -22, atol=tiny)


@pytest.mark.parametrize("L", [1, 2, 3, 7, 16, 64])
def test_associative_scan_matches_lax(L):
    rng = np.random.default_rng(L)
    a = rng.uniform(0.5, 1.0, (L, B, 8, 4)).astype(np.float32)
    bx = rng.standard_normal((L, B, 8, 4)).astype(np.float32)
    h0 = rng.standard_normal((B, 8, 4)).astype(np.float32)
    wa, wh = jax.jit(jssm._chunk_scan)(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    ga, gh = ssm._chunk_scan(torch.tensor(a), torch.tensor(bx), torch.tensor(h0))
    assert _rel(ga, wa) < 1e-6 and _rel(gh, wh) < 1e-6
    # a sequential loop, the plain recurrence, agrees as far as float32 lets it
    h = torch.tensor(h0)
    for t in range(L):
        h = torch.tensor(a[t]) * h + torch.tensor(bx[t])
        assert _rel(ga[t], h.numpy()) < 1e-5


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv1d_matches_reference(dtype):
    cfg, port = _cfgs()
    flat, _ = _draw(cfg, 16)
    x = np.random.default_rng(4).standard_normal((B, 16, cfg.d_inner)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = jax.jit(lambda p, x: jssm._conv1d(p, x, cfg))(
        _jax(_unflatten(flat), jdt), jnp.asarray(x).astype(jdt))
    got = ssm._conv1d(_torch(_unflatten(flat), tdt), torch.tensor(x).to(tdt), port)
    assert got.dtype == tdt
    assert _rel(got, want) < (F32_RTOL if dtype == "float32" else 1e-6)


@pytest.mark.parametrize("S", [16, 64, 128, 96], ids=["one-chunk", "chunk", "two-chunks",
                                                      "fallback"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_with_state_matches_reference(S, dtype):
    """S = 96 is not a multiple of 64: one chunk of 96, as the reference."""
    cfg, port = _cfgs()
    flat, x = _draw(cfg, S)
    jdt, tdt = DTYPES[dtype]
    jout, jst = jax.jit(lambda p, x: jssm.mamba(p, x, cfg, return_state=True))(
        _jax(_unflatten(flat), jdt), jnp.asarray(x).astype(jdt))
    with torch.no_grad():
        out, st = ssm.mamba(_torch(_unflatten(flat), tdt), torch.tensor(x).to(tdt), port,
                            return_state=True)
        plain = ssm.mamba(_torch(_unflatten(flat), tdt), torch.tensor(x).to(tdt), port)
    assert torch.equal(plain, out)
    rtol = F32_RTOL if dtype == "float32" else BF16_RTOL
    assert out.dtype == tdt and _rel(out, jout) < rtol
    assert st["conv"].dtype == tdt and st["ssm"].dtype == torch.float32
    assert tuple(st["conv"].shape) == jst["conv"].shape == (B, cfg.ssm_conv - 1, cfg.d_inner)
    assert tuple(st["ssm"].shape) == jst["ssm"].shape
    assert _rel(st["conv"], jst["conv"]) == 0.0      # the tail of the in_proj's x
    assert _rel(st["ssm"], jst["ssm"]) < rtol


def test_short_prompt_state_pads_the_conv_tail():
    """S = 2 < conv - 1: the tail is left-padded with zeros, as the
    reference pads it."""
    cfg, port = _cfgs()
    flat, x = _draw(cfg, 2)
    _, jst = jax.jit(lambda p, x: jssm.mamba(p, x, cfg, return_state=True))(
        _jax(_unflatten(flat), jnp.float32), jnp.asarray(x))
    _, st = ssm.mamba(_torch(_unflatten(flat), torch.float32), torch.tensor(x), port,
                      return_state=True)
    assert torch.equal(st["conv"][:, 0], torch.zeros_like(st["conv"][:, 0]))
    assert _rel(st["conv"], jst["conv"]) == 0.0
    assert _rel(st["ssm"], jst["ssm"]) < F32_RTOL


@pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_step_matches_reference(dtype, conv_dtype):
    """From the full pass's state over 16 tokens, written into a state of
    ``init_mamba_state``'s layout with its conv leaf in ``conv_dtype`` (the
    engine's float32 default, or the prefill's own type), three steps."""
    cfg, port = _cfgs()
    flat, x = _draw(cfg, 19)
    jdt, tdt = DTYPES[dtype]
    cj, ct = DTYPES[conv_dtype]
    jp, tp = _jax(_unflatten(flat), jdt), _torch(_unflatten(flat), tdt)
    _, jst = jax.jit(lambda p, x: jssm.mamba(p, x, cfg, return_state=True))(
        jp, jnp.asarray(x[:, :16]).astype(jdt))
    jst = {"conv": jst["conv"].astype(cj), "ssm": jst["ssm"]}
    st = {"conv": _torch(np.asarray(jst["conv"].astype(jnp.float32)), ct),
          "ssm": _torch(np.asarray(jst["ssm"]), torch.float32)}
    jstep = jax.jit(lambda p, x, s: jssm.mamba_step(p, x, s, cfg))
    rtol = F32_RTOL if dtype == "float32" else BF16_RTOL
    for t in range(16, 19):
        jout, jst = jstep(jp, jnp.asarray(x[:, t:t + 1]).astype(jdt), jst)
        out, st = ssm.mamba_step(tp, torch.tensor(x[:, t:t + 1]).to(tdt), st, port)
        assert out.dtype == tdt and tuple(out.shape) == (B, 1, cfg.d_model)
        assert _rel(out, jout) < rtol, t
        assert st["conv"].dtype == ct and st["ssm"].dtype == torch.float32
        assert _rel(st["conv"], jst["conv"]) < rtol and _rel(st["ssm"], jst["ssm"]) < rtol


def test_steps_continue_the_full_pass():
    """The reference's own invariant (``tests/test_models.py``): the full
    pass over 24 tokens equals 16 then 8 single steps, float32."""
    cfg, port = _cfgs()
    flat, x = _draw(cfg, 24)
    p = _torch(_unflatten(flat), torch.float32)
    xt = torch.tensor(x)
    with torch.no_grad():
        full, fst = ssm.mamba(p, xt, port, return_state=True)
        _, st = ssm.mamba(p, xt[:, :16], port, return_state=True)
        outs = []
        for t in range(16, 24):
            o, st = ssm.mamba_step(p, xt[:, t:t + 1], st, port)
            outs.append(o)
    assert float((torch.cat(outs, 1) - full[:, 16:]).abs().max()) < 5e-3
    assert _rel(torch.cat(outs, 1), full[:, 16:].numpy()) < F32_RTOL
    assert _rel(st["ssm"], fst["ssm"].numpy()) < F32_RTOL


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_init_mamba_state_matches_reference(dtype):
    cfg, port = _cfgs()
    kw = {} if dtype is None else {"dtype": DTYPES[dtype][0]}
    want = jssm.init_mamba_state(cfg, 3, **kw)
    got = ssm.init_mamba_state(port, 3, device="cpu",
                               **({} if dtype is None else {"dtype": DTYPES[dtype][1]}))
    assert sorted(got) == sorted(want) == ["conv", "ssm"]
    assert got["conv"].dtype == (torch.float32 if dtype is None else torch.bfloat16)
    assert got["ssm"].dtype == torch.float32
    for k in got:
        assert tuple(got[k].shape) == want[k].shape and not got[k].any()


def test_bf16_y_variant_matches_the_reference(monkeypatch):
    """``mamba_bf16_y`` on in both packages, bf16 over several chunks: the
    outputs within the bf16 bound of the reference's jitted pass with the
    flag on (bit-equal on the default path, see the module's docstring),
    and off the port's default path."""
    cfg, port = _cfgs()
    flat, x = _draw(cfg, 128)
    jdt, tdt = DTYPES["bfloat16"]
    tp, tx = _torch(_unflatten(flat), tdt), torch.tensor(x).to(tdt)
    base = ssm.mamba(tp, tx, port)
    monkeypatch.setitem(jssm.PERF_FLAGS, "mamba_bf16_y", True)
    monkeypatch.setitem(ssm.PERF_FLAGS, "mamba_bf16_y", True)
    want = jax.jit(lambda p, x: jssm.mamba(p, x, cfg))(
        _jax(_unflatten(flat), jdt), jnp.asarray(x).astype(jdt))
    got = ssm.mamba(tp, tx, port)
    assert got.dtype == tdt
    assert _rel(got, want) < BF16_RTOL
    assert not torch.equal(got, base)
