"""The port's int8 quantizer on the CPU, bit for bit against the JAX
package: the plain ``qpack``/``qunpack`` (``repro_torch.kernels.ref``, which
the wrappers run for CPU tensors) and ``ops.quantize_int8`` against the
Pallas kernels in interpret mode, ``ref.qpack_ref`` and the compressed
reduction's own ``_quantize_rows``; then ``rowparallel_einsum_compressed``
over a one-rank gloo group against the reference's on a one-device mesh.
The CUDA kernels themselves run only on the card (``chip_smoke.py``).

The reference runs compiled: XLA turns ``amax / 127.0`` into a product
with float32(1/127), while ``x / scale`` stays a division.  The port
computes the same, so ``qpack_ref`` and ``_quantize_rows`` are compared
under ``jax.jit``, as the reference's model and kernels call them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.qpack import qpack as qpack_pallas  # noqa: E402
from repro.kernels.qpack import qunpack as qunpack_pallas  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.parallel import compressed as jcomp  # noqa: E402
from repro.parallel.actctx import activation_context as jax_context  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.qpack import qpack, qunpack  # noqa: E402
from repro_torch.parallel import (activation_context, one_rank_group,  # noqa: E402
                                  rowparallel_einsum_compressed)

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def _rows(kind: str, rng) -> np.ndarray:
    """float32 rows of one kind: random ragged shapes, exact .5 ties, zero
    rows among others, non-finite and subnormal rows among others."""
    if kind == "ragged":
        return rng.standard_normal((5, 33)).astype(np.float32) * 3
    if kind == "one":
        return rng.standard_normal((1, 1)).astype(np.float32)
    if kind == "ties":
        # amax 127 * 2**e gives scale 2**e exactly, so x / scale lands on
        # k + 0.5: half-to-even must round 0.5 -> 0, 1.5 -> 2, 2.5 -> 2 ...
        halves = np.arange(-126.5, 127, 1.0, dtype=np.float32)        # 254
        row = np.concatenate([[127.0], halves, [-0.5, 0.5]]).astype(np.float32)
        return np.stack([row, row * 2.0 ** -3, -row * 2.0 ** 5])
    if kind == "zeros":
        x = rng.standard_normal((6, 17)).astype(np.float32)
        x[[0, 3, 5]] = 0.0
        return x
    if kind == "halfway":
        # x / scale within an ulp of k + 0.5 with a scale that is not a
        # power of two: a product by 1/scale would round many of these the
        # other way than the true quotient does
        amax = (rng.random((8, 1)) * 10 + 0.1).astype(np.float32)
        s = amax * np.float32(1 / 127)
        k = rng.integers(-126, 126, (8, 63)).astype(np.float32)
        return np.concatenate([amax, (k + 0.5) * s], 1).astype(np.float32)
    if kind == "nonfinite":
        # rows 0-4: a NaN, +inf, -inf, both infinities, and a subnormal amax
        # whose scale amax * float32(1/127) underflows to 0; rows 5-7 finite
        x = (rng.standard_normal((8, 33)) * 3).astype(np.float32)
        x[0, 4] = np.nan
        x[1, 7] = np.inf
        x[2, 0] = -np.inf
        x[3, 31], x[3, 2] = np.inf, -np.inf
        x[4] = 0.0
        x[4, [3, 9, 30]] = np.array([3e-45, -4e-45, 1e-45], np.float32)
        return x
    if kind == "subnormal":
        return _subnormal_rows()
    raise ValueError(kind)


TINY = np.finfo(np.float32).tiny      # FLT_MIN, 2**-126


def _subnormal_rows() -> np.ndarray:
    """Rows where XLA's flushing of subnormals to zero decides the result:
    0 an underflowing scale (a normal amax below 127 * FLT_MIN), 1 a
    subnormal amax, 2 subnormal elements beside a normal amax (equal
    without flushing), 3 a plain row, 4-5 subnormal elements beside an amax
    of 127 * FLT_MIN and just above it (0.9 * FLT_MIN / FLT_MIN rounds to 1
    unless flushed), 6 an amax one step below 127 * FLT_MIN, 7 negative
    subnormals only."""
    return np.array([
        [1e-37, 5e-38, 0.0, -3.3e-38],
        [1e-40, 0.0, 0.0, 0.0],
        [1e-30, 1e-39, 0.0, 2e-31],
        [1.0, 2.0, -3.0, 0.5],
        [127 * TINY, 0.9 * TINY, -0.6 * TINY, 0.4 * TINY],
        [127 * TINY * 1.01, 0.9 * TINY, -0.6 * TINY, 0.5 * TINY],
        [np.nextafter(np.float32(127 * TINY), np.float32(0)), 1e-39, 0.0, -2.0 * TINY],
        [-1e-40, -3e-39, 0.0, -1e-45],
    ], np.float32)


KINDS = ["ragged", "one", "ties", "zeros", "halfway", "nonfinite", "subnormal"]


def _pair(kind, dtype, rng):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    x = _rows(kind, rng)
    jx = jnp.asarray(x).astype(DTYPES[dtype][1])
    tx = torch.from_numpy(x).to(DTYPES[dtype][2])
    return jx, tx


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", [k for k in KINDS if k != "one"])
def test_quantize_matches_pallas(kind, dtype, rng):
    jx, tx = _pair(kind, dtype, rng)
    jq, js, jshape = jops.quantize_int8(jx, interpret=True)
    q, s, shape = ops.quantize_int8(tx)
    assert tuple(shape) == tuple(jshape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()      # bit-equal
    rq, rs = jax.jit(jref.qpack_ref)(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()


@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("kind", ["ragged", "zeros"])
def test_dequantize_matches_pallas(kind, out, rng):
    jx, tx = _pair(kind, "f32", rng)
    jq, js, jshape = jops.quantize_int8(jx, interpret=True)
    q, s, shape = ops.quantize_int8(tx)
    want = jops.dequantize_int8(jq, js, jshape, DTYPES[out][1], interpret=True)
    got = ops.dequantize_int8(q, s, shape, DTYPES[out][2])
    assert got.dtype == DTYPES[out][2]
    assert _np(got).tobytes() == _np(want).tobytes()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_qpack_matches_quantize_rows(kind, dtype, rng):
    """The compressed reduction's variant: a zero row scales 1.0."""
    jx, tx = _pair(kind, dtype, rng)
    jq, js = jax.jit(jcomp._quantize_rows)(jx)
    q, s = qpack(tx, zero_scale=1.0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    if kind == "zeros":
        assert (s.numpy()[[0, 3, 5]] == 1.0).all() and not q.numpy()[[0, 3, 5]].any()


@pytest.mark.parametrize("zero_scale", [0.0, 1.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_nonfinite_rows_match_the_reference(dtype, zero_scale, rng):
    """A row holding a NaN scales NaN, one holding an infinity inf, and
    their q are 0 (every quotient is NaN or 0, and a NaN converts to 0);
    a row whose scale underflows to 0 keeps the zero-scale rule.  Bit for
    bit against the Pallas kernel (zero_scale 0) and the compressed
    reduction's quantizer (zero_scale 1)."""
    jx, tx = _pair("nonfinite", dtype, rng)
    q, s = ref.qpack(tx, zero_scale)
    assert torch.equal(qpack(tx, zero_scale)[0], q)
    if zero_scale == 0.0:
        jq, js = qpack_pallas(jx, interpret=True)
        rq, rs = jax.jit(jref.qpack_ref)(jx)
        np.testing.assert_array_equal(np.asarray(rq), np.asarray(jq))
    else:
        jq, js = jax.jit(jcomp._quantize_rows)(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    s = s.numpy()[:, 0]
    assert np.isnan(s[0]) and (s[1:4] == np.inf).all() and s[4] == zero_scale
    assert not q.numpy()[:5].any()
    assert np.isfinite(s[5:]).all() and (s[5:] > 0).all() and q.numpy()[5:].any()


@pytest.mark.parametrize("zero_scale", [0.0, 1.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_subnormal_rows_match_each_reference(dtype, zero_scale):
    """Subnormals flushed as XLA flushes them (ROADMAP C 2), bit for bit:
    zero_scale 0 against the Pallas kernel (interpret) and the jitted
    ``qpack_ref``, 1.0 against the jitted ``_quantize_rows``, whose zero
    rule tests the amax and so differs from the other two on rows 0 and 1."""
    x = _subnormal_rows()
    jx = jnp.asarray(x).astype(DTYPES[dtype][1])
    tx = torch.from_numpy(x).to(DTYPES[dtype][2])
    q, s = ref.qpack(tx, zero_scale)
    assert torch.equal(qpack(tx, zero_scale)[0], q)
    if zero_scale == 0.0:
        refs = [qpack_pallas(jx, interpret=True), jax.jit(jref.qpack_ref)(jx)]
    else:
        refs = [jax.jit(jcomp._quantize_rows)(jx)]
    for jq, js in refs:
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
    s, q = s.numpy()[:, 0], q.numpy()
    if zero_scale == 0.0:
        assert (s[[0, 1]] == 0).all() and not q[[0, 1]].any()
    else:
        assert s[0] == 0 and (q[0] == [127, 127, 0, -127]).all()
        assert s[1] == 1.0 and not q[1].any()
    assert (q[4:6, 1:] == 0).all() and (q[4:6, 0] == 127).all()
    assert not q[7].any() and s[7] == zero_scale


@pytest.mark.parametrize("zero_scale", [0.0, 1.0])
def test_subnormal_payloads_dequantize_as_the_references(zero_scale):
    """``qunpack`` needs no flush: each scale is 0, 1.0 or at least
    FLT_MIN and each nonzero q at least 1 in size, so no product is
    subnormal, and the port dequantizes the payloads as the Pallas
    ``qunpack`` (interpret) and the jitted ``qunpack_ref`` do."""
    x = _subnormal_rows()
    q, s = ref.qpack(torch.from_numpy(x), zero_scale)
    sn = s.numpy()
    assert ((sn == 0) | (sn == zero_scale) | (sn >= TINY)).all()
    for dt in ("f32", "bf16"):
        got = _np(qunpack(q, s, DTYPES[dt][2]))
        jq, js = jnp.asarray(q.numpy()), jnp.asarray(sn)
        for want in (jax.jit(jref.qunpack_ref, static_argnums=2)(jq, js, DTYPES[dt][1]),
                     qunpack_pallas(jq, js, DTYPES[dt][1], interpret=True)):
            assert got.tobytes() == _np(want).tobytes()
        prod = np.abs(got[got != 0])
        assert (prod >= TINY).all()


def test_scale_is_the_compiled_references(rng):
    """scale = amax * float32(1/127), the product XLA compiles, which is
    one ulp off amax / 127 in some rows."""
    x = (rng.standard_normal((512, 16)) * 10).astype(np.float32)
    _, s = qpack(torch.from_numpy(x))
    amax = np.abs(x).max(1, keepdims=True)
    assert s.numpy().tobytes() == (amax * np.float32(1 / 127)).tobytes()
    assert (s.numpy() != amax / np.float32(127)).any()
    _, js = jax.jit(jref.qpack_ref)(jnp.asarray(x))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()


def test_quantize_any_shape(rng):
    x = rng.standard_normal((2, 3, 4, 9)).astype(np.float32)
    q, s, shape = ops.quantize_int8(torch.from_numpy(x))
    jq, js, _ = jops.quantize_int8(jnp.asarray(x), interpret=True)
    assert q.shape == (24, 9) and s.shape == (24, 1) and shape == x.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    flat = ops.quantize_int8(torch.from_numpy(x.reshape(-1)))[0]      # 1-D: one row
    assert flat.shape == (1, x.size)


@pytest.mark.parametrize("out", list(DTYPES))
def test_qunpack_sums_k_payloads_in_order(out, rng):
    """(k, R, C) payloads: sum_k q_k * s_k in float32, k in order, then cast."""
    q = rng.integers(-127, 128, (3, 7, 11)).astype(np.int8)
    s = (rng.random((3, 7, 1)) * 0.1).astype(np.float32)
    acc = q[0].astype(np.float32) * s[0]
    for j in (1, 2):
        acc = acc + q[j].astype(np.float32) * s[j]
    want = torch.from_numpy(acc).to(DTYPES[out][2])
    got = qunpack(torch.from_numpy(q), torch.from_numpy(s), DTYPES[out][2])
    assert torch.equal(got, want)
    one = qunpack(torch.from_numpy(q[:1]), torch.from_numpy(s[:1]), DTYPES[out][2])
    assert torch.equal(one, qunpack(torch.from_numpy(q[0]), torch.from_numpy(s[0]),
                                    DTYPES[out][2]))


@pytest.mark.parametrize("bad", ["3d", "int", "no_cols", "strided"])
def test_qpack_rejects(bad):
    x = {"3d": torch.zeros(2, 3, 4), "int": torch.zeros(2, 3, dtype=torch.int32),
         "no_cols": torch.zeros(2, 0), "strided": torch.zeros(4, 6)[:, ::2]}[bad]
    with pytest.raises(ValueError):
        qpack(x)


def test_qunpack_rejects_mismatched_scale():
    q = torch.zeros(2, 4, 8, dtype=torch.int8)
    with pytest.raises(ValueError):
        qunpack(q, torch.ones(2, 3, 1))
    with pytest.raises(ValueError):
        qunpack(q[0], torch.ones(4, 1), torch.int8)
    with pytest.raises(ValueError):
        qunpack(q[:0], torch.ones(0, 4, 1))


# ---------------------------------------------------------------------------
# the compressed row-parallel projection, one TP rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_group():
    group = one_rank_group("gloo")
    yield group
    dist.destroy_process_group()


def _auto_mesh():
    # Auto axes: jax.make_mesh makes Explicit ones, which constrain() refuses
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


@pytest.mark.parametrize("shape", [(2, 5, 32, 24), (3, 4, 7, 5)])
def test_compressed_projection_matches_jax(shape, tp_group, rng):
    B, S, E, D = shape
    y = rng.standard_normal((B, S, E)).astype(np.float32)
    w = (rng.standard_normal((E, D)) * 0.2).astype(np.float32)
    y[0, 0] = 0.0                                      # a zero row of the partial
    jy = jnp.asarray(y).astype(jnp.bfloat16)
    ty = torch.from_numpy(y).bfloat16()
    with _auto_mesh() as mesh, jax_context(mesh):
        jout = np.asarray(jax.jit(jcomp.rowparallel_einsum_compressed)(
            jy, jnp.asarray(w)), np.float32)
    with activation_context(tp_group):
        out = rowparallel_einsum_compressed(ty, torch.from_numpy(w))
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, D)
    # the float32 partials agree to rounding; where they are equal, so are q
    jpart = jnp.einsum("bse,ed->bsd", jy, jnp.asarray(w).astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    tpart = torch.matmul(ty.float(), torch.from_numpy(w).bfloat16().float())
    np.testing.assert_allclose(tpart.numpy(), np.asarray(jpart), rtol=1e-5, atol=1e-5)
    jq, js = jax.jit(jcomp._quantize_rows)(jpart.reshape(B * S, D))
    q, s = qpack(torch.from_numpy(np.array(jpart)).reshape(B * S, D), 1.0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    # outputs: within one int8 step of the row's scale (a partial that
    # rounds across a .5) plus one bf16 rounding of the result
    step = s.numpy().reshape(B, S, 1)
    got = out.float().numpy()
    assert np.all(np.abs(got - jout) <= 1.01 * step + 2.0 ** -8 * np.abs(jout))
    assert np.all(got[0, 0] == 0.0)
    ref = y @ w
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.02


def test_compressed_projection_without_context_is_matmul(rng):
    y = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    assert torch.equal(rowparallel_einsum_compressed(y, w),
                       torch.matmul(y, w.bfloat16()))
