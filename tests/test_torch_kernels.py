"""The port's preconditioner kernels, on the CPU: their plain versions
(``repro_torch.kernels.ref``) and the dispatch around them (``ops``) held
byte for byte (tolerance 0) against the JAX package's Pallas kernels in
interpret mode and against its host preconditioners, per basket.  The CUDA
kernels themselves run only on the card (``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precond as hostp  # noqa: E402
from repro.kernels import bitshuffle as pbs  # noqa: E402
from repro.kernels import byteshuffle as pbys  # noqa: E402
from repro.kernels import delta as pdl  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.bitshuffle import bitshuffle, bitunshuffle  # noqa: E402
from repro_torch.kernels.byteshuffle import byteshuffle  # noqa: E402
from repro_torch.kernels.delta import delta, undelta  # noqa: E402

ITEMSIZES = [1, 2, 4, 8]
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).reshape(-1).view(np.uint8).copy())


def _b(t: torch.Tensor) -> bytes:
    return t.numpy().tobytes()


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode), where those apply:
# N a multiple of 8 (bitshuffle) and one block per basket
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_bitshuffle_matches_pallas(itemsize, rng):
    mat = rng.integers(0, 256, (512, itemsize), dtype=np.uint8)
    want = np.asarray(pbs.bitshuffle(jnp.asarray(mat), interpret=True))
    got = ref.bitshuffle(_t(mat), itemsize)
    assert _b(got) == want.tobytes()
    back = np.asarray(pbs.bitunshuffle(jnp.asarray(want), itemsize,
                                       interpret=True))
    assert _b(ref.bitunshuffle(got, itemsize, mat.size)) == back.tobytes()


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_byteshuffle_matches_pallas(itemsize, rng):
    mat = rng.integers(0, 256, (1000, itemsize), dtype=np.uint8)
    want = np.asarray(pbys.byteshuffle(jnp.asarray(mat), interpret=True))
    got = ref.byteshuffle(_t(mat), itemsize)
    assert _b(got) == want.tobytes()
    back = np.asarray(pbys.byteunshuffle(jnp.asarray(want), interpret=True))
    assert _b(ref.byteunshuffle(got, itemsize)) == back.tobytes()


@pytest.mark.parametrize("itemsize", [1, 2, 4])   # jax has no uint64 without x64
def test_delta_matches_pallas_block(itemsize, rng):
    """The basket is the Pallas kernel's block: out[0] = x[0] restarts it."""
    x = np.cumsum(rng.integers(0, 300, 997)).astype(_UINT[itemsize])
    want = np.asarray(pdl.delta_block(jnp.asarray(x), block_n=x.size,
                                      interpret=True))
    got = ref.delta(_t(x), itemsize)
    assert _b(got) == want.tobytes()
    back = np.asarray(pdl.undelta_block(jnp.asarray(want), block_n=x.size,
                                        interpret=True))
    assert _b(ref.undelta(got, itemsize)) == back.tobytes() == x.tobytes()


# ---------------------------------------------------------------------------
# plain versions vs the host preconditioners: ragged N, tails, itemsize 8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("nbytes", [0, 1, 7, 8, 9, 77_100 * 4 + 3, 8191])
def test_ref_matches_host_precond(itemsize, nbytes, rng):
    raw = rng.integers(0, 256, nbytes, dtype=np.uint8)
    t = torch.from_numpy(raw.copy())
    body = nbytes - nbytes % itemsize
    cases = [
        (ref.bitshuffle(t, itemsize), hostp.bitshuffle(raw, itemsize)),
        (ref.byteshuffle(t, itemsize), hostp.shuffle(raw, itemsize)),
        (ref.delta(t, itemsize), hostp.delta_encode(raw, itemsize)),
        (ref.byteunshuffle(t, itemsize), hostp.unshuffle(raw, itemsize)),
        (ref.undelta(t, itemsize), hostp.delta_decode(raw, itemsize)),
    ]
    for got, want in cases:
        assert _b(got) == want
    shuffled = hostp.bitshuffle(raw, itemsize)
    planes = torch.from_numpy(np.frombuffer(shuffled, np.uint8).copy())
    assert _b(ref.bitunshuffle(planes, itemsize, body)) == raw.tobytes()


def test_delta_wraps_mod_width(rng):
    """Wraparound in the signed type gives the unsigned bits mod 2**k."""
    for itemsize, dt in _UINT.items():
        x = np.array([np.iinfo(dt).max, 0, 5, np.iinfo(dt).max - 2, 1], dt)
        got = ref.delta(_t(x), itemsize)
        assert _b(got) == hostp.delta_encode(x.tobytes(), itemsize)
        assert _b(ref.undelta(got, itemsize)) == x.tobytes()


# ---------------------------------------------------------------------------
# ops: spec strings per basket, the container's semantics
# ---------------------------------------------------------------------------

SPECS = ["bitshuffle4", "bitshuffle2", "bitshuffle8", "shuffle2", "shuffle8",
         "delta2+shuffle2", "delta8+shuffle8", "delta4+bitshuffle4", "none"]


@pytest.mark.parametrize("spec", SPECS)
def test_ops_spec_roundtrip_matches_host(spec, rng):
    for nbytes in (0, 5, 4096 + 6, 77_100 * 4):
        raw = rng.integers(0, 256, nbytes, dtype=np.uint8)
        staged = ops.precondition(spec, torch.from_numpy(raw.copy()))
        assert _b(staged) == hostp.apply_precond(spec, raw.tobytes())
        dst = torch.full((nbytes + 3,), 7, dtype=torch.uint8)
        ops.unprecondition_into(spec, staged, dst[1:1 + nbytes], nbytes)
        assert _b(dst[1:1 + nbytes]) == raw.tobytes()
        assert dst[0].item() == 7 and _b(dst[1 + nbytes:]) == b"\x07\x07"


def test_delta_restarts_per_basket(rng):
    """Two baskets of one offset array: each deltas from its own first
    element (core/basket.py), unlike the reference's global ops.delta_u32."""
    x = np.cumsum(rng.integers(1, 9, 2048)).astype(np.int64)
    t = _t(x)
    half = t.numel() // 2
    got = [ops.precondition("delta8+shuffle8", t[:half]),
           ops.precondition("delta8+shuffle8", t[half:])]
    want = [hostp.apply_precond("delta8+shuffle8", x[:1024].tobytes()),
            hostp.apply_precond("delta8+shuffle8", x[1024:].tobytes())]
    assert [_b(g) for g in got] == want
    second = np.frombuffer(_b(ref.delta(t[half:], 8)), np.int64)
    assert second[0] == x[1024]            # restarted, not x[1024] - x[1023]


def test_ops_rejects_unported_stage():
    with pytest.raises(ValueError, match="zigzag"):
        ops.precondition("zigzag8", torch.zeros(16, dtype=torch.uint8))


def test_cpu_tensors_take_plain_versions_uncounted(rng):
    """A CPU tensor runs the plain version and launches nothing."""
    ops.reset_launch_counts()
    raw = torch.from_numpy(rng.integers(0, 256, 1003, dtype=np.uint8))
    out = torch.empty(8 * 4 * 32 + 3, dtype=torch.uint8)
    assert bitshuffle(raw, 4, out=out) is out
    assert _b(out) == _b(ref.bitshuffle(raw, 4))
    assert _b(bitunshuffle(out, 4, 1000)) == _b(raw)
    assert _b(undelta(delta(raw, 2), 2)) == _b(raw)
    assert _b(byteshuffle(raw, 8)) == hostp.shuffle(raw.numpy(), 8)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_wrappers_validate_inputs():
    with pytest.raises(ValueError, match="uint8"):
        bitshuffle(torch.zeros(8, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="out must hold"):
        bitshuffle(torch.zeros(8, dtype=torch.uint8), 4,
                   out=torch.empty(3, dtype=torch.uint8))
    with pytest.raises(ValueError, match="cannot hold"):
        bitunshuffle(torch.zeros(8, dtype=torch.uint8), 4, 400)
