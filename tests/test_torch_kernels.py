"""The port's preconditioner kernels, on the CPU: their plain versions
(``repro_torch.kernels.ref``) and the dispatch around them (``ops``) held
byte for byte (tolerance 0) against the JAX package's Pallas kernels in
interpret mode and against its host preconditioners, per basket; zigzag,
which has no Pallas kernel, against the host preconditioners alone.  The
vector path that delta and zigzag share (``csrc/vector_map.cuh``) is
modelled from its source.  The CUDA kernels themselves run only on the
card (``chip_smoke.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precond as hostp  # noqa: E402
from repro.kernels import bitshuffle as pbs  # noqa: E402
from repro.kernels import byteshuffle as pbys  # noqa: E402
from repro.kernels import delta as pdl  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.bitshuffle import bitshuffle, bitunshuffle  # noqa: E402
from repro_torch.kernels.byteshuffle import byteshuffle  # noqa: E402
from repro_torch.kernels.delta import delta, undelta  # noqa: E402
from repro_torch.kernels.zigzag import unzigzag, zigzag  # noqa: E402

ITEMSIZES = [1, 2, 4, 8]
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_INT = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


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


@pytest.mark.parametrize("itemsize,tail",
                         [(i, t) for i in ITEMSIZES for t in range(i)])
def test_zigzag_matches_host_precond(itemsize, tail, rng):
    """Every signed width's extremes, -1, 0 and 1 beside random values, then
    ``tail`` bytes: bytes equal to the reference's, which sign-extends
    through int64 and keeps the low bits, and the round trip exact."""
    info = np.iinfo(_INT[itemsize])
    x = np.concatenate([
        np.array([info.min, info.max, -1, 0, 1, info.min + 1, info.max - 1],
                 _INT[itemsize]),
        rng.integers(info.min, info.max, 997, dtype=_INT[itemsize],
                     endpoint=True)])
    raw = np.concatenate([x.view(np.uint8),
                          rng.integers(0, 256, tail, dtype=np.uint8)])
    t = torch.from_numpy(raw.copy())
    enc = ref.zigzag(t, itemsize)
    assert _b(enc) == hostp.zigzag_encode(raw, itemsize)
    assert _b(ref.unzigzag(t, itemsize)) == hostp.zigzag_decode(raw, itemsize)
    assert _b(ref.unzigzag(enc, itemsize)) == raw.tobytes()
    # small magnitudes of either sign become small unsigned values
    small = np.frombuffer(_b(enc)[:7 * itemsize], _UINT[itemsize])
    assert small[2:5].tolist() == [1, 0, 2]


# ---------------------------------------------------------------------------
# the vector path of delta and zigzag, modelled from its source
# ---------------------------------------------------------------------------

_VMAP = (Path(_build.__file__).resolve().parent / "csrc" / "vector_map.cuh").read_text()


def _constant(name: str) -> int:
    m = re.search(rf"constexpr \w+ {name} = ([\d\s*]+);", _VMAP)
    return eval(m.group(1))              # a literal product: "2 * 132"


def _launch(n: int, itemsize: int) -> tuple[int, int]:
    """(blocks, vectors a thread) of a launch: vecs_per_thread, map_blocks."""
    threads, deep = _constant("kThreads"), _constant("kDeepVecs")
    vecs = -(-n * itemsize // 16)
    k = deep if -(-vecs // (threads * deep)) >= _constant("kDeepBlocks") else 1
    return max(1, -(-vecs // (threads * k))), k


def _model_delta(x: np.ndarray, blocks: int, k: int) -> np.ndarray:
    """The kernel's delta from its lanes: thread t of block b holds vectors
    b * threads * k + t + r * threads; a lane's left neighbour is lane - 1's
    last element of the same r, lane 0 loads it from x."""
    threads, v = _constant("kThreads"), 16 // x.itemsize
    n, out = x.size, np.empty_like(x)
    pad = np.zeros(blocks * threads * k * v, x.dtype)
    pad[:n] = x
    vec = pad.reshape(blocks, k, threads, v)          # [b, r, t, j]
    t = np.arange(threads)
    first = np.arange(blocks)[:, None, None] * threads * k + t + \
        np.arange(k)[None, :, None] * threads          # vector index [b, r, t]
    left = np.roll(vec[..., -1], 1, axis=-1)           # __shfl_up_sync by 1
    lane0 = t % 32 == 0
    e0 = first * v
    loaded = np.where(e0 > 0, pad[np.maximum(e0 - 1, 0)], 0).astype(x.dtype)
    left = np.where(lane0, loaded, left)
    prev = np.concatenate([left[..., None], vec[..., :-1]], axis=-1)
    with np.errstate(over="ignore"):
        got = (vec - prev).astype(x.dtype)
    flat = np.empty_like(pad)
    flat[(e0[..., None] + np.arange(v)).reshape(-1)] = got.reshape(-1)
    out[:] = flat[:n]
    return out


def test_vector_path_grid_from_source():
    """Constants and the thread's vectors as the source writes them: 256
    threads, four vectors a thread from 264 blocks on (4.3 MB), else one."""
    assert (_constant("kThreads"), _constant("kDeepVecs"),
            _constant("kDeepBlocks")) == (256, 4, 264)
    assert "(first + int64_t{r} * kThreads) * V" in _VMAP
    assert "__shfl_up_sync(kFullMask, Lane<I>(v[r].e[V - 1]), 1)" in _VMAP
    assert _launch(0, 8) == (1, 1)                     # a tail alone
    assert _launch((1 << 20) // 8, 8) == (256, 1)      # the main path's basket
    assert _launch(100_000_000 // 4, 4) == (6104, 4)
    edge = 263 * 1024 * 8               # 2-byte elements of 263 deep blocks
    assert _launch(edge + 1, 2) == (264, 4)
    assert _launch(edge, 2) == (263 * 4, 1)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_vector_path_model_matches_host_delta(itemsize, rng):
    """The lanes' delta equals the host's at the lengths the design turns
    on: 0, 1, 15, 16, 17 vectors and a block, each +-1 element, and a
    length with the deep grid's vectors."""
    v = 16 // itemsize
    lengths = sorted({max(0, c * v + d) for c in (0, 1, 15, 16, 17, 256)
                      for d in (-1, 0, 1)})
    for n in lengths + [264 * 1024 * v + 3]:
        x = rng.integers(0, np.iinfo(_UINT[itemsize]).max, n,
                         dtype=_UINT[itemsize], endpoint=True)
        got = _model_delta(x, *_launch(n, itemsize))
        assert got.tobytes() == hostp.delta_encode(x.tobytes(), itemsize), n


# ---------------------------------------------------------------------------
# ops: spec strings per basket, the container's semantics
# ---------------------------------------------------------------------------

SPECS = ["bitshuffle4", "bitshuffle2", "bitshuffle8", "shuffle2", "shuffle8",
         "delta2+shuffle2", "delta8+shuffle8", "delta4+bitshuffle4", "none",
         "zigzag1", "zigzag2", "zigzag4", "zigzag8", "zigzag4+shuffle4",
         "zigzag8+bitshuffle8"]


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
    """Every stage the container writes has a kernel (zigzag since it got
    one); a stage name the container does not know raises."""
    for spec in ("rle4", "zigzag4+lz8"):
        with pytest.raises(ValueError, match="unknown"):
            ops.precondition(spec, torch.zeros(16, dtype=torch.uint8))
        with pytest.raises(ValueError, match="unknown"):
            ops.unprecondition_into(spec, torch.zeros(16, dtype=torch.uint8),
                                    torch.empty(16, dtype=torch.uint8), 16)


@pytest.mark.parametrize("spec", ["zigzag4", "zigzag2+shuffle2",
                                  "delta8+zigzag8+shuffle8"])
def test_ops_zigzag_matches_apply_precond(spec, rng):
    """Signed values of every magnitude through the spec, against the
    reference's ``apply_precond``/``undo_precond``, odd basket lengths."""
    for nbytes in (3, 4096 + 5, 30_001):
        raw = rng.integers(-300, 300, nbytes, dtype=np.int64).astype(np.uint8)
        staged = ops.precondition(spec, torch.from_numpy(raw.copy()))
        assert _b(staged) == hostp.apply_precond(spec, raw.tobytes())
        out = torch.empty(nbytes, dtype=torch.uint8)
        ops.unprecondition_into(spec, staged, out, nbytes)
        assert _b(out) == hostp.undo_precond(spec, _b(staged), nbytes) \
            == raw.tobytes()


@pytest.mark.parametrize("fn", [delta, zigzag, unzigzag],
                         ids=lambda f: f.__name__)
def test_one_pass_wrappers_refuse_overlapping_out(fn):
    """The neighbour reads make an in-place delta a race, and the kernels
    read through the non-coherent cache: out may not share a byte with the
    input, on the CPU as on the card."""
    buf = torch.arange(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="overlaps"):
        fn(buf, 4, out=buf)
    wide = torch.arange(128, dtype=torch.uint8)
    with pytest.raises(ValueError, match="overlaps"):
        fn(wide[:64], 4, out=wide[60:124])
    with pytest.raises(ValueError, match="overlaps"):
        fn(wide[64:], 4, out=wide[4:68])
    beside = fn(wide[:64], 4, out=wide[64:])           # adjacent, not overlapping
    assert _b(beside) == _b(getattr(ref, fn.__name__)(wide[:64], 4))


def test_cpu_tensors_take_plain_versions_uncounted(rng):
    """A CPU tensor runs the plain version and launches nothing."""
    ops.reset_launch_counts()
    raw = torch.from_numpy(rng.integers(0, 256, 1003, dtype=np.uint8))
    out = torch.empty(8 * 4 * 32 + 3, dtype=torch.uint8)
    assert bitshuffle(raw, 4, out=out) is out
    assert _b(out) == _b(ref.bitshuffle(raw, 4))
    assert _b(bitunshuffle(out, 4, 1000)) == _b(raw)
    assert _b(undelta(delta(raw, 2), 2)) == _b(raw)
    assert _b(unzigzag(zigzag(raw, 8), 8)) == _b(raw)
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
