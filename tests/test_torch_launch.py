"""The port's kernel launch path and the plain versions of its two
redesigned kernels (``undelta``, ``qunpack``), on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py``).  What surrounds
them is tested here: the ctypes signatures against the launchers'
``extern "C"`` declarations, the undelta workspace's sizing, the launch
counters, the rule that a tensor on any other device than the CPU or a GPU
is refused, and the plain versions against the JAX package (Pallas kernels
in interpret mode, the host preconditioners, the compressed reduction's own
quantizer)."""

import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import precond as hostp  # noqa: E402
from repro.kernels import delta as pdl  # noqa: E402
from repro.kernels import qpack as pqp  # noqa: E402
from repro.parallel import compressed as jcomp  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import delta as dmod  # noqa: E402
from repro_torch.kernels.qpack import qpack, qunpack  # noqa: E402

CSRC = Path(_build.__file__).resolve().parent / "csrc"
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


# ---------------------------------------------------------------------------
# ctypes signatures against the sources
# ---------------------------------------------------------------------------

_DECL = re.compile(r'extern\s+"C"\s+int\s+(rt_\w+)\s*\(([^)]*)\)', re.S)
_STREAM = re.compile(r"^(void\s*\*|cudaStream_t)\s*stream$")


def _ctype(param: str):
    """The ctypes type that carries a C parameter declared as ``param``."""
    decl = " ".join(param.split())
    if "*" in decl or decl.startswith("cudaStream_t"):
        return _build._P
    kind = decl.rsplit(" ", 1)[0]
    return {"int64_t": _build._I64, "int": _build._I, "float": _build._F}[kind]


def _launchers() -> dict:
    """name -> parameter declarations of every ``extern "C"`` function in
    ``csrc/*.cu`` that takes a stream last (a launcher)."""
    found = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name, params in _DECL.findall(path.read_text()):
            params = [" ".join(p.split()) for p in params.split(",")]
            if _STREAM.match(params[-1]):
                assert name not in found, f"{name} declared twice"
                found[name] = params
    return found


def test_every_launcher_has_a_signature():
    assert sorted(_launchers()) == sorted(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_source(name):
    params = _launchers()[name]
    argtypes = _build._SIGNATURES[name]
    assert len(params) == len(argtypes) + 1, (params, argtypes)   # + the stream
    assert [_ctype(p) for p in params[:-1]] == argtypes, params


def test_workspace_layout_matches_source():
    src = (CSRC / "delta.cu").read_text()
    assert f"kTileBytes = {dmod.TILE_BYTES};" in src
    assert f"kHeaderWords = {dmod.HEADER_WORDS};" in src


# ---------------------------------------------------------------------------
# the undelta workspace's sizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
def test_tiles_at_boundaries(itemsize):
    per = dmod.TILE_BYTES // itemsize
    assert dmod.tiles(0, itemsize) == 1                 # a tail alone: one block
    assert dmod.tiles(1, itemsize) == 1
    assert dmod.tiles(per - 1, itemsize) == 1
    assert dmod.tiles(per, itemsize) == 1
    assert dmod.tiles(per + 1, itemsize) == 2
    n = 100_000_000 // itemsize                         # a 100 MB basket
    assert dmod.tiles(n, itemsize) == -(-100_000_000 // dmod.TILE_BYTES) == 3052


def test_capacity_grows_in_powers_of_two():
    assert dmod.capacity(1) == dmod.MIN_CAPACITY == 64
    assert dmod.capacity(64) == 64
    assert dmod.capacity(65) == 128
    assert dmod.capacity(3052) == 4096
    for need in range(1, 5000, 7):
        cap = dmod.capacity(need)
        assert cap >= need and cap & (cap - 1) == 0
        assert cap == dmod.MIN_CAPACITY or cap < 2 * need
    assert dmod.workspace_words(64) == dmod.HEADER_WORDS + 3 * 64


# ---------------------------------------------------------------------------
# the launch path's bookkeeping, with a stand-in launcher
# ---------------------------------------------------------------------------

class _FakeLib:
    @staticmethod
    def rt_error_string(code):
        return b"fake error"


@pytest.fixture
def fake_launcher(monkeypatch):
    seen = []

    def launcher(*args):
        seen.append(args)
        return args[0]                       # the first argument is the code

    monkeypatch.setitem(_build._fns, "rt_fake", launcher)
    monkeypatch.setattr(_build, "_lib", _FakeLib)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(_build, "_current_device", lambda: 0)
    return seen


def test_call_passes_the_current_stream_and_counts(fake_launcher):
    def wrapper():
        pass
    wrapper.launches = 0
    _build.call(wrapper, "rt_fake", 0, 0, 7)
    _build.call(wrapper, "rt_fake", 0, 0, 8, stream=55)
    _build.call(wrapper, "rt_fake", 0, 0, 9, counted=False)
    assert fake_launcher == [(0, 7, 1000), (0, 8, 55), (0, 9, 1000)]
    assert wrapper.launches == 2
    with pytest.raises(RuntimeError, match="rt_fake failed: fake error"):
        _build.call(wrapper, "rt_fake", 0, 3)
    assert wrapper.launches == 2             # a failed launch is not counted


def test_counts_are_exact_across_threads(fake_launcher):
    """Counts stay exact with more launching threads than cores and a short
    switch interval (the counters take a lock of their own: CPython 3.12
    happens not to switch inside ``+= 1`` on an attribute, a build without
    the interpreter lock would)."""
    def wrapper():
        pass
    wrapper.launches = 0

    def run():
        for _ in range(2000):
            _build.call(wrapper, "rt_fake", 0, 0)

    threads = [threading.Thread(target=run) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 32000


# ---------------------------------------------------------------------------
# no fallback: a tensor on neither the CPU nor a GPU is refused
# ---------------------------------------------------------------------------

def test_undelta_refuses_meta_tensors():
    with pytest.raises(ValueError, match="unsupported device meta"):
        dmod.undelta(torch.zeros(64, dtype=torch.uint8, device="meta"), 8)
    with pytest.raises(ValueError, match="unsupported device meta"):
        dmod.undelta(torch.zeros(64, dtype=torch.uint8), 8,
                     out=torch.empty(64, dtype=torch.uint8, device="meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qpack_refuses_meta_tensors(dtype):
    """A meta tensor passes every check of qpack's fast path but the device."""
    with pytest.raises(ValueError, match="unsupported device meta"):
        qpack(torch.zeros(4, 16, dtype=dtype, device="meta"))
    with pytest.raises(ValueError, match="unsupported device meta"):
        qpack(torch.zeros(4, 16, dtype=dtype, device="meta"), zero_scale=1.0)


@pytest.mark.parametrize("where", ["both", "q", "scale"])
def test_qunpack_refuses_meta_tensors(where):
    q = torch.zeros(2, 4, 16, dtype=torch.int8)
    s = torch.ones(2, 4, 1)
    if where in ("both", "q"):
        q = q.to("meta")
    if where in ("both", "scale"):
        s = s.to("meta")
    with pytest.raises(ValueError, match="device"):
        qunpack(q, s)


# ---------------------------------------------------------------------------
# ref.undelta against the Pallas kernel and the host preconditioner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [1, 2, 4])   # jax has no uint64 without x64
@pytest.mark.parametrize("n", [1, 1000, 4096, 8192])
def test_ref_undelta_matches_pallas_block(itemsize, n, rng):
    d = rng.integers(0, np.iinfo(_UINT[itemsize]).max, n, dtype=_UINT[itemsize],
                     endpoint=True)
    want = np.asarray(pdl.undelta_block(jnp.asarray(d), block_n=n, interpret=True))
    got = ref.undelta(torch.from_numpy(d.view(np.uint8).copy()), itemsize)
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
def test_ref_undelta_matches_host_across_tiles(itemsize, rng):
    """Baskets of the sizes the scan's tiling turns on (one tile, one tile
    plus and minus an element, a few tiles), with tails."""
    tile = dmod.TILE_BYTES
    for nbytes in (0, itemsize - 1, tile - itemsize, tile, tile + itemsize,
                   3 * tile + itemsize - 1):
        raw = rng.integers(0, 256, nbytes, dtype=np.uint8)
        got = ref.undelta(torch.from_numpy(raw.copy()), itemsize)
        assert got.numpy().tobytes() == hostp.delta_decode(raw, itemsize), nbytes


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
def test_ref_undelta_wraps_with_large_values(itemsize):
    top = np.iinfo(_UINT[itemsize]).max
    d = np.full(5000, top - 3, dtype=_UINT[itemsize])
    raw = d.view(np.uint8).tobytes() + b"\x05" * (itemsize - 1)
    got = ref.undelta(torch.frombuffer(bytearray(raw), dtype=torch.uint8), itemsize)
    assert got.numpy().tobytes() == hostp.delta_decode(raw, itemsize)
    want = (np.arange(1, 5001, dtype=np.uint64) * np.uint64(top - 3)).astype(
        _UINT[itemsize])
    assert got.numpy()[:5000 * itemsize].view(_UINT[itemsize]).tolist() == want.tolist()


# ---------------------------------------------------------------------------
# ref.qunpack against the Pallas kernel (k = 1) and the compressed
# reduction's payloads (k = 3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 2048), (7, 33), (256, 48)])
def test_ref_qunpack_matches_pallas(shape, out, rng):
    q = rng.integers(-127, 128, shape, dtype=np.int8)
    s = (rng.random((shape[0], 1)) * 0.05).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[out]
    want = np.asarray(pqp.qunpack(jnp.asarray(q), jnp.asarray(s), jdt,
                                  interpret=True).astype(jnp.float32))
    got = ref.qunpack(torch.from_numpy(q), torch.from_numpy(s), tdt)
    assert got.dtype == tdt
    assert got.float().numpy().tobytes() == want.tobytes()       # bit-equal


@pytest.mark.parametrize("shape", [(4, 2048), (5, 33)])
def test_ref_qunpack_sums_quantize_rows_payloads(shape, rng):
    """Three ranks' partials quantized by the reference's ``_quantize_rows``
    and summed as its compressed reduction does (an einsum over k).  The
    einsum may sum in another order or fuse a product, so the bound is four
    float32 ulps of the sum of the terms' magnitudes."""
    parts = rng.standard_normal((3, *shape)).astype(np.float32) * 4
    parts[1, 0] = 0.0                                    # a zero row: scale 1.0
    jq, js = jax.jit(jcomp._quantize_rows)(jnp.asarray(parts))
    want = np.asarray(jnp.einsum("krd,kru->rd", jq.astype(jnp.float32), js))
    q, s = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js))
    got = ref.qunpack(q, s, torch.float32).numpy()
    terms = np.abs(np.asarray(jq, np.float32) * np.asarray(js)).sum(0)
    assert np.all(np.abs(got - want) <= 4 * np.finfo(np.float32).eps * terms)
    assert qunpack(q, s, torch.float32).numpy().tobytes() == got.tobytes()
