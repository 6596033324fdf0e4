"""The bitshuffle kernels' design, on the CPU.

The CUDA kernels (``src/repro_torch/kernels/csrc/bitshuffle.cu``) run only
on the card (``chip_smoke.py``).  What they compute is modelled here in
numpy, with the constants read from the source: a warp's tile of
``kTileElems`` elements staged through the XOR-swizzled shared-memory tile,
each lane's 32 elements put through the five masked exchanges of the 32x32
bit transpose, the plane words cut at ``ceil(N/8)`` bytes.  The model is
held byte for byte (tolerance 0) against the port's plain version
(``kernels/ref.py``), against the JAX package's Pallas kernels in interpret
mode, and against the host preconditioner; the wrapper's grid rule is
checked at the tile edges."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precond as hostp  # noqa: E402
from repro.kernels import bitshuffle as pbs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import bitshuffle as bmod  # noqa: E402

SOURCE = (Path(bmod.__file__).resolve().parent / "csrc" / "bitshuffle.cu").read_text()
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
ITEMSIZES = [1, 2, 4, 8]


def _constant(pattern: str) -> re.Match:
    m = re.search(pattern, SOURCE, re.S)
    assert m, f"csrc/bitshuffle.cu no longer declares {pattern!r}"
    return m


LANE_ELEMS = int(_constant(r"kLaneElems = (\d+);").group(1))
TILE_ELEMS = int(_constant(r"kTileElems = (\d+) \* kLaneElems;").group(1)) * LANE_ELEMS
MASKS = [int(h, 16) for h in re.findall(
    r"0x([0-9A-Fa-f]{8})u", _constant(r"kMasks\[5\] = \{([^}]*)\}").group(1))]
_SHIFT = _constant(r"kSwizzleShift = I == 8 \? (\d+) : (\d+);")
SWIZZLE_SHIFT = {i: int(_SHIFT.group(1 if i == 8 else 2)) for i in ITEMSIZES}


def _chunks(itemsize: int) -> int:
    """16-byte chunks of a lane's row (``kChunks``)."""
    return LANE_ELEMS * itemsize // 16


def _swizzle(k: np.ndarray, itemsize: int) -> np.ndarray:
    return k ^ ((k >> SWIZZLE_SHIFT[itemsize]) & 7)


def _transpose(a: np.ndarray) -> np.ndarray:
    """The kernel's five rounds of masked exchanges over the last axis (32
    uint32 words): exchange distance ``16 >> r`` under ``MASKS[r]``."""
    a = a.copy()
    for r, m in enumerate(MASKS):
        j = 16 >> r
        lo_idx = [k for k in range(32) if not k & j]
        hi_idx = [k | j for k in lo_idx]
        lo, hi = a[..., lo_idx], a[..., hi_idx]
        t = ((lo >> np.uint32(j)) ^ hi) & np.uint32(m)
        a[..., lo_idx] = lo ^ (t << np.uint32(j))
        a[..., hi_idx] = hi ^ t
    return a


def _tiles(n: int) -> int:
    return -(-n // TILE_ELEMS)


def _stage_rows(tile_bytes: np.ndarray, itemsize: int) -> np.ndarray:
    """(tiles, TILE_ELEMS * I) bytes -> (tiles, 32 lanes, 32 * I) bytes: the
    chunks written to shared memory at ``swizzle(k)``, then each lane's row
    read back as chunks ``swizzle(lane * C + c)``."""
    c = _chunks(itemsize)
    chunks = tile_bytes.reshape(len(tile_bytes), 32 * c, 16)
    shared = np.empty_like(chunks)
    shared[:, _swizzle(np.arange(32 * c), itemsize)] = chunks
    rows = shared[:, _swizzle(np.arange(32 * c), itemsize)]
    return rows.reshape(len(tile_bytes), 32, LANE_ELEMS * itemsize)


def _unstage_rows(rows: np.ndarray, itemsize: int) -> np.ndarray:
    """The inverse: lane rows written at ``swizzle(lane * C + c)``, the tile
    read back chunk by chunk at ``swizzle(k)``."""
    c = _chunks(itemsize)
    chunks = rows.reshape(len(rows), 32 * c, 16)
    shared = np.empty_like(chunks)
    shared[:, _swizzle(np.arange(32 * c), itemsize)] = chunks
    return shared[:, _swizzle(np.arange(32 * c), itemsize)].reshape(len(rows), -1)


def model_bitshuffle(raw: np.ndarray, itemsize: int) -> bytes:
    n, tail = divmod(raw.size, itemsize)
    pb = (n + 7) // 8
    tiles = _tiles(n)
    body = np.zeros(tiles * TILE_ELEMS * itemsize, np.uint8)   # zero past N
    body[:n * itemsize] = raw[:n * itemsize]
    rows = _stage_rows(body.reshape(tiles, -1), itemsize)
    elems = rows.view(_UINT[itemsize]).astype(np.uint64)        # (tiles, 32, 32)
    halves = [(elems & 0xFFFFFFFF).astype(np.uint32)]
    if itemsize == 8:
        halves.append((elems >> np.uint64(32)).astype(np.uint32))
    words = np.concatenate([_transpose(h) for h in halves], -1)  # (tiles, 32, 32 or 64)
    planes = words[..., :8 * itemsize].transpose(2, 0, 1)       # (8I, tiles, lanes)
    planes = np.ascontiguousarray(planes).view(np.uint8).reshape(8 * itemsize, -1)
    return planes[:, :pb].tobytes() + raw[n * itemsize:].tobytes()


def model_bitunshuffle(buf: np.ndarray, itemsize: int, nbytes: int) -> bytes:
    n = nbytes // itemsize
    pb = (n + 7) // 8
    tiles = _tiles(n)
    planes = np.zeros((8 * itemsize, tiles * TILE_ELEMS // 8), np.uint8)  # zero past pb
    planes[:, :pb] = buf[:8 * itemsize * pb].reshape(8 * itemsize, pb)
    words = planes.view(np.uint32).reshape(8 * itemsize, tiles, 32).transpose(1, 2, 0)
    lo = np.zeros((tiles, 32, 32), np.uint32)
    lo[..., :min(32, 8 * itemsize)] = words[..., :32]
    elems = _transpose(lo).astype(np.uint64)
    if itemsize == 8:
        elems |= _transpose(np.ascontiguousarray(words[..., 32:])).astype(np.uint64) << np.uint64(32)
    rows = elems.astype(_UINT[itemsize]).view(np.uint8)
    body = _unstage_rows(rows, itemsize).reshape(-1)
    return body[:n * itemsize].tobytes() + buf[8 * itemsize * pb:].tobytes()


def _ref_bytes(fn, raw: np.ndarray, *args) -> bytes:
    return fn(torch.from_numpy(raw.copy()), *args).numpy().tobytes()


# ---------------------------------------------------------------------------
# (a) the model of the kernel's tile against the plain version, the Pallas
# kernels and the host preconditioner
# ---------------------------------------------------------------------------

def test_source_constants():
    assert (LANE_ELEMS, TILE_ELEMS) == (32, bmod.TILE_ELEMS) == (32, 1024)
    assert MASKS == [0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555]


def test_transpose_is_the_bit_transpose_and_its_own_inverse(rng):
    a = rng.integers(0, 1 << 32, (64, 32), dtype=np.uint64).astype(np.uint32)
    t = _transpose(a)
    bits = (a[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1      # [j, p]
    assert np.array_equal((t[:, None, :] >> np.arange(32, dtype=np.uint32)[:, None]) & 1,
                          bits)                                       # t[p] bit j
    assert np.array_equal(_transpose(t), a)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_swizzle_is_a_bijection_without_bank_conflicts(itemsize):
    """Both shared-memory passes, 8 lanes a phase of a 16-byte access: the
    tile copy (lane L on chunk 32i + L) and a lane's row (lane L on chunk
    L*C + c) touch 8 distinct 16-byte bank groups, so 32 banks."""
    c = _chunks(itemsize)
    k = np.arange(32 * c)
    assert sorted(_swizzle(k, itemsize)) == list(k)
    lanes = np.arange(32)
    for step in range(c):
        for pass_ in (32 * step + lanes, lanes * c + step):
            groups = (_swizzle(pass_, itemsize) % 8).reshape(4, 8)
            assert all(len(set(g)) == 8 for g in groups), (itemsize, step, groups)


_SIZES = [1, 7, 31, 33, 1023, 1024, 1025, 3 * 1024 - 1, 3 * 1024 + 1, 9637]


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("n", _SIZES)
def test_model_matches_ref_ragged(itemsize, n, rng):
    """Ragged N (a short last tile; ceil(N/8) % 4 of 1, 2, 3 and 0) and a
    ragged tail; the inverse model restores the basket."""
    for tail in sorted({0, itemsize - 1}):
        raw = rng.integers(0, 256, n * itemsize + tail, dtype=np.uint8)
        planes = model_bitshuffle(raw, itemsize)
        assert planes == _ref_bytes(ref.bitshuffle, raw, itemsize)
        assert planes == hostp.bitshuffle(raw, itemsize)
        buf = np.frombuffer(planes, np.uint8)
        back = model_bitunshuffle(buf, itemsize, n * itemsize)
        assert back == _ref_bytes(ref.bitunshuffle, buf, itemsize, n * itemsize)
        assert back == raw.tobytes()


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_model_matches_pallas(itemsize, rng):
    """N % 8 == 0, as the Pallas kernels require: two tiles and a short one."""
    mat = rng.integers(0, 256, (2 * TILE_ELEMS + 8, itemsize), dtype=np.uint8)
    raw = mat.reshape(-1)
    want = np.asarray(pbs.bitshuffle(jnp.asarray(mat), interpret=True))
    assert model_bitshuffle(raw, itemsize) == want.tobytes()
    back = np.asarray(pbs.bitunshuffle(jnp.asarray(want), itemsize, interpret=True))
    assert model_bitunshuffle(want.reshape(-1), itemsize, raw.size) == back.tobytes()


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_model_inverse_matches_ref_on_any_planes(itemsize, rng):
    """The inverse on random planes, not only on a forward's output:
    padding bits set past N are dropped alike."""
    n = 2 * TILE_ELEMS + 13
    pb = (n + 7) // 8
    buf = rng.integers(0, 256, 8 * itemsize * pb + itemsize - 1, dtype=np.uint8)
    assert (model_bitunshuffle(buf, itemsize, n * itemsize)
            == _ref_bytes(ref.bitunshuffle, buf, itemsize, n * itemsize))


# ---------------------------------------------------------------------------
# (b) the grid rule at the edges, and the launcher's copy of it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 31, 32, 1023, 1024, 1025, 77_100, 151_936,
                               262_144])
def test_grid_covers_every_tile_once(n):
    blocks = bmod.grid(n)
    tiles = _tiles(n)
    assert blocks == max(1, tiles)            # a tail alone: one block
    owned = np.zeros(max(n, 1), np.int64)
    for b in range(blocks):
        owned[b * TILE_ELEMS:min((b + 1) * TILE_ELEMS, n)] += 1
    assert (owned[:n] == 1).all()


def test_grid_fills_the_card_at_the_main_paths_baskets():
    """The lm_head row (607 744 bytes) and a 1 MiB basket of float32: at
    least 128 blocks of one warp, one an SM or two."""
    assert bmod.grid(607_744 // 4) == 149
    assert bmod.grid((1 << 20) // 4) == 256


def test_launcher_uses_the_grid_rule():
    launch = _constant(r"int launch\(Kernel k.*?\n\}").group(0)
    assert "(n + kTileElems - 1) / kTileElems" in launch
    assert "tiles > 0 ? tiles : 1), 32, 0, s>>>" in launch
    assert SOURCE.count("__launch_bounds__(32)") == 2


# ---------------------------------------------------------------------------
# the wrapper on the CPU: the plain version, and the checks it makes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_wrapper_tail_alone(itemsize):
    raw = torch.arange(itemsize - 1, dtype=torch.uint8)
    assert bmod.bitshuffle(raw, itemsize).tolist() == raw.tolist()
    assert bmod.bitunshuffle(raw, itemsize, 0).tolist() == raw.tolist()


def test_bitunshuffle_refuses_a_tail_of_an_element_or_more():
    planes = torch.zeros(8 * 4 * 2 + 4, dtype=torch.uint8)   # 16 elements, 4 left
    with pytest.raises(ValueError, match="cannot hold"):
        bmod.bitunshuffle(planes, 4, 64)
    assert bmod.bitunshuffle(planes[:-1], 4, 64).numel() == 67
