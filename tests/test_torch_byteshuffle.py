"""The byteshuffle kernels' design, on the CPU.

The CUDA kernels (``src/repro_torch/kernels/csrc/byteshuffle.cu``) run only
on the card (``chip_smoke.py``).  What they compute is modelled here in
numpy, with the constants read from the source: a warp's tile of
``kTileElems`` elements staged through the XOR-swizzled shared-memory tile,
each lane's 16 elements turned into one 16-byte vector of each plane by
``__byte_perm`` under the source's selectors (a numpy model of PTX
``prmt``), the planes cut at N.  The model is held byte for byte
(tolerance 0) against the port's plain version (``kernels/ref.py``),
against the JAX package's Pallas kernel in interpret mode, and against the
host preconditioner; the wrapper's grid rule and the launcher's choice of
access widths are checked at their edges."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precond as hostp  # noqa: E402
from repro.kernels import byteshuffle as pbys  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import byteshuffle as bmod  # noqa: E402

SOURCE = (Path(bmod.__file__).resolve().parent / "csrc" / "byteshuffle.cu").read_text()
ITEMSIZES = [1, 2, 4, 8]
SMS = 132                       # an H100 SXM's streaming multiprocessors
LM_HEAD_BASKET = 911_616        # three lm_head rows of qwen3-8b's bf16 moments


def _constant(pattern: str) -> re.Match:
    m = re.search(pattern, SOURCE, re.S)
    assert m, f"csrc/byteshuffle.cu no longer declares {pattern!r}"
    return m


LANE_ELEMS = int(_constant(r"kLaneElems = (\d+);").group(1))
TILE_ELEMS = int(_constant(r"kTileElems = (\d+) \* kLaneElems;").group(1)) * LANE_ELEMS
WIDE_WARPS = int(_constant(r"kWideWarps = (\d+);").group(1))
_WIDE = _constant(r"kWideTiles = (\d+) \* (\d+);")
WIDE_TILES = int(_WIDE.group(1)) * int(_WIDE.group(2))
SWIZZLE_SHIFT = int(_constant(r"kSwizzleShift = (\d+);").group(1))


def _selectors(name: str) -> tuple[int, int]:
    m = _constant(name + r"\[2\] = \{0x([0-9a-fA-F]+)u, 0x([0-9a-fA-F]+)u\};")
    return int(m.group(1), 16), int(m.group(2), 16)


INTERLEAVE = _selectors("kInterleave")
DEINTERLEAVE = _selectors("kDeinterleave")
HALVES = _selectors("kHalves")


# ---------------------------------------------------------------------------
# a numpy model of the kernel: __byte_perm, the lane's transpose, the tile
# ---------------------------------------------------------------------------

def prmt(x: np.ndarray, y: np.ndarray, s: int) -> np.ndarray:
    """``__byte_perm(x, y, s)`` (PTX ``prmt.b32``, default mode): byte i of
    the result is byte ``(s >> 4i) & 7`` of the eight bytes x (0-3), y (4-7)."""
    assert all((s >> (4 * i)) & 8 == 0 for i in range(4)), "sign-replicate mode"
    x, y = np.asarray(x, np.uint32), np.asarray(y, np.uint32)
    src = np.stack([(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
                   + [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)])
    out = np.zeros(np.broadcast(x, y).shape, np.uint32)
    for i in range(4):
        out |= src[(s >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _pair(sel, x, y):
    return prmt(x, y, sel[0]), prmt(x, y, sel[1])


def _transpose4(a0, a1, a2, a3):
    t0, t1 = _pair(INTERLEAVE, a0, a1)
    t2, t3 = _pair(INTERLEAVE, a2, a3)
    return _pair(HALVES, t0, t2) + _pair(HALVES, t1, t3)


def to_planes(w: np.ndarray, itemsize: int) -> np.ndarray:
    """The source's ``to_planes``: a lane's 4*I element words (last axis) ->
    its 4*I plane words, plane j's vector at ``[4j, 4j + 4)``."""
    p = np.empty_like(w)
    for q in range(4):
        if itemsize == 1:
            p[..., q] = w[..., q]
        elif itemsize == 2:
            p[..., q], p[..., 4 + q] = _pair(DEINTERLEAVE, w[..., 2 * q], w[..., 2 * q + 1])
        elif itemsize == 4:
            p[..., q::4] = np.stack(_transpose4(*(w[..., 4 * q + e] for e in range(4))), -1)
        else:
            p[..., q:16:4] = np.stack(_transpose4(*(w[..., 8 * q + 2 * e] for e in range(4))), -1)
            p[..., 16 + q::4] = np.stack(_transpose4(*(w[..., 8 * q + 2 * e + 1]
                                                       for e in range(4))), -1)
    return p


def from_planes(p: np.ndarray, itemsize: int) -> np.ndarray:
    """The source's ``from_planes``, the inverse of :func:`to_planes`."""
    w = np.empty_like(p)
    for q in range(4):
        if itemsize == 1:
            w[..., q] = p[..., q]
        elif itemsize == 2:
            w[..., 2 * q], w[..., 2 * q + 1] = _pair(INTERLEAVE, p[..., q], p[..., 4 + q])
        elif itemsize == 4:
            w[..., 4 * q:4 * q + 4] = np.stack(_transpose4(*(p[..., q + 4 * j]
                                                             for j in range(4))), -1)
        else:
            w[..., 8 * q:8 * q + 8:2] = np.stack(_transpose4(*(p[..., q + 4 * j]
                                                               for j in range(4))), -1)
            w[..., 8 * q + 1:8 * q + 8:2] = np.stack(_transpose4(*(p[..., 16 + q + 4 * j]
                                                                   for j in range(4))), -1)
    return w


def _swizzle(k: np.ndarray) -> np.ndarray:
    return k ^ ((k >> SWIZZLE_SHIFT) & 7)


def _tiles(n: int) -> int:
    return -(-n // TILE_ELEMS)


def _stage_rows(tile_bytes: np.ndarray, itemsize: int) -> np.ndarray:
    """(tiles, TILE_ELEMS * I) bytes -> (tiles, 32 lanes, 16 * I) bytes: the
    tile's chunks written to shared memory at ``swizzle(k)``, each lane's
    row read back as chunks ``swizzle(lane * I + c)``."""
    k = _swizzle(np.arange(32 * itemsize))
    chunks = tile_bytes.reshape(len(tile_bytes), 32 * itemsize, 16)
    shared = np.empty_like(chunks)
    shared[:, k] = chunks
    return shared[:, k].reshape(len(tile_bytes), 32, 16 * itemsize)


def _unstage_rows(rows: np.ndarray, itemsize: int) -> np.ndarray:
    """The inverse: lane rows written at ``swizzle(lane * I + c)``, the tile
    read back chunk by chunk at ``swizzle(k)``."""
    return _stage_rows(rows.reshape(len(rows), -1), itemsize).reshape(len(rows), -1)


def model_byteshuffle(raw: np.ndarray, itemsize: int) -> bytes:
    n, tail = divmod(raw.size, itemsize)
    tiles = _tiles(n)
    body = np.zeros(tiles * TILE_ELEMS * itemsize, np.uint8)     # zero past N
    body[:n * itemsize] = raw[:n * itemsize]
    rows = _stage_rows(body.reshape(tiles, -1), itemsize)
    p = to_planes(rows.view(np.uint32), itemsize)               # (tiles, 32, 4I)
    planes = p.reshape(tiles, 32, itemsize, 4).transpose(2, 0, 1, 3)
    planes = np.ascontiguousarray(planes).view(np.uint8).reshape(itemsize, -1)
    return planes[:, :n].tobytes() + raw[n * itemsize:].tobytes()


def model_byteunshuffle(buf: np.ndarray, itemsize: int) -> bytes:
    n, tail = divmod(buf.size, itemsize)
    tiles = _tiles(n)
    planes = np.zeros((itemsize, tiles * TILE_ELEMS), np.uint8)  # zero past N
    planes[:, :n] = buf[:n * itemsize].reshape(itemsize, n)
    p = planes.reshape(itemsize, tiles, 32, 16).transpose(1, 2, 0, 3)
    p = np.ascontiguousarray(p).view(np.uint32).reshape(tiles, 32, 4 * itemsize)
    rows = from_planes(p, itemsize).view(np.uint8)
    body = _unstage_rows(rows, itemsize).reshape(-1)
    return body[:n * itemsize].tobytes() + buf[n * itemsize:].tobytes()


def _ref_bytes(fn, raw: np.ndarray, itemsize: int) -> bytes:
    return fn(torch.from_numpy(raw.copy()), itemsize).numpy().tobytes()


# ---------------------------------------------------------------------------
# (a) __byte_perm and the selectors
# ---------------------------------------------------------------------------

def test_source_constants():
    assert (LANE_ELEMS, TILE_ELEMS) == (16, bmod.TILE_ELEMS) == (16, 512)
    assert (WIDE_WARPS, WIDE_TILES) == (bmod.WIDE_WARPS, bmod.WIDE_TILES) == (4, 2 * SMS)
    assert (INTERLEAVE, DEINTERLEAVE, HALVES) == (
        (0x5140, 0x7362), (0x6420, 0x7531), (0x5410, 0x7632))


def test_prmt_model():
    """PTX's own example values: x = 0x33221100, y = 0x77665544."""
    x, y = np.uint32(0x33221100), np.uint32(0x77665544)
    assert prmt(x, y, 0x3210) == x and prmt(x, y, 0x7654) == y
    assert prmt(x, y, 0x6420) == 0x66442200
    assert prmt(x, y, 0x0123) == 0x00112233


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_lane_transpose_is_the_byte_transpose_and_inverts(itemsize, rng):
    """A lane's 16 elements in, byte j of each element out as plane j's
    16-byte vector; from_planes undoes it."""
    elems = rng.integers(0, 256, (64, 16, itemsize), dtype=np.uint8)
    w = elems.reshape(64, 16 * itemsize).view(np.uint32)
    p = to_planes(w, itemsize)
    want = np.ascontiguousarray(elems.transpose(0, 2, 1))        # (64, I, 16)
    assert np.array_equal(p.view(np.uint8).reshape(64, itemsize, 16), want)
    assert np.array_equal(from_planes(p, itemsize), w)


# ---------------------------------------------------------------------------
# (b) the model of the kernel's tile against the plain version, the Pallas
# kernel and the host preconditioner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_swizzle_is_a_bijection_without_bank_conflicts(itemsize):
    """Both shared-memory passes, 8 lanes a phase of a 16-byte access: the
    tile copy (lane L on chunk 32i + L) and a lane's row (lane L on chunk
    L*I + c) touch 8 distinct 16-byte bank groups, so 32 banks."""
    k = np.arange(32 * itemsize)
    assert sorted(_swizzle(k)) == list(k)
    lanes = np.arange(32)
    for step in range(itemsize):
        for pass_ in (32 * step + lanes, lanes * itemsize + step):
            groups = (_swizzle(pass_) % 8).reshape(4, 8)
            assert all(len(set(g)) == 8 for g in groups), (itemsize, step, groups)


_COUNTS = [1, 15, 16, 17, 511, 512, 513, 3 * 512 - 1, 3 * 512 + 1, 77_100]
_COUNTS += [4096 + r for r in range(1, 16)]                      # N % 16 = 1 ... 15


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("n", _COUNTS)
def test_model_matches_ref_ragged(itemsize, n, rng):
    """Ragged N (a short last tile, N % 16 != 0) and a ragged tail; the
    inverse model restores the basket."""
    for tail in sorted({0, itemsize - 1}):
        raw = rng.integers(0, 256, n * itemsize + tail, dtype=np.uint8)
        planes = model_byteshuffle(raw, itemsize)
        assert planes == _ref_bytes(ref.byteshuffle, raw, itemsize)
        assert planes == hostp.shuffle(raw, itemsize)
        buf = np.frombuffer(planes, np.uint8)
        back = model_byteunshuffle(buf, itemsize)
        assert back == _ref_bytes(ref.byteunshuffle, buf, itemsize)
        assert back == hostp.unshuffle(buf, itemsize) == raw.tobytes()


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_model_at_the_main_paths_basket(itemsize, rng):
    """455 808 elements: the lm_head basket's element count."""
    raw = rng.integers(0, 256, 455_808 * itemsize, dtype=np.uint8)
    planes = model_byteshuffle(raw, itemsize)
    assert planes == _ref_bytes(ref.byteshuffle, raw, itemsize)
    assert model_byteunshuffle(np.frombuffer(planes, np.uint8), itemsize) == raw.tobytes()


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_model_matches_pallas(itemsize, rng):
    """Two tiles and a short one, as one Pallas block."""
    mat = rng.integers(0, 256, (2 * TILE_ELEMS + 40, itemsize), dtype=np.uint8)
    want = np.asarray(pbys.byteshuffle(jnp.asarray(mat), interpret=True))
    assert model_byteshuffle(mat.reshape(-1), itemsize) == want.tobytes()
    back = np.asarray(pbys.byteunshuffle(jnp.asarray(want), interpret=True))
    assert model_byteunshuffle(want.reshape(-1), itemsize) == back.tobytes() == mat.tobytes()


# ---------------------------------------------------------------------------
# (c) the grid rule at the edges, and the launcher's copy of it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 511, 512, 513, 77_100, 455_808,
                               WIDE_TILES * 512 - 1, WIDE_TILES * 512, 4 * 512 * 1001 + 1])
def test_grid_covers_every_tile_once(n, itemsize):
    blocks, warps, shared = bmod.grid(n, itemsize)
    tiles = _tiles(n)
    assert warps == (WIDE_WARPS if tiles >= WIDE_TILES else 1)
    assert blocks == max(1, -(-tiles // warps))               # a tail alone: one block
    assert blocks * warps - tiles < warps or tiles == 0       # no block without a tile
    assert shared == warps * 32 * itemsize * 16               # 32 * I chunks a warp
    owned = np.zeros(max(n, 1), np.int64)
    for t in range(blocks * warps):                            # warp w of block b: b*warps + w
        owned[t * TILE_ELEMS:min((t + 1) * TILE_ELEMS, n)] += 1
    assert (owned[:n] == 1).all()


def test_grid_fills_the_card_at_the_main_paths_baskets():
    """The lm_head basket of bf16 moments: 891 tiles, 223 blocks of four
    warps, at least one an SM; the event tree's 1 MiB baskets of 8-byte
    elements: 256 tiles, one warp a block; a 100.66 MB basket: four warps a
    block."""
    assert bmod.grid(LM_HEAD_BASKET // 2, 2)[:2] == (223, WIDE_WARPS)
    assert bmod.grid(LM_HEAD_BASKET // 2, 2)[0] >= SMS
    assert [bmod.grid((1 << 20) // i, i)[:2] for i in (2, 4, 8)] == [
        (256, 4), (128, 4), (256, 1)]
    assert bmod.grid(4096 * 12288, 2)[:2] == (24576, WIDE_WARPS)


def test_launcher_uses_the_grid_rule():
    launch = _constant(r"int launch\(Kernel k.*?\n\}").group(0)
    assert "const int64_t tiles = (n + kTileElems - 1) / kTileElems;" in launch
    assert "const int warps = tiles >= kWideTiles ? kWideWarps : 1;" in launch
    assert "const int64_t blocks = (tiles + warps - 1) / warps;" in launch
    assert "blocks > 0 ? blocks : 1), 32 * warps," in launch
    # shared memory: each warp's tile, 32 * I chunks of 16 bytes
    assert "32 * warps * itemsize * sizeof(uint4), s>>>" in launch
    assert "(threadIdx.x / 32) * 32 * I;" in SOURCE
    assert SOURCE.count("__launch_bounds__(32 * kWideWarps)") == 2


# ---------------------------------------------------------------------------
# (d) the narrow paths: which accesses the launcher picks, and why
# ---------------------------------------------------------------------------

def plane_width(n: int, ptr: int) -> int:
    """The launcher's ``plane_width`` (held against the source below)."""
    if n % 16 == 0 and ptr % 16 == 0:
        return 16
    if n % 4 == 0 and ptr % 4 == 0:
        return 4
    return 1


def test_plane_width_is_the_sources():
    body = _constant(r"int plane_width\(int64_t n, const void\* planes\) \{.*?\n\}").group(0)
    assert "if (n % 16 == 0 && aligned(planes, 16)) return 16;" in body
    assert "if (n % 4 == 0 && aligned(planes, 4)) return 4;" in body
    assert "return 1;" in body
    fwd = _constant(r'extern "C" int rt_byteshuffle\(.*?\n\}').group(0)
    inv = _constant(r'extern "C" int rt_byteunshuffle\(.*?\n\}').group(0)
    assert "aligned(in, 16)" in fwd and "plane_width(n, out)" in fwd
    assert "aligned(out, 16)" in inv and "plane_width(n, in)" in inv


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("n", [1, 15, 16, 17, 77_100, 455_808] + [4096 + r for r in range(16)])
def test_plane_accesses_stay_aligned_and_inside_each_plane(itemsize, n):
    """A lane's vector of plane j is bytes [e0, e0 + 16) of the plane at
    ptr + j*N, e0 a multiple of 16, stored or loaded in accesses of the
    chosen width, each only where it starts before N: every access is
    aligned to its width, and none reaches past N into the next plane."""
    for ptr in (0, 1, 2, 4, 8, 12):
        width = plane_width(n, ptr)
        for j in range(itemsize):
            assert (ptr + j * n) % width == 0, (ptr, j)
        starts = np.arange(0, _tiles(n) * TILE_ELEMS, width)  # every access's offset
        assert (starts[starts < n] + width).max() <= n, ptr


def test_main_path_baskets_take_the_wide_path():
    """Every basket the main path hands a byte shuffle (an aligned tensor's
    slice) takes 16-byte accesses on both sides; the golden's N = 77 100
    takes 4-byte ones on the planes."""
    for nbytes, itemsize in ((LM_HEAD_BASKET, 2), (4096 * 12288 * 2, 2),
                             (1 << 20, 4), (1 << 20, 8)):
        assert plane_width(nbytes // itemsize, 0) == 16
    assert plane_width(77_100, 0) == 4


# ---------------------------------------------------------------------------
# the wrapper on the CPU: the plain version, a tail alone, no launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_wrapper_tail_alone(itemsize):
    raw = torch.arange(itemsize - 1, dtype=torch.uint8)
    assert bmod.byteshuffle(raw, itemsize).tolist() == raw.tolist()
    assert bmod.byteunshuffle(raw, itemsize).tolist() == raw.tolist()
    assert bmod.grid(0, itemsize)[:2] == (1, 1)


def test_wrapper_out_and_no_launch_on_the_cpu(rng):
    ops.reset_launch_counts()
    raw = torch.from_numpy(rng.integers(0, 256, 4 * 1000 + 3, dtype=np.uint8))
    out = torch.empty_like(raw)
    assert bmod.byteshuffle(raw, 4, out=out) is out
    assert out.numpy().tobytes() == hostp.shuffle(raw.numpy(), 4)
    back = torch.empty_like(raw)
    assert bmod.byteunshuffle(out, 4, out=back) is back
    assert torch.equal(back, raw)
    assert (bmod.byteshuffle.launches, bmod.byteunshuffle.launches) == (0, 0)
    with pytest.raises(ValueError, match="out must hold"):
        bmod.byteshuffle(raw, 4, out=torch.empty(3, dtype=torch.uint8))
