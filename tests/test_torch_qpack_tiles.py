"""The qpack kernel's launch geometry, on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/qpack.cu``) runs only on
the card (``chip_smoke.py``).  Its constants and its launcher's rules are
read from the source here and modelled in Python: a block a row of up to
``kRowThreads`` threads (``qpack_geometry``; one row a block, so no
few-rows threshold: a warp a row measured no faster), each thread's group
of 16 elements, the chunks of a row longer than a block's groups (the
long-row threshold, 4096 elements; read again from L2 but for the last),
and the access widths picked from C and the pointers (``store_width``, the
16-byte loads, the wide instantiation).  Over R x C x dtype the model shows
every element read and written exactly once, every vector access aligned
to its width and inside its row, and every launch within CUDA's limits."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import qpack as qmod  # noqa: E402

SOURCE = (Path(qmod.__file__).resolve().parent / "csrc" / "qpack.cu").read_text()
SMS = 132                      # an H100 SXM's streaming multiprocessors
SMEM_PER_BLOCK = 232_448       # the most shared memory a block may have (227 KB)
ITEMSIZES = {"f32": 4, "bf16": 2}


def _constant(name: str) -> int:
    m = re.search(r"constexpr int(?:64_t)? " + name + r" = ([0-9a-fx* ]+);", SOURCE)
    assert m, f"csrc/qpack.cu no longer declares {name}"
    value = 1
    for factor in m.group(1).split("*"):
        value *= int(factor.strip(), 0)
    return value


GROUP = _constant("kGroup")
ROW_THREADS = _constant("kRowThreads")
MAX_BLOCKS = _constant("kMaxBlocks")


def _body(signature: str) -> str:
    m = re.search(re.escape(signature) + r".*?\n\}", SOURCE, re.S)
    assert m, f"csrc/qpack.cu no longer defines {signature}"
    return m.group(0)


# ---------------------------------------------------------------------------
# the model: the launcher's rules, written out
# ---------------------------------------------------------------------------

def geometry(rows: int, cols: int) -> tuple[int, int, int]:
    """``qpack_geometry``: (blocks, threads a block, chunks a row)."""
    groups = -(-cols // GROUP)
    threads = min(-(-groups // 32) * 32, ROW_THREADS)
    return min(rows, MAX_BLOCKS), threads, -(-groups // threads)


def store_width(cols: int, qptr: int) -> int:
    if cols % 16 == 0 and qptr % 16 == 0:
        return 16
    if cols % 4 == 0 and qptr % 4 == 0:
        return 4
    return 1


def vector_loads(cols: int, xptr: int, itemsize: int) -> bool:
    return cols % (16 // itemsize) == 0 and xptr % 16 == 0


def row_elements(cols: int, threads: int) -> np.ndarray:
    """(chunks, threads, GROUP) column of each value a thread holds, -1 past
    the row: in chunk c, thread t holds the chunk's group t."""
    chunks = -(-cols // (threads * GROUP))
    c = np.arange(chunks)[:, None, None]
    t = np.arange(threads)[None, :, None]
    i = np.arange(GROUP)[None, None, :]
    col = (c * threads + t) * GROUP + i
    return np.where(col < cols, col, -1)


def block_rows(rows: int, blocks: int) -> np.ndarray:
    """Every row each block takes, stepping by the grid."""
    return np.concatenate([np.arange(b, rows, blocks) for b in range(min(blocks, rows))]
                          or [np.zeros(0, np.int64)])


ROWS = [0, 1, 4, 255, 256, 257, 32768]
COLS = [1, 7, 15, 16, 17, 2047, 2048, 7168, 65536]


# ---------------------------------------------------------------------------
# the model is the source's
# ---------------------------------------------------------------------------

def test_source_constants():
    assert (GROUP, ROW_THREADS, MAX_BLOCKS) == (16, 256, 2 ** 31 - 1)
    assert "__shared__ unsigned red[kRowThreads / 32];" in SOURCE
    assert "__launch_bounds__(kRowThreads)" in SOURCE
    # one geometry: no warp a row, no staging in shared memory
    assert "kFewRows" not in SOURCE and "extern __shared__" not in SOURCE


def test_geometry_is_the_sources():
    body = _body("QpackGeometry qpack_geometry(int64_t rows, int64_t cols) {")
    for line in ("const int64_t groups = (cols + kGroup - 1) / kGroup;",
                 "static_cast<int>(std::min<int64_t>((groups + 31) / 32 * 32, kRowThreads));",
                 "return {std::min(rows, kMaxBlocks), threads, (groups + threads - 1) / threads};"):
        assert line in body, line
    width = _body("int store_width(int64_t cols, const void* q) {")
    assert "if (cols % 16 == 0 && aligned(q, 16)) return 16;" in width
    assert "if (cols % 4 == 0 && aligned(q, 4)) return 4;" in width
    assert "return 1;" in width
    launch = _body("int launch_qpack(const void* x, void* q, void* scale, int64_t rows,")
    assert ("const QpackAccess io{g.chunks, cols % (16 / sizeof(T)) == 0 && aligned(x, 16),"
            in launch)
    assert "const bool wide = io.vector_loads && io.store_width == 16;" in launch
    assert launch.count("<<<grid, g.threads, 0, s>>>") == 2


def test_threads_hold_the_modelled_groups():
    """The kernel's indexing, as the model takes it."""
    assert "const int64_t chunk = int64_t{blockDim.x} * kGroup;  // elements" in SOURCE
    assert "const int64_t c0 = int64_t{threadIdx.x} * kGroup;    // in each chunk" in SOURCE
    assert "for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {" in SOURCE
    assert "const T* xr = x + row * cols + c0;" in SOURCE
    assert "int8_t* qr = q + row * cols + c0;" in SOURCE
    assert SOURCE.count("in_row(cols - c0 - c * chunk)") == 2


# ---------------------------------------------------------------------------
# every element once, every access aligned, every launch legal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("rows", ROWS)
def test_every_element_read_and_written_once(rows, cols, dtype):
    """Each row by one block; within it, each column by one thread of that
    block in the amax pass, and once more in the quantize pass, from
    registers (the last chunk) or read again (the others)."""
    itemsize = ITEMSIZES[dtype]
    if rows == 0:
        # nothing to launch: the wrapper skips the call, the launcher refuses
        x = torch.zeros((0, cols), dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
        q, s = qmod.qpack(x)
        assert q.shape == (0, cols) and q.dtype == torch.int8 and s.shape == (0, 1)
        assert "if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);" \
            in _body('extern "C" int rt_qpack(')
        assert "    if rows:\n        call(qpack, \"rt_qpack\"" in Path(qmod.__file__).read_text()
        return
    blocks, threads, chunks = geometry(rows, cols)
    owned = np.bincount(block_rows(rows, blocks), minlength=rows)
    assert (owned == 1).all()
    cols_held = row_elements(cols, threads)
    assert cols_held.shape[0] == chunks
    assert np.array_equal(np.bincount(cols_held[cols_held >= 0], minlength=cols),
                          np.ones(cols, np.int64))
    # the quantize pass reads every chunk but the last again (from L2):
    # only rows longer than a block's groups have more than one
    assert (chunks > 1) == (cols > ROW_THREADS * GROUP)
    assert (chunks - 1) * threads * GROUP < cols


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("rows", ROWS)
def test_vector_accesses_stay_aligned_and_inside_their_row(rows, cols, dtype):
    """x's rows start at r * C * itemsize and q's at r * C, past a pointer
    0, 4 or 8 bytes off a 16-byte boundary: a 16-byte load or a 16- or
    4-byte store is taken only where every row's accesses are aligned to
    their width, and none reaches past its row."""
    itemsize = ITEMSIZES[dtype]
    r = np.arange(rows, dtype=np.int64)
    starts = np.arange(-(-cols // GROUP)) * GROUP     # every group's first column
    per_load = 16 // itemsize
    for off in (0, 4, 8):
        if vector_loads(cols, off, itemsize):
            firsts = (starts[:, None] + np.arange(0, GROUP, per_load)).reshape(-1)
            firsts = firsts[firsts < cols]
            assert ((off + r * cols * itemsize) % 16 == 0).all()
            assert (firsts * itemsize % 16 == 0).all()
            assert (firsts + per_load <= cols).all()
        width = store_width(cols, off)
        if width > 1:
            firsts = (starts[:, None] + np.arange(0, GROUP, width)).reshape(-1)
            firsts = firsts[firsts < cols]
            assert ((off + r * cols) % width == 0).all()
            assert (firsts % width == 0).all() and (firsts + width <= cols).all()
    # the serve path's rows, each a 16-byte aligned tensor of its own
    if cols % 16 == 0:
        assert vector_loads(cols, 0, itemsize) and store_width(cols, 0) == 16


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("cols", COLS + [4095, 4097, 131_073, 1 << 22])
@pytest.mark.parametrize("rows", ROWS[1:] + [2 ** 40])
def test_launch_within_cudas_limits(rows, cols, dtype):
    blocks, threads, chunks = geometry(rows, cols)
    assert 1 <= blocks <= 2 ** 31 - 1 and 1 <= chunks
    assert 32 <= threads <= ROW_THREADS and threads % 32 == 0
    # a capped grid steps over the rest of the rows
    assert blocks == min(rows, MAX_BLOCKS)


def test_main_path_shapes_take_the_designed_paths():
    """The serve path's decode (4, 2048): 4 blocks of 128 threads, one group
    each; its prefill (256, 2048) and a prefill_32k sequence (32768, 2048)
    the same a row; the w_v partial's width 7168: two chunks of a 256-thread
    block; a block of one warp for short rows."""
    assert geometry(4, 2048) == (4, 128, 1)
    assert geometry(256, 2048) == (256, 128, 1)
    assert geometry(32768, 2048) == (32768, 128, 1)
    assert geometry(32768, 2049) == (32768, 160, 1)
    assert geometry(4, 512) == (4, 32, 1)
    assert geometry(4, 1) == (4, 32, 1)
    assert geometry(256, 7168) == (256, 256, 2)
    assert geometry(3, 4096) == (3, 256, 1) and geometry(3, 4097) == (3, 256, 2)
    for itemsize in ITEMSIZES.values():     # the wide instantiation
        assert vector_loads(2048, 0, itemsize) and store_width(2048, 0) == 16
