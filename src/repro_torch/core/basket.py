"""Baskets: the unit of compression (paper Fig. 1).

A *branch* (column) is serialized into one or more *baskets*; each basket is
independently preconditioned + compressed and carries enough metadata to be
decompressed in isolation — that independence is what enables the paper's
"simultaneous read and decompression for multiple physics events"
(thread-pool parallel reads in ``repro_torch.data.reader``).

Basket metadata also carries an adler32 of the uncompressed bytes
(vectorized implementation — the CF-ZLIB checksum path), verified on read.

Zero-copy data plane: ``split_array`` yields buffer-protocol *views* of the
source array (no per-basket ``tobytes()``), ``pack_basket`` accepts any
buffer-protocol object, and ``unpack_basket_into`` decodes a basket directly
into a caller-provided destination slice — so a branch read allocates its
output array exactly once and baskets scatter into it with no per-basket
``bytes`` and no final concatenation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import codec as _codec
from .checksum import adler32_hw

__all__ = ["BasketMeta", "ChecksumError",
           "pack_basket", "unpack_basket", "unpack_basket_into",
           "pack_preconditioned", "decompress_staged",
           "split_array", "join_baskets", "byte_offsets"]


class ChecksumError(ValueError):
    """Decoded basket bytes fail their stored adler32 — corrupt payload.

    A distinct type (not a plain ValueError) so the robustness layer can
    tell *content corruption* apart from caller mistakes: a remote reader
    re-fetches the basket from another replica, a local reader raises a
    structured ``CorruptBasketError`` naming branch/index/offset."""


def byte_offsets(lens) -> tuple[list[int], int]:
    """Destination byte offset of each basket from its ``orig_len``
    (cumulative), plus the total — the scatter map every zero-copy branch
    read uses."""
    offs, pos = [], 0
    for n in lens:
        offs.append(pos)
        pos += int(n)
    return offs, pos


def _nbytes(buf) -> int:
    """Byte length of any buffer-protocol object."""
    if isinstance(buf, (bytes, bytearray)):
        return len(buf)
    return memoryview(buf).nbytes


@dataclasses.dataclass(frozen=True)
class BasketMeta:
    """Everything needed to decompress one basket in isolation."""

    algo: str
    level: int
    precond: str
    orig_len: int        # raw serialized bytes (pre-preconditioner)
    stored_len: int      # codec-input bytes (post-preconditioner)
    comp_len: int        # on-disk bytes
    checksum: int        # adler32 of raw bytes
    entry_start: int = 0  # first entry (row) covered by this basket
    entry_count: int = 0
    has_dict: bool = False

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "BasketMeta":
        return BasketMeta(**d)


def pack_basket(raw, cfg: _codec.CompressionConfig,
                entry_start: int = 0, entry_count: int = 0) -> tuple[bytes, BasketMeta]:
    """Precondition + compress one buffer; returns (payload, metadata).

    ``raw`` may be any buffer-protocol object; it is never copied up front
    (the preconditioner/codec read it through zero-copy views).  The
    returned payload is bytes-like; for the ``none``/``none`` identity
    configuration it may alias ``raw`` itself."""
    from . import precond as _precond
    staged = _precond.apply_precond(cfg.precond, raw) if cfg.precond != "none" else raw
    return pack_preconditioned(staged, cfg, _nbytes(raw), adler32_hw(raw),
                               entry_start, entry_count)


def pack_preconditioned(staged, cfg: _codec.CompressionConfig, orig_len: int,
                        checksum: int, entry_start: int = 0,
                        entry_count: int = 0) -> tuple[bytes, BasketMeta]:
    """Compress one basket whose ``cfg.precond`` stages already ran (on the
    host for :func:`pack_basket`, or on the GPU).  ``orig_len`` and
    ``checksum`` (adler32) describe the raw bytes, which this function
    never sees."""
    payload = _codec.get_codec(cfg.algo).compress(staged, cfg.level, cfg.dictionary) \
        if cfg.enabled else staged
    meta = BasketMeta(
        algo=cfg.algo if cfg.enabled else "none",
        level=cfg.level if cfg.enabled else 0,
        precond=cfg.precond,
        orig_len=int(orig_len),
        stored_len=_nbytes(staged),
        comp_len=_nbytes(payload),
        checksum=int(checksum),
        entry_start=entry_start,
        entry_count=entry_count,
        has_dict=cfg.dictionary is not None,
    )
    return payload, meta


def decompress_staged(payload, meta: BasketMeta,
                      dictionary: Optional[bytes] = None):
    """The codec stage of :func:`unpack_basket` alone: the preconditioned
    bytes (``meta.stored_len`` of them), for an inverse that runs
    elsewhere.  Verifying ``meta.checksum`` is then the caller's job."""
    cfg = _meta_cfg(meta, dictionary)
    staged = _codec.get_codec(cfg.algo).decompress(
        payload, meta.stored_len, cfg.dictionary) if cfg.enabled else payload
    if _nbytes(staged) != meta.stored_len:
        raise ValueError(f"basket decoded {_nbytes(staged)} bytes, "
                         f"expected {meta.stored_len}")
    return staged


def _meta_cfg(meta: BasketMeta, dictionary: Optional[bytes]) -> _codec.CompressionConfig:
    if meta.algo == "none":
        return _codec.CompressionConfig(algo="none", level=0, precond=meta.precond)
    return _codec.CompressionConfig(
        algo=meta.algo,
        level=meta.level,
        precond=meta.precond,
        dictionary=dictionary if meta.has_dict else None,
    )


def unpack_basket(payload: bytes, meta: BasketMeta,
                  dictionary: Optional[bytes] = None, verify: bool = True) -> bytes:
    """Invert :func:`pack_basket`; verifies the checksum unless disabled."""
    cfg = _meta_cfg(meta, dictionary)
    raw = _codec.decompress(payload, meta.orig_len, cfg, stored_len=meta.stored_len)
    if len(raw) != meta.orig_len:
        raise ValueError(f"basket decoded {len(raw)} bytes, expected {meta.orig_len}")
    if verify and adler32_hw(raw) != meta.checksum:
        raise ChecksumError("basket checksum mismatch (corrupt data)")
    return raw


def unpack_basket_into(payload, meta: BasketMeta, out,
                       dictionary: Optional[bytes] = None,
                       verify: bool = True) -> int:
    """Decompress one basket directly into ``out`` (writable buffer).

    ``out`` must be at least ``meta.orig_len`` bytes; exactly that many are
    written (a larger buffer keeps its remaining bytes untouched, so
    misaligned/oversized destination slices are fine).  The checksum is
    verified on the destination bytes.  Returns ``meta.orig_len``."""
    from . import precond as _precond
    dst = _precond._as_out(out)     # validates writability + contiguity
    if dst.size < meta.orig_len:
        raise ValueError(
            f"output buffer too small: {dst.size} < {meta.orig_len}")
    dst = dst[:meta.orig_len]
    cfg = _meta_cfg(meta, dictionary)
    n = _codec.decompress_into(payload, meta.orig_len, cfg, dst,
                               stored_len=meta.stored_len)
    if n != meta.orig_len:
        raise ValueError(f"basket decoded {n} bytes, expected {meta.orig_len}")
    if verify and adler32_hw(dst) != meta.checksum:
        raise ChecksumError("basket checksum mismatch (corrupt data)")
    return n


# ---------------------------------------------------------------------------
# Array <-> baskets
# ---------------------------------------------------------------------------

def split_array(arr: np.ndarray, target_basket_bytes: int = 1 << 20):
    """Split an array along axis 0 into basket-sized row chunks.

    Yields (entry_start, entry_count, buffer).  Row-granular so each basket
    maps to an entry range — the seekable-restart property the data
    pipeline's checkpoint cursor relies on.

    The buffers are zero-copy ``memoryview`` slices of ``arr`` (flattened
    to bytes); they stay valid while the generator is alive.  Consumers
    that outlive the iteration must ``bytes()`` them.
    """
    arr = np.ascontiguousarray(arr)
    if arr.ndim == 0:
        yield 0, 1, memoryview(arr.reshape(1)).cast("B")
        return
    n = arr.shape[0]
    row_bytes = max(1, arr.nbytes // max(n, 1))
    rows_per = max(1, target_basket_bytes // row_bytes)
    for start in range(0, max(n, 1), rows_per):
        stop = min(start + rows_per, n)
        if start >= n:
            break
        yield start, stop - start, memoryview(arr[start:stop]).cast("B")
    if n == 0:
        yield 0, 0, b""


def basket_rows(shape: tuple, itemsize: int,
                target_basket_bytes: int = 1 << 20) -> int:
    """Rows per basket for a (shape, itemsize) branch — exactly the chunk
    boundaries :func:`split_array` produces, computable without the array.
    The streamed checkpoint staging path uses this so device-sliced chunks
    land on identical basket boundaries (byte-determinism invariant)."""
    n = shape[0] if shape else 1
    total = int(itemsize) * int(np.prod(shape, dtype=np.int64)) if shape else int(itemsize)
    row_bytes = max(1, total // max(n, 1))
    return max(1, target_basket_bytes // row_bytes)


def join_baskets(chunks: list, dtype: str, shape: tuple) -> np.ndarray:
    """Assemble decoded chunks into one array with a single allocation
    (kept for API compatibility; the hot read path scatters baskets into
    the destination with :func:`unpack_basket_into` instead)."""
    out = np.empty(shape, dtype=np.dtype(dtype))
    flat = out.reshape(-1).view(np.uint8)
    pos = 0
    for c in chunks:
        b = np.frombuffer(c, dtype=np.uint8) if not isinstance(c, np.ndarray) else c
        flat[pos:pos + b.size] = b
        pos += b.size
    if pos != flat.size:
        raise ValueError(f"chunks total {pos} bytes, expected {flat.size}")
    return out
