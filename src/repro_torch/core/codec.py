"""Codec registry — the paper's §2 algorithm set behind one interface.

Every codec exposes the single tunable the paper describes: an integer
"compression level", 0 = disabled, 1 = fastest … 9 = best ratio.  Each codec
maps that onto its native knob:

=============  =======================================================
``zlib``       stdlib zlib (madler reference — the paper's baseline)
``lz4``        our LZ4 block format; levels 1–3 greedy fast, 4–9 HC
``zstd``       libzstd via ``zstandard``; level l -> zstd level 2l+1
               (so level 9 ~ zstd 19, the practical max)
``zstd-fast``  libzstd negative levels (-1..-9): the C-speed stand-in
               for LZ4-class operating points (see DESIGN.md §4)
``lzma``       stdlib lzma, preset = level; **no dictionary support** —
               FORMAT_XZ has no zdict-style preset-dictionary hook, so
               *compressing* with a dictionary raises ``ValueError``
               rather than silently dropping it (decompression tolerates
               one: files written before this check are plain XZ streams
               and must stay readable)
``repro-deflate``  from-scratch LZ77+Huffman with triplet/quadruplet
               hashing (CF-ZLIB's levels-1–5 mechanism, measurable)
``none``       identity (level 0 semantics for every codec)
=============  =======================================================

Dictionaries (paper §2.3): ``CompressionConfig.dictionary`` carries trained
dictionary bytes.  zstd uses them natively; zlib via ``zdict``; lz4 via
prefix priming (dictionary prepended to the window); lzma rejects them
(see the table above).  See ``repro_torch.core.dictionary`` for training.
"""

from __future__ import annotations

import dataclasses
import lzma
import zlib
from typing import Callable, Optional

from . import lz4 as _lz4
from . import precond as _precond
from . import repro_deflate as _rdef

try:
    import zstandard as _zstd
    HAVE_ZSTD = True
except ImportError:  # pragma: no cover
    HAVE_ZSTD = False

__all__ = ["Codec", "CompressionConfig", "CODECS", "get_codec", "compress",
           "decompress", "decompress_into"]


@dataclasses.dataclass(frozen=True)
class Codec:
    name: str
    compress: Callable  # (data, level, dictionary) -> bytes
    decompress: Callable  # (comp, orig_len, dictionary) -> bytes
    max_level: int = 9
    # True = the codec runs in the Python interpreter and holds the GIL, so
    # thread-level basket parallelism can't scale it; the parallel I/O
    # engine (repro_torch.io.engine) routes such codecs to a process pool instead.
    pure_python: bool = False


# ---------------------------------------------------------------------------
# zlib
# ---------------------------------------------------------------------------

def _zlib_c(data: bytes, level: int, d: Optional[bytes]) -> bytes:
    if d:
        co = zlib.compressobj(level=level, zdict=d)
        return co.compress(data) + co.flush()
    return zlib.compress(data, level)


def _zlib_d(comp: bytes, orig_len: int, d: Optional[bytes]) -> bytes:
    if d:
        do = zlib.decompressobj(zdict=d)
        return do.decompress(comp) + do.flush()
    return zlib.decompress(comp)


# ---------------------------------------------------------------------------
# lz4 (our block format); dictionary = window prefix priming
# ---------------------------------------------------------------------------

def _lz4_c(data: bytes, level: int, d: Optional[bytes]) -> bytes:
    return _lz4.compress_block(data, level, dict_prefix=d or b"")


def _lz4_d(comp: bytes, orig_len: int, d: Optional[bytes]) -> bytes:
    return _lz4.decompress_block(comp, orig_len, dict_prefix=d or b"")


# ---------------------------------------------------------------------------
# zstd (real libzstd) — positive and negative ("fast") level maps
# ---------------------------------------------------------------------------

def _zstd_c(data: bytes, level: int, d: Optional[bytes]) -> bytes:
    zl = min(2 * level + 1, 19)
    kw = {"dict_data": _zstd.ZstdCompressionDict(d)} if d else {}
    return _zstd.ZstdCompressor(level=zl, **kw).compress(data)


def _zstd_d(comp: bytes, orig_len: int, d: Optional[bytes]) -> bytes:
    kw = {"dict_data": _zstd.ZstdCompressionDict(d)} if d else {}
    return _zstd.ZstdDecompressor(**kw).decompress(comp, max_output_size=max(orig_len, 1))


def _zstd_fast_c(data: bytes, level: int, d: Optional[bytes]) -> bytes:
    kw = {"dict_data": _zstd.ZstdCompressionDict(d)} if d else {}
    return _zstd.ZstdCompressor(level=-level, **kw).compress(data)


# ---------------------------------------------------------------------------
# lzma
# ---------------------------------------------------------------------------

def _lzma_c(data: bytes, level: int, d: Optional[bytes]) -> bytes:
    if d:
        raise ValueError(
            "lzma codec does not support trained dictionaries "
            "(FORMAT_XZ has no preset-dictionary mechanism); "
            "use zstd/zlib/lz4 or drop the dictionary")
    return lzma.compress(data, format=lzma.FORMAT_XZ, preset=level)


def _lzma_d(comp: bytes, orig_len: int, d: Optional[bytes]) -> bytes:
    # decompress tolerates a configured dictionary: files written before
    # compression started rejecting it are plain XZ streams (the dict was
    # never used) and must stay readable
    return lzma.decompress(comp, format=lzma.FORMAT_XZ)


# ---------------------------------------------------------------------------
# repro-deflate / repro-zstd — our from-scratch LZ77+Huffman engine.
# repro-deflate: 32 KB window (zlib-like), CF quadruplet hashing.
# repro-deflate-ref: same but reference-zlib triplet hashing (the paper's
#     CF-vs-ref ablation, exposed as a codec so it flows through benchmarks).
# repro-zstd: 256 KB window (the ZSTD window mechanism, §2.3).
# ---------------------------------------------------------------------------

def _rdef_c(data: bytes, level: int, d: Optional[bytes]) -> bytes:
    return _rdef.compress(data, level=level, mode="cf", window_log=15, dictionary=d)


def _rdef_ref_c(data: bytes, level: int, d: Optional[bytes]) -> bytes:
    return _rdef.compress(data, level=level, mode="ref", window_log=15, dictionary=d)


def _rzstd_c(data: bytes, level: int, d: Optional[bytes]) -> bytes:
    return _rdef.compress(data, level=level, mode="cf", window_log=18, dictionary=d)


def _rdef_d(comp: bytes, orig_len: int, d: Optional[bytes]) -> bytes:
    return _rdef.decompress(comp, orig_len, dictionary=d)


# ---------------------------------------------------------------------------
# identity
# ---------------------------------------------------------------------------

def _id_c(data: bytes, level: int, d: Optional[bytes]) -> bytes:
    return data


def _id_d(comp: bytes, orig_len: int, d: Optional[bytes]) -> bytes:
    return comp


CODECS: dict[str, Codec] = {
    "none": Codec("none", _id_c, _id_d, max_level=0),
    "zlib": Codec("zlib", _zlib_c, _zlib_d),
    "lz4": Codec("lz4", _lz4_c, _lz4_d, pure_python=True),
    "lzma": Codec("lzma", _lzma_c, _lzma_d),
    "repro-deflate": Codec("repro-deflate", _rdef_c, _rdef_d, pure_python=True),
    "repro-deflate-ref": Codec("repro-deflate-ref", _rdef_ref_c, _rdef_d,
                               pure_python=True),
    "repro-zstd": Codec("repro-zstd", _rzstd_c, _rdef_d, pure_python=True),
}
if HAVE_ZSTD:
    CODECS["zstd"] = Codec("zstd", _zstd_c, _zstd_d)
    CODECS["zstd-fast"] = Codec("zstd-fast", _zstd_fast_c, _zstd_d)
else:
    # offline fallback: the mechanism-faithful large-window engine stands in
    # for libzstd (DESIGN.md §4); "zstd-fast" maps to low-level large-window.
    CODECS["zstd"] = Codec("zstd", _rzstd_c, _rdef_d, pure_python=True)
    CODECS["zstd-fast"] = Codec("zstd-fast",
                                lambda d, l, dic: _rzstd_c(d, 1, dic), _rdef_d,
                                pure_python=True)


def is_pure_python(algo: str) -> bool:
    """True when ``algo`` can't scale across threads (holds the GIL)."""
    return algo != "none" and get_codec(algo).pure_python


def register_codec(codec: Codec) -> None:
    CODECS[codec.name] = codec


def get_codec(name: str) -> Codec:
    try:
        return CODECS[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; have {sorted(CODECS)}") from None


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Per-branch compression choice — ROOT's (algo, level) plus the paper's
    proposed extensions: a preconditioner pipeline and an optional trained
    dictionary."""

    algo: str = "zstd" if HAVE_ZSTD else "zlib"
    level: int = 5
    precond: str = "none"          # e.g. "bitshuffle4", "delta4+shuffle4"
    dictionary: Optional[bytes] = None

    def __post_init__(self):
        if self.algo != "none":
            get_codec(self.algo)
        if not (0 <= self.level <= 9):
            raise ValueError(f"compression level must be 0..9, got {self.level}")

    @property
    def enabled(self) -> bool:
        return self.level > 0 and self.algo != "none"


def compress(data: bytes, cfg: CompressionConfig) -> bytes:
    """Apply preconditioner pipeline then codec.  Level 0 = passthrough
    (but preconditioning is still applied so roundtrip stays symmetric).

    ``data`` may be any buffer-protocol object (bytes, memoryview,
    contiguous ndarray) — the zero-copy chunks from ``split_array`` flow
    through here without an intermediate ``bytes`` materialization."""
    buf = _precond.apply_precond(cfg.precond, data) if cfg.precond != "none" else data
    if not cfg.enabled:
        return buf
    return get_codec(cfg.algo).compress(buf, cfg.level, cfg.dictionary)


def decompress(comp: bytes, orig_len: int, cfg: CompressionConfig,
               stored_len: Optional[int] = None) -> bytes:
    """Invert :func:`compress`.

    ``orig_len`` is the pre-preconditioner length; ``stored_len`` the
    post-preconditioner (= codec input) length.  They differ only for
    bitshuffle with an element count not divisible by 8 (packbits padding).
    """
    if stored_len is None:
        stored_len = orig_len
    buf = comp if not cfg.enabled else get_codec(cfg.algo).decompress(comp, stored_len, cfg.dictionary)
    if cfg.precond != "none":
        buf = _precond.undo_precond(cfg.precond, buf, orig_len)
    return buf


def decompress_into(comp: bytes, orig_len: int, cfg: CompressionConfig, out,
                    stored_len: Optional[int] = None) -> int:
    """Invert :func:`compress` directly into ``out`` (writable buffer).

    The codec stage still produces an intermediate (none of the entropy
    backends expose a decode-into hook), but the preconditioner inverse —
    or, for ``precond="none"``, the single payload copy — lands in the
    caller's destination, so ``read_branch`` can scatter every basket into
    one preallocated array with no per-basket ``bytes`` and no final
    concatenation.  Returns the number of bytes written."""
    if stored_len is None:
        stored_len = orig_len
    buf = comp if not cfg.enabled else get_codec(cfg.algo).decompress(comp, stored_len, cfg.dictionary)
    return _precond.undo_precond_into(cfg.precond, buf, out, orig_len)
