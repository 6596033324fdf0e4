"""Preconditioners: deterministic, invertible byte-stream transforms.

These reproduce the paper's §2.2 mechanism (Blosc-inspired Shuffle and
BitShuffle) plus Delta/Zigzag for offset arrays.  The paper's example:

    ROOT serializes a var-size branch as (payload, offset array).  The
    offset array is a near-arithmetic sequence of big-endian integers;
    byte-oriented LZ4 cannot compress it.  A stride-``itemsize`` byte
    transpose groups the (almost always equal) high bytes together,
    producing long runs LZ4 eats for breakfast.

All host-path transforms are pure numpy and exactly invertible:
``inverse(forward(x)) == x`` for every byte string whose length is a
multiple of ``itemsize`` (remainder bytes are passed through untouched,
matching Blosc semantics).

The device path (Pallas TPU kernels) lives in ``repro_torch.kernels``; this module
is the reference implementation those kernels are tested against.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "shuffle",
    "unshuffle",
    "bitshuffle",
    "bitunshuffle",
    "delta_encode",
    "delta_decode",
    "zigzag_encode",
    "zigzag_decode",
    "PRECONDITIONERS",
    "apply_precond",
    "undo_precond",
    "undo_precond_into",
]


def _as_bytes(buf) -> np.ndarray:
    """View any buffer-protocol object as a flat uint8 array (zero-copy)."""
    a = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    if a.dtype != np.uint8:
        a = a.view(np.uint8)
    return a.reshape(-1)


def _as_out(out) -> np.ndarray:
    """View a writable buffer-protocol object as a flat uint8 array."""
    if isinstance(out, np.ndarray):
        if not out.flags.c_contiguous:
            # reshape(-1) on a strided view would COPY and orphan the write
            raise ValueError("output array must be C-contiguous")
        a = out if out.dtype == np.uint8 else out.view(np.uint8)
        a = a.reshape(-1)
    else:
        mv = memoryview(out)
        if mv.readonly:
            raise ValueError("output buffer is read-only")
        a = np.frombuffer(mv, dtype=np.uint8)
    if not a.flags.writeable:
        raise ValueError("output buffer is read-only")
    return a


# ---------------------------------------------------------------------------
# Shuffle (byte transpose) — Blosc "shuffle"
# ---------------------------------------------------------------------------

def shuffle(buf, itemsize: int = 4) -> bytes:
    """Byte-transpose: [e0b0 e0b1 .. e1b0 e1b1 ..] -> [e0b0 e1b0 .. e0b1 e1b1 ..].

    The paper's example (stride 4, big-endian ints 1 and 2):
    ``00 00 00 01 00 00 00 02`` -> ``00 00 00 00 00 00 01 02``.
    """
    a = _as_bytes(buf)
    n = a.size - (a.size % itemsize)
    body, tail = a[:n], a[n:]
    out = body.reshape(-1, itemsize).T.reshape(-1)
    return out.tobytes() + tail.tobytes()


def unshuffle(buf, itemsize: int = 4) -> bytes:
    a = _as_bytes(buf)
    n = a.size - (a.size % itemsize)
    body, tail = a[:n], a[n:]
    out = body.reshape(itemsize, -1).T.reshape(-1)
    return out.tobytes() + tail.tobytes()


# ---------------------------------------------------------------------------
# BitShuffle (bit transpose) — Blosc "bitshuffle"
# ---------------------------------------------------------------------------

def bitshuffle(buf, itemsize: int = 4) -> bytes:
    """Bit-transpose within each block of ``itemsize`` elements' bits.

    Treats the input as N elements of ``itemsize`` bytes; emits, for each bit
    position 0..8*itemsize-1, the stream of that bit across all elements,
    packed 8 bits/byte.  Tail bytes (len % itemsize) pass through.
    """
    a = _as_bytes(buf)
    n = a.size - (a.size % itemsize)
    body, tail = a[:n], a[n:]
    if n == 0:
        return tail.tobytes()
    elems = body.reshape(-1, itemsize)                       # (N, itemsize)
    bits = np.unpackbits(elems, axis=1, bitorder="little")   # (N, 8*itemsize)
    bits_t = bits.T                                          # (8*itemsize, N)
    out = np.packbits(bits_t, axis=1, bitorder="little")     # (8*itemsize, ceil(N/8))
    return out.tobytes() + tail.tobytes()


def bitunshuffle(buf, itemsize: int = 4, nbytes: int | None = None) -> bytes:
    """Invert :func:`bitshuffle`.

    ``nbytes`` is the ORIGINAL body length (pre-shuffle, excluding tail); if
    None it is inferred assuming N was a multiple of 8 (exact when the
    original element count was a multiple of 8 — the basket layer always
    records nbytes explicitly, so the None path is only a convenience).
    """
    a = _as_bytes(buf)
    nbits = 8 * itemsize
    if nbytes is None:
        # total = nbits * ceil(N/8) + tail; assume tail < itemsize
        per_bit = a.size // nbits if a.size % nbits == 0 else None
        if per_bit is None:
            # find split honouring tail < itemsize
            for t in range(itemsize):
                if (a.size - t) % nbits == 0:
                    per_bit = (a.size - t) // nbits
                    break
            else:  # pragma: no cover - malformed input
                raise ValueError("cannot infer bitshuffle layout; pass nbytes")
            nbytes = per_bit * nbits - 0  # may overestimate N padding
        n_elems = per_bit * 8
        nbytes = n_elems * itemsize
    n_elems = nbytes // itemsize
    per_bit = (n_elems + 7) // 8
    body_len = nbits * per_bit
    body, tail = a[:body_len], a[body_len:]
    rows = body.reshape(nbits, per_bit)
    bits_t = np.unpackbits(rows, axis=1, bitorder="little")[:, :n_elems]  # (nbits, N)
    bits = bits_t.T                                                       # (N, nbits)
    elems = np.packbits(bits, axis=1, bitorder="little")                  # (N, itemsize)
    return elems.reshape(-1).tobytes() + tail.tobytes()


# ---------------------------------------------------------------------------
# Delta / Zigzag — for offset-array-like integer branches
# ---------------------------------------------------------------------------

def delta_encode(buf, itemsize: int = 4) -> bytes:
    """Element-wise delta over little-endian unsigned ints of ``itemsize``.

    Offset arrays (1,2,3,4,...) become (1,1,1,1,...): maximally compressible
    by any LZ77 codec.  Wraparound arithmetic makes this exactly invertible.
    """
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[itemsize]
    a = _as_bytes(buf)
    n = a.size - (a.size % itemsize)
    body, tail = a[:n], a[n:]
    v = body.view(dtype).copy()
    v[1:] = (v[1:] - v[:-1]).astype(dtype)
    return v.tobytes() + tail.tobytes()


def delta_decode(buf, itemsize: int = 4) -> bytes:
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[itemsize]
    a = _as_bytes(buf)
    n = a.size - (a.size % itemsize)
    body, tail = a[:n], a[n:]
    v = body.view(dtype)
    with np.errstate(over="ignore"):
        out = np.cumsum(v.astype(dtype), dtype=dtype)
    return out.tobytes() + tail.tobytes()


def zigzag_encode(buf, itemsize: int = 4) -> bytes:
    """Map signed -> unsigned so small-magnitude values have small encodings."""
    sdt = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[itemsize]
    udt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[itemsize]
    a = _as_bytes(buf)
    n = a.size - (a.size % itemsize)
    body, tail = a[:n], a[n:]
    v = body.view(sdt).astype(np.int64)
    enc = ((v << 1) ^ (v >> 63)).astype(udt)
    return enc.tobytes() + tail.tobytes()


def zigzag_decode(buf, itemsize: int = 4) -> bytes:
    sdt = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[itemsize]
    udt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[itemsize]
    a = _as_bytes(buf)
    n = a.size - (a.size % itemsize)
    body, tail = a[:n], a[n:]
    u = body.view(udt).astype(np.uint64)
    dec = ((u >> 1) ^ (-(u & 1)).astype(np.uint64)).astype(np.int64).astype(sdt)
    return dec.tobytes() + tail.tobytes()


# ---------------------------------------------------------------------------
# In-place inverses — the zero-copy decode path.  Each ``*_into`` writes the
# decoded bytes directly into a caller-provided buffer (the destination
# array slice in ``read_branch``), replacing the tobytes()+join copies of
# the byte-returning inverses above.  Semantics are identical:
# ``inv_into(fwd(x), itemsize, out) => out[:len(x)] == x``.
# ---------------------------------------------------------------------------

def _copy_into(buf, itemsize, out, nbytes=None) -> int:
    a = _as_bytes(buf)
    o = _as_out(out)
    o[:a.size] = a
    return a.size


def unshuffle_into(buf, itemsize: int, out, nbytes=None) -> int:
    a = _as_bytes(buf)
    o = _as_out(out)
    n = a.size - (a.size % itemsize)
    # direct scatter: the transpose assignment writes straight into ``out``
    o[:n].reshape(-1, itemsize)[...] = a[:n].reshape(itemsize, -1).T
    o[n:a.size] = a[n:]
    return a.size


def bitunshuffle_into(buf, itemsize: int, out, nbytes=None) -> int:
    dec = bitunshuffle(buf, itemsize, nbytes)   # packbits can't target out
    o = _as_out(out)
    o[:len(dec)] = np.frombuffer(dec, dtype=np.uint8)
    return len(dec)


def delta_decode_into(buf, itemsize: int, out, nbytes=None) -> int:
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[itemsize]
    a = _as_bytes(buf)
    o = _as_out(out)
    n = a.size - (a.size % itemsize)
    v = a[:n].view(dtype)
    with np.errstate(over="ignore"):
        dec = np.cumsum(v.astype(dtype), dtype=dtype)
    o[:n] = dec.view(np.uint8)
    o[n:a.size] = a[n:]
    return a.size


def zigzag_decode_into(buf, itemsize: int, out, nbytes=None) -> int:
    a = _as_bytes(buf)
    o = _as_out(out)
    n = a.size - (a.size % itemsize)
    dec = np.frombuffer(zigzag_decode(a[:n], itemsize), dtype=np.uint8)
    o[:n] = dec
    o[n:a.size] = a[n:]
    return a.size


# ---------------------------------------------------------------------------
# Registry — composable pipelines, named like "bitshuffle4", "delta4+shuffle4"
# ---------------------------------------------------------------------------

def _make_entry(fwd, inv, needs_len=False, inv_into=None):
    return {"fwd": fwd, "inv": inv, "needs_len": needs_len,
            "inv_into": inv_into or _copy_into}


PRECONDITIONERS = {
    "none": _make_entry(lambda b, i: bytes(_as_bytes(b)),
                        lambda b, i, n=None: bytes(_as_bytes(b)),
                        inv_into=_copy_into),
    "shuffle": _make_entry(shuffle, lambda b, i, n=None: unshuffle(b, i),
                           inv_into=unshuffle_into),
    "bitshuffle": _make_entry(bitshuffle, bitunshuffle, needs_len=True,
                              inv_into=bitunshuffle_into),
    "delta": _make_entry(delta_encode, lambda b, i, n=None: delta_decode(b, i),
                         inv_into=delta_decode_into),
    "zigzag": _make_entry(zigzag_encode, lambda b, i, n=None: zigzag_decode(b, i),
                          inv_into=zigzag_decode_into),
}


def _parse(spec: str):
    """'delta4+bitshuffle8' -> [('delta',4), ('bitshuffle',8)]."""
    stages = []
    for part in spec.split("+"):
        part = part.strip()
        if not part or part == "none":
            continue
        name = part.rstrip("0123456789")
        size = part[len(name):]
        stages.append((name, int(size) if size else 4))
    return stages


def apply_precond(spec: str, buf) -> bytes:
    """Run the forward pipeline.  Accepts any buffer-protocol object and
    defers the first copy to the first stage (each stage reads its input
    through a zero-copy uint8 view); with no stages the input is only
    materialized if it isn't ``bytes`` already."""
    stages = _parse(spec)
    if not stages:
        return buf if isinstance(buf, bytes) else bytes(_as_bytes(buf))
    out = buf
    for name, itemsize in stages:
        out = PRECONDITIONERS[name]["fwd"](out, itemsize)
    return out


def _needs_n(ent: dict, itemsize: int, orig_len: int | None) -> int | None:
    if not ent["needs_len"] or orig_len is None:
        return None
    return orig_len - (orig_len % itemsize)


def undo_precond(spec: str, buf, orig_len: int | None = None) -> bytes:
    stages = _parse(spec)
    if not stages:
        return buf if isinstance(buf, bytes) else bytes(_as_bytes(buf))
    out = buf
    for name, itemsize in reversed(stages):
        ent = PRECONDITIONERS[name]
        if ent["needs_len"]:
            out = ent["inv"](out, itemsize, _needs_n(ent, itemsize, orig_len))
        else:
            out = ent["inv"](out, itemsize)
    return out


def undo_precond_into(spec: str, buf, out, orig_len: int | None = None) -> int:
    """Invert the pipeline, writing the final stage directly into ``out``
    (a writable buffer-protocol object).  Intermediate stages still
    materialize (they are different lengths for bitshuffle), but the last
    inverse — the one that used to feed ``b"".join`` — lands in place.
    Returns the number of bytes written."""
    stages = list(reversed(_parse(spec)))
    if not stages:
        return _copy_into(buf, 1, out)
    cur = buf
    for name, itemsize in stages[:-1]:
        ent = PRECONDITIONERS[name]
        if ent["needs_len"]:
            cur = ent["inv"](cur, itemsize, _needs_n(ent, itemsize, orig_len))
        else:
            cur = ent["inv"](cur, itemsize)
    name, itemsize = stages[-1]
    ent = PRECONDITIONERS[name]
    return ent["inv_into"](cur, itemsize, out, _needs_n(ent, itemsize, orig_len))
