"""Two-pass vectorized executor for LZ4-framed token streams.

Both of our from-scratch LZ codecs emit the same sequence framing (LZ4's
block format; ``repro_deflate`` widens the offset to 3 bytes so large
windows fit)::

  sequence := token | [litlen ext 255*] | literals | offset
              | [matchlen ext 255*]
  token    := (literal_length:4 | match_length-4 :4)

The old decoders walked this serially, one Python iteration per sequence,
interleaving header arithmetic with byte copies.  Per-sequence Python cost
only *matters* when sequences are short and plentiful, so the entry point
:func:`decode_token_stream` probes the first few hundred sequences and
routes by density:

* **sparse / mid-density streams** (long literal runs, incompressible
  data): the single-pass serial decoder is already memcpy-bound — kept as
  :func:`_decode_serial` and used directly.
* **dense streams** (many short sequences): the two-pass vectorized path.

**Pass 1 — parse** (:func:`_parse_vector`): token fields and the per-token
step (distance to the next token) are computed *speculatively for every
byte position* in ~10 vector passes — cheap, because a dense stream has
few bytes per sequence.  The serial dependency (each header's position
depends on the previous literal length) collapses to pointer-chasing the
step table, done eight sequences per Python iteration through composed
jump tables (``step``, ``step²``, ``step⁴``, ``step⁸``) and re-expanded
vectorized.  Extension-byte runs (rare) are patched sparsely: the run of
0xFF bytes at q ends at the first non-0xFF position, found by one
``searchsorted`` against the positions of all non-0xFF bytes.

**Pass 2 — execute** (:func:`execute_sequences`): one cumulative sum
yields every output position.  Literal runs are either scattered in a
single vectorized gather (many short runs) or sliced per run (few long
runs).  Matches are the only true serial chain — a match may read bytes
produced by an earlier one — but any *contiguous run* of matches whose
sources lie entirely below the first pending match's output start can be
replayed at once: every source byte is already final and every
destination is disjoint.  Those run boundaries are exact and vectorized:
a non-overlapping match always has ``ref_end <= out_start``, so within a
segment free of overlapping matches the first conflict for frontier ``o``
is ``searchsorted(running_max(ref_end), o)``.  Each batch then executes
as two numpy calls over slices of globally precomputed gather indices.
Close-referencing streams (tiny distances, e.g. byte-plane shuffles)
degrade to a lean serial memcpy loop instead of paying batch overhead.
"""

from __future__ import annotations

import numpy as np

__all__ = ["parse_sequences", "execute_sequences", "decode_token_stream"]

_MIN_MATCH = 4
_VECTOR_MIN = 4096        # below this blob size, serial always wins
_PROBE_SEQS = 256         # sequences scanned to estimate density
_SERIAL_DENSITY = 32      # >= this many comp bytes/seq: serial decoder wins
_SCATTER_MAX_RUN = 16     # mean literal run where scatter beats memcpy
_BATCH_MIN = 16           # smallest match batch worth numpy dispatch


# ---------------------------------------------------------------------------
# serial reference decoder (sparse/mid-density route + small blobs)
# ---------------------------------------------------------------------------

def _decode_serial(comp: bytes, prefix: bytes, orig_len: int, base: int,
                   offset_bytes: int, name: str) -> bytes:
    plen = len(prefix)
    dst = bytearray(plen + orig_len)
    dst[:plen] = prefix
    i = base
    o = plen
    n = len(comp)
    while i < n:
        token = comp[i]
        i += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                b = comp[i]
                i += 1
                litlen += b
                if b != 255:
                    break
        if litlen:
            dst[o:o + litlen] = comp[i:i + litlen]
            i += litlen
            o += litlen
        if i >= n:
            break  # last sequence: literals only
        if offset_bytes == 2:
            dist = comp[i] | (comp[i + 1] << 8)
        else:
            dist = comp[i] | (comp[i + 1] << 8) | (comp[i + 2] << 16)
        i += offset_bytes
        mlen = (token & 0xF) + _MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                b = comp[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        ref = o - dist
        if dist >= mlen:  # non-overlapping: one slice copy
            dst[o:o + mlen] = dst[ref:ref + mlen]
            o += mlen
        else:             # overlapping match: replicate pattern
            while mlen > 0:
                chunk = min(mlen, o - ref)
                dst[o:o + chunk] = dst[ref:ref + chunk]
                o += chunk
                mlen -= chunk
    if o - plen != orig_len:
        raise ValueError(f"{name} decoded {o - plen} bytes, expected {orig_len}")
    return bytes(memoryview(dst)[plen:])


# ---------------------------------------------------------------------------
# pass 1: parse
# ---------------------------------------------------------------------------

def _scan_scalar(comp: bytes, base: int, offset_bytes: int,
                 max_seqs: int | None):
    """Scalar header scan (up to ``max_seqs``); returns raw scan state."""
    n = len(comp)
    tpos: list[int] = []
    ll_fix: list[tuple[int, int, int]] = []   # (seq, litlen, n ext bytes)
    ml_fix: list[tuple[int, int]] = []        # (seq, matchlen)
    last_literal_only = False
    append = tpos.append
    i = base
    while i < n:
        if max_seqs is not None and len(tpos) >= max_seqs:
            break
        append(i)
        token = comp[i]
        i += 1
        ll = token >> 4
        if ll == 15:
            nx = 0
            while True:
                b = comp[i]
                i += 1
                nx += 1
                ll += b
                if b != 255:
                    break
            ll_fix.append((len(tpos) - 1, ll, nx))
        i += ll
        if i >= n:
            last_literal_only = True
            break
        i += offset_bytes
        if token & 15 == 15:
            ml = 15 + _MIN_MATCH
            while True:
                b = comp[i]
                i += 1
                ml += b
                if b != 255:
                    break
            ml_fix.append((len(tpos) - 1, ml))
    done = last_literal_only or i >= n
    return tpos, ll_fix, ml_fix, i, done, last_literal_only


def _scalar_arrays(comp: bytes, state, offset_bytes: int):
    """Build (lit_src, lit_len, mlens, dists) from a scalar scan state."""
    tpos, ll_fix, ml_fix, i_end, _done, last_literal_only = state
    k = len(tpos)
    tp = np.asarray(tpos, dtype=np.int32)
    # all gathered indices (tp, opos+2) are bounded by the scan end, so pad
    # only that prefix instead of copying a possibly-multi-MB blob
    carr = np.frombuffer(comp[:i_end] + b"\x00" * 4, dtype=np.uint8)
    tokens = carr[tp] if k else np.zeros(0, dtype=np.uint8)
    lit_len = (tokens >> 4).astype(np.int32)
    lit_src = tp + 1
    mlens = (tokens & 15).astype(np.int32) + _MIN_MATCH
    for s, ll, nx in ll_fix:
        lit_len[s] = ll
        lit_src[s] += nx
    for s, ml in ml_fix:
        mlens[s] = ml
    opos = lit_src + lit_len
    dists = carr[opos].astype(np.int32) | (carr[opos + 1].astype(np.int32) << 8)
    if offset_bytes == 3:
        dists |= carr[opos + 2].astype(np.int32) << 16
    if last_literal_only and k:
        mlens[k - 1] = 0
        dists[k - 1] = 0
    return lit_src, lit_len, mlens, dists


class _FFRuns:
    """Run-length lookup for 0xFF bytes: how far does the 255-run starting
    at q extend?  Built once from the (few) 255 positions, so extension
    fields resolve with one small searchsorted instead of a scan."""

    def __init__(self, tu: np.ndarray):
        ff = np.flatnonzero(tu == 255)
        self.tu = tu
        self.ff = ff
        if ff.size:
            # remaining run length at each 255 position (groups of
            # consecutive positions, counted from the back of each group)
            grp = np.cumsum(np.concatenate([[0], (np.diff(ff) != 1)]))
            last = np.concatenate([np.flatnonzero(np.diff(grp)), [ff.size - 1]])
            self.rem = ff[last][grp] - ff + 1
        else:
            self.rem = ff

    def ext(self, q: np.ndarray, cap: int):
        """(n ext bytes, decoded value) for extension fields starting at q.

        Values are clipped to ``cap`` (the blob length): anything larger is
        corrupt anyway and the clip keeps later int32 arithmetic exact."""
        if self.ff.size:
            j = np.searchsorted(self.ff, q)
            hit = (j < self.ff.size) & (self.ff[np.minimum(j, self.ff.size - 1)] == q)
            run = np.where(hit, self.rem[np.minimum(j, self.ff.size - 1)], 0)
        else:
            run = np.zeros(q.size, dtype=np.int64)
        end = q + run
        return run + 1, np.minimum(run * 255 + self.tu[end], cap)


def _parse_vector(comp: bytes, base: int, offset_bytes: int):
    """Speculative parse of the dense stream at ``comp[base:]``.
    Returned positions are absolute.  See module docstring."""
    n = len(comp) - base
    pad = 8
    P = n + pad
    tu = np.empty(P, dtype=np.uint8)
    tu[:n] = np.frombuffer(comp, dtype=np.uint8, count=n, offset=base)
    tu[n:] = 0
    qmax = n  # pad bytes are 0 (non-255): every ext query resolves
    lln = tu >> 4
    mln = tu & 15
    # speculative step to the next token, assuming no extension bytes
    step = np.arange(P, dtype=np.int32)
    step += np.int32(1 + offset_bytes)
    step += lln
    mask_ll = lln == 15
    mask_ml = mln == 15
    has_ll_ext = bool(mask_ll.any())
    has_ml_ext = bool(mask_ml.any())
    ffr = None

    def _ffr():
        nonlocal ffr
        if ffr is None:
            ffr = _FFRuns(tu)
        return ffr

    if has_ll_ext:
        pl = np.flatnonzero(mask_ll)
        q = np.minimum(pl + 1, qmax)
        nxt = tu[q]
        # common case: a single extension byte (the next byte ends the run)
        step[pl] += nxt.astype(np.int32) + 1
        rare = np.flatnonzero(nxt == 255)
        if rare.size:
            qr = q[rare]
            nx, val = _ffr().ext(qr, n)
            # remove the speculative single-byte fix, apply the true run
            step[pl[rare]] += (nx + val - 256).astype(np.int32)
    if has_ml_ext:
        pm = np.flatnonzero(mask_ml)
        # step currently points at the first matchlen-ext byte
        q = np.minimum(step[pm], qmax)
        step[pm] += 1
        rare = np.flatnonzero(tu[q] == 255)
        if rare.size:
            nx, _ = _ffr().ext(q[rare], n)
            step[pm[rare]] += (nx - 1).astype(np.int32)
    np.minimum(step, np.int32(n), out=step)  # >= n: sentinel self-loop at n

    s2 = step[step]
    s4 = s2[s2]
    s8 = s4[s4]
    anchors: list[int] = []
    append = anchors.append
    view = memoryview(s8)  # scalar chase: 8 sequences per iteration
    pos = 0
    while pos < n:
        append(pos)
        pos = view[pos]
    if not anchors:
        z = np.zeros(0, dtype=np.int32)
        return z, z.copy(), z.copy(), z.copy()
    a = np.asarray(anchors, dtype=np.int32)
    g2 = s2[a]
    g4 = s4[a]
    g6 = s2[g4]
    tp = np.stack([a, step[a], g2, step[g2], g4, step[g4], g6, step[g6]],
                  axis=1).ravel()
    tp = tp[tp < n]

    # exact fields, gathered at real token positions only
    tok = tu[tp]
    lit_len = (tok >> 4).astype(np.int32)
    lit_src = tp + 1
    mlens = (tok & 15).astype(np.int32) + _MIN_MATCH
    if has_ll_ext:
        el = np.flatnonzero(lit_len == 15)
        if el.size:
            nx, val = _ffr().ext(np.minimum(tp[el] + 1, qmax), n)
            lit_len[el] = (15 + val).astype(np.int32)
            lit_src[el] += nx.astype(np.int32)
    opos = np.minimum(lit_src + lit_len, qmax)
    if has_ml_ext:
        em = np.flatnonzero(tok & 15 == 15)
        if em.size:
            # match lengths are bounded by the OUTPUT size (matches expand),
            # not the comp size — cap only against int32 overflow
            nx, val = _ffr().ext(np.minimum(opos[em] + offset_bytes, qmax),
                                 1 << 30)
            mlens[em] = (15 + _MIN_MATCH + val).astype(np.int32)
    dists = tu[opos].astype(np.int32) | (tu[opos + 1].astype(np.int32) << 8)
    if offset_bytes == 3:
        dists |= tu[opos + 2].astype(np.int32) << 16
    if int(opos[-1]) >= n:  # final sequence is literals-only
        mlens[-1] = 0
        dists[-1] = 0
    if base:
        lit_src += np.int32(base)
    return lit_src, lit_len, mlens, dists


def parse_sequences(comp: bytes, base: int = 0, offset_bytes: int = 2):
    """Parse all sequence headers of ``comp[base:]``.

    Returns ``(lit_src, lit_len, mlens, dists)`` int32 arrays, one row
    per sequence, ``mlens == 0`` marking the final literals-only one."""
    state = _scan_scalar(comp, base, offset_bytes,
                         None if len(comp) - base < _VECTOR_MIN
                         else _PROBE_SEQS)
    if state[4]:  # done
        return _scalar_arrays(comp, state, offset_bytes)
    head = _scalar_arrays(comp, state, offset_bytes)
    tail = _parse_vector(comp, state[3], offset_bytes)
    return tuple(np.concatenate([h, t]) for h, t in zip(head, tail))


# ---------------------------------------------------------------------------
# pass 2: execute
# ---------------------------------------------------------------------------

def _range_concat(starts: np.ndarray, lens: np.ndarray,
                  cs: np.ndarray) -> np.ndarray:
    """Concatenated ``arange(s, s+l)`` for every (start, len) run.

    Equivalent to ``arange(total) + repeat(starts - (cs - lens), lens)``
    but built with one boundary scatter + cumsum — np.repeat loops per run
    in C and is ~5x slower for short runs.  All lens must be > 0 (zero-
    length runs would collide boundary slots)."""
    d = np.ones(int(cs[-1]), dtype=np.int32)
    d[0] = starts[0]
    d[cs[:-1]] = starts[1:] - starts[:-1] - lens[:-1] + 1
    return np.cumsum(d, dtype=np.int32)

def _run_serial(dst: bytearray, mo: np.ndarray, ml: np.ndarray,
                refs: np.ndarray, p: int, q: int) -> None:
    """In-order slice-memcpy replay of matches p..q-1."""
    for o, m, ref in zip(mo[p:q].tolist(), ml[p:q].tolist(),
                         refs[p:q].tolist()):
        if o - ref >= m:   # non-overlapping: one slice copy
            dst[o:o + m] = dst[ref:ref + m]
        else:              # overlapping match: replicate pattern
            while m > 0:
                chunk = min(m, o - ref)
                dst[o:o + chunk] = dst[ref:ref + chunk]
                o += chunk
                m -= chunk


def execute_sequences(comp: bytes, prefix: bytes, orig_len: int,
                      lit_src, lit_len, mlens, dists,
                      name: str = "token stream") -> bytes:
    """Materialize the output of parsed sequences (cumulative-position
    table, vectorized literal placement, batched match replay)."""
    plen = len(prefix)
    k = lit_len.size
    seq_len = lit_len + mlens
    ends = np.cumsum(seq_len, dtype=np.int32)
    decoded = int(ends[-1]) if k else 0
    if decoded != orig_len:
        raise ValueError(f"{name} decoded {decoded} bytes, expected {orig_len}")
    dst = bytearray(plen + orig_len)
    dst[:plen] = prefix
    darr = np.frombuffer(memoryview(dst), dtype=np.uint8)
    lit_dst = plen + ends - seq_len

    total_lit = int(lit_len.sum())
    if total_lit:
        if total_lit > _SCATTER_MAX_RUN * k:
            # few long runs: per-run memcpy beats building index arrays
            for s, l, dp in zip(lit_src.tolist(), lit_len.tolist(),
                                lit_dst.tolist()):
                if l:
                    dst[dp:dp + l] = comp[s:s + l]
        else:
            carr = np.frombuffer(comp, dtype=np.uint8)
            nzr = np.flatnonzero(lit_len)
            ll_ = lit_len[nzr]
            big = np.flatnonzero(ll_ > 1024)
            if big.size:  # dictionary-style head runs: memcpy, not indices
                for j in big.tolist():
                    s, l, dp = (int(lit_src[nzr[j]]), int(ll_[j]),
                                int(lit_dst[nzr[j]]))
                    dst[dp:dp + l] = comp[s:s + l]
                keep = ll_ <= 1024
                nzr = nzr[keep]
                ll_ = ll_[keep]
            if nzr.size:
                cs_ = np.cumsum(ll_)
                darr[_range_concat(lit_dst[nzr], ll_, cs_)] = \
                    carr[_range_concat(lit_src[nzr], ll_, cs_)]

    if k == 0 or int(mlens.max()) == 0:
        return bytes(memoryview(dst)[plen:])

    if k > 1 and mlens[k - 1] == 0 and int(mlens[:k - 1].min()) > 0:
        # dense streams end literals-only with a match everywhere else:
        # plain slices beat a flatnonzero + four gathers
        mo = (lit_dst + lit_len)[:k - 1]
        ml = mlens[:k - 1]
        md = dists[:k - 1]
    else:
        sel = np.flatnonzero(mlens)
        mo = (lit_dst + lit_len)[sel]
        ml = mlens[sel]
        md = dists[sel]
    refs = mo - md
    if int(md.min()) < 1 or int(refs.min()) < 0:
        raise ValueError(f"{name} match offset reaches before the window")
    K = mo.size
    ov = np.flatnonzero(md < ml)          # overlapping: batch-breakers
    if K < 2 * _BATCH_MIN or K // (ov.size + 1) < _BATCH_MIN:
        # close-referencing regime: batches would be tiny, stay serial
        _run_serial(dst, mo, ml, refs, 0, K)
        return bytes(memoryview(dst)[plen:])

    # global gather indices: a batch is two numpy calls over a slice
    re = refs + ml
    cs = np.cumsum(ml)
    pre = cs - ml
    didx = _range_concat(mo, ml, cs)
    sidx = _range_concat(refs, ml, cs)
    bounds = ov.tolist() + [K]
    s0 = 0
    for b in bounds:
        if b - s0 >= _BATCH_MIN:
            # segment without overlap matches: re <= o elementwise, so the
            # first conflict for frontier o[p] is exactly where the running
            # max of re exceeds it
            M = np.maximum.accumulate(re[s0:b])
            Q = np.searchsorted(M, mo[s0:b], side="right")
            p = s0
            while p < b:
                q = int(Q[p - s0]) + s0  # > p: re[p] <= o[p] holds here
                if q - p >= _BATCH_MIN:
                    sl = slice(int(pre[p]), int(cs[q - 1]))
                    darr[didx[sl]] = darr[sidx[sl]]
                else:
                    _run_serial(dst, mo, ml, refs, p, q)
                p = q
        elif b > s0:
            _run_serial(dst, mo, ml, refs, s0, b)
        if b < K:  # the overlap match itself
            _run_serial(dst, mo, ml, refs, b, b + 1)
        s0 = b + 1
    return bytes(memoryview(dst)[plen:])


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def decode_token_stream(comp: bytes, prefix: bytes, orig_len: int,
                        base: int = 0, offset_bytes: int = 2,
                        name: str = "token stream") -> bytes:
    """Decode an LZ4-framed token stream, routing by sequence density."""
    if len(comp) - base < _VECTOR_MIN:
        return _decode_serial(comp, prefix, orig_len, base, offset_bytes, name)
    if comp[base] >> 4 == 15 and comp[base + 1:base + 257] == b"\xff" * 256:
        # >= 64 KiB leading literal (incompressible payload): go serial now
        # rather than walking the extension run in the probe and again here
        return _decode_serial(comp, prefix, orig_len, base, offset_bytes, name)
    state = _scan_scalar(comp, base, offset_bytes, _PROBE_SEQS)
    if state[4]:  # whole stream fits in the probe: too few sequences
        return _decode_serial(comp, prefix, orig_len, base, offset_bytes, name)
    head = _scalar_arrays(comp, state, offset_bytes)
    # density estimate, discounting one dictionary-style leading literal
    scanned = state[3] - base - int(head[1].max())
    if scanned >= _SERIAL_DENSITY * max(len(state[0]) - 1, 1):
        # long sequences: the serial decoder is memcpy-bound already
        return _decode_serial(comp, prefix, orig_len, base, offset_bytes, name)
    tail = _parse_vector(comp, state[3], offset_bytes)
    arrays = tuple(np.concatenate([h, t]) for h, t in zip(head, tail))
    return execute_sequences(comp, prefix, orig_len, *arrays, name=name)
