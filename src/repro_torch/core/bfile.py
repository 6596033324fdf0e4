"""BasketFile: the on-disk container (the "ROOT file" of this framework).

Layout::

    [8B magic "RBKTv001"][baskets...][TOC json][8B TOC length][8B magic]

* The TOC (table of contents) maps branch name -> dtype/shape/compression
  config/dictionary + the (offset, length, meta) of every basket — ROOT's
  directory/streamer-info analogue, minus C++ streamers.
* Baskets are written streaming; the TOC goes last, and the file is written
  to a temp path then atomically renamed — a crash mid-write can never
  produce a file with a valid trailer (fault-tolerance invariant used by
  the checkpointer).
* Dictionaries (paper §2.3 "placement within the ROOT file" open question):
  stored once in the TOC region per branch, not per basket — amortizing
  dictionary bytes across baskets, which is the sizing/placement policy the
  paper asks for (evaluated in benchmarks/fig_dict.py).
"""

from __future__ import annotations

import base64
import json
import lzma
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from .basket import (BasketMeta, ChecksumError, byte_offsets, join_baskets,
                     split_array, unpack_basket, unpack_basket_into)
from .checksum import adler32_hw
from .codec import CompressionConfig


def _pread(path: str, offset: int, n: int, expect=None) -> bytes:
    # lazy import: repro_torch.io imports repro_torch.core at package-init time
    from repro_torch.io import fdcache
    return fdcache.pread(path, offset, n, expect=expect)

__all__ = ["BasketWriter", "BasketFile", "write_arrays", "read_arrays",
           "CorruptBasketError", "TruncatedContainerError",
           "recover_container"]

_MAGIC = b"RBKTv001"
_JOURNAL_MAGIC = "RBKJ1"

# Everything a damaged payload can raise out of the decode path: adler /
# shape mismatches (ValueError, incl. ChecksumError), malformed metadata
# (KeyError), torn preads (EOFError), a garbled *compressed* stream blowing
# up inside a codec before the adler check runs (zlib.error / LZMAError /
# IndexError from the pure-Python LZ4 match copier).  Staleness (OSError)
# is deliberately absent — a replaced file must never be "healed".
_DECODE_ERRORS = (ValueError, KeyError, IndexError, EOFError,
                  zlib.error, lzma.LZMAError)


class CorruptBasketError(ChecksumError):
    """A basket's decoded bytes fail their stored adler32 — structured:
    names the container, branch, basket index, and byte offset so the
    operator (or a repair tool) can locate the damage without a hexdump."""

    def __init__(self, path: str, branch: str, index: int, offset: int,
                 cause=None):
        super().__init__(
            f"corrupt basket in {path}: branch={branch!r} index={index} "
            f"offset={offset}" + (f" ({cause})" if cause else ""))
        self.path = str(path)
        self.branch = str(branch)
        self.index = int(index)
        self.offset = int(offset)


class TruncatedContainerError(ValueError):
    """The container is torn or truncated (crash mid-copy, partial
    download, disk-full tail loss): header present but the TOC trailer is
    missing or inconsistent.  :func:`recover_container` can salvage every
    basket that precedes the tear when a write journal is present."""

    def __init__(self, path: str, msg: str):
        super().__init__(f"{path}: {msg}")
        self.path = str(path)


def _fsync_dir(dirname: str) -> None:
    """fsync the directory so a rename survives a power cut — the commit
    is not durable until the directory entry itself is on disk."""
    try:
        dfd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return                       # not fsyncable here (e.g. some FSes)
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def _journal_path(path: str) -> str:
    """The write journal that describes ``path``'s bytes.  A leftover
    ``*.tmp`` from a crashed writer shares its final path's journal (the
    tmp is byte-for-byte the committed prefix)."""
    path = str(path)
    if path.endswith(".tmp"):
        path = path[:-4]
    return path + ".journal"


def _count_corrupt() -> None:
    try:
        from repro_torch import obs
        obs.counter("bfile.corrupt_baskets").inc()
    except Exception:
        pass


def _count_repair(event: str) -> None:
    try:
        from repro_torch import obs
        obs.counter(f"repair.{event}").inc()
    except Exception:
        pass


class BasketWriter:
    """Streaming writer with atomic commit.

    ``workers>0`` (or an explicit shared ``engine``) turns on the parallel
    I/O engine (repro_torch.io.engine): baskets compress concurrently on a
    bounded pool while this thread commits payloads in offset order —
    output is byte-identical to the serial path.

    Crash safety: baskets stream to ``path + ".tmp"``; :meth:`close`
    writes the TOC, fsyncs, atomically renames onto ``path``, then fsyncs
    the directory — readers see the old generation, the new generation,
    or (for a torn external copy) a :class:`TruncatedContainerError`,
    never silently wrong bytes.  ``journal=True`` additionally appends a
    ``path + ".journal"`` sidecar (one JSON line per branch and basket,
    flushed as written); :func:`recover_container` uses it to salvage
    every basket preceding a tear.  The container bytes are identical
    either way — the journal is a sidecar, never part of the format.

    ``parity=k`` (k ≥ 2) additionally groups baskets, in write order,
    into k-wide XOR stripes and writes a ``path + ".parity"`` sidecar
    (repro_torch.repair.stripe) committed *after* the container — any single
    damaged basket per stripe becomes reconstructible in place
    (``BasketFile(heal="auto")``).  Like the journal, parity never
    changes the container's own bytes.
    """

    def __init__(self, path: str, workers: int = 0, engine=None,
                 tuner=None, objective=None, journal: bool = False,
                 parity: int = 0):
        if tuner is not None or objective is not None:
            raise NotImplementedError(
                "measured codec selection (tuner=/objective=) is not ported "
                "yet: ROADMAP.md queue A, 'tune in the port'")
        self.path = str(path)
        self._tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        self._f = open(self._tmp, "wb")
        self._f.write(_MAGIC)
        self._branches: dict[str, dict] = {}
        self._closed = False
        self._failed = None          # first exception seen mid-write
        self._journal = None
        self._jpath = _journal_path(self.path)
        if journal:
            self._journal = open(self._jpath, "w")
            self._journal.write(json.dumps(
                {"magic": _JOURNAL_MAGIC,
                 "container": os.path.basename(self.path)}) + "\n")
            self._journal.flush()
        else:
            # a stale journal from an earlier journalled generation must
            # not describe this write's bytes
            try:
                os.remove(self._jpath)
            except OSError:
                pass
        self._parity = None
        if parity:
            from repro_torch.repair.stripe import ParityWriter, parity_path
            self._parity = ParityWriter(parity_path(self.path), k=parity)
        else:
            # same staleness rule as the journal: a sidecar from an
            # earlier parity-protected generation must not describe this
            # write's bytes
            try:
                os.remove(self.path + ".parity")
            except OSError:
                pass
        self._engine = engine
        self._owns_engine = False
        if engine is None and workers:
            from repro_torch.io.engine import CompressionEngine
            self._engine = CompressionEngine(workers)
            self._owns_engine = True

    def write_branch(self, name: str, arr: np.ndarray,
                     cfg: Optional[CompressionConfig] = None,
                     target_basket_bytes: int = 1 << 20) -> dict:
        """Serialize an array column-wise into compressed baskets."""
        arr = np.asarray(arr)
        return self.write_branch_chunks(
            name, dtype=arr.dtype.str, shape=arr.shape,
            chunks=split_array(arr, target_basket_bytes), cfg=cfg)

    def write_branch_chunks(self, name: str, *, dtype, shape, chunks,
                            cfg: Optional[CompressionConfig] = None) -> dict:
        """Stream a branch from a ``(entry_start, entry_count, buffer)``
        chunk iterator without materializing the whole array — the
        checkpointer's device→host staging path.  Chunk boundaries are the
        caller's; to match :func:`write_branch` bytes exactly, produce
        the boundaries of :func:`repro_torch.core.basket.basket_rows`."""
        if name in self._branches:
            raise ValueError(f"branch {name!r} already written")
        cfg = cfg or CompressionConfig()
        engine = self._engine
        if engine is None:
            from repro_torch.io.engine import CompressionEngine
            engine = CompressionEngine(0)   # the serial path — no pools
        entry = {
            "dtype": np.dtype(dtype).str,
            "shape": list(shape),
            "config": {"algo": cfg.algo, "level": cfg.level, "precond": cfg.precond},
            "dictionary": base64.b64encode(cfg.dictionary).decode() if cfg.dictionary else None,
            "baskets": [],
        }
        self._journal_branch(name, entry)
        try:
            packed = engine.pack_stream(chunks, cfg)
            for _start, _count, payload, meta in packed:
                off = self._f.tell()
                self._f.write(payload)  # accepts memoryview payloads zero-copy
                if self._parity is not None:
                    self._parity.add(name, len(entry["baskets"]), payload)
                entry["baskets"].append({"offset": off, "meta": meta.to_json()})
                self._journal_basket(name, off, meta.to_json())
        except BaseException as e:
            self._failed = self._failed or e
            raise
        self._branches[name] = entry
        return entry

    def write_precompressed(self, name: str, *, dtype, shape, config,
                            dictionary, baskets) -> dict:
        """Append already-compressed ``(payload, meta_json)`` baskets as a
        branch — the BufferMerger/fast-merge path (no recompression)."""
        if name in self._branches:
            raise ValueError(f"branch {name!r} already written")
        entry = {"dtype": dtype, "shape": list(shape), "config": dict(config),
                 "dictionary": dictionary, "baskets": []}
        self._journal_branch(name, entry)
        try:
            for payload, meta_json in baskets:
                off = self._f.tell()
                self._f.write(payload)
                if self._parity is not None:
                    self._parity.add(name, len(entry["baskets"]), payload)
                entry["baskets"].append({"offset": off, "meta": dict(meta_json)})
                self._journal_basket(name, off, dict(meta_json))
        except BaseException as e:
            self._failed = self._failed or e
            raise
        self._branches[name] = entry
        return entry

    # -- write journal (recovery sidecar) --------------------------------

    def _journal_branch(self, name: str, entry: dict) -> None:
        if self._journal is None:
            return
        self._journal.write(json.dumps(
            {"branch": name, "dtype": entry["dtype"],
             "shape": entry["shape"], "config": entry["config"],
             "dictionary": entry["dictionary"]}) + "\n")
        self._journal.flush()

    def _journal_basket(self, name: str, offset: int, meta_json: dict) -> None:
        if self._journal is None:
            return
        self._journal.write(json.dumps(
            {"basket": name, "offset": offset, "meta": meta_json}) + "\n")
        self._journal.flush()

    def write_blob(self, name: str, raw: bytes, cfg: Optional[CompressionConfig] = None) -> None:
        """Opaque byte branch (metadata blobs, tokenizer state, ...)."""
        self.write_branch(name, np.frombuffer(raw, dtype=np.uint8), cfg)

    def close(self) -> None:
        if self._closed:
            return
        if self._failed is not None:
            # a basket write already failed: committing would publish a
            # container whose TOC describes bytes that were never written.
            # Abort instead and surface the original failure; subsequent
            # close() calls are no-ops (idempotent after failure).
            err = self._failed
            self.abort()
            raise RuntimeError(
                f"container write to {self.path!r} failed mid-stream; "
                f"aborted without committing: {err!r}") from err
        doc = {"branches": self._branches}
        try:
            toc = json.dumps(doc).encode()
            self._f.write(toc)
            self._f.write(len(toc).to_bytes(8, "little"))
            self._f.write(_MAGIC)
            self._f.flush()
            size = self._f.tell()
            os.fsync(self._f.fileno())
            self._f.close()
            os.replace(self._tmp, self.path)  # atomic commit
        except BaseException:
            # commit failed (ENOSPC on the TOC, rename error, ...): never
            # leave the half-written tmp behind
            self.abort()
            raise
        # the rename is durable only once the directory entry is synced
        _fsync_dir(os.path.dirname(os.path.abspath(self.path)))
        if self._parity is not None:
            # sidecar commits strictly after the container: a crash here
            # leaves a valid container without parity, never the reverse
            from repro_torch.repair.stripe import content_stamp
            self._parity.commit(self._branches, content_stamp(size, toc),
                                self.path)
            self._parity = None
        if self._journal is not None:
            # the journal now describes the committed bytes: keep it as
            # the recovery sidecar for torn copies of this container
            self._journal.flush()
            self._journal.close()
            self._journal = None
        self._closed = True
        if self._owns_engine:
            self._engine.close()

    def abort(self) -> None:
        if not self._closed:
            try:
                self._f.close()
            except OSError:
                pass
            if os.path.exists(self._tmp):
                os.remove(self._tmp)
            if self._journal is not None:
                try:
                    self._journal.close()
                    os.remove(self._jpath)
                except OSError:
                    pass
                self._journal = None
            if self._parity is not None:
                self._parity.abort()
                self._parity = None
            self._closed = True
            if self._owns_engine:
                self._engine.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self.close()
        else:
            self.abort()


class BasketFile:
    """Reader with optional thread-pool parallel decompression.

    ``workers`` sets the default decompression pool width.  ``prefetch>0``
    (decompress-ahead reads) is not ported yet and raises.

    ``heal="auto"`` turns a checksum-failing or torn basket read into a
    repair attempt instead of a quarantine dead end: the basket is
    re-read once (transient read rot clears on retry), else reconstructed
    from its XOR stripe peers + the ``.parity`` sidecar
    (``BasketWriter(parity=k)``), re-verified against the stored adler32,
    patched back **in place** (same inode — open readers stay valid), and
    served.  Healed/transient/failed outcomes are counted in
    ``self.heal_stats`` and the ``repair.*`` counters; an unhealable
    basket still raises :class:`CorruptBasketError`.
    """

    def __init__(self, path: str, verify: bool = True,
                 workers: int = 0, prefetch: int = 0,
                 heal: Optional[str] = None):
        if heal not in (None, "auto"):
            raise ValueError(f"heal must be None or 'auto', got {heal!r}")
        if prefetch:
            raise NotImplementedError(
                "decompress-ahead reads (prefetch>0) are not ported yet: "
                "ROADMAP.md queue A, 'prefetch in the port'")
        self.path = str(path)
        self.verify = verify
        self.heal = heal
        self.workers = workers
        self.prefetch = prefetch
        self._engine = None
        self._readers: dict = {}
        self._reader_lock = threading.Lock()
        self._closed = False
        with open(self.path, "rb") as f:
            # the generation of the inode whose TOC we are about to read:
            # every later pread checks against it, so a tmp-then-replace of
            # the path raises StaleFileError instead of slicing baskets out
            # of a file this TOC does not describe
            st = os.fstat(f.fileno())
            self.generation = (st.st_dev, st.st_ino)
            size = st.st_size
            head = f.read(8)
            if head != _MAGIC:
                if _MAGIC.startswith(head):
                    # a real container sheared off inside the header
                    raise TruncatedContainerError(
                        path, f"truncated container ({size} bytes)")
                raise ValueError(f"{path}: not a BasketFile (bad magic)")
            if size < 8 + 16:
                raise TruncatedContainerError(
                    path, f"truncated container ({size} bytes) — "
                          "incomplete write?")
            f.seek(-16, os.SEEK_END)
            toc_len = int.from_bytes(f.read(8), "little")
            if f.read(8) != _MAGIC:
                raise TruncatedContainerError(
                    path, "truncated (bad trailer) — incomplete write?")
            if not 2 <= toc_len <= size - 24:
                raise TruncatedContainerError(
                    path, f"TOC length {toc_len} inconsistent with "
                          f"file size {size}")
            f.seek(-16 - toc_len, os.SEEK_END)
            toc_bytes = f.read(toc_len)
            try:
                self._toc = json.loads(toc_bytes)
            except ValueError as e:
                raise TruncatedContainerError(
                    path, f"undecodable TOC — torn write? ({e})") from None
        # the content-derived stamp a parity sidecar must match before its
        # stripe map is trusted (repro_torch.repair.stripe.content_stamp)
        self._content_stamp = {"size": int(size),
                               "toc_adler": int(adler32_hw(toc_bytes))}
        self._heal_lock = threading.Lock()
        self._parity_sc = None
        self.heal_stats = {"healed": 0, "transient": 0, "failed": 0}
        self.branches = self._toc["branches"]
        # per-branch autotuner decisions persisted at write time (may be
        # absent: files predating repro_torch.tune, or written without a tuner)
        self.tuning = self._toc.get("tuning", {})

    def branch_names(self) -> list[str]:
        return list(self.branches)

    def tuning_decisions(self) -> dict[str, dict]:
        """Persisted per-branch tuner decisions (``{}`` when untuned) —
        feed to :meth:`repro_torch.tune.Tuner.load` to append/re-open without
        re-measurement."""
        return dict(self.tuning)

    def _dictionary(self, entry: dict) -> Optional[bytes]:
        d = entry.get("dictionary")
        return base64.b64decode(d) if d else None

    def read_basket_payload(self, name: str, i: int) -> bytes:
        """Compressed on-disk payload of one basket (no decompression) —
        the fast-merge path."""
        entry = self.branches[name]
        b = entry["baskets"][i]
        return _pread(self.path, b["offset"], b["meta"]["comp_len"],
                      expect=self.generation)

    def read_basket_raw(self, name: str, i: int) -> bytes:
        entry = self.branches[name]
        b = entry["baskets"][i]
        meta = BasketMeta.from_json(b["meta"])
        try:
            payload = _pread(self.path, b["offset"], meta.comp_len,
                             expect=self.generation)
            return unpack_basket(payload, meta, self._dictionary(entry),
                                 verify=self.verify)
        except ChecksumError as e:
            if self.heal == "auto":
                return self._heal_basket(name, i, cause=e)
            raise self._quarantine(name, i, b, e) from e
        except _DECODE_ERRORS as e:
            # torn pread / undecodable payload — healable damage too, but
            # staleness (the file was replaced) must never be "healed"
            if self.heal == "auto":
                return self._heal_basket(name, i, cause=e)
            raise

    def read_basket_into(self, name: str, i: int, out) -> int:
        """Read + decode basket ``i`` directly into ``out`` (writable
        buffer ≥ ``orig_len`` bytes) — the zero-copy scatter step."""
        entry = self.branches[name]
        b = entry["baskets"][i]
        meta = BasketMeta.from_json(b["meta"])
        try:
            payload = _pread(self.path, b["offset"], meta.comp_len,
                             expect=self.generation)
            return unpack_basket_into(payload, meta, out,
                                      self._dictionary(entry),
                                      verify=self.verify)
        except ChecksumError as e:
            if self.heal == "auto":
                raw = self._heal_basket(name, i, cause=e)
                memoryview(out).cast("B")[:len(raw)] = raw
                return len(raw)
            raise self._quarantine(name, i, b, e) from e
        except _DECODE_ERRORS as e:
            if self.heal == "auto":
                raw = self._heal_basket(name, i, cause=e)
                memoryview(out).cast("B")[:len(raw)] = raw
                return len(raw)
            raise

    def _quarantine(self, name: str, i: int, b: dict,
                    cause) -> CorruptBasketError:
        """Turn a checksum failure into the structured error (counted in
        ``bfile.corrupt_baskets``) naming exactly what is damaged."""
        _count_corrupt()
        return CorruptBasketError(self.path, name, i, int(b["offset"]),
                                  cause=cause)

    # -- self-healing (repro_torch.repair) -------------------------------------

    def _sidecar(self):
        """The parity sidecar, loaded once and stamp-checked against this
        container's committed content — a sidecar left over from an older
        generation must never donate stripes to these bytes."""
        if self._parity_sc is None:
            from repro_torch.repair.stripe import ParityError, ParitySidecar, \
                parity_path
            sc = ParitySidecar.load(parity_path(self.path))
            if sc.stamp != self._content_stamp:
                raise ParityError(
                    f"{sc.path}: stamp {sc.stamp} does not match container "
                    f"content {self._content_stamp} — sidecar is for a "
                    "different generation")
            self._parity_sc = sc
        return self._parity_sc

    def _try_decode(self, name: str, i: int):
        """One pread + verified decode; ``None`` on any damage (a torn or
        rotted read), raising only for staleness."""
        from repro_torch.io.fdcache import StaleFileError
        entry = self.branches[name]
        b = entry["baskets"][i]
        meta = BasketMeta.from_json(b["meta"])
        try:
            payload = _pread(self.path, b["offset"], meta.comp_len,
                             expect=self.generation)
            raw = unpack_basket(payload, meta, self._dictionary(entry),
                                verify=True)
            return payload, raw
        except StaleFileError:
            raise
        except _DECODE_ERRORS:
            return None

    def _read_peer(self, name: str, i: int) -> bytes:
        b = self.branches[name]["baskets"][i]
        return _pread(self.path, b["offset"], b["meta"]["comp_len"],
                      expect=self.generation)

    def _verify_peer(self, name: str, i: int, payload) -> bool:
        entry = self.branches[name]
        meta = BasketMeta.from_json(entry["baskets"][i]["meta"])
        try:
            unpack_basket(payload, meta, self._dictionary(entry),
                          verify=True)
            return True
        except _DECODE_ERRORS:
            return False

    def _heal_basket(self, name: str, i: int, cause=None) -> bytes:
        """Repair basket ``(name, i)`` and return its decoded raw bytes.

        Under the heal lock: (1) one verified re-read — transient read rot
        (a fault-hook garble, a racing heal by another thread) clears
        without touching parity; (2) reconstruct the on-disk payload from
        stripe peers + parity, decode-verify it against the stored
        adler32, and patch it back in place (same inode, so open readers
        and cache generations stay valid).  Reconstruction is retried a
        few times because the *reads* it depends on go through the same
        rot-prone pread path as the basket that failed.  Unhealable →
        ``repair.heal_failed`` + :class:`CorruptBasketError`."""
        from repro_torch.repair.stripe import ParityError
        entry = self.branches[name]
        b = entry["baskets"][i]
        meta = BasketMeta.from_json(b["meta"])
        with self._heal_lock:
            got = self._try_decode(name, i)
            if got is not None:
                self.heal_stats["transient"] += 1
                _count_repair("transient")
                return got[1]
            candidate = raw = None
            last = None
            for _attempt in range(3):
                try:
                    sc = self._sidecar()
                    candidate = sc.reconstruct(
                        name, i, meta.comp_len,
                        self._read_peer, self._verify_peer)
                    raw = unpack_basket(candidate, meta,
                                        self._dictionary(entry), verify=True)
                    break
                except (ParityError,) + _DECODE_ERRORS as e:
                    last, candidate = e, None
            if candidate is None:
                self.heal_stats["failed"] += 1
                _count_repair("heal_failed")
                raise self._quarantine(name, i, b, cause or last)
            from repro_torch.io import fdcache
            fdcache.patch(self.path, int(b["offset"]), candidate,
                          expect=self.generation)
            self.heal_stats["healed"] += 1
            _count_repair("healed")
            return raw

    def ensure_payload(self, name: str, i: int, payload=None) -> bytes:
        """Verified on-disk payload bytes for basket ``(name, i)``, healing
        in place when damaged — the serve-path hook (remote server, scrub).

        ``payload``, when given, is a candidate slice the caller already
        read; it is returned as-is if it decode-verifies.  Otherwise the
        basket is healed (:meth:`_heal_basket`) and re-read.  Raises
        :class:`CorruptBasketError` when unhealable."""
        entry = self.branches[name]
        b = entry["baskets"][i]
        meta = BasketMeta.from_json(b["meta"])
        if payload is not None and self._verify_peer(name, i, payload):
            return bytes(payload)
        self._heal_basket(name, i)
        last = None
        for _attempt in range(4):
            got = self._try_decode(name, i)
            if got is not None:
                return got[0]
        raise self._quarantine(name, i, b, last or "post-heal re-read "
                               "keeps failing")

    @staticmethod
    def _byte_offsets(entry: dict) -> tuple[list[int], int]:
        return byte_offsets(b["meta"]["orig_len"] for b in entry["baskets"])

    def read_branch(self, name: str, workers: Optional[int] = None) -> np.ndarray:
        """Read + decompress a branch; ``workers>0`` = parallel decompression
        (the paper's simultaneous-read-and-decompress).

        Zero-copy plane: the destination array is allocated once and every
        basket decodes directly into its slice — no per-basket ``bytes``,
        no final concatenation."""
        if workers is None:
            workers = self.workers
        entry = self.branches[name]
        n = len(entry["baskets"])
        out = np.empty(tuple(entry["shape"]), dtype=np.dtype(entry["dtype"]))
        offs, total = self._byte_offsets(entry)
        if total != out.nbytes:
            # malformed TOC: fall back to the copying join (raises there)
            chunks = [self.read_basket_raw(name, i) for i in range(n)]
            return join_baskets(chunks, entry["dtype"], tuple(entry["shape"]))
        flat = out.reshape(-1).view(np.uint8)

        def scatter(i: int) -> None:
            ln = entry["baskets"][i]["meta"]["orig_len"]
            self.read_basket_into(name, i, flat[offs[i]:offs[i] + ln])

        if workers and n > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(scatter, range(n)))
        else:
            for i in range(n):
                scatter(i)
        return out

    def read_entries(self, name: str, start: int, stop: int) -> np.ndarray:
        """Row-range read touching only the covering baskets (seekability)."""
        entry = self.branches[name]
        shape = tuple(entry["shape"])
        dtype = np.dtype(entry["dtype"])
        cover, first_entry, total = [], None, 0
        for i, b in enumerate(entry["baskets"]):
            m = b["meta"]
            if m["entry_start"] + m["entry_count"] <= start or m["entry_start"] >= stop:
                continue
            if first_entry is None:
                first_entry = m["entry_start"]
            cover.append((i, total, m["orig_len"]))
            total += m["orig_len"]
        if not cover:
            return np.zeros((0,) + shape[1:], dtype=dtype)
        row_elems = int(np.prod(shape[1:], dtype=np.int64)) or 1
        rows = total // (dtype.itemsize * row_elems)
        arr = np.empty((rows,) + shape[1:], dtype=dtype)
        flat = arr.reshape(-1).view(np.uint8)
        for i, off, ln in cover:
            self.read_basket_into(name, i, flat[off:off + ln])
        return arr[start - first_entry: stop - first_entry].copy()

    def compressed_bytes(self, name: Optional[str] = None) -> int:
        names = [name] if name else self.branch_names()
        return sum(b["meta"]["comp_len"] for n in names for b in self.branches[n]["baskets"])

    def raw_bytes(self, name: Optional[str] = None) -> int:
        names = [name] if name else self.branch_names()
        return sum(b["meta"]["orig_len"] for n in names for b in self.branches[n]["baskets"])

    def compression_ratio(self, name: Optional[str] = None) -> float:
        c = self.compressed_bytes(name)
        return self.raw_bytes(name) / c if c else float("inf")

    def close(self) -> None:
        """Release prefetch readers, the engine pool, and this path's
        cached fd (so a long-lived server doesn't pin unlinked inodes
        until LRU eviction).  Idempotent: a second close is a no-op."""
        with self._reader_lock:
            if self._closed:
                return
            self._closed = True
            readers, self._readers = list(self._readers.values()), {}
            engine, self._engine = self._engine, None
        for r in readers:
            r.close()
        if engine is not None:
            engine.close()
        from repro_torch.io import fdcache
        fdcache.invalidate(self.path)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @staticmethod
    def recover(path: str, out_path: Optional[str] = None) -> dict:
        """Salvage a torn container — see :func:`recover_container`."""
        return recover_container(path, out_path)


# ---------------------------------------------------------------------------
# crash recovery
# ---------------------------------------------------------------------------

def recover_container(path: str, out_path: Optional[str] = None) -> dict:
    """Salvage every intact basket preceding the tear of a torn container.

    ``path`` is a truncated/torn container (or a leftover ``*.tmp`` from a
    crashed writer).  Recovery needs the write journal sidecar
    (``BasketWriter(journal=True)``); without one the basket boundaries
    live only in the (lost) TOC and a structured
    :class:`TruncatedContainerError` says so.  Every candidate basket is
    decoded and checked against its stored adler32 before it is kept —
    a stale or mismatched journal can drop baskets but never resurrect
    wrong bytes.  A branch is cut at its first missing/corrupt basket so
    salvaged entry ranges stay contiguous from row 0.

    Writes a fresh, valid container to ``out_path`` (default
    ``path + ".recovered"``, committed atomically) and returns a report::

        {"out_path", "baskets_kept", "baskets_lost",
         "branches": {name: rows_kept}}
    """
    path = str(path)
    out_path = str(out_path) if out_path else path + ".recovered"
    jpath = _journal_path(path)
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise TruncatedContainerError(path, f"unreadable: {e}") from None
    with open(path, "rb") as f:
        head = f.read(8)
    if head != _MAGIC:
        if _MAGIC.startswith(head):
            raise TruncatedContainerError(
                path, "sheared inside the header — nothing to salvage")
        raise ValueError(f"{path}: not a BasketFile (bad magic)")
    # basket boundaries: the write journal when present, else the parity
    # sidecar's TOC mirror (BasketWriter(parity=k)) — either way, every
    # candidate basket is decode-verified below, so a stale boundary
    # source can drop baskets but never resurrect wrong bytes
    order: list[str] = []
    jbranches: dict[str, dict] = {}
    if os.path.exists(jpath):
        with open(jpath) as jf:
            first = jf.readline()
            try:
                if json.loads(first).get("magic") != _JOURNAL_MAGIC:
                    raise ValueError("bad journal magic")
            except ValueError as e:
                raise TruncatedContainerError(
                    path, f"unusable write journal {jpath}: {e}") from None
            for line in jf:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    break            # journal itself torn: keep what parsed
                if "branch" in rec:
                    order.append(rec["branch"])
                    jbranches[rec["branch"]] = {
                        "dtype": rec["dtype"], "shape": rec["shape"],
                        "config": rec["config"],
                        "dictionary": rec["dictionary"], "baskets": []}
                elif "basket" in rec and rec["basket"] in jbranches:
                    jbranches[rec["basket"]]["baskets"].append(
                        {"offset": int(rec["offset"]), "meta": rec["meta"]})
    else:
        from repro_torch.repair.stripe import ParityError, ParitySidecar, \
            parity_path
        ppath = parity_path(path)
        try:
            sc = ParitySidecar.load(ppath)
        except ParityError:
            raise TruncatedContainerError(
                path, "cannot recover: no write journal sidecar "
                      f"({jpath} missing) and no parity sidecar "
                      f"({ppath}) — basket boundaries were lost with the "
                      "TOC; write with BasketWriter(journal=True) or "
                      "BasketWriter(parity=k) to make containers "
                      "salvageable") from None
        # no stamp check: a torn copy never matches the committed stamp —
        # that is exactly the case being recovered
        for bname, e in sc.branches.items():
            order.append(bname)
            jbranches[bname] = {
                "dtype": e["dtype"], "shape": list(e["shape"]),
                "config": dict(e["config"]),
                "dictionary": e.get("dictionary"),
                "baskets": [{"offset": int(b["offset"]),
                             "meta": dict(b["meta"])}
                            for b in e["baskets"]]}

    kept = lost = 0
    out_branches: dict[str, dict] = {}
    rows_kept: dict[str, int] = {}
    tmp = out_path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    src = open(path, "rb")
    try:
        with open(tmp, "wb") as dst:
            dst.write(_MAGIC)
            for name in order:
                e = jbranches[name]
                dictionary = base64.b64decode(e["dictionary"]) \
                    if e["dictionary"] else None
                out_baskets = []
                rows = 0
                for b in e["baskets"]:
                    meta = BasketMeta.from_json(b["meta"])
                    end = b["offset"] + meta.comp_len
                    if end > size:
                        break       # the tear: nothing later is complete
                    src.seek(b["offset"])
                    payload = src.read(meta.comp_len)
                    try:
                        unpack_basket(payload, meta, dictionary, verify=True)
                    except (ChecksumError, ValueError, KeyError):
                        break       # cut the branch at the first bad basket
                    off = dst.tell()
                    dst.write(payload)
                    out_baskets.append({"offset": off, "meta": b["meta"]})
                    rows += int(meta.entry_count)
                    kept += 1
                lost += len(e["baskets"]) - len(out_baskets)
                if not out_baskets:
                    continue
                shape = list(e["shape"])
                if len(out_baskets) < len(e["baskets"]):
                    if not shape:
                        continue     # 0-d branch lost its only basket tail
                    # trim the leading dimension to the salvaged rows and
                    # require exact byte agreement — a partial basket can
                    # never smuggle a misaligned row count through
                    row_elems = 1
                    for d in shape[1:]:
                        row_elems *= int(d)
                    row_bytes = np.dtype(e["dtype"]).itemsize * row_elems
                    total = sum(b["meta"]["orig_len"] for b in out_baskets)
                    if row_bytes <= 0 or total % row_bytes:
                        continue
                    shape[0] = total // row_bytes
                    rows = shape[0]
                out_branches[name] = {
                    "dtype": e["dtype"], "shape": shape,
                    "config": e["config"], "dictionary": e["dictionary"],
                    "baskets": out_baskets}
                rows_kept[name] = rows
            toc = json.dumps({"branches": out_branches}).encode()
            dst.write(toc)
            dst.write(len(toc).to_bytes(8, "little"))
            dst.write(_MAGIC)
            dst.flush()
            os.fsync(dst.fileno())
        os.replace(tmp, out_path)
        _fsync_dir(os.path.dirname(os.path.abspath(out_path)))
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    finally:
        src.close()
    return {"out_path": out_path, "baskets_kept": kept,
            "baskets_lost": lost, "branches": rows_kept}


# ---------------------------------------------------------------------------
# pytree-of-arrays convenience (used by the checkpointer)
# ---------------------------------------------------------------------------

def write_arrays(path: str, arrays: dict[str, np.ndarray],
                 cfg_for: Optional[callable] = None,
                 target_basket_bytes: int = 1 << 20,
                 workers: int = 0, tuner=None, objective=None,
                 parity: int = 0) -> None:
    """Write a flat dict of named arrays; ``cfg_for(name, arr)`` picks the
    per-branch CompressionConfig (the codec policy hook); ``workers>0``
    compresses baskets in parallel (identical bytes).  ``tuner=`` /
    ``objective=`` switch branches without an explicit config to
    measurement-driven selection (repro_torch.tune).  ``parity=k`` writes the
    self-healing XOR sidecar (container bytes unchanged)."""
    with BasketWriter(path, workers=workers, tuner=tuner,
                      objective=objective, parity=parity) as w:
        for name, arr in arrays.items():
            cfg = cfg_for(name, np.asarray(arr)) if cfg_for else None
            w.write_branch(name, arr, cfg, target_basket_bytes)


def read_arrays(path: str, workers: int = 0, prefetch: int = 0) -> dict[str, np.ndarray]:
    with BasketFile(path, workers=workers, prefetch=prefetch) as f:
        return {name: f.read_branch(name, workers=workers)
                for name in f.branch_names()}
