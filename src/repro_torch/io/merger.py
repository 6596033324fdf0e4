"""Buffer merging — the TBufferMerger analogue.

ROOT's ``TBufferMerger`` lets N producer tasks fill in-memory ``TTree``
buffers (compressing as they go, in parallel) while a single sequential
writer drains them into one output file, so the file format's single-writer
invariant never serializes *compression*.  Here:

* ``BasketBuffer`` — an in-memory branch set: producers call
  ``write_branch`` exactly like ``BasketWriter``, but payloads land in RAM
  (optionally compressed through a shared ``CompressionEngine``).

* ``BufferMerger`` — wraps one ``BasketWriter`` and a lock; ``merge(buf)``
  appends a buffer's pre-compressed payloads to the file **without
  recompression** and records the branch TOC entries.  Producers on
  different threads interleave merges safely; the atomic tmp-then-rename
  commit of ``BasketWriter`` is preserved, so a crash mid-merge still
  leaves no valid trailer.

* ``merge_files`` — the ``hadd -ff``-style fast merge: splices existing
  BasketFiles into one output by copying compressed payloads byte-for-byte.

Used by the checkpointer for parallel shard writes (each producer thread
compresses its slice of the train state) and by any multi-writer pipeline
that wants one artifact out the other end.
"""

from __future__ import annotations

import base64
import itertools
import threading
from typing import Iterable, Optional

import numpy as np

from repro_torch.core.basket import split_array
from repro_torch.core.bfile import BasketFile, BasketWriter
from repro_torch.core.codec import CompressionConfig

from .engine import CompressionEngine

__all__ = ["BasketBuffer", "BufferMerger", "merge_files"]


class BasketBuffer:
    """In-memory compressed branch set, filled by one producer."""

    def __init__(self, engine: Optional[CompressionEngine] = None,
                 tuner=None):
        self._engine = engine
        self._tuner = tuner
        self._branches: dict[str, dict] = {}   # name -> TOC-entry skeleton
        self._payloads: dict[str, list[bytes]] = {}

    def write_branch(self, name: str, arr: np.ndarray,
                     cfg: Optional[CompressionConfig] = None,
                     target_basket_bytes: int = 1 << 20) -> dict:
        arr = np.asarray(arr)
        if cfg is None and self._tuner is not None:
            cfg = self._tuner.config_for(name, arr)
        return self.write_branch_chunks(
            name, dtype=arr.dtype.str, shape=arr.shape,
            chunks=split_array(arr, target_basket_bytes), cfg=cfg)

    def write_branch_chunks(self, name: str, *, dtype, shape, chunks,
                            cfg: Optional[CompressionConfig] = None) -> dict:
        """Buffer a branch from a ``(entry_start, entry_count, buffer)``
        chunk stream (the producers>1 checkpoint staging path)."""
        if name in self._branches:
            raise ValueError(f"branch {name!r} already buffered")
        if cfg is None and self._tuner is not None:
            it = iter(chunks)
            first = next(it, None)
            if first is not None:
                cfg = self._tuner.config_for(
                    name, first[2], dtype=np.dtype(dtype))
                chunks = itertools.chain([first], it)
        cfg = cfg or CompressionConfig()
        # CompressionEngine(0) is the serial path — no pools, same stream
        packed = (self._engine or CompressionEngine(0)).pack_stream(chunks, cfg)
        payloads, baskets = [], []
        for _start, _count, payload, meta in packed:
            if self._tuner is not None:
                self._tuner.observe(name, meta)
            # pack_stream payloads are only valid until the next iteration
            # (slab transport / zero-copy identity path) — the buffer
            # retains them, so it must own the bytes
            payloads.append(payload if isinstance(payload, bytes)
                            else bytes(payload))
            baskets.append({"meta": meta.to_json()})
        entry = {
            "dtype": np.dtype(dtype).str,
            "shape": list(shape),
            "config": {"algo": cfg.algo, "level": cfg.level,
                       "precond": cfg.precond},
            "dictionary": base64.b64encode(cfg.dictionary).decode()
                          if cfg.dictionary else None,
            "baskets": baskets,
        }
        self._branches[name] = entry
        self._payloads[name] = payloads
        return entry

    def write_blob(self, name: str, raw: bytes,
                   cfg: Optional[CompressionConfig] = None) -> None:
        self.write_branch(name, np.frombuffer(raw, dtype=np.uint8), cfg)

    def branch_names(self) -> list[str]:
        return list(self._branches)

    def nbytes(self) -> int:
        return sum(len(p) for ps in self._payloads.values() for p in ps)

    def clear(self) -> None:
        self._branches.clear()
        self._payloads.clear()


class BufferMerger:
    """One output file, many producers; merges are serialized by a lock."""

    def __init__(self, path: str, workers: int = 0,
                 engine: Optional[CompressionEngine] = None,
                 tuner=None, objective=None, parity: int = 0):
        self._engine = engine
        self._owns_engine = False
        if engine is None and workers:
            self._engine = CompressionEngine(workers)
            self._owns_engine = True
        if tuner is None and objective is not None:
            from repro_torch.tune import Tuner
            tuner = Tuner(objective, engine=self._engine)
        self._tuner = tuner
        # the writer carries the tuner so merged branches' decisions
        # persist in the output TOC (Tuner.config_for is thread-safe —
        # producers tune concurrently, per-branch decisions serialize)
        self._writer = BasketWriter(path, tuner=tuner, parity=parity)
        self._lock = threading.Lock()

    def buffer(self) -> BasketBuffer:
        """A fresh producer-side buffer wired to the shared engine."""
        return BasketBuffer(engine=self._engine, tuner=self._tuner)

    def merge(self, buf: BasketBuffer, clear: bool = True) -> None:
        """Append ``buf``'s pre-compressed baskets to the file (no
        recompression); thread-safe."""
        with self._lock:
            for name, entry in buf._branches.items():
                self._writer.write_precompressed(
                    name,
                    dtype=entry["dtype"], shape=entry["shape"],
                    config=entry["config"], dictionary=entry["dictionary"],
                    baskets=zip(buf._payloads[name],
                                (b["meta"] for b in entry["baskets"])))
        if clear:
            buf.clear()

    def write_branch(self, name: str, arr: np.ndarray,
                     cfg: Optional[CompressionConfig] = None,
                     target_basket_bytes: int = 1 << 20) -> None:
        """Convenience: buffer + merge one branch in a single call."""
        buf = self.buffer()
        buf.write_branch(name, arr, cfg, target_basket_bytes)
        self.merge(buf)

    def close(self) -> None:
        self._writer.close()
        if self._owns_engine:
            self._engine.close()

    def abort(self) -> None:
        self._writer.abort()
        if self._owns_engine:
            self._engine.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self.close()
        else:
            self.abort()


def merge_files(out_path: str, in_paths: Iterable[str],
                rename: Optional[callable] = None) -> None:
    """Fast merge: splice whole BasketFiles into one output by copying
    compressed payloads (no decompress/recompress round-trip).

    ``rename(path, branch) -> str`` maps input branch names onto output
    names (defaults to identity; duplicate output names are an error).
    """
    with BasketWriter(out_path) as w:
        for path in in_paths:
            f = BasketFile(path, verify=False)
            with open(path, "rb") as fh:   # one handle per input, not per basket
                def payloads(entry):
                    for b in entry["baskets"]:
                        fh.seek(b["offset"])
                        yield fh.read(b["meta"]["comp_len"]), b["meta"]

                for name in f.branch_names():
                    entry = f.branches[name]
                    out_name = rename(path, name) if rename else name
                    w.write_precompressed(
                        out_name,
                        dtype=entry["dtype"], shape=entry["shape"],
                        config=entry["config"],
                        dictionary=entry["dictionary"],
                        baskets=payloads(entry))
