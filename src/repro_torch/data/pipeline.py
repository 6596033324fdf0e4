"""LM token pipeline over compressed BasketFiles (the port's copy of
``repro/data/pipeline.py``).

The hot read path is the paper's "simultaneous read and decompression for
multiple physics events" (Fig. 1): a background prefetch thread reads
shard files and decompresses baskets in a thread pool while the device
computes, and tokens flow out as fixed-shape (batch, seq+1) windows.

Fault-tolerance / scale properties:
  * **deterministic host sharding** — shard files are assigned
    round-robin by (host_id, n_hosts); every host sees a disjoint stream,
    and re-running with the same ids reproduces it exactly;
  * **remote shards** — the reference's ``repro://host:port/file.bskt``
    URLs need ``remote``, which is not ported yet: they raise
    ``NotImplementedError`` (ROADMAP A9);
  * **exact restart cursor** — the pipeline state is (epoch, file index,
    window index); ``state_dict()``/``load_state_dict()`` round-trip it, so
    a restore resumes mid-shard with no token skew (basket index = restart
    cursor);
  * **bounded prefetch** — a depth-limited queue, so a slow (straggler)
    consumer never lets the reader run unboundedly ahead.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.bfile import BasketFile, BasketWriter
from repro_torch.core.policy import choose
from repro_torch.io.engine import CompressionEngine
from repro_torch.io.prefetch import PrefetchReader

__all__ = ["write_token_shards", "TokenPipeline"]


def write_token_shards(paths: list[str], *, vocab: int, tokens_per_shard: int,
                       seed: int = 0, profile: str = "analysis",
                       tune: bool = False, objective=None,
                       tuner=None) -> None:
    """Synthetic LM corpus: Zipf-ish token stream, one branch per shard.
    Real deployments swap the generator for a tokenized corpus; the
    container/codec path is identical.

    ``tune=True`` (or an ``objective=`` / explicit ``tuner=``) replaces the
    static profile with measurement-driven selection (repro_torch.tune):
    the first shard runs the trial matrix on its sampled tokens, and every
    later shard reuses that cached decision — the tuner is shared across
    shards, so tuning cost is paid once per corpus, and each shard's
    header carries the decision for re-opens."""
    if tuner is None and (tune or objective is not None):
        from repro_torch.tune import Tuner
        tuner = Tuner(objective if objective is not None else "max_read_tput",
                      fallback_profile=profile)
    for i, path in enumerate(paths):
        rng = np.random.default_rng(seed + 1000 * i)
        # Zipf-distributed ids compress like natural text-token streams
        toks = rng.zipf(1.3, tokens_per_shard).astype(np.int64)
        toks = (toks % (vocab - 2)) + 2           # reserve 0=pad, 1=eos
        toks = toks.astype(np.int32)
        with BasketWriter(path, tuner=tuner) as w:
            w.write_branch("tokens", toks,
                           None if tuner else choose("tokens", toks, profile))


class TokenPipeline:
    """Iterator of {"tokens","targets"} batches with prefetch + restart."""

    def __init__(self, paths: list[str], *, batch: int, seq_len: int,
                 host_id: int = 0, n_hosts: int = 1,
                 prefetch: int = 4, decomp_workers: int = 4,
                 prefetch_baskets: int = 4, readahead_files: int = 1,
                 seed: int = 0):
        if not paths:
            raise ValueError("no shard paths")
        self.all_paths = list(paths)
        self.my_paths = [p for i, p in enumerate(paths)
                         if i % n_hosts == host_id] or [paths[host_id % len(paths)]]
        self.batch = batch
        self.seq_len = seq_len
        self.prefetch = prefetch
        self.decomp_workers = decomp_workers
        self.prefetch_baskets = prefetch_baskets
        self.readahead_files = readahead_files
        self.seed = seed
        # restart cursor
        self.epoch = 0
        self.file_idx = 0
        self.window_idx = 0
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # one shared engine decompresses every shard (repro.io); a 1-deep
        # file readahead slot decompresses shard i+1 while i's windows flow
        self._io_engine: Optional[CompressionEngine] = None
        self._ra_pool: Optional[ThreadPoolExecutor] = None

    # -- cursor ----------------------------------------------------------

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "file_idx": self.file_idx,
                "window_idx": self.window_idx, "seed": self.seed}

    def load_state_dict(self, st: dict) -> None:
        self._shutdown()
        self.epoch = int(st["epoch"])
        self.file_idx = int(st["file_idx"])
        self.window_idx = int(st["window_idx"])
        self.seed = int(st.get("seed", self.seed))

    # -- iteration -------------------------------------------------------

    def _windows_of_file(self, path: str) -> np.ndarray:
        """Decompress one shard through the prefetching reader: all baskets
        scheduled on the shared engine, joined in entry order (the
        simultaneous-read-and-decompress hot path).  ``repro://`` shard
        URLs raise: ``remote`` is not ported yet."""
        if self._stop.is_set():
            # a straggler producer must not recreate the engine that
            # _shutdown just closed (it would leak); die quietly instead
            raise RuntimeError("pipeline closed")
        if self._io_engine is None:
            self._io_engine = CompressionEngine(self.decomp_workers)
        remote = path.startswith("repro://")
        if remote:
            raise NotImplementedError(
                f"remote shards ({path}) are not ported yet: ROADMAP.md A9, "
                "'remote in the port'")
        bfile = BasketFile(path)
        try:
            reader = PrefetchReader(bfile, "tokens",
                                    ahead=self.prefetch_baskets,
                                    engine=self._io_engine)
            try:
                with obs.trace.span("pipeline.shard", cat="data", path=path,
                                    remote=remote):
                    toks = reader.read_all()
            finally:
                reader.close()
        finally:
            if remote:
                bfile.close()
        obs.counter("pipeline.shards", remote=str(remote).lower()).inc()
        w = self.seq_len + 1
        n_win = toks.size // w
        return toks[: n_win * w].reshape(n_win, w)

    def _producer(self):
        # local cursor: the consumer concurrently rewrites self.epoch/
        # file_idx/window_idx to the cursor of each *consumed* batch (the
        # state to persist), so the producer must never re-read those
        # attributes mid-run — it snapshots them once at thread start
        ra: Optional[tuple] = None       # (path, Future[windows]) readahead
        epoch, file_idx, window_idx = self.epoch, self.file_idx, self.window_idx
        try:
            while not self._stop.is_set():
                path = self.my_paths[file_idx % len(self.my_paths)]
                if ra is not None and ra[0] == path:
                    wins = ra[1].result()
                else:
                    wins = self._windows_of_file(path)
                ra = None
                if self.readahead_files and len(self.my_paths) > 1:
                    nxt = self.my_paths[(file_idx + 1)
                                        % len(self.my_paths)]
                    if self._ra_pool is None:
                        self._ra_pool = ThreadPoolExecutor(
                            1, thread_name_prefix="repro-io-ra")
                    ra = (nxt, self._ra_pool.submit(
                        self._windows_of_file, nxt))
                # deterministic per-(epoch,file) shuffle of window order
                rng = np.random.default_rng(
                    (self.seed, epoch, file_idx))
                order = rng.permutation(len(wins))
                wi = window_idx
                while wi + self.batch <= len(wins):
                    if self._stop.is_set():
                        return
                    idx = order[wi: wi + self.batch]
                    chunk = wins[idx]
                    batch = {"tokens": chunk[:, :-1].astype(np.int32),
                             "targets": chunk[:, 1:].astype(np.int32)}
                    cursor = {"epoch": epoch, "file_idx": file_idx,
                              "window_idx": wi + self.batch, "seed": self.seed}
                    self._q.put((batch, cursor))
                    obs.gauge("pipeline.queue_depth").set(self._q.qsize())
                    wi += self.batch
                window_idx = 0
                file_idx += 1
                if file_idx % len(self.my_paths) == 0:
                    epoch += 1
        except Exception as e:  # surface reader errors to the consumer
            self._q.put(e)

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._q = queue.Queue(maxsize=self.prefetch)
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()

    def _shutdown(self):
        if self._thread is not None:
            self._stop.set()
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # straggler still decompressing: leave the pools to it
                # (it exits at the next stop check) rather than closing
                # an engine that is mid-use
                return
            self._thread = None
        if self._ra_pool is not None:
            self._ra_pool.shutdown(wait=True, cancel_futures=True)
            self._ra_pool = None
        if self._io_engine is not None:
            self._io_engine.close()
            self._io_engine = None

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        self._ensure_thread()
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        batch, cursor = item
        obs.counter("pipeline.batches").inc()
        # the cursor of the batch just handed out = state to persist
        self.epoch = cursor["epoch"]
        self.file_idx = cursor["file_idx"]
        self.window_idx = cursor["window_idx"]
        return batch

    def close(self):
        self._shutdown()
