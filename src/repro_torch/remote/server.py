"""The basket server — an xrootd-analogue content service for BasketFiles.

One process exports a directory tree of containers.  Every connection is a
handler thread (threaded socket server), but the expensive shared state is
engine-wide, exactly like the local stack:

* **one** :class:`~repro_torch.io.engine.CompressionEngine` serves every
  connection's transcode work (the C archive codecs release the GIL, so a
  vectored request's baskets decode across the pool);
* **one** fd per container via ``repro_torch.io.fdcache`` — a thousand clients
  hitting one file share a single descriptor and positional ``pread``s;
* **one** catalog entry per open container (TOC + tuning decisions +
  generation), revalidated by ``(st_dev, st_ino)`` on every touch, so an
  atomically-replaced file flips to a new catalog generation instead of
  serving baskets sliced with the old TOC.

The request that matters is ``READV``: many (branch, basket) ranges per
round-trip.  The server maps them to on-disk byte ranges, coalesces those
into large sequential ``pread``s (:func:`repro_torch.remote.protocol.coalesce`),
slices each basket back out of the merged buffers, optionally transcodes
archive-tier payloads for the wire (``repro_torch.remote.transcode``), and
answers with one frame.  Request vectorization + coalescing is where the
latency win comes from (arXiv:1804.03326's vector-read argument); the
per-request transcode is where the archive/analysis split is served from
one copy of the data.

Degradation under load is graceful, not accidental (DESIGN.md §14): a
bounded admission gate (``max_inflight`` concurrent requests, then a
bounded wait queue) sheds excess work with ``RESP_BUSY`` + a load-scaled
retry-after instead of queueing unboundedly until every client times out;
idle connections are reaped after ``idle_timeout``; and ``close()`` drains
— in-flight requests finish (bounded by ``drain_timeout``) before
lingering connections are forcibly closed.
"""

from __future__ import annotations

import logging
import os
import socket
import socketserver
import threading
import time
from typing import Optional

from repro_torch import obs
from repro_torch.core.bfile import BasketFile
from repro_torch.io import fdcache
from repro_torch.io.engine import CompressionEngine

from . import protocol as P
from . import transcode as T

__all__ = ["BasketServer"]

_LOG = logging.getLogger("repro_torch.remote")


class _Catalog:
    """One open container: reader (TOC), generation, decoded dictionaries."""

    __slots__ = ("bf", "generation", "dicts")

    def __init__(self, abspath: str, heal=None):
        # verify=False: the server never decodes raw bytes on the plain
        # path (transcode verifies content equality via stored_len and the
        # client re-verifies the raw checksum end-to-end).  heal="auto"
        # (the self-healing server) arms in-place parity reconstruction
        # for the verify-on-serve path (_readv) and the scrubber.
        self.bf = BasketFile(abspath, verify=False, heal=heal)
        self.generation = self.bf.generation
        self.dicts = {name: self.bf._dictionary(entry)
                      for name, entry in self.bf.branches.items()}


class _Handler(socketserver.StreamRequestHandler):
    def setup(self):
        super().setup()
        srv: "BasketServer" = self.server.basket_server
        # per-connection idle reaping: a client that stops talking (or a
        # half-open TCP ghost) releases its handler thread instead of
        # pinning it forever
        if srv.idle_timeout:
            self.connection.settimeout(srv.idle_timeout)
        srv._register(self.connection)

    def finish(self):
        self.server.basket_server._unregister(self.connection)
        try:
            super().finish()
        except OSError:
            pass                    # drain force-closed the socket under us

    def handle(self):
        srv: "BasketServer" = self.server.basket_server
        peer = "%s:%s" % (self.client_address[0], self.client_address[1])
        seq = 0                     # per-connection request sequence
        while not srv._draining.is_set():
            try:
                ftype, body, _payload = P.read_frame(self.rfile)
            except EOFError:
                return
            except (socket.timeout, TimeoutError):
                obs.counter("server.idle_closed").inc()
                return
            except P.ProtocolError as e:
                # malformed frame: answer once, then drop the connection —
                # framing is gone, nothing later on this stream is trusted
                obs.counter("server.errors", verb="protocol").inc()
                try:
                    self._reply(P.RESP_ERROR, {"error": f"protocol: {e}"})
                except OSError:
                    pass
                return
            except OSError:
                return              # force-closed mid-read (drain)
            seq += 1
            verb = P.VERB_NAMES.get(ftype, str(ftype))
            if not srv._admit():
                # saturated: shed with a load-scaled retry-after rather
                # than queueing until every waiting client times out
                obs.counter("server.shed").inc()
                try:
                    self._reply(P.RESP_BUSY, {"error": "busy",
                                              "retry_after_s":
                                              srv._retry_after()})
                except OSError:
                    return
                continue
            t0 = time.perf_counter()
            try:
                # adopt the caller's traceparent (if any rode in) so the
                # serve span — and every span below it, pread/transcode/
                # engine — chains into the client's trace (DESIGN.md §16)
                with obs.context.activated(body.get("tp")), \
                        obs.trace.span("rbsp.serve", cat="server", verb=verb):
                    if ftype == P.REQ_PING:
                        self._reply(P.RESP_PING, {"ok": True})
                    elif ftype == P.REQ_CATALOG:
                        self._reply(P.RESP_CATALOG, srv._catalog_body(body))
                    elif ftype == P.REQ_READV:
                        rbody, payload = srv._readv(body)
                        self._reply(P.RESP_READV, rbody, payload)
                    elif ftype == P.REQ_STATS:
                        self._reply(P.RESP_STATS, srv._stats_body(body))
                    elif ftype == P.REQ_SCRUB:
                        self._reply(P.RESP_SCRUB, srv._scrub_body(body))
                    elif ftype == P.REQ_PROF:
                        self._reply(P.RESP_PROF, srv._prof_body(body))
                    else:
                        self._reply(P.RESP_ERROR,
                                    {"error": f"unexpected frame type {ftype}"})
                obs.counter("server.requests", verb=verb).inc()
                obs.histogram("server.request_s", verb=verb).observe(
                    time.perf_counter() - t0)
                if srv.heatlog is not None:
                    srv.heatlog.maybe_flush()
            except BrokenPipeError:
                return
            except (socket.timeout, TimeoutError):
                return              # peer stopped reading our reply
            except Exception as e:   # per-request fault isolation
                obs.counter("server.errors", verb=verb).inc()
                _LOG.warning("request failed (peer=%s seq=%d verb=%s): %r",
                             peer, seq, verb, e)
                try:
                    self._reply(P.RESP_ERROR, {"error": str(e)})
                except OSError:
                    return
            finally:
                srv._finish_request()

    def _reply(self, ftype: int, body: dict, payload: bytes = b"") -> None:
        self.wfile.write(P.pack_frame(ftype, body, payload))
        self.wfile.flush()


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    # small request/response frames must not sit in Nagle/delayed-ACK
    # limbo — a vectored protocol lives or dies by per-round-trip latency
    disable_nagle_algorithm = True


class BasketServer:
    """Serve a directory of BasketFiles over RBSP.

    ``port=0`` binds an ephemeral port (read it back from :attr:`port`) —
    the test/benchmark loopback pattern.  ``transcode=False`` disables
    wire transcoding server-wide regardless of what clients request.

    Load/lifecycle knobs: at most ``max_inflight`` requests execute
    concurrently; up to ``admit_queue`` more wait (each at most
    ``admit_timeout`` seconds) before being shed with ``RESP_BUSY``;
    connections idle longer than ``idle_timeout`` are closed; ``close()``
    lets in-flight requests finish for up to ``drain_timeout`` seconds
    before force-closing what remains.

    Self-healing (DESIGN.md §15): ``heal="auto"`` makes READV
    verify-on-serve — every basket slice is decode-verified before it
    goes on the wire, and a failing one is reconstructed in place from
    its parity stripe (repro_torch.repair) rather than served corrupt.
    ``scrub_mbps`` additionally runs a background :class:`Scrubber`
    thread over the export root at that byte-rate budget (started with
    the server, drained with ``close()``); the RBSP ``SCRUB`` verb
    inspects/triggers it.
    """

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0,
                 workers: int = 4, transcode: bool = True,
                 max_gap: int = 64 << 10, max_span: int = 8 << 20,
                 engine: Optional[CompressionEngine] = None,
                 max_inflight: int = 32, admit_queue: int = 128,
                 admit_timeout: float = 5.0, idle_timeout: float = 600.0,
                 drain_timeout: float = 10.0, heal: Optional[str] = None,
                 scrub_mbps: Optional[float] = None,
                 scrub_interval: float = 30.0,
                 heat: bool = True, heat_halflife_s: float = 3600.0,
                 heat_flush_s: float = 30.0,
                 slo=True):
        self.root = os.path.abspath(root)
        if not os.path.isdir(self.root):
            raise NotADirectoryError(self.root)
        self.transcode = bool(transcode)
        self.max_gap = int(max_gap)
        self.max_span = int(max_span)
        self.max_inflight = max(int(max_inflight), 1)
        self.admit_queue = max(int(admit_queue), 0)
        self.admit_timeout = float(admit_timeout)
        self.idle_timeout = float(idle_timeout)
        self.drain_timeout = float(drain_timeout)
        if heal not in (None, "auto"):
            raise ValueError(f"heal must be None or 'auto', got {heal!r}")
        self.heal = heal
        self._scrubber = None
        if scrub_mbps is not None:
            from repro_torch.repair import Scrubber
            self._scrubber = Scrubber(self.root, mbps=scrub_mbps or None,
                                      heal=heal is not None,
                                      interval=scrub_interval)
        # durable access-heat telemetry + rolling SLO verdicts (§16).
        # heat=False turns the sidecars off (read-only serving roots);
        # slo may be False/None, True (defaults), or a list of SLOSpec.
        from repro_torch.obs.heat import HeatLog
        from repro_torch.obs.slo import SLOEngine
        self.heatlog = HeatLog(halflife_s=heat_halflife_s,
                               flush_interval_s=heat_flush_s) \
            if heat else None
        if slo is True:
            self.slo_engine: Optional[SLOEngine] = SLOEngine()
        elif slo:
            self.slo_engine = SLOEngine(slo)
        else:
            self.slo_engine = None
        self.engine = engine if engine is not None \
            else CompressionEngine(workers)
        self._owns_engine = engine is None
        self._catalogs: dict[str, _Catalog] = {}
        self._cat_lock = threading.Lock()
        # admission gate: a semaphore bounds concurrency; the queued
        # counter bounds how many may *wait* for a slot
        self._sem = threading.BoundedSemaphore(self.max_inflight)
        self._load_cond = threading.Condition()
        self._inflight = 0
        self._queued = 0
        self._draining = threading.Event()
        self._conns: set = set()
        self._conn_lock = threading.Lock()
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.basket_server = self
        self._thread: Optional[threading.Thread] = None
        self._serving = False
        self._closed = False
        # stats (under _stat_lock)
        self._stat_lock = threading.Lock()
        self.stats = {"requests": 0, "baskets_served": 0, "preads": 0,
                      "bytes_disk": 0, "bytes_wire": 0, "transcoded": 0}
        self._stats_gen = 0           # bumps per STATS response (under lock)
        self._t_start = time.time()

    # -- admission / load shedding ---------------------------------------

    def _register(self, conn) -> None:
        with self._conn_lock:
            self._conns.add(conn)

    def _unregister(self, conn) -> None:
        with self._conn_lock:
            self._conns.discard(conn)

    def _admit(self) -> bool:
        """Take an execution slot, waiting in the bounded admission queue
        when the pool is saturated.  False means the request must be shed."""
        if self._sem.acquire(blocking=False):
            with self._load_cond:
                self._inflight += 1
            return True
        with self._load_cond:
            if self._queued >= self.admit_queue or self._draining.is_set():
                return False
            self._queued += 1
        ok = self._sem.acquire(timeout=self.admit_timeout)
        with self._load_cond:
            self._queued -= 1
            if ok:
                self._inflight += 1
        return ok

    def _finish_request(self) -> None:
        with self._load_cond:
            self._inflight -= 1
            self._load_cond.notify_all()
        self._sem.release()

    def _retry_after(self) -> float:
        """The shed response's suggested delay, scaled with queue depth so
        a deeper backlog spreads retries further out."""
        with self._load_cond:
            q = self._queued
        return round(min(1.0, 0.02 + 0.01 * q), 4)

    # -- lifecycle -------------------------------------------------------

    @property
    def host(self) -> str:
        return self._tcp.server_address[0]

    @property
    def port(self) -> int:
        return self._tcp.server_address[1]

    def url(self, rel_path: str) -> str:
        return P.format_url(self.host, self.port, rel_path)

    def start(self) -> "BasketServer":
        """Serve on a daemon thread (the embedded / test mode)."""
        self._serving = True
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True, name="repro-bserve")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread (the CLI mode)."""
        self._serving = True
        self._tcp.serve_forever()

    def close(self) -> None:
        """Drain-then-close: stop accepting, let in-flight requests finish
        (bounded by ``drain_timeout``), then force-close lingering
        connections so blocked reads unblock and handler threads exit."""
        if self._closed:
            return
        self._closed = True
        self._draining.set()
        if self._scrubber is not None:
            self._scrubber.close()
        if self._serving:
            # shutdown() blocks on an event only serve_forever() sets —
            # calling it on a bound-but-never-served server deadlocks
            self._tcp.shutdown()
        self._tcp.server_close()
        deadline = time.monotonic() + self.drain_timeout
        with self._load_cond:
            while self._inflight > 0:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    _LOG.warning("drain timeout with %d requests in flight",
                                 self._inflight)
                    break
                self._load_cond.wait(timeout=remain)
        # idle handlers are still blocked in read_frame; yank their
        # sockets so the threads exit instead of waiting out idle_timeout
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.heatlog is not None:   # final durable fold of access heat
            self.heatlog.flush()
        with self._cat_lock:
            cats, self._catalogs = list(self._catalogs.values()), {}
        for c in cats:
            c.bf.close()
        if self._owns_engine:
            self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- catalog ---------------------------------------------------------

    def _resolve(self, rel: str) -> str:
        """Map a request path onto the export root; reject escapes."""
        rel = str(rel)
        norm = os.path.normpath(rel)
        if os.path.isabs(norm) or norm.startswith("..") or norm == ".":
            raise ValueError(f"invalid path {rel!r}")
        return os.path.join(self.root, norm)

    def _catalog(self, rel: str) -> _Catalog:
        """The open container for ``rel``, revalidated by generation: a
        replaced file atomically swaps to a fresh catalog (the old reader
        is closed, releasing its cached fd — long-lived servers must not
        pin unlinked inodes)."""
        abspath = self._resolve(rel)
        with self._cat_lock:
            cat = self._catalogs.get(rel)
            if cat is not None:
                try:
                    if fdcache.generation(abspath) == cat.generation:
                        return cat
                except OSError:
                    pass
                del self._catalogs[rel]
                cat.bf.close()
            cat = _Catalog(abspath, heal=self.heal)
            self._catalogs[rel] = cat
            return cat

    def _catalog_body(self, body: dict) -> dict:
        cat = self._catalog(body["path"])
        return {
            "path": body["path"],
            "generation": list(cat.generation),
            "branches": cat.bf.branches,
            # canonical JSON sorts keys; the TOC's branch order is API
            # (branch_names() mirrors the write order), so carry it aside
            "order": list(cat.bf.branches),
            "tuning": cat.bf.tuning,
            "transcode": self.transcode,
        }

    # -- observability ---------------------------------------------------

    @staticmethod
    def _filter_snapshot(snap: dict, prefixes) -> dict:
        """Restrict a registry snapshot to metric-name prefixes (labels
        are part of the key but prefixes match the *name*)."""
        if isinstance(prefixes, str):
            prefixes = [prefixes]
        pfx = tuple(str(p) for p in prefixes)
        out = {}
        for kind, metrics in snap.items():
            out[kind] = {k: v for k, v in metrics.items()
                         if k.startswith(pfx)}
        return out

    def _stats_body(self, body: dict) -> dict:
        """The ``STATS`` response: generation-stamped snapshot of the
        process-wide obs registry plus this server's stats dict.  The
        generation is a per-server monotonic counter so a monitor can
        tell two polls apart (and detect a restarted server by a reset).
        ``"trace": true`` drains the span ring into the response — each
        buffered event leaves the server exactly once.  ``"filter"`` (a
        metric-name prefix or list of prefixes) trims the shipped
        registry; a bare poll still gets everything.  ``"heat": true``
        includes the access-heat snapshot.  Each poll also ticks the SLO
        engine, whose rolling verdicts ride the ``"slo"`` key."""
        with self._stat_lock:
            self._stats_gen += 1
            gen = self._stats_gen
            server_stats = dict(self.stats)
        snap = obs.snapshot()
        out = {"gen": gen, "pid": os.getpid(),
               "uptime_s": time.time() - self._t_start,
               "server": server_stats,
               "metrics": snap}
        if self.slo_engine is not None:
            with self._stat_lock:
                self.slo_engine.tick(snap)
                out["slo"] = self.slo_engine.evaluate()
        flt = body.get("filter")
        if flt:
            out["metrics"] = self._filter_snapshot(snap, flt)
        if body.get("heat") and self.heatlog is not None:
            out["heat"] = self.heatlog.snapshot()
        if body.get("trace"):
            out["trace_events"] = obs.trace.drain()
        if body.get("profile"):
            # the --watch profiler section's input: status + per-function
            # self counts, never the full fold table (that is PROF fetch)
            pstat = obs.profile.status()
            pstat["self"] = obs.profile.self_counts()
            out["profile"] = pstat
        return out

    # -- continuous profiling control (PROF verb) ------------------------

    def _prof_body(self, body: dict) -> dict:
        """The ``PROF`` verb (DESIGN.md §17): ``start``/``stop`` manage
        this process's sampling profiler, ``status`` reports it, and
        ``fetch`` ships the profile document (fold table + span trace ids
        + memory watermarks; ``reset: true`` drains, so successive fetches
        cover disjoint windows)."""
        action = body.get("action", "status")
        if action == "start":
            hz = float(body.get("hz") or obs.profile.DEFAULT_HZ)
            started = obs.profile.start(hz=hz, mem=body.get("mem") or False)
            return {"started": started, "profile": obs.profile.status()}
        if action == "stop":
            obs.profile.stop()
            return {"stopped": True, "profile": obs.profile.status()}
        if action == "status":
            return {"profile": obs.profile.status()}
        if action == "fetch":
            # fold the pool workers' samples in first so a remote
            # flamegraph includes process-pool stacks, like collect_obs
            self.engine.collect_obs()
            return {"profile": obs.profile.snapshot(
                reset=bool(body.get("reset")))}
        raise ValueError(f"unknown prof action {action!r}")

    # -- self-healing control (SCRUB verb) -------------------------------

    def _scrub_body(self, body: dict) -> dict:
        """The ``SCRUB`` verb: ``status`` / ``trigger`` poke the
        background scrubber; ``scrub`` runs one synchronous pass (of a
        single container when ``path`` is given, else the whole root) on
        this request's thread and returns the reports."""
        action = body.get("action", "status")
        if action == "status":
            return {"scrubber": self._scrubber.status()
                    if self._scrubber is not None else None,
                    "heal": self.heal}
        if action == "trigger":
            if self._scrubber is None:
                raise ValueError("no background scrubber configured "
                                 "(start the server with scrub_mbps=)")
            self._scrubber.trigger()
            return {"triggered": True}
        if action == "scrub":
            rel = body.get("path")
            if self._scrubber is not None:
                reports = self._scrubber.scrub_now(rel)
            else:
                from repro_torch.repair import scrub_container
                if rel is not None:
                    reports = [scrub_container(self._resolve(rel),
                                               heal=self.heal is not None)]
                else:
                    reports = []
                    for dirpath, _d, files in os.walk(self.root):
                        for fn in sorted(files):
                            if fn.endswith(".bskt"):
                                reports.append(scrub_container(
                                    os.path.join(dirpath, fn),
                                    heal=self.heal is not None))
            for r in reports:
                r["path"] = os.path.relpath(r["path"], self.root) \
                    if os.path.isabs(r["path"]) else r["path"]
            return {"reports": reports}
        raise ValueError(f"unknown scrub action {action!r}")

    # -- vectored reads --------------------------------------------------

    def _readv(self, body: dict) -> tuple[dict, bytes]:
        with obs.profile.mem_phase("server.readv"):
            return self._readv_inner(body)

    def _readv_inner(self, body: dict) -> tuple[dict, bytes]:
        rel = body["path"]
        cat = self._catalog(rel)
        gen = body.get("generation")
        if gen is not None and tuple(gen) != cat.generation:
            raise ValueError(
                f"stale generation {tuple(gen)} for {rel!r} "
                f"(current {cat.generation}); re-open the catalog")
        abspath = self._resolve(rel)
        wants = body.get("baskets") or []
        ranges = []
        metas = []
        for branch, idx in wants:
            entry = cat.bf.branches.get(branch)
            if entry is None:
                raise KeyError(f"no branch {branch!r} in {rel!r}")
            idx = int(idx)
            if not 0 <= idx < len(entry["baskets"]):
                raise IndexError(f"basket {idx} out of range for "
                                 f"{branch!r} ({len(entry['baskets'])})")
            b = entry["baskets"][idx]
            ranges.append((int(b["offset"]), int(b["meta"]["comp_len"])))
            metas.append(dict(b["meta"]))

        # per-branch access telemetry: the repacker's input signal.  One
        # locked add per (path, branch) pair per request, not per basket;
        # the heat log additionally folds basket indices + byte volume
        # into its durable per-container EWMA state.
        per_branch: dict[str, list] = {}    # branch -> [idx list, bytes]
        for i, (branch, idx) in enumerate(wants):
            rec = per_branch.setdefault(branch, [[], 0])
            rec[0].append(int(idx))
            rec[1] += ranges[i][1]
        for branch, (idxs, nbytes) in per_branch.items():
            obs.counter("server.reads", path=rel, branch=branch).inc(
                len(idxs))
            if self.heatlog is not None:
                self.heatlog.record(abspath, branch, idxs, nbytes)

        merged = P.coalesce(ranges, self.max_gap, self.max_span)
        payloads: list[Optional[bytes]] = [None] * len(wants)
        disk_bytes = 0
        with obs.trace.span("server.pread", cat="server", path=rel,
                            preads=len(merged)):
            for off, ln, members in merged:
                buf = fdcache.pread(abspath, off, ln, expect=cat.generation)
                disk_bytes += ln
                for i in members:
                    r_off, r_len = ranges[i]
                    payloads[i] = buf[r_off - off: r_off - off + r_len]

        if self.heal is not None:
            # verify-on-serve: a slice that fails its decode-verify is
            # healed from parity (in place — the generation survives) and
            # re-read before it ever reaches the wire.  Best-effort: an
            # unhealable basket (double-damaged stripe, no sidecar) is
            # served as-is so the *client's* end-to-end checksum + cross-
            # replica quarantine takes over — a hard error here would turn
            # damage one replica can't fix into damage no replica serves.
            from repro_torch.core.bfile import CorruptBasketError
            for i, (branch, idx) in enumerate(wants):
                try:
                    payloads[i] = cat.bf.ensure_payload(branch, int(idx),
                                                        payloads[i])
                except CorruptBasketError as e:
                    _LOG.warning("verify-on-serve: unhealable basket "
                                 "served damaged: %s", e)

        n_trans = 0
        wire = body.get("wire")
        if wire and self.transcode:
            accept = wire.get("accept") or list(T.DEFAULT_ACCEPT)
            objective = wire.get("objective", "max_read_tput")
            link = float(wire.get("link_mbps") or T.DEFAULT_LINK_MBPS)
            items = [(payloads[i], metas[i], cat.dicts[wants[i][0]])
                     for i in range(len(wants))]
            out = T.transcode_many(items, objective, accept,
                                   engine=self.engine, link_mbps=link)
            for i, (wp, wm) in enumerate(out):
                n_trans += wm is not metas[i]    # kept baskets pass through
                payloads[i], metas[i] = wp, wm

        resp_baskets = []
        for (branch, idx), m, p in zip(wants, metas, payloads):
            resp_baskets.append({"branch": branch, "index": int(idx),
                                 "len": len(p), "meta": m})
        payload = b"".join(payloads)
        with self._stat_lock:
            self.stats["requests"] += 1
            self.stats["baskets_served"] += len(wants)
            self.stats["preads"] += len(merged)
            self.stats["bytes_disk"] += disk_bytes
            self.stats["bytes_wire"] += len(payload)
            self.stats["transcoded"] += n_trans
        obs.counter("server.baskets_served").inc(len(wants))
        obs.counter("server.bytes_disk").inc(disk_bytes)
        obs.counter("server.bytes_wire").inc(len(payload))
        obs.histogram("server.readv_baskets").observe(len(wants))
        return {"path": rel, "generation": list(cat.generation),
                "baskets": resp_baskets}, payload
