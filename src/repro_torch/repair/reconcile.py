"""Anti-entropy replica repair — converge damaged/divergent replicas.

The remote client leaves cross-replica damage as a *read-side* workaround: a client
whose basket fails its checksum refetches from another replica, and
mismatched replicas raise :exc:`ReplicaMismatchError`.  The disk damage
stayed.  This module is the write-side fix:

* :func:`diff_catalogs` — compare per-basket ``(checksum, orig_len,
  entry_start)`` across replica catalogs (the same fields the client's
  compat check trusts) and name every basket where they disagree.

* :func:`repair_replica` — heal one local replica using its peers:

  1. scrub the local container (parity heals what parity can);
  2. for baskets parity could **not** heal (double-damaged stripes, no
     sidecar), pull the original payload bytes from a peer whose catalog
     checksum matches the local TOC, decode-verify, and patch them back
     in place — same inode, readers stay valid;
  3. for baskets whose *TOC metadata itself* diverges across replicas,
     pick the majority version (deterministic tie-break, so every
     replica independently converges to the same winner), pull the
     winning payloads, and rewrite the container through the
     atomic-commit path (tmp → fsync → rename → dir fsync), regenerating
     the parity sidecar if the replica had one.

Nothing is ever written that did not first decode and match the checksum
it claims — a lying peer can fail a repair, never corrupt a replica.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from repro_torch.core.basket import BasketMeta, unpack_basket
from repro_torch.core.bfile import BasketFile, BasketWriter

from .scrub import scrub_container
from .stripe import parity_path

__all__ = ["diff_catalogs", "repair_replica"]


def _counter(name: str, n: int = 1) -> None:
    try:
        from repro_torch import obs
        obs.counter(name).inc(n)
    except Exception:
        pass


def _basket_key(meta: dict) -> tuple:
    """The content identity of one basket — what replicas must agree on.
    Offsets and wire compression are *not* identity (a replica may be
    repacked); decoded bytes are."""
    return (int(meta["checksum"]), int(meta["orig_len"]),
            int(meta["entry_start"]), int(meta["entry_count"]))


def diff_catalogs(catalogs: dict) -> list[dict]:
    """Per-basket disagreements across replica catalogs.

    ``catalogs`` maps a replica label (endpoint, path, anything hashable)
    to its ``branches`` dict (the CATALOG / TOC shape).  Returns one
    record per basket where any replica's content key differs::

        [{"branch", "index", "keys": {label: (checksum, orig_len,
          entry_start, entry_count) | None}}, ...]

    ``None`` marks a replica missing that branch/basket entirely.
    """
    all_branches: set[str] = set()
    for bs in catalogs.values():
        all_branches.update(bs)
    out = []
    for name in sorted(all_branches):
        depth = max(len(bs.get(name, {}).get("baskets", []))
                    for bs in catalogs.values())
        for i in range(depth):
            keys = {}
            for label, bs in catalogs.items():
                baskets = bs.get(name, {}).get("baskets", [])
                keys[label] = _basket_key(baskets[i]["meta"]) \
                    if i < len(baskets) else None
            if len(set(keys.values())) > 1:
                out.append({"branch": name, "index": i, "keys": keys})
    return out


def _quorum_key(keys: dict) -> tuple:
    """The winning content key: majority vote, ties broken by the
    smallest key tuple — a pure function of the vote set, so every
    replica running reconcile independently picks the same winner."""
    votes: dict[tuple, int] = {}
    for k in keys.values():
        if k is not None:
            votes[k] = votes.get(k, 0) + 1
    return min(votes, key=lambda k: (-votes[k], k))


class _Peer:
    """One remote replica: lazy client + verified payload pulls."""

    def __init__(self, host: str, port: int, path: str,
                 timeout: float):
        self.ep = (str(host), int(port))
        self.path = path
        self.timeout = timeout
        self._rf = None
        self.dead = False

    def open(self):
        if self._rf is None and not self.dead:
            from repro_torch.remote.client import RemoteBasketFile
            try:
                # wire=None: payloads arrive as the peer's on-disk bytes,
                # exactly what gets patched/rewritten locally
                self._rf = RemoteBasketFile(
                    host=self.ep[0], port=self.ep[1], path=self.path,
                    wire=None, timeout=self.timeout, retries=3,
                    backoff=0.02)
            except Exception:
                self.dead = True
        return self._rf

    @property
    def branches(self) -> Optional[dict]:
        rf = self.open()
        return rf.branches if rf is not None else None

    def pull(self, branch: str, index: int, want_key: tuple,
             dictionary: Optional[bytes]) -> Optional[tuple[bytes, dict]]:
        """``(payload, meta_json)`` for one basket — only if this peer's
        catalog claims ``want_key`` *and* the bytes decode-verify to it."""
        rf = self.open()
        if rf is None:
            return None
        entry = rf.branches.get(branch)
        if entry is None or index >= len(entry["baskets"]):
            return None
        meta_json = entry["baskets"][index]["meta"]
        if _basket_key(meta_json) != want_key:
            return None
        try:
            pairs = rf.fetch_wire(branch, [index])
            payload, got_meta = pairs[0]
            meta = BasketMeta.from_json(got_meta)
            if _basket_key(got_meta) != want_key:
                return None
            unpack_basket(payload, meta, dictionary, verify=True)
            return bytes(payload), dict(got_meta)
        except Exception:
            return None

    def close(self) -> None:
        if self._rf is not None:
            try:
                self._rf.close()
            except Exception:
                pass
            self._rf = None


def repair_replica(local_path: str, path: str, endpoints: Sequence,
                   *, timeout: float = 10.0,
                   scrub_mbps: Optional[float] = None) -> dict:
    """Converge one local replica with its peers (see module docstring).

    ``local_path`` is the container on this host's disk; ``path`` is the
    name peers export it under (the RBSP catalog path); ``endpoints`` are
    ``(host, port)`` peers.  Returns a report::

        {"path", "scrub": {...}, "divergent", "pulled", "patched",
         "rewritten", "remaining": [[branch, index], ...], "converged"}

    ``remaining`` lists baskets still damaged after every source was
    tried — nonzero means the fleet has lost those bytes everywhere.
    """
    local_path = str(local_path)
    report = {"path": local_path, "divergent": 0, "pulled": 0,
              "patched": 0, "rewritten": False, "remaining": [],
              "converged": False}

    # 1. local scrub: parity heals what parity can, and names what it
    #    cannot (the pull list)
    scrub = scrub_container(local_path, heal=True, mbps=scrub_mbps)
    report["scrub"] = scrub
    if "error" in scrub:
        report["remaining"] = [["*", -1]]
        return report
    unhealable = [tuple(u) for u in scrub["unhealable"]]

    peers = [_Peer(h, p, path, timeout) for h, p in
             (tuple(e) for e in endpoints)]
    try:
        with BasketFile(local_path, verify=True) as bf:
            catalogs = {"local": bf.branches}
            for pr in peers:
                bs = pr.branches
                if bs is not None:
                    catalogs[pr.ep] = bs
            diverged = diff_catalogs(catalogs)
            report["divergent"] = len(diverged)
            _counter("repair.reconcile.divergent", len(diverged))

            # what each damaged/divergent basket *should* contain
            wanted: dict[tuple[str, int], tuple] = {}
            for name, i in unhealable:
                wanted[(name, i)] = _basket_key(
                    bf.branches[name]["baskets"][i]["meta"])
            losers: dict[tuple[str, int], tuple] = {}
            for d in diverged:
                key = _quorum_key(d["keys"])
                if d["keys"].get("local") != key:
                    losers[(d["branch"], d["index"])] = key
            wanted.update(losers)

            # 2. pull verified bytes for every wanted basket
            pulled: dict[tuple[str, int], tuple[bytes, dict]] = {}
            failed: list[tuple[str, int]] = []
            for (name, i), key in sorted(wanted.items()):
                entry = bf.branches.get(name, {})
                dictionary = bf._dictionary(entry) if entry else None
                got = None
                for pr in peers:
                    got = pr.pull(name, i, key, dictionary)
                    if got is not None:
                        break
                if got is None:
                    failed.append((name, i))
                else:
                    pulled[(name, i)] = got
                    report["pulled"] += 1
                    _counter("repair.reconcile.pulled")
            report["remaining"] = [list(t) for t in sorted(failed)]

            # 3a. same-metadata damage: patch in place (comp_len matches,
            #     the inode survives, open readers stay valid)
            in_place = {k: v for k, v in pulled.items() if k not in losers}
            if in_place:
                from repro_torch.io import fdcache
                for (name, i), (payload, _meta) in sorted(in_place.items()):
                    b = bf.branches[name]["baskets"][i]
                    fdcache.patch(local_path, int(b["offset"]), payload,
                                  expect=bf.generation)
                    report["patched"] += 1
                    _counter("repair.reconcile.patched")

            # 3b. divergent metadata: the TOC itself must change — rewrite
            #     the whole container through the atomic-commit path
            to_rewrite = {k: v for k, v in pulled.items() if k in losers}
            if to_rewrite:
                k_parity = 0
                if os.path.exists(parity_path(local_path)):
                    from .stripe import ParitySidecar
                    try:
                        k_parity = ParitySidecar.load(
                            parity_path(local_path)).k
                    except Exception:
                        k_parity = 0
                with BasketWriter(local_path, parity=k_parity) as w:
                    for name in bf.branch_names():
                        entry = bf.branches[name]
                        baskets = []
                        for i, b in enumerate(entry["baskets"]):
                            if (name, i) in to_rewrite:
                                payload, meta_json = to_rewrite[(name, i)]
                            else:
                                payload = bf.read_basket_payload(name, i)
                                meta_json = b["meta"]
                            baskets.append((payload, meta_json))
                        w.write_precompressed(
                            name, dtype=entry["dtype"],
                            shape=entry["shape"],
                            config=entry["config"],
                            dictionary=entry.get("dictionary"),
                            baskets=baskets)
                report["rewritten"] = True
                _counter("repair.reconcile.rewritten")
    finally:
        for pr in peers:
            pr.close()

    # 4. the proof: a fresh scrub of the converged replica
    post = scrub_container(local_path, heal=True, mbps=scrub_mbps)
    report["post_scrub"] = post
    report["converged"] = (not report["remaining"]
                           and post.get("completed", False)
                           and not post.get("unhealable"))
    return report
