"""Seeded fault plans — reproducible descriptions of what to break.

A :class:`FaultPlan` is a list of :class:`FaultRule`\\ s plus a seed.
Whether a rule fires for a given event is a pure function of
``(seed, rule index, connection id, direction, frame number)`` — a
blake2b hash mapped to [0, 1) and compared against the rule's
probability.  No RNG state, no ``random`` module: the same plan applied
to the same traffic fires the same faults, every run, in every process.
(Python's builtin ``hash()`` is deliberately *not* used — it is salted
per process, which is exactly the non-determinism this module exists to
remove.)

Rule kinds (what the proxy / pread hook does when a rule fires):

========  ============================================================
drop      swallow the frame (receiver waits → client times out)
delay     sleep ``delay_s`` before forwarding (stall; hedging bait)
reset     hard RST on the client-side socket (connection reset)
garble    flip one deterministic payload byte (corrupt frame/basket)
short     forward a prefix of the frame, then close (torn stream)
========  ============================================================

Triggers compose (all present must match): ``verb`` (catalog / readv /
ping / stats), ``direction`` (``"c2s"`` / ``"s2c"``), ``every`` (fire on
every Nth matching frame), ``after_byte`` (only once this many bytes
passed the connection), ``p`` (probability), ``max_fires`` (stop after K
firings, plan-wide per rule).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

__all__ = ["FaultRule", "FaultPlan", "parse_rule", "pread_fault_hook",
           "rot_container"]

KINDS = ("drop", "delay", "reset", "garble", "short")


@dataclass(frozen=True)
class FaultRule:
    """One kind of damage plus the conditions under which it happens."""
    kind: str
    p: float = 1.0                      # fire probability per match
    direction: Optional[str] = None     # "c2s" | "s2c" | None (both)
    verb: Optional[str] = None          # "readv", "catalog", ... | None
    every: Optional[int] = None         # fire on every Nth matching frame
    after_byte: Optional[int] = None    # only after N bytes on the conn
    delay_s: float = 0.05               # stall length for kind="delay"
    max_fires: Optional[int] = None     # total firing budget

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(want one of {KINDS})")
        if self.direction not in (None, "c2s", "s2c"):
            raise ValueError(f"direction must be c2s/s2c, not "
                             f"{self.direction!r}")


def _unit(seed: int, rule_idx: int, conn_id: int, direction: str,
          frame_no: int) -> float:
    """Deterministic uniform [0, 1) for one (rule, frame) event."""
    key = f"{seed}|{rule_idx}|{conn_id}|{direction}|{frame_no}".encode()
    h = hashlib.blake2b(key, digest_size=8).digest()
    return int.from_bytes(h, "little") / 2.0 ** 64


class FaultPlan:
    """A seeded set of rules; :meth:`decide` answers "which rules fire for
    this event".  Thread-safe (the proxy evaluates from pump threads)."""

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._fired = [0] * len(self.rules)

    def decide(self, *, conn_id: int = 0, direction: str = "c2s",
               verb: Optional[str] = None, frame_no: int = 0,
               offset: int = 0) -> list[FaultRule]:
        """The rules that fire for one frame event (usually 0 or 1)."""
        out = []
        for i, r in enumerate(self.rules):
            if r.direction is not None and r.direction != direction:
                continue
            if r.verb is not None and r.verb != verb:
                continue
            if r.after_byte is not None and offset < r.after_byte:
                continue
            if r.every is not None:
                if frame_no <= 0 or frame_no % r.every != 0:
                    continue
            if r.p < 1.0 and _unit(self.seed, i, conn_id, direction,
                                   frame_no) >= r.p:
                continue
            with self._lock:
                if r.max_fires is not None and self._fired[i] >= r.max_fires:
                    continue
                self._fired[i] += 1
            out.append(r)
        return out

    def counts(self) -> dict[str, int]:
        """Total firings per kind — soak gates assert every planned fault
        actually happened (a chaos run that injected nothing proves
        nothing)."""
        with self._lock:
            fired = list(self._fired)
        out: dict[str, int] = {}
        for r, n in zip(self.rules, fired):
            out[r.kind] = out.get(r.kind, 0) + n
        return out

    def reset(self) -> None:
        with self._lock:
            self._fired = [0] * len(self.rules)


def parse_rule(spec: str) -> FaultRule:
    """Parse a CLI rule string: ``kind[:k=v,k=v,...]``.

    Keys: ``p`` (probability), ``dir`` (c2s/s2c), ``verb``, ``every``,
    ``after`` (bytes), ``ms`` (delay in milliseconds), ``max`` (firing
    budget).  Examples::

        garble:p=0.02,dir=s2c
        delay:verb=readv,ms=100,p=0.5
        reset:every=50
        short:after=4096,max=1
    """
    kind, _, rest = spec.partition(":")
    kw: dict = {}
    if rest:
        for item in rest.split(","):
            k, _, v = item.partition("=")
            k = k.strip()
            if not _:
                raise ValueError(f"malformed rule item {item!r} in {spec!r}")
            if k == "p":
                kw["p"] = float(v)
            elif k == "dir":
                kw["direction"] = v
            elif k == "verb":
                kw["verb"] = v
            elif k == "every":
                kw["every"] = int(v)
            elif k == "after":
                kw["after_byte"] = int(v)
            elif k == "ms":
                kw["delay_s"] = float(v) / 1000.0
            elif k == "max":
                kw["max_fires"] = int(v)
            else:
                raise ValueError(f"unknown rule key {k!r} in {spec!r}")
    return FaultRule(kind=kind.strip(), **kw)


def garble_byte(buf: bytes, seed: int, tag: int = 0,
                lo: int = 0) -> bytes:
    """Flip one deterministically-chosen byte of ``buf`` at index ≥ ``lo``
    (the proxy keeps frame headers intact — corrupting a length field
    turns "corrupt payload" into "receiver hangs forever", a different
    and less useful fault)."""
    if len(buf) <= lo:
        return buf
    span = len(buf) - lo
    i = lo + int(_unit(seed, 71, tag, "g", span) * span)
    i = min(i, len(buf) - 1)
    out = bytearray(buf)
    out[i] ^= 0x5A
    return bytes(out)


def rot_container(path: str, *, seed: int = 0, every: int = 3,
                  phase: int = 0,
                  max_baskets: Optional[int] = None) -> list[tuple[str, int]]:
    """Deterministically rot a container *on disk* — bit-rot you can
    reproduce.  Walks the TOC in container *write order* (ascending file
    offset) and garbles one payload byte (:func:`garble_byte`, via
    ``os.pwrite``) of every ``every``-th basket, starting at position
    ``phase``; returns the damaged ``(branch, index)`` list.

    With a parity sidecar of stripe width ``k`` the stripes are k-wide
    runs of *consecutive* baskets in write order — the same walk order —
    so ``every >= k + 1`` guarantees at most one damaged member per
    stripe: every hit healable from single parity.  Different ``seed``/
    ``phase`` per replica rots *different* baskets, the setup anti-entropy
    repair converges.  ``max_baskets`` bounds the total damage."""
    from repro_torch.core.bfile import BasketFile
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    with BasketFile(path, verify=False) as bf:
        order = sorted(
            ((int(b["offset"]), name, i, int(b["meta"]["comp_len"]))
             for name in bf.branch_names()
             for i, b in enumerate(bf.branches[name]["baskets"])))
        plan = [(name, i, off, ln)
                for n, (off, name, i, ln) in enumerate(order)
                if n % every == phase % every]
    if max_baskets is not None:
        plan = plan[:max_baskets]
    damaged = []
    fd = os.open(path, os.O_RDWR)
    try:
        for name, i, off, ln in plan:
            buf = os.pread(fd, ln, off)
            bad = garble_byte(buf, seed, tag=off)
            if bad == buf:          # zero-length payload: nothing to flip
                continue
            j = next(k for k in range(len(buf)) if buf[k] != bad[k])
            os.pwrite(fd, bad[j:j + 1], off + j)
            damaged.append((name, i))
        os.fsync(fd)
    finally:
        os.close(fd)
    return damaged


def pread_fault_hook(*, match: Optional[str] = None, kind: str = "garble",
                     every: int = 1, seed: int = 0,
                     max_fires: Optional[int] = None,
                     delay_s: float = 0.05):
    """Build a hook for :func:`repro_torch.io.fdcache.set_fault_hook` — local
    storage faults underneath a live reader or server.

    ``match`` substring-filters the path (None = every pread); ``kind``
    is ``garble`` (flip a byte), ``short`` (drop the last byte → reader
    sees a torn read), or ``delay`` (sleep ``delay_s`` — a slow device);
    ``every`` fires on every Nth matching call; ``max_fires`` bounds the
    total.  Returns the hook; install/remove with ``set_fault_hook``.
    The hook exposes ``hook.fired`` for test assertions."""
    if kind not in ("garble", "short", "delay"):
        raise ValueError(f"pread fault kind {kind!r} not supported")
    state = {"calls": 0, "fired": 0}
    lock = threading.Lock()

    def hook(path: str, offset: int, buf: bytes) -> bytes:
        with lock:
            if match is not None and match not in path:
                return buf
            state["calls"] += 1
            if state["calls"] % max(every, 1) != 0:
                return buf
            if max_fires is not None and state["fired"] >= max_fires:
                return buf
            state["fired"] += 1
            hook.fired = state["fired"]
        if kind == "delay":
            time.sleep(delay_s)
            return buf
        if kind == "short":
            return buf[:-1] if buf else buf
        return garble_byte(buf, seed, tag=offset)

    hook.fired = 0
    return hook
