"""Parity sidecars — XOR stripe protection for basket containers.

A container written with ``BasketWriter(parity=k)`` gets a
``<container>.parity`` sidecar: baskets are grouped, in write order, into
k-wide *stripes*, and each stripe's parity is the byte-wise XOR of its
member payloads (each zero-padded to the longest member).  Any **one**
damaged member of a stripe can then be reconstructed from its peers plus
the parity blob — without a second replica, without re-deriving the data.
The container's own bytes are untouched (golden-pinned): parity is a
sidecar, never part of the format.

Sidecar layout (mirrors the container's trailer convention)::

    [8B magic "RPARv001"][parity blobs...]
    [zlib(header JSON)][8B header_len][8B magic]

The header JSON is zlib-compressed (it mirrors the container's whole
branch TOC — on a well-compressed container the raw JSON alone would eat
a visible slice of the 1/k byte budget).

The header carries:

* ``k`` and the stripe map — for each stripe, its member ``(branch,
  index)`` list, the parity blob's offset/length, and an adler32 of the
  blob (a rotted parity read must fail loudly, not reconstruct garbage);
* a **generation stamp** ``{"size", "toc_adler"}`` of the committed
  container — content-derived (not inode-derived), so it stays valid for
  byte-identical replica copies and survives in-place heals, but refuses
  to describe a container that was rewritten;
* a full mirror of the container's branch TOC — the alternative boundary
  source :func:`repro_torch.core.bfile.recover_container` uses when a torn
  container has no write journal.

Reconstruction never trusts anything it cannot verify: every peer payload
must decode and match its stored raw adler32, the parity blob must match
its stored adler32, and the reconstructed payload must decode and match
the *target's* stored adler32 before it is returned.  A stripe with two
damaged members is unhealable here (single parity) — that is what the
anti-entropy replica repair (:mod:`repro_torch.repair.reconcile`) is for.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Callable, Optional

import numpy as np

from repro_torch.core.checksum import adler32_hw

__all__ = ["ParityWriter", "ParitySidecar", "parity_path", "content_stamp",
           "ParityError"]

MAGIC = b"RPARv001"


class ParityError(ValueError):
    """The parity sidecar is missing, torn, stamped for a different
    container generation, or its blobs fail their own checksums."""


def parity_path(container_path: str) -> str:
    """The sidecar path for ``container_path`` (a leftover ``*.tmp`` from
    a crashed writer shares its final path's sidecar)."""
    p = str(container_path)
    if p.endswith(".tmp"):
        p = p[:-4]
    return p + ".parity"


def content_stamp(size: int, toc_bytes: bytes) -> dict:
    """The content-derived generation stamp binding a sidecar to the
    container bytes it describes.  Derived from the committed file size
    and the TOC's adler32 — identical for byte-identical replicas, and
    unchanged by an in-place basket heal (which restores original bytes),
    but different for any rewritten/re-tuned container."""
    return {"size": int(size), "toc_adler": int(adler32_hw(toc_bytes))}


def _xor_into(acc: bytearray, payload) -> None:
    """acc[:len(payload)] ^= payload, growing ``acc`` as needed."""
    buf = np.frombuffer(payload, dtype=np.uint8)
    if buf.size > len(acc):
        acc.extend(b"\0" * (buf.size - len(acc)))
    a = np.frombuffer(acc, dtype=np.uint8)
    a[:buf.size] ^= buf


class ParityWriter:
    """Accumulates k-wide XOR stripes while a container streams out.

    ``add`` is called once per basket payload in container write order;
    completed stripes spool to ``path + ".tmp"`` immediately (one stripe
    accumulator of memory, never the whole parity set), and ``commit``
    writes the header trailer and atomically renames the sidecar into
    place — called only *after* the container itself commits, so a crash
    can never leave a sidecar describing bytes that were never published.
    """

    def __init__(self, path: str, k: int = 8):
        if int(k) < 2:
            raise ValueError(f"parity stripe width must be >= 2, got {k}")
        self.path = str(path)
        self.k = int(k)
        self._tmp = self.path + ".tmp"
        self._f = open(self._tmp, "wb")
        self._f.write(MAGIC)
        self._stripes: list[dict] = []
        self._members: list[list] = []      # current stripe's (branch, idx)
        self._acc = bytearray()
        self._closed = False

    def add(self, branch: str, index: int, payload) -> None:
        """Fold one basket payload into the current stripe."""
        _xor_into(self._acc, payload)
        self._members.append([str(branch), int(index)])
        if len(self._members) >= self.k:
            self._flush_stripe()

    def _flush_stripe(self) -> None:
        if not self._members:
            return
        blob = bytes(self._acc)
        off = self._f.tell()
        self._f.write(blob)
        self._stripes.append({"off": off, "len": len(blob),
                              "adler": int(adler32_hw(blob)),
                              "members": self._members})
        self._members = []
        self._acc = bytearray()

    def commit(self, branches: dict, stamp: dict, container: str) -> None:
        """Seal the sidecar: flush the partial tail stripe, append the
        header (stripe map + TOC mirror + stamp), fsync, atomic rename."""
        if self._closed:
            return
        self._flush_stripe()
        header = {
            "container": os.path.basename(container),
            "k": self.k,
            "stamp": dict(stamp),
            "stripes": self._stripes,
            "branches": branches,
        }
        try:
            hj = zlib.compress(
                json.dumps(header, sort_keys=True).encode(), 6)
            self._f.write(hj)
            self._f.write(len(hj).to_bytes(8, "little"))
            self._f.write(MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            os.replace(self._tmp, self.path)
        except BaseException:
            self.abort()
            raise
        self._closed = True
        from repro_torch.core.bfile import _fsync_dir
        _fsync_dir(os.path.dirname(os.path.abspath(self.path)))

    def abort(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._f.close()
        except OSError:
            pass
        try:
            os.remove(self._tmp)
        except OSError:
            pass


class ParitySidecar:
    """Parsed sidecar: the stripe map plus verified parity blob access.

    Loading parses only the trailer header; parity blobs are pread on
    demand through ``repro_torch.io.fdcache`` (so the same staleness/fault
    machinery that covers basket reads covers parity reads)."""

    def __init__(self, path: str, header: dict):
        self.path = str(path)
        self.k = int(header["k"])
        self.stamp = dict(header.get("stamp") or {})
        self.container = header.get("container", "")
        self.stripes = header["stripes"]
        self.branches = header.get("branches") or {}
        self._by_member: dict[tuple[str, int], int] = {}
        for si, s in enumerate(self.stripes):
            for br, idx in s["members"]:
                self._by_member[(str(br), int(idx))] = si
        self._lock = threading.Lock()

    @classmethod
    def load(cls, path: str) -> "ParitySidecar":
        """Parse the sidecar trailer; raises :class:`ParityError` for a
        missing, torn, or undecodable sidecar."""
        try:
            size = os.path.getsize(path)
        except OSError as e:
            raise ParityError(f"{path}: no parity sidecar ({e})") from None
        try:
            with open(path, "rb") as f:
                if f.read(8) != MAGIC or size < 8 + 16:
                    raise ParityError(f"{path}: bad parity magic/size")
                f.seek(-16, os.SEEK_END)
                hlen = int.from_bytes(f.read(8), "little")
                if f.read(8) != MAGIC:
                    raise ParityError(f"{path}: torn parity trailer")
                if not 2 <= hlen <= size - 24:
                    raise ParityError(f"{path}: parity header length {hlen} "
                                      f"inconsistent with size {size}")
                f.seek(-16 - hlen, os.SEEK_END)
                header = json.loads(zlib.decompress(f.read(hlen)))
        except ParityError:
            raise
        except (OSError, ValueError, zlib.error) as e:
            raise ParityError(f"{path}: unreadable parity sidecar "
                              f"({e})") from None
        return cls(path, header)

    def check_stamp(self, size: int, toc_bytes: bytes) -> None:
        """Refuse to describe a container whose bytes this sidecar was not
        written for (rewritten, re-tuned, or swapped underneath)."""
        want = content_stamp(size, toc_bytes)
        if self.stamp != want:
            raise ParityError(
                f"{self.path}: stamp {self.stamp} does not match the "
                f"container's current content {want} — the container was "
                "rewritten since parity was computed")

    def stripe_of(self, branch: str, index: int) -> Optional[dict]:
        si = self._by_member.get((str(branch), int(index)))
        return self.stripes[si] if si is not None else None

    def covers(self, branch: str, index: int) -> bool:
        return (str(branch), int(index)) in self._by_member

    def _parity_blob(self, stripe: dict) -> bytes:
        from repro_torch.io import fdcache
        blob = fdcache.pread(self.path, int(stripe["off"]),
                             int(stripe["len"]))
        if adler32_hw(blob) != int(stripe["adler"]):
            raise ParityError(
                f"{self.path}: parity blob at {stripe['off']} fails its "
                "checksum (rotted parity)")
        return blob

    def reconstruct(self, branch: str, index: int, comp_len: int,
                    read_peer: Callable[[str, int], bytes],
                    verify_peer: Callable[[str, int, bytes], bool]) -> bytes:
        """Rebuild one damaged member's on-disk payload from its stripe.

        ``read_peer(branch, index)`` returns a peer's on-disk payload
        bytes; ``verify_peer(branch, index, payload)`` must confirm the
        payload decodes to its stored raw adler32 — an unverified peer
        would XOR its own damage straight into the reconstruction.
        Raises :class:`ParityError` when the stripe cannot vouch for the
        target (no stripe, a damaged peer, rotted parity)."""
        stripe = self.stripe_of(branch, index)
        if stripe is None:
            raise ParityError(
                f"{self.path}: no stripe covers ({branch!r}, {index})")
        acc = bytearray(self._parity_blob(stripe))
        for br, idx in stripe["members"]:
            br, idx = str(br), int(idx)
            if (br, idx) == (str(branch), int(index)):
                continue
            peer = read_peer(br, idx)
            if not verify_peer(br, idx, peer):
                raise ParityError(
                    f"{self.path}: stripe peer ({br!r}, {idx}) is itself "
                    "damaged — single parity cannot heal two members")
            _xor_into(acc, peer)
        if comp_len > len(acc):
            raise ParityError(
                f"{self.path}: stripe blob shorter than target payload "
                f"({len(acc)} < {comp_len})")
        return bytes(acc[:comp_len])
