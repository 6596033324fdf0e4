"""ChaosProxy — an in-process RBSP-aware TCP proxy that applies a FaultPlan.

Sits between a real client and a real basket server::

    plan = FaultPlan([FaultRule("garble", p=0.02, direction="s2c")], seed=7)
    with ChaosProxy(srv.host, srv.port, plan) as px:
        f = RemoteBasketFile(host=px.host, port=px.port, path="data.bskt")

Each accepted client connection opens one upstream connection and two pump
threads (client→server, server→client).  Pumps parse *raw RBSP framing*
(header → body/payload lengths → exact byte counts) so faults land on
frame boundaries: a ``garble`` flips a byte strictly after the 21-byte
header (corrupting a length field would hang the receiver instead of
failing its checksum — a different, less useful fault), a ``drop``
swallows exactly one frame, a ``short`` tears mid-frame and closes, a
``reset`` sends a hard RST.  Verb and per-connection frame counts feed
the plan's triggers, so "delay every 3rd s2c readv response" means
exactly that.

Deterministic: connection ids are assigned in accept order and frame
numbers per direction, so with a single client the same plan replays the
same faults (see :mod:`repro_torch.fault.inject`).
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

from repro_torch.remote import protocol as P

from .inject import FaultPlan, garble_byte

__all__ = ["ChaosProxy"]

_HEADER = struct.Struct("<4sBIQI")
# frame type -> plan verb (responses map to their request's verb so one
# rule spec covers both directions)
_VERB = {P.REQ_CATALOG: "catalog", P.RESP_CATALOG: "catalog",
         P.REQ_READV: "readv", P.RESP_READV: "readv",
         P.REQ_PING: "ping", P.RESP_PING: "ping",
         P.REQ_STATS: "stats", P.RESP_STATS: "stats",
         P.RESP_BUSY: "busy", P.RESP_ERROR: "error"}


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks, got = [], 0
    while got < n:
        b = sock.recv(min(n - got, 1 << 20))
        if not b:
            raise EOFError
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


class _Conn:
    """One proxied connection pair plus its pump threads."""

    def __init__(self, proxy: "ChaosProxy", client: socket.socket,
                 conn_id: int):
        self.proxy = proxy
        self.client = client
        self.conn_id = conn_id
        self.upstream = socket.create_connection(
            (proxy.upstream_host, proxy.upstream_port), timeout=30)
        for s in (self.client, self.upstream):
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._closed = threading.Event()
        self._threads = [
            threading.Thread(target=self._pump, daemon=True,
                             args=(self.client, self.upstream, "c2s"),
                             name=f"chaos-c2s-{conn_id}"),
            threading.Thread(target=self._pump, daemon=True,
                             args=(self.upstream, self.client, "s2c"),
                             name=f"chaos-s2c-{conn_id}"),
        ]
        for t in self._threads:
            t.start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              direction: str) -> None:
        plan = self.proxy.plan
        frame_no = 0
        offset = 0
        try:
            while not self._closed.is_set():
                head = _recv_exact(src, _HEADER.size)
                magic, ftype, body_len, payload_len, _sum = \
                    _HEADER.unpack(head)
                if magic != P.MAGIC:
                    # not RBSP (or we lost sync): fall back to dumb
                    # byte-pumping for the rest of the stream
                    dst.sendall(head)
                    self._raw_pump(src, dst)
                    return
                rest = _recv_exact(src, body_len + payload_len)
                frame = head + rest
                frame_no += 1
                offset += len(frame)
                fired = plan.decide(conn_id=self.conn_id,
                                    direction=direction,
                                    verb=_VERB.get(ftype),
                                    frame_no=frame_no, offset=offset)
                if not self._apply(fired, frame, dst, frame_no):
                    return
        except (EOFError, OSError):
            pass
        finally:
            self.close()

    def _apply(self, fired, frame: bytes, dst: socket.socket,
               frame_no: int) -> bool:
        """Apply fired rules to one frame; False = stream is dead."""
        for r in fired:
            if r.kind == "delay":
                self._closed.wait(r.delay_s)
            elif r.kind == "drop":
                return True            # swallow the frame, keep pumping
            elif r.kind == "reset":
                self._reset()
                return False
            elif r.kind == "garble":
                frame = garble_byte(frame, self.proxy.plan.seed,
                                    tag=frame_no, lo=_HEADER.size)
            elif r.kind == "short":
                try:
                    dst.sendall(frame[:max(len(frame) // 2, 1)])
                except OSError:
                    pass
                self.close()
                return False
        try:
            dst.sendall(frame)
        except OSError:
            return False
        return True

    def _raw_pump(self, src: socket.socket, dst: socket.socket) -> None:
        while not self._closed.is_set():
            b = src.recv(1 << 16)
            if not b:
                return
            dst.sendall(b)

    def _reset(self) -> None:
        """Hard RST toward the client: SO_LINGER(1, 0) + close."""
        try:
            self.client.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER,
                struct.pack("ii", 1, 0))
        except OSError:
            pass
        self.close()

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        for s in (self.client, self.upstream):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        self.proxy._forget(self)


class ChaosProxy:
    """Listen on ``host:port`` (0 = ephemeral), forward to the upstream
    basket server, applying ``plan`` to every RBSP frame in both
    directions.  Context-manageable; :meth:`close` tears down the
    listener and every live proxied connection."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 plan: Optional[FaultPlan] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.upstream_host = upstream_host
        self.upstream_port = int(upstream_port)
        self.plan = plan if plan is not None else FaultPlan([])
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, int(port)))
        self._lsock.listen(64)
        self._conns: set[_Conn] = set()
        self._lock = threading.Lock()
        self._next_id = 0
        self._closing = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="chaos-accept")
        self._accept_thread.start()

    @property
    def host(self) -> str:
        return self._lsock.getsockname()[0]

    @property
    def port(self) -> int:
        return self._lsock.getsockname()[1]

    def _accept_loop(self) -> None:
        while True:
            try:
                client, _addr = self._lsock.accept()
            except OSError:
                return                  # listener closed
            with self._lock:
                if self._closing:
                    client.close()
                    return
                cid = self._next_id
                self._next_id += 1
            try:
                conn = _Conn(self, client, cid)
            except OSError:
                client.close()          # upstream refused
                continue
            with self._lock:
                self._conns.add(conn)

    def _forget(self, conn: _Conn) -> None:
        with self._lock:
            self._conns.discard(conn)

    def close(self) -> None:
        with self._lock:
            if self._closing:
                return
            self._closing = True
            conns = list(self._conns)
        try:
            self._lsock.close()
        except OSError:
            pass
        for c in conns:
            c.close()
        self._accept_thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
