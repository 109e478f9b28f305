"""Shared skeleton for the no-SDK wire clients (RESP / OP_MSG / CQL):
one socket, one in-flight command, redial-once on a dead connection.

Subclasses implement `_handshake()` (post-connect protocol setup) and
call `_call(fn)` with a closure that performs one round trip on the
live socket — the retry/reconnect/close lifecycle lives here once
instead of per protocol (filer/redis_store.py, mongo_store.py,
cassandra_store.py)."""

from __future__ import annotations

import socket
import threading

from ..trace import span as _trace_span


class WireClient:
    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None

    # -- subclass hooks ------------------------------------------------------

    def _handshake(self) -> None:
        """Protocol setup after the TCP connect (AUTH/STARTUP/...)."""

    def _on_connect(self) -> None:
        """Wrap the fresh socket (buffered readers etc.)."""

    # -- lifecycle -----------------------------------------------------------

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._on_connect()
        self._handshake()

    def _recv_exact(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            piece = self._sock.recv(n - len(out))
            if not piece:
                raise ConnectionError(
                    f"{type(self).__name__}: peer closed the connection")
            out += piece
        return bytes(out)

    def _call(self, fn):
        """Run one round trip under the lock, redialing once if the
        pooled connection died between commands.

        Binary wire protocols (RESP/OP_MSG/CQL) carry no traceparent
        header, so the backing-store hop appears on a trace as a client
        span here instead — a no-op outside an active request."""
        with _trace_span(f"wire.{type(self).__name__}",
                         peer=f"{self.host}:{self.port}"):
            with self._lock:
                for attempt in (0, 1):
                    if self._sock is None:
                        self._connect()
                    try:
                        return fn()
                    except (OSError, ConnectionError):
                        self.close_nolock()
                        if attempt:
                            raise
        raise AssertionError("unreachable")

    def close_nolock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self.close_nolock()
