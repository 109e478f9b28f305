"""SockReader — a buffered reader over (prefix bytes + socket) with
`makefile("rb")`-compatible semantics, so `_serve_one` can parse a
request whose head the event loop already received.

Semantics matched to BufferedReader-over-SocketIO exactly where
`_serve_one`/`_read_headers`/`BodyReader` rely on them:

- `readline(limit)` returns through the newline, or exactly `limit`
  bytes when the line is longer (the 431/414 handling keys on a
  full-cap newline-less line), or the remaining bytes at EOF.
- `read(n)` blocks until n bytes or EOF (a short return means EOF —
  the non-streaming body read treats short as truncated).
- A recv timeout (the kernel SO_RCVTIMEO the worker arms, or a
  settimeout from `_drain_then_fin`) reads as b"" / EOF, the same
  mapping BufferedReader gives the threaded transport — a stalled
  peer looks gone, and the connection closes.
"""

from __future__ import annotations

import socket


class SockReader:
    __slots__ = ("_sock", "_buf", "_pos", "_info", "_eof")

    def __init__(self, prefix: bytes, sock, info=None):
        self._sock = sock
        self._buf = bytearray(prefix)
        self._pos = 0
        self._info = info
        self._eof = False

    def _fill(self) -> int:
        if self._eof:
            return 0
        try:
            data = self._sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError, socket.timeout):
            data = b""
        except OSError:
            data = b""
        if not data:
            self._eof = True
            return 0
        if self._pos:
            del self._buf[:self._pos]
            self._pos = 0
        self._buf += data
        if self._info is not None:
            self._info.bytes_in += len(data)
        return len(data)

    def readline(self, limit: int = -1) -> bytes:
        while True:
            i = self._buf.find(b"\n", self._pos)
            if i >= 0:
                end = i + 1
                if 0 <= limit < end - self._pos:
                    end = self._pos + limit
                break
            if 0 <= limit <= len(self._buf) - self._pos:
                end = self._pos + limit
                break
            if not self._fill():
                end = len(self._buf)
                break
        out = bytes(self._buf[self._pos:end])
        self._pos = end
        return out

    def read(self, n: int) -> bytes:
        while len(self._buf) - self._pos < n:
            if not self._fill():
                break
        end = min(self._pos + n, len(self._buf))
        out = bytes(self._buf[self._pos:end])
        self._pos = end
        return out

    # -- handoff back to the event loop --------------------------------------

    def has_buffered(self) -> bool:
        """Pipelined bytes already read off the wire?"""
        return len(self._buf) > self._pos

    def take_buffered(self) -> bytes:
        out = bytes(self._buf[self._pos:])
        self._buf = bytearray()
        self._pos = 0
        return out
