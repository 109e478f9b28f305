"""EventLoopTransport — the `-transport=aio` front door.

One selectors-based loop thread owns every accepted plaintext socket
while it is idle-keep-alive or mid-header.  When a complete header
block has arrived the connection is handed to a bounded worker pool
where the UNCHANGED synchronous `JsonHttpServer._serve_one` runs —
admission lanes, 429+Retry-After shedding, tracing, phase ledgers and
response framing are the same code on both transports, which is what
makes the HTTP semantics byte-identical by construction.

Division of labor:

- loop thread: accept, non-blocking reads into a per-conn buffer,
  header-terminator detection, idle/stall reaping, re-registration of
  keep-alive conns returned by workers.
- worker pool (N threads, default 16): blocking body reads + handler +
  response write for one request at a time per connection, with
  kernel SO_RCVTIMEO armed to the STALL deadline (a peer that stalls
  mid-body is reaped harder than an idle keep-alive conn, which the
  loop reaps at the softer -idle.timeout).
- dedicated threads: TLS conns (the loop never reads TLS bytes — the
  handshake and all framing happen in the thread, i.e. the threaded
  transport per-connection path) and long-lived push streams
  (`server.stream_paths`, e.g. /cluster/watch) which would otherwise
  pin worker slots forever.

Reap policy (the idle-vs-stalled distinction):

- buffer empty + idle > idle_timeout          -> reap kind="idle"
- buffer non-empty + idle > stall_timeout     -> reap kind="stalled"
  (slow-loris: a peer dribbling header bytes holds only a buffer
  here, never a thread, but is still cut off quickly)
- worker-held conns are guarded by SO_RCVTIMEO=stall_timeout for
  reads and SO_SNDTIMEO=idle_timeout for writes.
"""

from __future__ import annotations

import queue
import selectors
import socket
import struct
import threading
import time

from .bufio import SockReader
from .registry import ConnInfo, CountedConn, conns_reaped_total

# Hand a terminator-less buffer to a worker anyway past this size: the
# request line/header caps in _serve_one produce the same 431/414 the
# threaded transport gives (64KB line cap + header lines).
_HDR_DISPATCH_CAP = 1 << 18

_OVERFLOW_503 = (b"HTTP/1.1 503 Service Unavailable\r\n"
                 b"Content-Type: application/json\r\n"
                 b"Content-Length: 33\r\n"
                 b"Connection: close\r\n\r\n"
                 b'{"error": "dispatch queue full"}\n')


class _ConnState:
    __slots__ = ("sock", "peer", "buf", "info", "armed")

    def __init__(self, sock, peer: str, info: ConnInfo):
        self.sock = sock
        self.peer = peer
        self.buf = bytearray()
        self.info = info
        self.armed = False  # kernel timeouts set once, on first handoff


class EventLoopTransport:
    def __init__(self, server):
        self.server = server
        self.idle_timeout = float(server.idle_timeout)
        self.stall_timeout = float(server.stall_timeout)
        self.workers = int(server.workers)
        self._sel = selectors.DefaultSelector()
        self._q: queue.Queue = queue.Queue(maxsize=self.workers * 64)
        self._pending: list[tuple] = []  # cross-thread loop commands
        self._pending_lock = threading.Lock()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._owned: dict[int, _ConnState] = {}  # fd -> loop-owned conn
        self._running = False
        self._threads: list[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._running = True
        lsock = self.server._sock
        lsock.setblocking(False)
        self._sel.register(lsock, selectors.EVENT_READ, "listen")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"aio-worker-{self.server.port}-{i}")
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._loop, daemon=True,
                             name=f"aio-loop-{self.server.port}")
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._running = False
        for _ in range(self.workers):
            try:
                self._q.put_nowait(None)
            except queue.Full:
                break
        self._wake()
        # Severing worker-held sockets happens in JsonHttpServer.stop()
        # (every accepted socket is registered in server._conns).

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    # -- loop thread ---------------------------------------------------------

    def _loop(self) -> None:
        last_sweep = time.monotonic()
        try:
            while self._running and self.server._running:
                events = self._sel.select(0.25)
                now = time.monotonic()
                for key, _mask in events:
                    if key.data == "listen":
                        self._accept()
                    elif key.data == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        self._read(key.data, now)
                self._process_pending()
                if now - last_sweep >= min(0.25, self.stall_timeout / 2):
                    self._sweep(now)
                    last_sweep = now
        except Exception:  # noqa: BLE001 — selector torn down mid-stop
            pass
        finally:
            for state in list(self._owned.values()):
                self._close(state)
            try:
                self._sel.close()
            except OSError:
                pass
            try:
                self._wake_r.close()
                self._wake_w.close()
            except OSError:
                pass

    def _accept(self) -> None:
        server = self.server
        while True:
            try:
                conn, addr = server._sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer = addr[0] if addr else ""
            if server.ssl_context is not None:
                # TLS handshake + framing need blocking reads the loop
                # cannot do; the per-connection threaded path handles
                # these (and registers itself with _conns + registry).
                threading.Thread(target=server._serve_conn,
                                 args=(conn, peer), daemon=True).start()
                continue
            conn.setblocking(False)
            info = server.conns.add(peer, "aio")
            state = _ConnState(conn, peer, info)
            with server._conns_lock:
                server._conns.add(conn)
            self._owned[conn.fileno()] = state
            try:
                self._sel.register(conn, selectors.EVENT_READ, state)
            except (ValueError, OSError):
                self._close(state)

    def _read(self, state: _ConnState, now: float) -> None:
        try:
            data = state.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(state)
            return
        if not data:
            self._close(state)
            return
        state.buf += data
        state.info.bytes_in += len(data)
        state.info.last_activity = now
        state.info.state = "reading"
        self._maybe_dispatch(state)

    @staticmethod
    def _headers_complete(buf: bytearray) -> bool:
        # _read_headers accepts bare-\n framing, so both terminators
        # count.  Scans are cheap: header blocks are small and arrive
        # in O(1) reads.
        return buf.find(b"\r\n\r\n") >= 0 or buf.find(b"\n\n") >= 0

    def _maybe_dispatch(self, state: _ConnState) -> None:
        buf = state.buf
        if not self._headers_complete(buf) and \
                len(buf) < _HDR_DISPATCH_CAP:
            return
        # Loop-side request-line peek, only to divert long-lived push
        # streams (they would pin worker slots forever) to dedicated
        # threads; everything else re-parses in the worker.
        i = buf.find(b"\n")
        target = b""
        if i > 0:
            parts = bytes(buf[:i]).split(b" ")
            if len(parts) >= 2:
                target = parts[1].split(b"?", 1)[0]
        self._disown(state)
        if target.decode("latin-1", "replace") in self.server.stream_paths:
            state.info.transport = "aio+thread"
            threading.Thread(
                target=self.server._serve_conn_buffered,
                args=(state.sock, state.peer, bytes(buf), state.info),
                daemon=True).start()
            return
        state.info.state = "handling"
        try:
            self._q.put_nowait(state)
        except queue.Full:
            conns_reaped_total.inc(kind="overflow")
            try:
                state.sock.setblocking(True)
                state.sock.settimeout(1.0)
                state.sock.sendall(_OVERFLOW_503)
            except OSError:
                pass
            self._close(state)

    def _disown(self, state: _ConnState) -> None:
        try:
            self._owned.pop(state.sock.fileno(), None)
        except OSError:
            pass
        try:
            self._sel.unregister(state.sock)
        except (KeyError, ValueError, OSError):
            pass

    def _close(self, state: _ConnState, reap_kind: str = "") -> None:
        self._disown(state)
        if reap_kind:
            conns_reaped_total.inc(kind=reap_kind)
        self.server.conns.remove(state.info)
        with self.server._conns_lock:
            self.server._conns.discard(state.sock)
        try:
            state.sock.close()
        except OSError:
            pass

    def _process_pending(self) -> None:
        with self._pending_lock:
            pending, self._pending = self._pending, []
        for state, leftover in pending:
            if not self._running or not self.server._running:
                self._close(state)
                continue
            try:
                state.sock.setblocking(False)
            except OSError:
                self._close(state)
                continue
            state.buf = bytearray(leftover)
            state.info.state = "reading" if leftover else "idle"
            self._owned[state.sock.fileno()] = state
            try:
                self._sel.register(state.sock, selectors.EVENT_READ,
                                   state)
            except (ValueError, OSError):
                self._close(state)
                continue
            if leftover:
                self._maybe_dispatch(state)

    def _sweep(self, now: float) -> None:
        for state in list(self._owned.values()):
            idle = now - state.info.last_activity
            if state.buf:
                if idle > self.stall_timeout:
                    self._close(state, reap_kind="stalled")
            elif idle > self.idle_timeout:
                self._close(state, reap_kind="idle")

    # -- worker pool ---------------------------------------------------------

    def resume(self, state: _ConnState, leftover: bytes) -> None:
        with self._pending_lock:
            self._pending.append((state, leftover))
        self._wake()

    def _worker(self) -> None:
        while True:
            state = self._q.get()
            if state is None:
                return
            try:
                self._serve_handoff(state)
            except Exception:  # noqa: BLE001 — never kill the worker
                try:
                    self._close(state)
                except Exception:  # noqa: BLE001
                    pass

    def _serve_handoff(self, state: _ConnState) -> None:
        server = self.server
        sock, info = state.sock, state.info
        sock.setblocking(True)
        if not state.armed:
            # Kernel-enforced timeouts, same trick (and same EAGAIN ->
            # b"" peer-gone mapping) as the threaded transport — but
            # reads get the harder STALL deadline: by the time a worker
            # touches this socket a request is mid-flight, so a silent
            # peer is a slow-loris, not an idle keep-alive.
            rtv = struct.pack("ll", int(self.stall_timeout),
                              int(self.stall_timeout % 1 * 1e6))
            wtv = struct.pack("ll", int(self.idle_timeout),
                              int(self.idle_timeout % 1 * 1e6))
            try:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, rtv)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, wtv)
            except OSError:
                pass
            state.armed = True
        rf = SockReader(bytes(state.buf), sock, info)
        state.buf = bytearray()
        conn = CountedConn(sock, info)
        keep = True
        try:
            while True:
                info.state = "handling"
                keep = server._serve_one(conn, rf, state.peer, info)
                info.requests += 1
                info.touch()
                if not keep or not server._running:
                    keep = False
                    break
                if not rf.has_buffered():
                    break  # back to the loop until more bytes arrive
        except Exception:  # noqa: BLE001 — peer reset mid-exchange
            keep = False
        if keep:
            self.resume(state, rf.take_buffered())
        else:
            self._close(state)
