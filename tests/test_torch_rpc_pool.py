"""The client's keep-alive pool (`cluster/rpc.py` `_ConnPool.acquire`,
`_request`) in both packages and on both server transports.

A server closes every idle keep-alive connection after one shared idle
timeout, and all of them when it stops, so a client's pooled
connections to a host die together.  The reference hands out the newest
idle connection unchecked and, when the server had closed it, retries
once on the next pooled one, which is dead too: the call raises
`ConnectionResetError("server closed connection")`.  The port drops
every idle connection whose server has closed it before handing one out
and retries on a new connection.  A timeout is still never re-sent, and
a live connection is still reused."""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from _torch_cluster import hermetic_port_state, mod  # noqa: F401

pytestmark = pytest.mark.torch

PACKAGES = ("seaweedfs_tpu", "seaweedfs_tpu_torch")
TRANSPORTS = ("threads", "aio")
POOLED = 4  # connections each scenario leaves in the pool
IDLE_TIMEOUT = 0.5


class Server:
    """A package's JsonHttpServer with one route that counts its calls
    and one count of the sockets it accepted.  `GET /hold` waits until
    POOLED calls are in it at once, so they ride POOLED connections;
    `GET /sleep?s=S` sleeps S seconds, then sets `slept`."""

    def __init__(self, pkg: str, transport: str, port: int = 0,
                 idle_timeout: float = 120.0):
        self.rpc = mod(pkg, "cluster.rpc")
        self.srv = self.rpc.JsonHttpServer(port=port, transport=transport,
                                           idle_timeout=idle_timeout)
        self.calls = {"ping": 0, "hold": 0, "sleep": 0}
        self.sockets = 0
        self._lock = threading.Lock()
        self._barrier = threading.Barrier(POOLED, timeout=10)
        self.slept = threading.Event()
        add = self.srv.conns.add

        def counted_add(*a):
            with self._lock:
                self.sockets += 1
            return add(*a)

        self.srv.conns.add = counted_add
        self.srv.route("GET", "/ping", self._route("ping"))
        self.srv.route("GET", "/hold", self._route("hold", self._hold))
        self.srv.route("GET", "/sleep", self._route("sleep", self._sleep))
        self.srv.start()

    def _route(self, name, then=None):
        def handler(query, body):
            with self._lock:
                self.calls[name] += 1
            if then is not None:
                then(query)
            return {"ok": name}
        return handler

    def _hold(self, _query):
        self._barrier.wait()

    def _sleep(self, query):
        time.sleep(float(query["s"]))
        self.slept.set()

    def url(self, path: str) -> str:
        return self.srv.url() + path

    def fill_pool(self) -> None:
        """POOLED concurrent calls: POOLED connections go back to the
        client's pool."""
        with ThreadPoolExecutor(POOLED) as ex:
            answers = list(ex.map(
                lambda _i: self.rpc.call(self.url("/hold")), range(POOLED)))
        assert answers == [{"ok": "hold"}] * POOLED
        key = ("http", self.srv.host, self.srv.port)
        assert len(self.rpc._pool._idle[key]) >= POOLED

    def stop(self) -> None:
        self.srv.stop()


def _after_stale_pool(pkg, server, call):
    """The outcome of `call` in `pkg`: the reference meets the server's
    closed connections twice and raises; the port answers, and the
    handler runs once."""
    before = server.calls["ping"]
    if pkg == "seaweedfs_tpu":
        with pytest.raises(ConnectionResetError,
                           match="server closed connection"):
            call()
        assert server.calls["ping"] == before
    else:
        assert call() == {"ok": "ping"}
        assert server.calls["ping"] == before + 1


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_pooled_connection_reaped(pkg, transport):
    """The server's idle timeout closes all POOLED pooled connections;
    the next call goes out after it."""
    server = Server(pkg, transport, idle_timeout=IDLE_TIMEOUT)
    try:
        server.fill_pool()
        time.sleep(3 * IDLE_TIMEOUT)
        _after_stale_pool(pkg, server,
                          lambda: server.rpc.call(server.url("/ping")))
    finally:
        server.stop()


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("pkg", PACKAGES)
def test_server_restarted_on_the_same_port(pkg, transport):
    """A server stops while the client pools connections to it, and a
    new one starts on its port: the first call goes to the new one."""
    old = Server(pkg, transport)
    try:
        old.fill_pool()
    finally:
        old.stop()
    new = Server(pkg, transport, port=old.srv.port)
    try:
        _after_stale_pool(pkg, new,
                          lambda: new.rpc.call(new.url("/ping")))
        assert old.calls["ping"] == 0
    finally:
        new.stop()


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("pkg", PACKAGES)
def test_timeout_on_a_reused_connection_is_not_resent(pkg, transport):
    """A call that times out on a reused connection raises in both
    packages: the server may still be running it, so it is never sent
    again."""
    server = Server(pkg, transport)
    try:
        assert server.rpc.call(server.url("/ping")) == {"ok": "ping"}
        with pytest.raises(TimeoutError):
            server.rpc.call(server.url("/sleep?s=0.6"), timeout=0.2)
        assert server.slept.wait(10)
        assert server.calls["sleep"] == 1
        assert server.sockets == 1
    finally:
        server.stop()


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("pkg", PACKAGES)
def test_live_connection_is_reused(pkg, transport):
    """50 sequential calls ride one connection, counted on the
    server."""
    server = Server(pkg, transport)
    try:
        for _ in range(50):
            assert server.rpc.call(server.url("/ping")) == {"ok": "ping"}
        assert server.calls["ping"] == 50
        assert server.sockets == 1
    finally:
        server.stop()
