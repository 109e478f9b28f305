"""The port's HTTP/JSON plane (cluster/rpc.py, netcore/) against
seaweedfs_tpu's: the cases of tests/test_rpc_robustness.py (truncated
transfers, over-long lines, chunked streaming) run for both packages
with their outcomes held equal; the byte-range parser's answers,
including the reference fault kept for parity; and the server-only
cases of tests/test_frontdoor.py on both transports, asserting the
same behaviour of the port."""

from __future__ import annotations

import socket
import threading
import time

import pytest

from _torch_cluster import (both, hermetic_port_state,  # noqa: F401
                            mod, outcome, pair)
from seaweedfs_tpu_torch.cluster import rpc
from seaweedfs_tpu_torch.stats.promcheck import validate_exposition
from seaweedfs_tpu_torch.trace import tracer

pytestmark = pytest.mark.torch

TRANSPORTS = ("threads", "aio")


def _raw_server(script):
    """One-shot raw-socket server: accepts one connection, runs
    script(conn), closes.  Returns the port."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def run():
        conn, _ = srv.accept()
        try:
            script(conn)
        finally:
            conn.close()
            srv.close()

    threading.Thread(target=run, daemon=True).start()
    return port


def _drain_request(conn):
    buf = b""
    while b"\r\n\r\n" not in buf:
        data = conn.recv(65536)
        if not data:
            return buf
        buf += data
    return buf


# -- client robustness -------------------------------------------------------

def test_early_close_with_content_length_raises():
    """A peer that dies mid-body must surface an error, not a short
    'successful' read."""
    def script(conn):
        _drain_request(conn)
        conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 100\r\n\r\n"
                     b"only-ten-b")  # 10 of 100 bytes, then close

    def run(pkg):
        port = _raw_server(script)
        with pytest.raises(ConnectionError) as ei:
            mod(pkg, "cluster.rpc").call(f"http://127.0.0.1:{port}/x",
                                         timeout=5.0)
        return type(ei.value).__name__
    both(run)


def test_early_close_to_file_raises(tmp_path):
    def script(conn):
        _drain_request(conn)
        conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 1048576\r\n\r\n"
                     + b"x" * 1000)

    def run(pkg):
        port = _raw_server(script)
        with pytest.raises(ConnectionError) as ei:
            mod(pkg, "cluster.rpc").call_to_file(
                f"http://127.0.0.1:{port}/x", str(tmp_path / pkg),
                timeout=5.0)
        return type(ei.value).__name__
    both(run)


def test_chunked_body_streams_incrementally(tmp_path):
    """call_to_file must stream a chunked upstream in bounded reads, and
    reassemble the exact payload."""
    payload = bytes(range(256)) * 512  # 128KB

    def script(conn):
        _drain_request(conn)
        conn.sendall(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n")
        for i in range(0, len(payload), 7001):  # awkward chunk sizes
            chunk = payload[i:i + 7001]
            conn.sendall(hex(len(chunk))[2:].encode() + b"\r\n" + chunk
                         + b"\r\n")
        conn.sendall(b"0\r\n\r\n")

    def run(pkg):
        port = _raw_server(script)
        dest = tmp_path / pkg
        n = mod(pkg, "cluster.rpc").call_to_file(
            f"http://127.0.0.1:{port}/x", str(dest), timeout=5.0)
        assert n == len(payload) and dest.read_bytes() == payload
        return n
    both(run)


def test_chunked_read_honors_requested_size():
    def script(conn):
        _drain_request(conn)
        conn.sendall(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n"
                     b"10\r\n" + b"a" * 16 + b"\r\n"
                     b"10\r\n" + b"b" * 16 + b"\r\n0\r\n\r\n")

    def run(pkg):
        port = _raw_server(script)
        resp, conn = mod(pkg, "cluster.rpc")._request(
            f"http://127.0.0.1:{port}/x", "GET", None, 5.0)
        try:
            reads = [resp.read(4), resp.read(20), resp.read(), resp.read()]
        finally:
            conn.close()
        assert reads == [b"aaaa", b"a" * 12 + b"b" * 8, b"b" * 8, b""]
        return reads
    both(run)


def test_chunked_early_close_raises():
    def script(conn):
        _drain_request(conn)
        conn.sendall(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
                     b"100\r\n" + b"x" * 16)  # promises 256, sends 16

    def run(pkg):
        port = _raw_server(script)
        with pytest.raises(ConnectionError) as ei:
            mod(pkg, "cluster.rpc").call(f"http://127.0.0.1:{port}/x",
                                         timeout=5.0)
        return type(ei.value).__name__
    both(run)


@pytest.mark.parametrize("request_bytes,status", [
    (b"GET /" + b"a" * 70000 + b" HTTP/1.1\r\n\r\n", b"414"),
    (b"GET /ok HTTP/1.1\r\nX-Big: " + b"a" * 70000 + b"\r\n\r\n", b"431"),
], ids=["overlong_request_line", "overlong_header"])
def test_server_rejects_overlong_lines(request_bytes, status):
    def run(pkg):
        server = mod(pkg, "cluster.rpc").JsonHttpServer()
        server.route("GET", "/ok", lambda q, b: {"ok": True})
        server.start()
        try:
            with socket.create_connection(("127.0.0.1", server.port),
                                          timeout=5.0) as s:
                s.sendall(request_bytes)
                line = s.recv(65536).split(b"\r\n", 1)[0]
        finally:
            server.stop()
        assert status in line
        return line
    both(run)


def test_server_ignores_truncated_request():
    """EOF mid-headers must not route a half-request."""
    hits = []
    server = rpc.JsonHttpServer()
    server.route("POST", "/mutate", lambda q, b: hits.append(1) or {})
    server.start()
    try:
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=5.0) as s:
            s.sendall(b"POST /mutate HTTP/1.1\r\nContent-Le")
        time.sleep(0.1)  # connection closed mid-headers
        assert hits == []
    finally:
        server.stop()


# -- byte ranges -------------------------------------------------------------

RANGES = [("bytes=0-4", 10), ("bytes=5-", 10), ("bytes=-3", 10),
          ("bytes=-30", 10), ("bytes=3-300", 10), ("bytes=0-0", 1),
          ("bytes=x-2", 10), ("bytes=1-2,4-5", 10), ("bytes=--10", 10),
          ("bytes=+5-6", 10), ("items=0-4", 10), ("bytes=-", 10),
          ("bytes=10-12", 10), ("bytes=5-2", 10)]


def test_parse_byte_range_matches_reference():
    def run(pkg):
        parse = mod(pkg, "cluster.rpc").parse_byte_range
        out = []
        for r, size in RANGES:
            got = outcome(parse, r, size)
            out.append(got if got[0] == "ok" else got[:2])
        return out
    both(run)


def test_reversed_range_serves_whole_body_in_both_packages():
    """A reference fault kept for parity: `bytes=5-2` (last < first)
    parses to None, so the server answers 200 with the whole body where
    Go's net/http answers 416.  A fix belongs in both packages at once
    (ROADMAP queue 3)."""
    ref, port = pair("cluster.rpc")
    assert ref.parse_byte_range("bytes=5-2", 10) is None
    assert port.parse_byte_range("bytes=5-2", 10) is None


# -- front door: the transport matrix ----------------------------------------

@pytest.mark.parametrize("transport", TRANSPORTS)
def test_admission_shed_and_exemption(transport):
    """A saturated lane sheds with 429 + Retry-After on both transports,
    and /debug/ surfaces stay admission-exempt."""
    server = rpc.JsonHttpServer(
        transport=transport,
        admission=rpc.AdmissionControl(1, queue_depth=0, queue_timeout=0.1))
    gate = threading.Event()
    server.route("GET", "/work",
                 lambda q, b: (gate.wait(5.0), {"ok": True})[1])
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    results: list = []

    def one():
        try:
            results.append(("ok", rpc.call(f"{base}/work", timeout=10.0)))
        except rpc.RpcError as e:
            results.append(("shed", e))

    try:
        threads = [threading.Thread(target=one) for _ in range(5)]
        for th in threads:
            th.start()
        time.sleep(0.4)  # one holds the slot; the rest shed
        snap = rpc.call(f"{base}/debug/conns", timeout=5.0)
        assert snap["transport"] == transport
        gate.set()
        for th in threads:
            th.join()
    finally:
        server.stop()
    sheds = [e for kind, e in results if kind == "shed"]
    assert sheds and [r for kind, r in results if kind == "ok"]
    for e in sheds:
        assert e.status == 429 and e.retry_after is not None


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_phase_budget_rides_exemplar(transport):
    from seaweedfs_tpu_torch.stats import phases
    server = rpc.JsonHttpServer(transport=transport)

    def slowop(q, b):
        with phases.phase("disk"):
            time.sleep(0.2)
        time.sleep(0.08)
        return {"ok": True}

    server.route("GET", "/slowop", slowop)
    server.enable_metrics(f"fd_{transport}")
    server.start()
    try:
        assert rpc.call(
            f"http://127.0.0.1:{server.port}/slowop") == {"ok": True}
        ex = server.slo.exemplars()
        assert ex, "0.28s request must exemplar (threshold 0.25)"
        ph = ex[0]["phases"]
        assert 0.15 <= ph["disk"] <= 0.3
        assert ph.get("handler", 0) > 0.04
    finally:
        server.stop()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_trace_propagation(transport, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACES", "1")
    tracer.BUFFER.clear()
    server = rpc.JsonHttpServer(transport=transport)
    server.route("GET", "/traced", lambda q, b: {"ok": True})
    from seaweedfs_tpu_torch.trace import setup_server_tracing
    setup_server_tracing(server, "fdsvc")
    server.start()
    try:
        with tracer.root_span("client.op", "testclient") as root:
            assert rpc.call(
                f"http://127.0.0.1:{server.port}/traced",
                headers={tracer.TRACEPARENT_HEADER: root.traceparent()}
            ) == {"ok": True}
            trace_id = root.trace_id
        spans = tracer.BUFFER.get(trace_id)
        srv = [s for s in spans if s["service"] == "fdsvc"]
        assert srv and srv[0]["name"] == "GET /traced"
    finally:
        server.stop()
        tracer.BUFFER.clear()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_pipelined_keepalive_requests(transport):
    """Two requests written back to back before reading: the aio loop
    must replay buffered leftover bytes after a handoff."""
    server = rpc.JsonHttpServer(transport=transport)
    server.route("GET", "/a", lambda q, b: {"n": 1})
    server.route("GET", "/b", lambda q, b: {"n": 2})
    server.start()
    try:
        s = socket.create_connection(("127.0.0.1", server.port),
                                     timeout=5.0)
        s.sendall(b"GET /a HTTP/1.1\r\nHost: x\r\n\r\n"
                  b"GET /b HTTP/1.1\r\nHost: x\r\n\r\n")
        buf = b""
        deadline = time.time() + 5.0
        while buf.count(b"HTTP/1.1 200") < 2 and time.time() < deadline:
            buf += s.recv(65536)
        assert b'{"n": 1}' in buf and b'{"n": 2}' in buf
        s.close()
    finally:
        server.stop()


def test_env_default_transport(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_TRANSPORT", "aio")
    server = rpc.JsonHttpServer()
    server.route("GET", "/t", lambda q, b: {"ok": True})
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert rpc.call(f"{base}/t") == {"ok": True}
        assert rpc.call(f"{base}/debug/conns")["transport"] == "aio"
    finally:
        server.stop()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_debug_conns_and_gauge(transport):
    server = rpc.JsonHttpServer(transport=transport)
    server.route("GET", "/t", lambda q, b: {"ok": True})
    reg = server.enable_metrics(f"connrole_{transport}")
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert rpc.call(f"{base}/t") == {"ok": True}
        snap = rpc.call(f"{base}/debug/conns")
        assert snap["transport"] == transport
        assert snap["open"] >= 1
        assert sum(snap["states"].values()) == snap["open"]
        for k in ("peer", "state", "age_s", "idle_s", "requests"):
            assert k in snap["conns"][0]
        text = reg.expose()
        assert "SeaweedFS_open_connections{" in text
        assert f'role="connrole_{transport}"' in text
        assert validate_exposition(text) == []
    finally:
        server.stop()
