"""The port's RPC resilience policy (cluster/resilience.py) against
seaweedfs_tpu's: the cases of tests/test_resilience.py.  Cases whose
answer is deterministic (attempt sequences, breaker states, parsed
headers) run for both packages and are held equal; cases that sleep
through a cooldown or a deadline run for the port alone, asserting the
reference's behaviour, so they sleep no longer than their twins."""

from __future__ import annotations

import threading
import time

import pytest

from _torch_cluster import both, hermetic_port_state, mod  # noqa: F401
from seaweedfs_tpu_torch.cluster import resilience, rpc
from seaweedfs_tpu_torch.cluster.resilience import (BreakerOpen,
                                                    CircuitBreaker,
                                                    ConnectError,
                                                    RetryPolicy)

pytestmark = pytest.mark.torch


def _res(pkg):
    return mod(pkg, "cluster.resilience")


# -- RetryPolicy -------------------------------------------------------------

def test_backoff_full_jitter_bounds():
    p = RetryPolicy(base_delay=0.1, max_delay=1.0)
    for attempt in range(8):
        cap = min(1.0, 0.1 * 2 ** attempt)
        for _ in range(20):
            assert 0.0 <= p.backoff(attempt) <= cap


def test_retries_connect_errors_even_non_idempotent():
    def run(pkg):
        res = _res(pkg)
        calls = []

        def fn(attempt, timeout):
            calls.append(attempt)
            if len(calls) < 3:
                raise res.ConnectError("dial failed")
            return "ok"

        p = res.RetryPolicy(max_attempts=3, base_delay=0.001, max_delay=0.002)
        assert p.run(fn, idempotent=False) == "ok"
        assert calls == [0, 1, 2]
        return calls
    both(run)


def test_non_idempotent_never_retries_after_send():
    """Once bytes may have hit the wire, a non-idempotent body must not
    be re-sent; the same failure is retried when idempotent."""
    def run(pkg):
        calls = []

        def fn(attempt, timeout):
            calls.append(attempt)
            raise ConnectionResetError("mid-exchange")

        p = _res(pkg).RetryPolicy(max_attempts=3, base_delay=0.001)
        seen = []
        for idem in (False, True):
            calls.clear()
            with pytest.raises(ConnectionResetError):
                p.run(fn, idempotent=idem)
            seen.append(list(calls))
        assert seen == [[0], [0, 1, 2]]
        return seen
    both(run)


def test_5xx_retried_only_when_idempotent():
    def run(pkg):
        err = mod(pkg, "cluster.rpc").RpcError
        calls = []

        def fn(attempt, timeout):
            calls.append(attempt)
            raise err(503, "unavailable")

        p = _res(pkg).RetryPolicy(max_attempts=2, base_delay=0.001)
        seen = []
        for idem in (False, True):
            calls.clear()
            with pytest.raises(err):
                p.run(fn, idempotent=idem)
            seen.append(list(calls))
        assert seen == [[0], [0, 1]]
        return seen
    both(run)


def test_4xx_never_retried():
    def run(pkg):
        err = mod(pkg, "cluster.rpc").RpcError
        calls = []

        def fn(attempt, timeout):
            calls.append(attempt)
            raise err(404, "not found")

        with pytest.raises(err):
            _res(pkg).RetryPolicy(max_attempts=3, base_delay=0.001).run(fn)
        assert calls == [0]
        return calls
    both(run)


def test_total_deadline_bounds_attempts_and_timeout():
    seen = []

    def fn(attempt, timeout):
        seen.append(timeout)
        time.sleep(0.05)
        raise ConnectError("down")

    p = RetryPolicy(max_attempts=50, base_delay=0.0, max_delay=0.0,
                    per_attempt_timeout=10.0, total_deadline=0.2)
    t0 = time.monotonic()
    with pytest.raises(ConnectError):
        p.run(fn)
    assert time.monotonic() - t0 < 2.0
    assert len(seen) < 50
    assert all(t <= 10.0 for t in seen)
    assert seen[0] <= 0.2 + 0.01


def test_retry_counter_increments():
    def run(pkg):
        res = _res(pkg)
        before = res.rpc_retries_total.value(reason="connect")

        def fn(attempt, timeout):
            if attempt == 0:
                raise res.ConnectError("dial")
            return "ok"

        res.RetryPolicy(max_attempts=2, base_delay=0.001).run(fn)
        delta = res.rpc_retries_total.value(reason="connect") - before
        assert delta == 1
        return delta
    both(run)


# -- CircuitBreaker ----------------------------------------------------------

def test_breaker_opens_after_threshold_and_half_open_probe():
    b = CircuitBreaker(threshold=3, cooldown=0.1)
    assert b.state == "closed"
    for _ in range(2):
        b.record_failure()
    assert b.state == "closed" and b.allow()
    b.record_failure()
    assert b.state == "open" and not b.allow()
    time.sleep(0.12)
    assert b.allow()               # the half-open probe
    assert b.state == "half-open"
    assert not b.allow()           # only one probe at a time
    b.record_success()
    assert b.state == "closed" and b.allow()


def test_breaker_half_open_failure_reopens():
    b = CircuitBreaker(threshold=1, cooldown=0.05)
    b.record_failure()
    assert b.state == "open"
    time.sleep(0.06)
    assert b.allow()
    b.record_failure()             # probe failed
    assert b.state == "open" and not b.allow()


def test_breaker_success_resets_consecutive_count():
    def run(pkg):
        b = _res(pkg).CircuitBreaker(threshold=3, cooldown=1.0)
        states = []
        for step in ("f", "f", "s", "f", "f"):
            (b.record_failure if step == "f" else b.record_success)()
            states.append(b.state)
        assert states[-1] == "closed"     # never 3 consecutive
        return states
    both(run)


def test_breaker_disabled_with_zero_threshold():
    def run(pkg):
        b = _res(pkg).CircuitBreaker(threshold=0, cooldown=0.01)
        for _ in range(10):
            b.record_failure()
        assert b.allow()
        return b.state
    both(run)


def test_breaker_thread_safety_smoke():
    b = CircuitBreaker(threshold=5, cooldown=0.01)

    def churn():
        for i in range(500):
            b.allow()
            (b.record_failure if i % 3 else b.record_success)()

    threads = [threading.Thread(target=churn) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert b.state in ("closed", "half-open", "open")


# -- pool integration --------------------------------------------------------

def test_pool_connect_failures_open_breaker_and_fail_fast():
    """Dial failures to a dead host open its breaker; once open, the
    acquire fails fast with BreakerOpen."""
    port = rpc.free_port()  # nothing listens here
    url = f"http://127.0.0.1:{port}/x"
    for _ in range(resilience.BREAKER_THRESHOLD):
        with pytest.raises(ConnectionError):
            rpc.call(url, timeout=2.0)
    assert resilience.breaker_for(f"127.0.0.1:{port}").state == "open"
    t0 = time.monotonic()
    with pytest.raises(BreakerOpen):
        rpc.call(url, timeout=30.0)
    assert time.monotonic() - t0 < 0.5


def test_pool_dial_failure_is_connect_error():
    def run(pkg):
        rpcm = mod(pkg, "cluster.rpc")
        with pytest.raises(_res(pkg).ConnectError) as ei:
            rpcm.call(f"http://127.0.0.1:{rpcm.free_port()}/x", timeout=2.0)
        return type(ei.value).__name__
    both(run)


def test_success_closes_breaker_again():
    server = rpc.JsonHttpServer()
    server.route("GET", "/ok", lambda q, b: {"ok": True})
    server.start()
    try:
        hostport = f"127.0.0.1:{server.port}"
        b = resilience.breaker_for(hostport)
        for _ in range(resilience.BREAKER_THRESHOLD):
            b.record_failure()
        assert b.state == "open"
        b.cooldown = 0.01
        time.sleep(0.02)
        assert rpc.call(f"http://{hostport}/ok") == {"ok": True}
        assert b.state == "closed"
    finally:
        server.stop()


def test_resilience_metrics_on_scrape():
    def run(pkg):
        rpcm = mod(pkg, "cluster.rpc")
        servers = [rpcm.JsonHttpServer(), rpcm.JsonHttpServer()]
        reg = servers[0].enable_metrics("testrole")
        text = reg.expose()
        families = [f for f in ("SeaweedFS_rpc_retries_total",
                                "SeaweedFS_rpc_breaker_state",
                                "SeaweedFS_faults_injected_total")
                    if f in text]
        assert len(families) == 3
        # Two servers sharing a registry must not duplicate blocks.
        servers[1].enable_metrics("testrole2", registry=reg,
                                  serve_route=False)
        n = reg.expose().count("# TYPE SeaweedFS_rpc_retries_total counter")
        for server in servers:
            server.stop()
        assert n == 1
        return families, n
    both(run)


# -- overload protection (429 / Retry-After) ---------------------------------

class _StatusErr(Exception):
    def __init__(self, status, retry_after=None):
        super().__init__(f"status {status}")
        self.status = status
        self.retry_after = retry_after


def test_429_shed_retried_even_non_idempotent(monkeypatch):
    """An admission shed is refused before the handler runs, so a 429 is
    always safe to retry, even for a non-idempotent body."""
    def run(pkg):
        res = _res(pkg)
        monkeypatch.setattr(res.time, "sleep", lambda s: None)
        calls = []

        def fn(attempt, timeout):
            calls.append(attempt)
            if len(calls) < 3:
                raise _StatusErr(429)
            return "ok"

        p = res.RetryPolicy(max_attempts=3, base_delay=0.001)
        assert p.run(fn, idempotent=False) == "ok"
        assert calls == [0, 1, 2]
        return calls
    both(run)


def test_retry_after_is_backoff_floor_capped_at_attempt_budget(
        monkeypatch):
    def run(pkg):
        res = _res(pkg)
        slept = []
        monkeypatch.setattr(res.time, "sleep", slept.append)

        def fail_with(ra):
            def fn(attempt, timeout):
                raise _StatusErr(429, retry_after=ra)
            with pytest.raises(_StatusErr):
                res.RetryPolicy(max_attempts=2, base_delay=0.0001,
                                max_delay=0.001,
                                per_attempt_timeout=0.5).run(fn)
            return slept[-1]

        floor, cap = fail_with(0.3), fail_with(999.0)
        assert floor >= 0.3 and cap <= 0.5
        return floor, cap
    both(run)


def test_rpc_call_parses_retry_after_header():
    def run(pkg):
        rpcm = mod(pkg, "cluster.rpc")
        server = rpcm.JsonHttpServer()
        server.route("GET", "/shedme", lambda q, b: (
            429, {"error": "overloaded"}, {"Retry-After": "2.5"}))
        server.start()
        try:
            with pytest.raises(rpcm.RpcError) as ei:
                rpcm.call(f"http://127.0.0.1:{server.port}/shedme")
        finally:
            server.stop()
        assert ei.value.status == 429 and ei.value.retry_after == 2.5
        return ei.value.status, ei.value.retry_after, ei.value.message
    both(run)


def test_breaker_treats_429_like_503():
    """Deliberate shedding from a live process never opens the breaker;
    real 5xx answers keep counting toward opening it."""
    def run(pkg):
        rpcm, res = mod(pkg, "cluster.rpc"), _res(pkg)
        server = rpcm.JsonHttpServer()
        server.route("GET", "/shed", lambda q, b: (429, {"error": "busy"}))
        server.route("GET", "/sick", lambda q, b: (500, {"error": "ill"}))
        server.start()
        hostport = f"127.0.0.1:{server.port}"
        states = []
        try:
            for path, n in (("shed", res.BREAKER_THRESHOLD + 2),
                            ("sick", res.BREAKER_THRESHOLD)):
                for _ in range(n):
                    with pytest.raises(rpcm.RpcError):
                        rpcm.call(f"http://{hostport}/{path}")
                states.append(res.breaker_for(hostport).state)
        finally:
            server.stop()
            res.reset_breakers()
        assert states == ["closed", "open"]
        return states
    both(run)
