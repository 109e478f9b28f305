"""The port's SLO plane (stats/slo.py, with stats/sketch.py and
stats/hotkeys.py beneath it, and the rpc middleware that feeds it)
against seaweedfs_tpu's: the cases of tests/test_slo.py that need no
volume server, each run for both packages with injected clocks and the
answers (quantiles, burn states, exemplars, labels) held equal; plus the
master's half of the aggregation cases, with heartbeats standing in for
the volume servers (the live-server cases are in
tests/test_torch_volume_planes.py)."""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from _torch_cluster import both, hermetic_port_state, mod  # noqa: F401
from seaweedfs_tpu_torch.cluster import rpc
from seaweedfs_tpu_torch.cluster.master import MasterServer
from seaweedfs_tpu_torch.stats.slo import SloTracker

pytestmark = pytest.mark.torch


def _sk(pkg):
    return mod(pkg, "stats.sketch")


def _slo(pkg):
    return mod(pkg, "stats.slo")


# -- quantile sketch: documented accuracy bound ------------------------------

def _bound(pkg, values, alpha=0.01):
    """The sketch's guarantee: the reported q-quantile is within relative
    error alpha of the true (nearest-rank) q-quantile."""
    sk = _sk(pkg).QuantileSketch(alpha=alpha)
    for v in values:
        sk.observe(float(v))
    arr = np.sort(np.asarray(values))
    out = []
    for q in (0.01, 0.1, 0.5, 0.9, 0.95, 0.99, 0.999):
        est = sk.quantile(q)
        true = float(arr[max(0, int(np.ceil(q * len(arr))) - 1)])
        assert abs(est - true) <= alpha * true + 1e-12, (q, est, true)
        out.append(est)
    return out


@pytest.mark.parametrize("name", ["heavy_tail", "bimodal",
                                  "lognormal_and_constant"])
def test_sketch_accuracy(name):
    if name == "heavy_tail":
        sets = [np.random.default_rng(7).pareto(1.5, 50000) * 1e-3 + 1e-5]
    elif name == "bimodal":
        rng = np.random.default_rng(8)
        sets = [np.concatenate([rng.lognormal(-8.0, 0.3, 40000),
                                rng.lognormal(-2.0, 0.4, 1000)])]
    else:
        sets = [np.random.default_rng(9).lognormal(-7.0, 1.5, 30000),
                np.full(1000, 0.0042)]
    both(lambda pkg: [_bound(pkg, v) for v in sets])


def test_sketch_zero_and_empty():
    def run(pkg):
        sk = _sk(pkg).QuantileSketch()
        assert sk.quantile(0.5) is None
        sk.observe(0.0)          # below min_value -> zero bucket
        sk.observe(1e-9)
        assert sk.quantile(0.5) == sk.min_value and sk.count == 2
        return sk.to_dict()
    both(run)


def test_sketch_merge_equals_concatenated_stream():
    rng = np.random.default_rng(10)
    a, b = rng.pareto(2.0, 5000) * 1e-3, rng.lognormal(-6, 1, 5000)

    def run(pkg):
        qs = _sk(pkg).QuantileSketch
        whole, left, right = qs(), qs(), qs()
        for v in np.concatenate([a, b]):
            whole.observe(float(v))
        for v in a:
            left.observe(float(v))
        for v in b:
            right.observe(float(v))
        left.merge(right)
        assert left.count == whole.count
        got = [left.quantile(q) for q in (0.05, 0.5, 0.95, 0.99)]
        assert got == [whole.quantile(q) for q in (0.05, 0.5, 0.95, 0.99)]
        return got
    both(run)


def test_sketch_merge_parameter_mismatch_raises():
    def run(pkg):
        qs = _sk(pkg).QuantileSketch
        with pytest.raises(ValueError) as ei:
            qs(alpha=0.01).merge(qs(alpha=0.02))
        return str(ei.value)
    both(run)


def test_sketch_wire_roundtrip_and_dict_merge():
    rng = np.random.default_rng(11)
    streams = [rng.lognormal(-6, 1, 2000) for _ in range(3)]

    def run(pkg):
        qs, merge = _sk(pkg).QuantileSketch, _slo(pkg).merge_sketch_dicts
        sketches = []
        for s in streams:
            sk = qs()
            for v in s:
                sk.observe(float(v))
            sketches.append(sk)
        dicts = [sk.to_dict() for sk in sketches]
        rt = qs.from_dict(dicts[0])
        assert rt.quantile(0.99) == sketches[0].quantile(0.99)
        assert rt.count == sketches[0].count
        merged = merge(dicts)
        live = qs()
        for sk in sketches:
            live.merge(sk)
        assert merged.count == live.count
        assert merged.quantile(0.95) == live.quantile(0.95)
        # Garbage entries are skipped, never fatal.
        assert merge([{"junk": 1}, dicts[0]]).count == 2000
        assert merge([{"buckets": [1, 2]}, {"buckets": "zzz", "alpha": 0.01},
                      {"alpha": "NaN is fine", "buckets": {"1": "x"}},
                      dicts[0]]).count == 2000
        assert merge([]) is None
        return dicts, merged.to_dict()
    both(run)


def test_windowed_sketch_rolls_with_injected_clock():
    def run(pkg):
        t = [0.0]
        w = _sk(pkg).WindowedSketch(window=60.0, slices=6,
                                    clock=lambda: t[0])
        for _ in range(100):
            w.observe(0.001)
        t[0] = 30.0
        for _ in range(100):
            w.observe(1.0)
        seen = [w.count(), w.quantile(0.25)]
        assert seen[0] == 200 and seen[1] < 0.01
        t[0] = 65.0                        # the t=0 slice expired
        seen += [w.count(), w.quantile(0.5)]
        assert seen[2] == 100
        assert seen[3] == pytest.approx(1.0, rel=0.02)
        t[0] = 200.0                       # everything expired
        assert w.count() == 0 and w.quantile(0.5) is None
        w.observe(0.5)  # ring reuse must not resurrect old epochs
        assert w.count() == 1
        return seen
    both(run)


# -- space-saving heavy hitters ----------------------------------------------

def test_space_saving_exact_when_under_capacity():
    keys = np.random.default_rng(12).integers(0, 40, 5000)

    def run(pkg):
        ss = mod(pkg, "stats.hotkeys").SpaceSaving(capacity=64)
        truth: dict[int, int] = {}
        for k in keys:
            ss.offer(int(k))
            truth[int(k)] = truth.get(int(k), 0) + 1
        top = ss.top(64)
        for row in top:
            assert row["error"] == 0 and row["count"] == truth[row["key"]]
        return top
    both(run)


def test_space_saving_bounded_error_under_zipf():
    capacity, n = 64, 50000
    ranks = np.arange(1, 5001)
    probs = 1.0 / ranks ** 1.2
    keys = np.random.default_rng(13).choice(ranks, size=n,
                                            p=probs / probs.sum())

    def run(pkg):
        ss = mod(pkg, "stats.hotkeys").SpaceSaving(capacity=capacity)
        truth: dict[int, int] = {}
        for k in keys:
            ss.offer(int(k))
            truth[int(k)] = truth.get(int(k), 0) + 1
        top = ss.top(capacity)
        min_count = min(row["count"] for row in top)
        for row in top:
            true = truth.get(row["key"], 0)
            assert true <= row["count"] <= true + row["error"]
            assert row["error"] <= min_count <= n / capacity + min_count
        tracked = {row["key"] for row in top}
        for key, cnt in truth.items():
            if cnt > n / capacity:
                assert key in tracked, (key, cnt)
        return top
    both(run)


def test_hot_key_tracker_snapshot_shape():
    def run(pkg):
        hk = mod(pkg, "stats.hotkeys").HotKeyTracker(capacity=8)
        for _ in range(5):
            hk.read(3, 0x172, "10.0.0.1")
        hk.write(4, 0x9, "10.0.0.2")
        snap = hk.snapshot(k=4)
        dims = snap["dimensions"]
        assert dims["volume"]["read"]["top"][0]["key"] == 3
        assert dims["needle"]["read"]["top"][0]["key"] == "3,172"
        assert dims["client"]["write"]["top"][0]["key"] == "10.0.0.2"
        hk.clear()
        assert hk.snapshot()["dimensions"]["volume"]["read"]["total"] == 0
        return dims
    both(run)


# -- burn-rate engine (deterministic clock) ----------------------------------

def _tracker(pkg, clock, **obj):
    tr = _slo(pkg).SloTracker("t", node="t:1", clock=clock,
                              short_window=60.0, long_window=360.0)
    tr.set_objectives(**obj)
    return tr


def test_undeclared_objectives_never_burn():
    def run(pkg):
        tr = _tracker(pkg, lambda: 100.0)
        for _ in range(50):
            tr.observe("/needle", "GET", 500, 2.0)
        state = tr.burn_state()
        assert not state["declared"] and not state["fast_burn"]
        return state
    both(run)


def test_availability_fast_burn_and_recovery():
    def run(pkg):
        events = mod(pkg, "events")
        t = [100.0]
        tr = _tracker(pkg, lambda: t[0], availability=0.999)
        before = events.events_total.value(type="slo.burn")
        for i in range(40):
            tr.observe("/needle", "GET", 500 if i % 2 else 200, 0.001)
        states = [tr.burn_state()]
        # 50% errors / 0.1% budget = 500x burn in both windows.
        assert states[0]["fast_burn"]
        assert states[0]["availability"]["short"]["burn"] >= 14.4
        assert events.events_total.value(type="slo.burn") == before + 1
        tr.burn_state()  # still burning: no second event
        assert events.events_total.value(type="slo.burn") == before + 1
        t[0] += 70.0  # errors stop, the short window expires
        for _ in range(20):
            tr.observe("/needle", "GET", 200, 0.001)
        states.append(tr.burn_state())
        assert not states[1]["fast_burn"]
        for _ in range(40):
            tr.observe("/needle", "GET", 500, 0.001)
        states.append(tr.burn_state())
        assert states[2]["fast_burn"]
        assert events.events_total.value(type="slo.burn") == before + 2
        return states
    both(run)


def test_latency_burn_counts_slow_reads_only():
    """The read-p99 burn divides by reads: 10 slow reads among 90 writes
    must still fast-burn."""
    def run(pkg):
        tr = _tracker(pkg, lambda: 50.0, read_p99=0.010)
        for _ in range(10):
            tr.observe("/needle", "GET", 200, 0.050)
        for _ in range(90):
            tr.observe("/needle", "POST", 200, 0.050)
        state = tr.burn_state()
        assert state["fast_burn"]
        assert state["latency"]["short"]["breaching"] == 10
        assert state["latency"]["short"]["total"] == 10
        return state
    both(run)


def test_sheds_do_not_pollute_latency_sketches():
    def run(pkg):
        tr = _tracker(pkg, lambda: 20.0, availability=0.999)
        tr.observe("/needle", "GET", 200, 0.020)
        for _ in range(50):
            tr.observe("/needle", "GET", 429, 0.0)
        agg = tr.agg_quantiles("read")
        assert agg["count"] == 1
        assert agg["p50"] == pytest.approx(0.020, rel=0.03)
        st = tr.burn_state()["availability"]["short"]
        assert st["shed"] == 50 and st["total"] == 1
        assert st["breaching"] == 0
        return agg, st
    both(run)


def test_burn_needs_minimum_traffic():
    def run(pkg):
        tr = _tracker(pkg, lambda: 10.0, availability=0.999)
        for _ in range(_slo(pkg).SloTracker.MIN_WINDOW_REQUESTS - 1):
            tr.observe("/needle", "GET", 500, 0.001)
        state = tr.burn_state()
        assert not state["fast_burn"]
        return state
    both(run)


def test_control_plane_excluded_from_burn_and_agg():
    def run(pkg):
        tr = _tracker(pkg, lambda: 10.0, availability=0.999)
        for _ in range(50):
            tr.observe("/admin/scrub", "POST", 500, 0.001)
            tr.observe("/debug/*", "GET", 500, 0.001)
        state = tr.burn_state()
        assert not state["fast_burn"]
        assert state["availability"]["short"]["total"] == 0
        assert tr.agg_quantiles("read")["count"] == 0
        families = tr.snapshot()["families"]
        assert "/admin/scrub 5xx" in families  # per-family sketches see it
        return state, families
    both(run)


def test_objectives_validation():
    def run(pkg):
        obj = _slo(pkg).SloObjectives
        assert obj(availability=99.9).availability == pytest.approx(0.999)
        with pytest.raises(ValueError) as ei:
            obj(read_p99=-1.0)
        assert not obj().declared
        return str(ei.value)
    both(run)


def test_exemplars_ring_is_bounded_newest_first():
    def run(pkg):
        tr = _slo(pkg).SloTracker("t", clock=lambda: 5.0,
                                  exemplar_capacity=4)
        tr.set_objectives(read_p99=0.001)
        for i in range(10):
            tr.observe("/needle", "GET", 200, 0.5, trace_id=f"tid{i}")
        ex = tr.exemplars(10)
        assert len(ex) == 4 and tr.exemplars_recorded == 10
        assert [e["trace_id"] for e in ex] == ["tid9", "tid8", "tid7",
                                               "tid6"]
        assert ex[0]["seconds"] == 0.5
        return [{k: v for k, v in e.items() if k != "ts"} for e in ex]
    both(run)


# -- rpc middleware: labels, family normalization, sheds ---------------------

def test_endpoint_family_bounds_cardinality():
    cases = [("/dir/assign", True), ("/admin/ec/generate", True),
             ("/admin/minted-by-client-7", False), ("/3,0172cb7d88", False),
             ("/3,0172cb7d88/img.jpg", False), ("/debug/whatever", False),
             ("/any/user/path.txt", False)]

    def run(pkg):
        fam = mod(pkg, "cluster.rpc").endpoint_family
        got = [fam(p, literal=lit) for p, lit in cases]
        assert got == ["/dir/assign", "/admin/ec/generate", "/other",
                       "/needle", "/needle", "/debug/*", "/other"]
        return got
    both(run)


def test_request_histogram_status_and_family_labels():
    def run(pkg):
        rpcm = mod(pkg, "cluster.rpc")
        server = rpcm.JsonHttpServer()
        server.route("GET", "/admin/thing", lambda q, b: {"ok": 1})

        def boom(q, b):
            raise RuntimeError("kaboom")

        def missing(q, b):
            raise rpcm.RpcError(404, "nope")
        server.route("GET", "/boom", boom)
        server.route("GET", "/gone", missing)
        server.prefix_route("GET", "/", lambda p, q, b: {"path": p})
        reg = server.enable_metrics("labeltest")
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            rpcm.call(f"{base}/admin/thing")
            rpcm.call(f"{base}/3,0172abcd")        # prefix -> /needle
            rpcm.call(f"{base}/some/user/file")    # prefix -> /other
            for path in ("/boom", "/gone"):
                with pytest.raises(rpcm.RpcError):
                    rpcm.call(f"{base}{path}")
            text = reg.expose()
            fams = server.slo.snapshot()["families"]
        finally:
            server.stop()
        for needle in ('SeaweedFS_labeltest_request_seconds_bucket{'
                       'family="/admin/thing"', 'family="/needle"',
                       'family="/other"',
                       'family="/boom",le="+Inf",status="5xx"',
                       'family="/gone",le="+Inf",status="4xx"',
                       'SeaweedFS_labeltest_request_total{type="GET"} 5'):
            assert needle in text
        assert mod(pkg, "stats.promcheck").validate_exposition(text) == []
        assert "/boom 5xx" in fams and "/gone 4xx" in fams
        assert fams["/needle 2xx"]["count"] == 1
        return sorted(fams), sorted(
            line.split(" ")[0] for line in text.splitlines()
            if "labeltest_request_total" in line and
            not line.startswith("#"))
    both(run)


def test_admission_shed_lands_in_error_tail():
    server = rpc.JsonHttpServer(admission=rpc.AdmissionControl(
        1, queue_depth=0, queue_timeout=0.05))
    server.route("GET", "/slow",
                 lambda q, b: (time.sleep(0.4), {"ok": True})[1])
    reg = server.enable_metrics("shedtest")
    server.slo.set_objectives(availability=0.999)
    server.start()
    statuses = []

    def call_slow():
        try:
            rpc.call(f"http://127.0.0.1:{server.port}/slow", timeout=5.0)
            statuses.append(200)
        except rpc.RpcError as e:
            statuses.append(e.status)
    try:
        threads = [threading.Thread(target=call_slow) for _ in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert 429 in statuses
        assert 'family="/slow",le="+Inf",status="4xx"' in reg.expose()
        burn = server.slo.burn_state()
        assert burn["availability"]["short"]["shed"] >= 1
        assert burn["availability"]["short"]["breaching"] == 0
    finally:
        server.stop()


def test_enable_metrics_idempotent_no_duplicate_families():
    def run(pkg):
        server = mod(pkg, "cluster.rpc").JsonHttpServer()
        reg1 = server.enable_metrics("duptest")
        assert server.enable_metrics("duptest") is reg1
        metrics = mod(pkg, "stats.metrics")
        for _ in range(2):  # process-global singletons re-registered
            reg1.register_once(metrics.ec_stage_seconds)
            reg1.register_once(metrics.ec_stage_bytes)
        text = reg1.expose()
        counts = [text.count(f"# TYPE {f}") for f in (
            "SeaweedFS_duptest_request_total",
            "SeaweedFS_request_quantile_seconds",
            "SeaweedFS_ec_stage_seconds")]
        assert counts == [1, 1, 1]
        assert mod(pkg, "stats.promcheck").validate_exposition(text) == []
        server.stop()
        return counts
    both(run)


# -- the master's half: sketches carried by heartbeats -----------------------

def _node_view(seed: int) -> dict:
    tr = SloTracker("volume", clock=lambda: 1.0)
    for s in np.random.default_rng(seed).lognormal(-7, 1, 40):
        tr.observe("/needle", "GET", 200, float(s))
    return tr.heartbeat_view()


def test_healthz_aggregates_node_sketches():
    """Every node's heartbeat sketches fold, with the master's own, into
    one cluster-wide tail on /cluster/healthz."""
    m = MasterServer(pulse_seconds=60)
    m.start()
    try:
        views = [_node_view(s) for s in (1, 2)]
        for port, view in zip((4201, 4202), views):
            rpc.call(m.url() + "/heartbeat", "POST", json.dumps(
                {"ip": "127.0.0.1", "port": port, "slo": view}).encode())
        status, doc = rpc.call_status(m.url() + "/cluster/healthz")
        assert status == 200, doc.get("problems")
        slo_doc = doc["slo"]
        assert slo_doc["sources"] == 3  # the master and both nodes
        own = m.server.slo.agg_quantiles("read")["count"]
        assert 80 <= slo_doc["read"]["count"] <= 80 + own
        assert slo_doc["read"]["p99"] > 0
        assert all("slo" in n for n in doc["nodes"])
    finally:
        m.stop()


def test_dead_node_slo_state_excluded_from_rollup():
    """A dead node's final heartbeat verdict drops out of the rollup
    once its heartbeat goes stale."""
    m = MasterServer(pulse_seconds=60)
    m.start()
    try:
        poisoned = {"declared": True, "fast_burn": True, "slow_burn": False,
                    "read": {"alpha": 0.01, "min_value": 1e-6,
                             "count": 10 ** 9, "sum": 1.0, "zero": 0,
                             "buckets": {"600": 10 ** 9}}}
        rpc.call(m.url() + "/heartbeat", "POST", json.dumps(
            {"ip": "127.0.0.1", "port": 4203, "slo": poisoned}).encode())
        _st, doc = rpc.call_status(m.url() + "/cluster/healthz")
        assert any("SLO fast burn" in p for p in doc["problems"])
        assert doc["slo"]["read"]["count"] >= 10 ** 9
        next(iter(m.topo.leaves())).last_seen = 0.0  # the node dies
        _st, doc = rpc.call_status(m.url() + "/cluster/healthz")
        assert not any("SLO fast burn" in p for p in doc["problems"])
        assert doc["slo"]["read"]["count"] < 10 ** 9
    finally:
        m.stop()
