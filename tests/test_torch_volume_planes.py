"""The tenancy, SLO and lifecycle planes on a live volume server: the
VolumeServer cases of tests/test_tenancy.py and tests/test_slo.py and
the end-to-end tiering and TTL cases of tests/test_lifecycle.py, each
run once for the JAX package and once for the port (`pkg`).  Their
filer halves are not held here (the filer is ported, slice 11a) and
their S3 halves wait for slice 11b, so the tenant cases write straight
to the volume server.

- tenancy: a hard quota rejects assigns once the heartbeat rollup
  passes it, a delete reclaims, the volume ledger agrees; a flooding
  tenant is throttled with 429 + Retry-After while the victim's p99
  holds;
- SLO: a server re-created in one process scrapes promcheck-clean;
  /cluster/healthz folds every node's sketches; a dead node's verdict
  leaves the rollup; a slow read fault leaves exemplars whose traces
  resolve, burns the latency SLO and emits slo.burn;
- lifecycle: an idle rule tiers a cold volume with no read outage, the
  block cache serves re-reads and hot reads promote it back; a short
  TTL answers 404 past expiry, the expire rule vacuums and the holder
  retires the volume.
"""

from __future__ import annotations

import http.client
import os
import time
import urllib.parse

import pytest

from _torch_cluster import (LiveCluster, cluster_deadline,  # noqa: F401
                            device_kw, hermetic_port_state, mod, pkg)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]


def _http(url: str, method: str = "GET", body: bytes = b"",
          headers: dict | None = None):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=10)
    try:
        conn.request(method, u.path + (f"?{u.query}" if u.query else ""),
                     body=body or None, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _wait_until(fn, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not fn():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.1)


# -- tenancy -----------------------------------------------------------------

@pytest.fixture
def tenant_cluster(pkg, tmp_path):
    rules = tmp_path / "tenants.txt"
    rules.write_text("alice max_bytes=1KB\n"
                     "flood max_rps=5 weight=1\n"
                     "victim weight=4 max_bytes=1GB\n")
    c = LiveCluster(pkg, tmp_path, n=1,
                    master_kw={"tenant_rules": str(rules)},
                    vs_kw={"tenant_rules": str(rules), "pulse_seconds": 1})
    yield c
    c.stop()


def test_hard_quota_at_the_volume_server(tenant_cluster):
    c = tenant_cluster
    rpc, m = c.rpc, c.url()
    hdr = {"X-Weed-Tenant": "alice"}
    a = rpc.call(m + "/dir/assign", headers=hdr)
    rpc.call(f"http://{a['url']}/{a['fid']}", "POST", b"x" * 2048,
             headers=hdr)
    _wait_until(lambda: rpc.call(m + "/cluster/tenants")["tenants"]
                .get("alice", {}).get("bytes", 0) >= 2048,
                what="heartbeat usage rollup")
    st, _h, body = _http(m + "/dir/assign", headers=hdr)
    assert st == 403 and b"QuotaExceeded" in body
    evs = rpc.call(m + "/debug/events?type=quota.exceeded")
    assert any(e.get("attrs", {}).get("tenant") == "alice"
               for e in evs["events"])
    assert _http(m + "/dir/assign",
                 headers={"X-Weed-Tenant": "bob"})[0] == 200
    rpc.call(f"http://{a['url']}/{a['fid']}", "DELETE", headers=hdr)
    _wait_until(lambda: rpc.call(m + "/cluster/tenants")["tenants"]
                .get("alice", {}).get("bytes", 1) < 1024,
                what="usage reclaim after delete")
    b = rpc.call(m + "/dir/assign", headers=hdr)
    rpc.call(f"http://{b['url']}/{b['fid']}", "POST", b"w" * 100,
             headers=hdr)
    dt = rpc.call(f"http://{c.servers[0].url()}/debug/tenants")
    assert {r["tenant"]: r["bytes"] for r in dt["stored"]}["alice"] == 100


def test_noisy_neighbor_throttle_and_victim_p99(tenant_cluster):
    c = tenant_cluster
    rpc = c.rpc
    a = rpc.call(c.url() + "/dir/assign")
    url = f"http://{a['url']}/{a['fid']}"
    rpc.call(url, "POST", b"v" * 4096, headers={"X-Weed-Tenant": "victim"})
    before = rpc.tenant_throttled_total.value(tenant="flood")
    flood = {"X-Weed-Tenant": "flood"}
    shed, retry_after = 0, None
    t_end = time.monotonic() + 1.0
    while time.monotonic() < t_end:
        st, h, _b = _http(url, headers=flood)
        if st == 429:
            shed += 1
            retry_after = h.get("Retry-After") or retry_after
        time.sleep(0.02)
    assert shed > 0, "flood was never throttled"
    assert retry_after is not None and float(retry_after) > 0.0
    assert rpc.tenant_throttled_total.value(tenant="flood") >= before + shed
    lat = []
    for _ in range(40):
        _http(url, headers=flood)
        t0 = time.perf_counter()
        st, _h, body = _http(url, headers={"X-Weed-Tenant": "victim"})
        lat.append(time.perf_counter() - t0)
        assert st == 200 and len(body) == 4096
    lat.sort()
    assert lat[int(len(lat) * 0.99) - 1] < 0.5
    evs = rpc.call(f"http://{c.servers[0].url()}/debug/events"
                   "?type=tenant.throttled")
    assert any(e.get("attrs", {}).get("tenant") == "flood"
               for e in evs["events"])


# -- SLO ---------------------------------------------------------------------

def test_in_process_server_restart_scrape_stays_clean(pkg, tmp_path):
    validate = mod(pkg, "stats.promcheck").validate_exposition
    c = LiveCluster(pkg, tmp_path, n=1, master_kw={"volume_size_limit_mb": 16})
    try:
        client = c.client()
        fid = client.upload_data(b"restart payload")
        d = c.servers[0].store.locations[0].directory
        c.servers[0].stop()
        vs2 = mod(pkg, "cluster.volume_server").VolumeServer(
            c.url(), [d], pulse_seconds=60, **device_kw(pkg))
        vs2.start()
        c.servers.append(vs2)
        c.client().download(fid)
        text = c.rpc.call(f"http://{vs2.url()}/metrics").decode()
        assert validate(text) == [], validate(text)[:5]
        for fam in ("SeaweedFS_ec_stage_seconds",
                    "SeaweedFS_request_quantile_seconds",
                    "SeaweedFS_requests_shed_total"):
            assert text.count(f"# TYPE {fam}") == 1, fam
    finally:
        c.stop()


@pytest.fixture
def slo_cluster(pkg, tmp_path):
    c = LiveCluster(pkg, tmp_path, n=2, master_kw={"volume_size_limit_mb": 16},
                    vs_kw={"max_volume_counts": [100], "slo_read_p99": 0.5,
                           "slo_availability": 0.999})
    yield c
    c.stop()


def test_healthz_aggregates_node_sketches(slo_cluster):
    c = slo_cluster
    client = c.client()
    fid = client.upload_data(b"aggregation payload")
    for _ in range(4):
        client.download(fid)
    c.freshen()
    status, doc = c.rpc.call_status(f"{c.url()}/cluster/healthz")
    assert status == 200, doc.get("problems")
    slo_doc = doc["slo"]
    assert slo_doc["sources"] == 3
    assert slo_doc["read"]["count"] >= 4 and slo_doc["read"]["p99"] > 0
    node_counts = sum(
        getattr(dn, "slo_state", {}).get("read", {}).get("count", 0)
        for dn in c.master.topo.leaves())
    own = c.master.server.slo.agg_quantiles("read")["count"]
    assert node_counts <= slo_doc["read"]["count"] <= node_counts + own
    assert all("slo" in n for n in doc["nodes"])


def test_dead_node_slo_state_excluded_from_rollup(slo_cluster):
    c = slo_cluster
    dn = next(d for d in c.master.topo.leaves()
              if d.url() == c.servers[1].url())
    dn.slo_state = {"declared": True, "fast_burn": True, "slow_burn": False,
                    "read": {"alpha": 0.01, "min_value": 1e-6,
                             "count": 10 ** 9, "sum": 1.0, "zero": 0,
                             "buckets": {"600": 10 ** 9}}}
    _st, doc = c.rpc.call_status(f"{c.url()}/cluster/healthz")
    assert any("SLO fast burn" in p for p in doc["problems"])
    assert doc["slo"]["read"]["count"] >= 10 ** 9
    dn.last_seen = 0.0
    _st, doc = c.rpc.call_status(f"{c.url()}/cluster/healthz")
    assert not any("SLO fast burn" in p for p in doc["problems"])
    assert doc["slo"]["read"]["count"] < 10 ** 9


def test_acceptance_slow_fault_exemplar_trace_burn_healthz(
        pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACES", "1")
    monkeypatch.delenv("SEAWEEDFS_TPU_TRACE", raising=False)
    events, fault = mod(pkg, "events"), mod(pkg, "fault")
    c = LiveCluster(pkg, tmp_path, n=1, master_kw={"volume_size_limit_mb": 16},
                    vs_kw={"slo_read_p99": 0.010, "slo_availability": 0.99})
    try:
        vs, rpc = c.servers[0], c.rpc
        client = c.client()
        fid = client.upload_data(b"slow fault payload " * 8)
        burn_before = events.events_total.value(type="slo.burn")
        fault.arm("volume.read", "delay:0.05")
        try:
            for _ in range(15):
                client.download(fid)
        finally:
            fault.disarm_all()
        slow = rpc.call(f"http://{vs.url()}/debug/slow")
        assert slow["threshold_seconds"] == 0.010
        exemplars = [e for e in slow["exemplars"] if e["family"] == "/needle"]
        assert len(exemplars) >= 15
        assert all(e["seconds"] >= 0.05 for e in exemplars[:15])
        tid = exemplars[0]["trace_id"]
        trace = rpc.call(f"http://{vs.url()}/debug/traces?trace={tid}")
        assert tid and trace["trace_id"] == tid and trace["spans"]
        assert any(s["service"] == "volumeServer" for s in trace["spans"])
        vs._send_heartbeat(full=True)
        status, doc = rpc.call_status(f"{c.url()}/cluster/healthz")
        assert status == 503 and not doc["healthy"]
        assert any("SLO fast burn" in p for p in doc["problems"])
        assert vs.url() in doc["slo"]["fast_burn"]
        assert events.events_total.value(type="slo.burn") > burn_before
        evs = events.JOURNAL.snapshot(type_="slo.burn")
        assert evs and evs[-1]["attrs"]["slo"] == "latency"
        assert evs[-1]["trace_id"]
    finally:
        c.stop()


# -- lifecycle ---------------------------------------------------------------

@pytest.fixture
def lc_cluster(pkg, tmp_path):
    c = LiveCluster(pkg, tmp_path, n=1, master_kw={"volume_size_limit_mb": 16},
                    vs_kw={"tier_promote_hits": 3,
                           "tier_promote_window": 60.0})
    yield c
    c.stop()


def _fresh_volume(c, col: str, ttl: str = ""):
    q = f"&ttl={ttl}" if ttl else ""
    c.rpc.call(f"{c.url()}/vol/grow?count=1&collection={col}{q}", "POST")
    a = c.rpc.call(f"{c.url()}/dir/assign?collection={col}{q}")
    payload = f"{col} payload ".encode() * 64
    c.rpc.call(f"http://{a['url']}/{a['fid']}", "POST", payload)
    c.servers[0]._send_heartbeat(full=True)
    return int(a["fid"].split(",")[0]), a["fid"], payload


def test_e2e_idle_tiering_cache_and_promotion(lc_cluster, tmp_path):
    c = lc_cluster
    lc = mod(c.pkg, "lifecycle")
    cache = mod(c.pkg, "storage.remote_cache").CACHE
    vs, client = c.servers[0], c.client()
    vid, fid, payload = _fresh_volume(c, "cold1")
    daemon = lc.LifecycleDaemon(c.master, lc.Policy([lc.Rule(
        collection="cold1", action="tier", dest=f"local://{tmp_path}/tier",
        idle_for=0.05)]), interval=3600, mbps=0)
    out = daemon.scan_once()
    assert out["tiered"] == [] and out["errors"] == []
    time.sleep(0.3)
    out = daemon.scan_once()
    assert out["tiered"] == [vid], out
    v = vs.store.find_volume(vid)
    assert v.remote_file is not None and v.readonly
    assert not os.path.exists(v.file_name() + ".dat")
    s0 = cache.stats()
    for _ in range(3):
        assert client.download(fid) == payload
    s1 = cache.stats()
    hit_d = s1["hit_bytes"] - s0["hit_bytes"]
    miss_d = s1["miss_bytes"] - s0["miss_bytes"]
    assert miss_d > 0 and hit_d > miss_d, (hit_d, miss_d)
    vs._lifecycle_tick()
    _wait_until(lambda: vs.store.find_volume(vid).remote_file is None,
                timeout=15, what="promotion")
    v = vs.store.find_volume(vid)
    assert os.path.exists(v.file_name() + ".dat")
    assert not os.path.exists(v.file_name() + ".vif")
    assert client.download(fid) == payload


def test_e2e_ttl_expiry_vacuum_and_volume_retirement(lc_cluster):
    c = lc_cluster
    lc, expiry = mod(c.pkg, "lifecycle"), mod(c.pkg, "storage.expiry")
    vs, client = c.servers[0], c.client()
    vid, fid, payload = _fresh_volume(c, "scratch1", ttl="1m")
    assert client.download(fid) == payload
    v = vs.store.find_volume(vid)
    assert v.super_block.ttl.minutes() == 1
    before_dat = v.dat_size()
    base_now = time.time()
    expiry.set_clock(lambda: base_now + 90.0)
    try:
        with pytest.raises(c.rpc.RpcError) as ei:
            client.download(fid)
        assert ei.value.status == 404
        daemon = lc.LifecycleDaemon(c.master, lc.Policy([lc.Rule(
            collection="scratch1", action="expire")]), interval=3600)
        out = daemon.scan_once()
        assert vid in out["vacuumed"], out
        assert vs.store.find_volume(vid).dat_size() < before_dat
        assert vs.store.find_volume(vid).file_count() == 0
        expiry.set_clock(lambda: base_now + 600.0)
        vs._lifecycle_tick()
        assert vs.store.find_volume(vid) is None
    finally:
        expiry.reset_clock()
