"""The port's tenancy & QoS plane (tenancy/) against seaweedfs_tpu's:
the unit cases of tests/test_tenancy.py (quota grammar, token buckets,
DRR fairness, usage ledger and rollup, per-tenant chunk-cache caps) run
for both packages with their answers held equal, and the master's half
of its end-to-end cases (403 QuotaExceeded at assign from the
heartbeat-fed rollup, the quota event, the rollup surviving a restart,
429 for a tenant over its rate, a clean scrape).  The volume-server
cases are in tests/test_torch_volume_planes.py; those that need a filer
are not held here (the filer is ported, slice 11a; the S3 gateway waits
for slice 11b)."""

from __future__ import annotations

import json
import time

import pytest

from _torch_cluster import both, hermetic_port_state, mod  # noqa: F401
from seaweedfs_tpu_torch.cluster import rpc
from seaweedfs_tpu_torch.cluster.master import MasterServer
from seaweedfs_tpu_torch.stats.promcheck import validate_exposition
from seaweedfs_tpu_torch.tenancy import TokenBucket

pytestmark = pytest.mark.torch


def _t(pkg):
    return mod(pkg, "tenancy")


# -- quota rule grammar ------------------------------------------------------

def test_parse_size():
    def run(pkg):
        parse_size = _t(pkg).parse_size
        sizes = [parse_size(s) for s in ("1024", "64MB", "1.5KB", "2GiB")]
        assert sizes == [1024, 64 << 20, 1536, 2 << 30]
        with pytest.raises(ValueError) as ei:
            parse_size("twelve")
        return sizes, str(ei.value)
    both(run)


def test_rules_text_grammar():
    def run(pkg):
        policy = _t(pkg).parse_rules_text(
            "# comment\n"
            "alice max_bytes=1GB max_objects=100 weight=4\n"
            "bob   max_rps=10 max_mbps=8 soft=true\n"
            "*     max_bytes=10GB\n")
        assert len(policy) == 3
        r = policy.rule_for("alice")
        assert r.max_bytes == 1 << 30 and r.max_objects == 100
        assert policy.weight_for("alice") == 4.0
        assert policy.rule_for("bob").soft is True
        # wildcard catches everyone else; empty tenant never matches
        assert policy.rule_for("mallory").max_bytes == 10 << 30
        assert policy.rule_for("") is None
        return [repr(policy.rule_for(t)) for t in ("alice", "bob", "zed")]
    both(run)


def test_rules_text_errors():
    def run(pkg):
        parse = _t(pkg).parse_rules_text
        msgs = []
        for text, match in (("alice max_bytes=nope\n", "line 1"),
                            ("alice max_bananas=3\n", "unknown rule keys"),
                            ("alice\n", None)):
            with pytest.raises(ValueError, match=match) as ei:
                parse(text)
            msgs.append(str(ei.value))
        return msgs
    both(run)


def test_rules_toml(tmp_path):
    p = tmp_path / "tenants.toml"
    p.write_text('[[rule]]\ntenant = "alice"\nmax_bytes = "2MB"\n'
                 'weight = 2.0\n'
                 '[[rule]]\ntenant = "*"\nmax_rps = 5\n')

    def run(pkg):
        t = _t(pkg)
        policy = t.load_rules(str(p))
        assert policy.rule_for("alice").max_bytes == 2 << 20
        assert policy.rule_for("zoe").max_rps == 5.0
        assert t.parse_rules_toml(p.read_text()).weight_for("alice") == 2.0
        return repr(policy.rule_for("alice")), repr(policy.rule_for("zoe"))
    both(run)


# -- token buckets -----------------------------------------------------------

def test_token_bucket_admit_and_retry():
    b = TokenBucket(rate=10.0, burst=2.0)
    assert b.try_take() == 0.0
    assert b.try_take() == 0.0
    retry = b.try_take()  # bucket drained
    assert retry > 0.0
    time.sleep(retry + 0.02)
    assert b.try_take() == 0.0  # refilled


def test_tenant_buckets_scope():
    def run(pkg):
        t = _t(pkg)
        tb = t.TenantBuckets(t.parse_rules_text("flood max_rps=2\n"))
        # ruleless tenants and untenanted traffic pass free, always
        for _ in range(50):
            assert tb.admit("calm") == 0.0
            assert tb.admit("") == 0.0
        verdicts = [tb.admit("flood") > 0.0 for _ in range(20)]
        assert any(verdicts)
        assert "flood" in tb.snapshot()["rps_tenants"]
        return verdicts[:2]
    both(run)


# -- deficit round robin -----------------------------------------------------

def test_drr_weight_proportionality():
    def run(pkg):
        weights = {"heavy": 3.0, "light": 1.0}
        q = _t(pkg).DrrQueue(weight_for=lambda t: weights.get(t, 1.0))
        for _ in range(60):
            q.push("heavy")
            q.push("light")
        served = [q.pop().tenant for _ in range(40)]
        heavy, light = served.count("heavy"), served.count("light")
        assert heavy == pytest.approx(30, abs=3)
        assert light == pytest.approx(10, abs=3)
        assert heavy + light == 40
        return served
    both(run)


def test_drr_skips_cancelled_and_drains():
    def run(pkg):
        q = _t(pkg).DrrQueue()
        a = q.push("a")
        q.push("a")
        b = q.push("b")
        q.discard(a)
        got = [q.pop(), q.pop()]
        assert all(w is not None and not w.cancelled for w in got)
        assert b in got
        assert q.pop() is None and len(q) == 0
        return [w.tenant for w in got]
    both(run)


# -- usage accounting --------------------------------------------------------

def test_tenant_usage_ledger():
    def run(pkg):
        u = _t(pkg).TenantUsage()
        u.add("alice", "pics", 1000, 2, vid=7)
        u.add("alice", "pics", 500, 1, vid=8)
        u.add("bob", "", 100, 1, vid=7)
        view = u.heartbeat_view()
        rows = {(r["tenant"], r["collection"]): r for r in view}
        assert rows[("alice", "pics")]["bytes"] == 1500
        assert rows[("alice", "pics")]["objects"] == 3
        u.remove("alice", "pics", 500, 1, vid=8)
        assert u.stored_totals()["alice"]["bytes"] == 1000
        # dropping a volume sheds exactly that volume's contribution
        u.drop_volume(7)
        totals = u.stored_totals()
        assert "bob" not in totals
        assert totals.get("alice", {}).get("bytes", 0) == 0
        # over-removal clamps at zero instead of going negative
        u.add("carol", "", 10, 1, vid=9)
        u.remove("carol", "", 9999, 99, vid=9)
        assert "carol" not in u.stored_totals()
        return view, u.stored_totals()
    both(run)


def test_usage_rollup_snapshot_roundtrip(tmp_path):
    def run(pkg):
        path = str(tmp_path / f"{pkg}.tenants.json")
        rollup = _t(pkg).UsageRollup
        r = rollup(path)
        r.update_node("vs1", [{"tenant": "alice", "collection": "",
                               "bytes": 2048, "objects": 2}])
        r.update_node("vs2", [{"tenant": "alice", "collection": "",
                               "bytes": 1024, "objects": 1}])
        assert r.usage_for("alice") == (3072, 3)
        r.save(force=True)
        # a fresh rollup (master restart) restores the totals from disk
        r2 = rollup(path)
        assert r2.usage_for("alice") == (3072, 3)
        assert r2.totals()["alice"]["objects"] == 3
        # absolute node reports replace: a shrunken re-report shrinks
        r2.update_node("vs1", [{"tenant": "alice", "collection": "",
                                "bytes": 100, "objects": 1}])
        assert r2.usage_for("alice") == (1124, 2)
        with open(path) as f:
            return r2.totals(), sorted(json.load(f))
    both(run)


# -- per-tenant chunk-cache caps ---------------------------------------------

def test_chunk_cache_tenant_cap():
    def run(pkg):
        cache = mod(pkg, "storage.chunk_cache").FilerChunkCache
        blob = b"x" * 1000
        c = cache(max_bytes=1 << 20)
        c.configure_tenant_cap(3000)
        # the victim's chunk went in before the scanner blew its cap: it
        # must survive (the scanner evicts its own oldest, not the LRU)
        c.get_or_fetch("victim,1", lambda: blob, tenant="victim")
        for i in range(5):
            c.get_or_fetch(f"scan,{i}", lambda: blob, tenant="scanner")
        stats = c.stats()
        assert stats["tenants"]["scanner"] <= 3000
        assert stats["tenants"]["victim"] == 1000
        assert stats["tenant_evictions"] >= 2
        hits = c.hit_bytes
        c.get_or_fetch("victim,1", lambda: (_ for _ in ()).throw(
            AssertionError("victim chunk was evicted")), tenant="victim")
        assert c.hit_bytes == hits + 1000
        c.reset()
        assert c.stats()["tenants"] == {} and c.tenant_max_bytes == 0
        stats.pop("fetch_ms")  # wall time of the fetches
        return stats
    both(run)


# -- the master's half of the end-to-end cases -------------------------------

def _beat(m, port, rows):
    rpc.call(m.url() + "/heartbeat", "POST", json.dumps({
        "ip": "127.0.0.1", "port": port, "tenants": rows}).encode())


def test_hard_quota_rejects_assign_and_survives_restart(tmp_path):
    """A tenant whose heartbeat-fed usage passes its hard quota gets 403
    QuotaExceeded from /dir/assign and a quota.exceeded event; other
    tenants pass; the rollup survives a restart via tenants.json."""
    from seaweedfs_tpu_torch.events import JOURNAL
    rules = tmp_path / "tenants.txt"
    rules.write_text("alice max_bytes=1KB\nvictim weight=4 max_bytes=1GB\n")
    m = MasterServer(meta_dir=str(tmp_path / "m"), tenant_rules=str(rules))
    m.start()
    try:
        _beat(m, 4101, [{"tenant": "alice", "collection": "",
                         "bytes": 2048, "objects": 1}])
        doc = rpc.call(m.url() + "/cluster/tenants")
        assert doc["tenants"]["alice"]["bytes"] == 2048
        status, body = rpc.call_status(m.url() + "/dir/assign",
                                       headers={"X-Weed-Tenant": "alice"})
        assert status == 403 and "QuotaExceeded" in body["error"]
        assert any(e["attrs"].get("tenant") == "alice"
                   for e in JOURNAL.snapshot(type_="quota.exceeded"))
        # other tenants are untouched (no volume: the grow path answers)
        status, body = rpc.call_status(m.url() + "/dir/assign",
                                       headers={"X-Weed-Tenant": "bob"})
        assert status != 403
        _beat(m, 4101, [{"tenant": "alice", "collection": "",
                         "bytes": 100, "objects": 1}])
        status, _ = rpc.call_status(m.url() + "/dir/assign",
                                    headers={"X-Weed-Tenant": "alice"})
        assert status != 403
    finally:
        m.stop()
    assert (tmp_path / "m" / "tenants.json").exists()
    m2 = MasterServer(meta_dir=str(tmp_path / "m"))
    m2.start()
    try:
        doc = rpc.call(m2.url() + "/cluster/tenants")
        assert doc["tenants"]["alice"]["bytes"] == 100
    finally:
        m2.stop()


def test_tenant_over_its_rate_gets_429_at_the_master(tmp_path):
    rules = tmp_path / "tenants.txt"
    rules.write_text("flood max_rps=2\n")
    m = MasterServer(tenant_rules=str(rules))
    m.start()
    try:
        before = rpc.tenant_throttled_total.value(tenant="flood")
        statuses, retry = [], None
        for _ in range(20):
            status, body = rpc.call_status(
                m.url() + "/dir/status", headers={"X-Weed-Tenant": "flood"})
            statuses.append(status)
        assert 429 in statuses and 200 in statuses
        assert rpc.tenant_throttled_total.value(tenant="flood") \
            >= before + statuses.count(429)
        with pytest.raises(rpc.RpcError) as ei:
            for _ in range(5):
                rpc.call(m.url() + "/dir/status",
                         headers={"X-Weed-Tenant": "flood"})
        retry = ei.value.retry_after
        assert ei.value.status == 429 and retry and retry > 0.0
        # a calm tenant is never throttled
        for _ in range(20):
            rpc.call(m.url() + "/dir/status",
                     headers={"X-Weed-Tenant": "calm"})
    finally:
        m.stop()


def test_promcheck_tenancy_instruments_on_the_master(tmp_path):
    rules = tmp_path / "tenants.txt"
    rules.write_text("alice max_bytes=1KB\n")
    m = MasterServer(tenant_rules=str(rules))
    m.start()
    try:
        _beat(m, 4102, [{"tenant": "alice", "collection": "",
                         "bytes": 300, "objects": 1}])
        text = bytes(rpc.call(m.url() + "/metrics")).decode()
    finally:
        m.stop()
    assert validate_exposition(text) == []
    for fam in ("SeaweedFS_admission_queue_depth",
                "SeaweedFS_tenant_throttled_total",
                "SeaweedFS_master_tenant_bytes"):
        assert fam in text
    assert 'tenant="alice"' in text
