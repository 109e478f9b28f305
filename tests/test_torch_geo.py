"""The port's geo active/active plane (epoch-fenced `.lease` sidecars,
compressed bidirectional shipping, locality-steered reads and the
cluster.lease.* verbs) held against the JAX package's.

Mirrors tests/test_geo.py: the same scenarios run against each
package's two-region fixture (the `pkg` parameter) with the reference
test's assertions.  `test_lease_sidecars_byte_identical_across_packages`
holds both packages' `.lease`, `.rlog` and `.rwm` files byte for byte
after the same writes, lease moves and shipping.  The fsck case builds
`volume.fsck -crc -json`'s `volumes` map from the ids it wrote (the
filer that fsck walks is not ported yet).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time

import pytest

from _torch_cluster import (PACKAGES, device_kw,  # noqa: F401
                            hermetic_port_state, pin_clocks)
from _torch_mirror import (clean, crc_map, geo_pair, pkg_ns, rlog_status,
                           stop_all, wait, wait_shipped)
from _torch_storage import snapshot

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _clean_both():
    for pkg in PACKAGES:
        clean(pkg_ns(pkg))
    yield
    for pkg in PACKAGES:
        clean(pkg_ns(pkg))


@pytest.fixture(scope="module", params=PACKAGES)
def geo(request, tmp_path_factory):
    P = pkg_ns(request.param)
    root = tmp_path_factory.mktemp(f"geo-{request.param}")
    servers = geo_pair(P, root)
    yield (P,) + servers
    ma, va, mb, vb = servers
    stop_all(vb, va, mb, ma)


_GEO_COL_N = [0]


def _geo_put(P, master, vs, data, collection=None):
    """A home-region write (tests/test_geo.py `_geo_put`): grow, enable
    the change log, acquire the lease, then POST."""
    if collection is None:
        _GEO_COL_N[0] += 1
        collection = f"geocol{_GEO_COL_N[0]}"
        P.rpc.call(f"{master.url()}/vol/grow?count=1"
                   f"&collection={collection}", "POST")
    a = P.rpc.call(f"{master.url()}/dir/assign?collection={collection}")
    vid = int(a["fid"].split(",")[0])
    v = vs.store.find_volume(vid)
    if v.rlog is None:
        v.enable_rlog()
    if vs.leases.get(vid) is None:
        P.rpc.call_json(f"http://{vs.url()}/admin/lease/acquire",
                        payload={"volume": vid})
    P.rpc.call(f"http://{a['url']}/{a['fid']}", "POST", data)
    return vid, a["fid"], collection


def test_bidirectional_compressed_convergence(geo):
    P, ma, va, mb, vb = geo
    pay_a = b"region A payload " * 64
    vid_a, fid_a, _ = _geo_put(P, ma, va, pay_a)
    pay_b = b"region B payload " * 64
    vid_b, fid_b, _ = _geo_put(P, mb, vb, pay_b)
    wait_shipped(P, va, vid_a)
    wait_shipped(P, vb, vid_b)
    assert P.client.WeedClient(mb.url()).download(fid_a) == pay_a
    assert P.client.WeedClient(ma.url()).download(fid_b) == pay_b
    for vs in (va, vb):
        # The change log is acked before the counters move (shipper.py).
        wait(lambda: vs.shipper.shipped["wire_bytes"] > 0, 20)
        sh = vs.shipper.shipped
        assert sh["batches"] >= 1
        assert 0 < sh["wire_bytes"] < sh["raw_bytes"]
    wait(lambda: vb.leases.get(vid_a) is not None, 20)
    wait(lambda: va.leases.get(vid_b) is not None, 20)
    assert vb.leases.holder(vid_a) == "A" and vb.leases.epoch(vid_a) == 1
    assert not vb.leases.is_holder(vid_a) and not vb.leases.ships(vid_a)
    assert va.leases.holder(vid_b) == "B" and not va.leases.ships(vid_b)


def test_write_at_non_holder_forwards_to_lease_holder(geo):
    P, ma, va, mb, vb = geo
    v1 = b"forward v1 " * 32
    vid, fid, _col = _geo_put(P, ma, va, v1)
    wait_shipped(P, va, vid)
    va.shipper.paused = True
    try:
        v2 = b"forward v2 " * 32
        out = P.rpc.call(f"http://{vb.url()}/{fid}", "POST", v2)
        assert out.get("size", 0) > 0
        assert P.client.WeedClient(ma.url()).download(fid) == v2
        assert rlog_status(P, va, vid)["pending"] >= 1
        wm = vb._replication_watermark(vb.store.find_volume(vid))
        assert wm.value == 1
    finally:
        va.shipper.paused = False
    va.shipper.kick()
    wait_shipped(P, va, vid)
    wait(lambda: P.client.WeedClient(mb.url()).download(fid) == v2, 20,
         "forwarded write never shipped back to region B")


def test_wan_reorder_refused_unacked_then_converges(geo):
    P, ma, va, mb, vb = geo
    resends = P.metrics.replication_resends_total
    pays = [b"reorder zero " * 40]
    vid, fid0, col = _geo_put(P, ma, va, pays[0])
    wait_shipped(P, va, vid)
    fids = [fid0]
    old_batch = va.shipper.batch_records
    va.shipper.paused = True
    try:
        for i in (1, 2, 3):
            a = P.rpc.call(f"{ma.url()}/dir/assign?collection={col}")
            assert int(a["fid"].split(",")[0]) == vid
            pay = f"reorder {i} ".encode() * 40
            P.rpc.call(f"http://{a['url']}/{a['fid']}", "POST", pay)
            fids.append(a["fid"])
            pays.append(pay)
        va.shipper.batch_records = 1
        before = resends.value(reason="reorder")
        P.fault.arm("wan.reorder", "fail*1")
        va.shipper.paused = False
        va.shipper.kick()
        wait_shipped(P, va, vid)
        assert resends.value(reason="reorder") == before + 1
    finally:
        va.shipper.paused = False
        va.shipper.batch_records = old_batch
        P.fault.disarm_all()
    bc = P.client.WeedClient(mb.url())
    assert [bc.download(f) for f in fids] == pays
    wm = vb._replication_watermark(vb.store.find_volume(vid))
    assert wm.value == rlog_status(P, va, vid)["last_seq"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_compact_racing_inflight_tick_never_reships_or_skips(
        pkg, tmp_path, monkeypatch):
    rl = pkg_ns(pkg).rlog
    base = str(tmp_path / "race")
    log = rl.ReplicationLog(base)
    for i in range(6):
        log.append(rl.OP_WRITE, 100 + i, 0, 32)
    log.set_acked(3)
    inflight = log.read_from(log.acked_seq + 1, 100)
    assert [r.seq for r in inflight] == [4, 5, 6]
    in_swap = threading.Event()
    ack_done = threading.Event()
    real_replace = os.replace

    def barriered_replace(src, dst):
        if dst.endswith(".rlog") and not in_swap.is_set():
            in_swap.set()
            assert ack_done.wait(20), "acker never ran"
        return real_replace(src, dst)

    monkeypatch.setattr(rl.os, "replace", barriered_replace)

    def acker():
        assert in_swap.wait(20)
        log.set_acked(6)
        ack_done.set()

    t = threading.Thread(target=acker)
    t.start()
    dropped = log.compact()
    t.join(20)
    assert not t.is_alive()
    assert dropped == 3
    assert log.acked_seq == 6
    tail = log.read_from(log.acked_seq + 1, 100)
    assert all(r.op == rl.OP_VACUUM for r in tail)
    assert log.pending() == len(tail)
    assert {4, 5, 6} <= {r.seq for r in log.read_from(1, 100)}
    log.close()
    log2 = rl.ReplicationLog(base)
    assert log2.acked_seq == 6
    assert {4, 5, 6} <= {r.seq for r in log2.read_from(1, 100)}
    log2.close()


def test_compressed_ship_bytes_land_under_rlog_ship_budget(geo):
    P, ma, va, _mb, _vb = geo
    fl = P.flows
    me = va.url()
    fl.LEDGER.set_budgets(fl.parse_budgets("rlog.ship=8MB/s"))
    try:
        b0, o0 = fl.LEDGER.totals(purpose_="rlog.ship", direction="out",
                                  local=me)
        w0 = va.shipper.shipped["wire_bytes"]
        r0 = va.shipper.shipped["raw_bytes"]
        vid, _fid, _col = _geo_put(P, ma, va, b"budget geo payload " * 512)
        wait_shipped(P, va, vid)
        # The shipper acks the change log before it adds the batch to
        # its counters (shipper.py, both packages): wait for those too.
        wait(lambda: va.shipper.shipped["wire_bytes"] > w0, 20,
             "the shipped batch never reached the counters")
        b1, o1 = fl.LEDGER.totals(purpose_="rlog.ship", direction="out",
                                  local=me)
        dwire = va.shipper.shipped["wire_bytes"] - w0
        draw = va.shipper.shipped["raw_bytes"] - r0
        assert 0 < dwire < draw
        assert b1 - b0 >= dwire and o1 - o0 >= 1
        st = fl.LEDGER.budget_status(local=me).get("rlog.ship")
        assert st is not None and st["limit_bps"] > 0
        assert not st["breached"]
    finally:
        fl.LEDGER.set_budgets({})


def test_split_brain_fencing_gate(geo):
    """The fencing gate: a mid-partition lease move fails closed, a
    contested lease leaves no holder (both regions refuse writes), a
    stale-epoch batch is refused with 409, and a proper move succeeds."""
    P, ma, va, mb, vb = geo
    rpc = P.rpc
    base = b"fence base " * 32
    vid, fid, col = _geo_put(P, ma, va, base)
    wait_shipped(P, va, vid)
    wait(lambda: vb.leases.get(vid) is not None, 20)
    P.fault.arm("wan.partition", "fail*1000")
    try:
        w1 = b"during partition " * 16
        rpc.call(f"http://{va.url()}/{fid}", "POST", w1)
        st, out = rpc.call_status(
            f"http://{va.url()}/admin/lease/move", "POST",
            json.dumps({"volume": vid, "to": "B", "timeout": 0.5}).encode())
        assert st == 503 and "NOT moved" in json.dumps(out)
        assert va.leases.is_holder(vid) and va.leases.epoch(vid) == 1
        rpc.call_json(f"http://{va.url()}/admin/lease/acquire",
                      payload={"volume": vid, "cluster_id": "B",
                               "epoch": 2})
        assert not va.leases.is_holder(vid)
        assert not vb.leases.is_holder(vid)
        P.resilience.reset_breakers()
        st_a, _ = rpc.call_status(f"http://{va.url()}/{fid}", "POST",
                                  b"split brain A " * 8)
        st_b, _ = rpc.call_status(f"http://{vb.url()}/{fid}", "POST",
                                  b"split brain B " * 8)
        assert st_a >= 500 and st_b >= 500
        assert P.client.WeedClient(ma.url()).download(fid) == w1
        wm = vb._replication_watermark(vb.store.find_volume(vid))
        assert wm.value == 1
    finally:
        clean(P)
    for node in (va, vb):
        rpc.call_json(f"http://{node.url()}/admin/lease/acquire",
                      payload={"volume": vid, "cluster_id": "A",
                               "epoch": 3})
    assert va.leases.is_holder(vid) and not vb.leases.is_holder(vid)
    va.shipper.kick()
    wait_shipped(P, va, vid)
    wait(lambda: P.client.WeedClient(mb.url()).download(fid)
         == b"during partition " * 16, 20,
         "stranded partition-era write never reached region B")
    st, out = rpc.call_status(
        f"http://{vb.url()}/admin/replication/apply", "POST",
        json.dumps({"volume": vid, "collection": col, "cluster_id": "B",
                    "epoch": 2, "records": []}).encode())
    assert st == 409 and "stale" in json.dumps(out)
    out = rpc.call_json(f"http://{va.url()}/admin/lease/move",
                        payload={"volume": vid, "to": "B", "timeout": 10.0})
    assert out["epoch"] == 4 and out["peer_acquired"] is True
    assert vb.leases.is_holder(vid) and not va.leases.is_holder(vid)
    final = b"post-move final " * 16
    rpc.call(f"http://{vb.url()}/{fid}", "POST", final)
    wait_shipped(P, vb, vid)
    wait(lambda: P.client.WeedClient(ma.url()).download(fid) == final, 20,
         "post-move write never shipped back to region A")


def test_partition_heal_converges_fsck_map_equality(geo):
    """A partition strands acked writes on the holder; after the heal
    the backlog drains and the CRC maps through both masters agree."""
    P, ma, va, mb, _vb = geo
    rng = random.Random(5)
    vid, fid0, col = _geo_put(P, ma, va, rng.randbytes(3000))
    fids = [fid0]
    P.fault.arm("wan.partition", "fail*1000")
    try:
        for _ in range(4):
            fids.append(_geo_put(P, ma, va, rng.randbytes(
                rng.randrange(1, 12000)), collection=col)[1])
        assert rlog_status(P, va, vid)["pending"] > 0
    finally:
        clean(P)
    va.shipper.kick()
    wait_shipped(P, va, vid)
    fa = crc_map(P, ma.url(), fids)
    fb = crc_map(P, mb.url(), fids)
    assert fa == fb, "regions diverged after partition + heal"
    assert len(fa[str(vid)]) == len(fids)


def test_locality_steering_on_lag_and_tenant_home(geo):
    P, ma, va, mb, vb = geo
    rpc = P.rpc
    pay = b"steer me " * 64
    vid, fid, _col = _geo_put(P, mb, vb, pay)
    wait_shipped(P, vb, vid)
    wait(lambda: rpc.call_status(
        f"{ma.url()}/dir/lookup?volumeId={vid}")[0] == 200, 20,
        "region A never learned the mirrored replica")
    vb._send_heartbeat(full=True)

    def first_location(tenant=""):
        q = f"&tenant={tenant}" if tenant else ""
        return rpc.call(f"{ma.url()}/dir/lookup?volumeId={vid}{q}"
                        )["locations"][0]["url"]

    # The steer caches refresh every 0.2 s: wait on the answer.
    wait(lambda: first_location() == va.url(), 20,
         "in-SLO read must stay local")
    vb.shipper.paused = True
    try:
        rpc.call(f"http://{vb.url()}/{fid}", "POST", b"stale now " * 64)

        def lag_breached():
            vb._send_heartbeat(full=True)
            rows = {int(r["volume"]): r for r in rpc.call(
                f"{mb.url()}/cluster/mirror").get("volumes", [])}
            row = rows.get(vid)
            return bool(row) and float(row.get("lag_seconds", 0) or 0) > 0.05
        wait(lag_breached, 20, "lag never breached the SLO")
        wait(lambda: first_location() == vb.url(), 20,
             "out-of-SLO read must steer to the fresh replica")
        doc = rpc.call(f"{ma.url()}/dir/lookup?volumeId={vid}")
        assert any(loc["url"] == va.url() for loc in doc["locations"])
    finally:
        vb.shipper.paused = False
    vb.shipper.kick()
    wait_shipped(P, vb, vid)
    vb._send_heartbeat(full=True)
    wait(lambda: first_location() == va.url(), 20,
         "recovered mirror must un-steer")
    ma.tenant_policy.rules.append(
        P.quota.QuotaRule(tenant="geo-steer-bob", home="B"))
    try:
        assert first_location("geo-steer-bob") == vb.url()
        assert first_location() == va.url()
    finally:
        ma.tenant_policy.rules = [r for r in ma.tenant_policy.rules
                                  if r.tenant != "geo-steer-bob"]


def test_shell_lease_verbs_and_surfaces(geo):
    P, ma, va, mb, vb = geo
    vid, _fid, _col = _geo_put(P, ma, va, b"shell lease " * 32)
    wait_shipped(P, va, vid)
    va._send_heartbeat(full=True)
    env = P.shell.CommandEnv(ma.url(), **device_kw(P.pkg))
    run = P.shell.run_command
    try:
        out = run(env, "cluster.lease.ls")
        assert "this cluster: A" in out and str(vid) in out
        assert "HOLDER" in out and "EPOCH" in out
        out = run(env, "cluster.mirror.status")
        assert "cluster: A" in out and "LEASE" in out and "A@e1" in out
        out = run(env, "cluster.mirror.status -watch -interval 0.05 -count 1")
        assert "LEASE" in out
        run(env, "lock")
        out = run(env, f"cluster.lease.move -volume {vid} -to B")
        assert "moved to cluster B at epoch 2" in out
        run(env, "unlock")
    finally:
        env.close()
    assert vb.leases.is_holder(vid) and not va.leases.is_holder(vid)
    assert va.leases.epoch(vid) == 2
    va._send_heartbeat(full=True)
    _status, doc = P.rpc.call_status(f"{ma.url()}/cluster/healthz")
    repl = doc["replication"]
    assert repl["cluster_id"] == "A"
    assert repl["leases"]["volumes"] >= 1
    assert repl["leases"]["moving"] == 0


# -- both packages' regions, byte for byte ---------------------------------------


def _geo_files(pkg, root):
    """One package's two regions fed a fixed run: writes homed in A,
    a lease move to B, writes homed in B; every file of both volume
    servers once all has shipped back and forth."""
    P = pkg_ns(pkg)
    ma, va, mb, vb = geo_pair(P, root)
    try:
        rng = random.Random(3)
        P.rpc.call(f"{ma.url()}/vol/grow?count=1&collection=geotwin", "POST")
        vid, fid, col = _geo_put(P, ma, va, rng.randbytes(5000),
                                 collection="geotwin")
        wait_shipped(P, va, vid)
        fids = [fid]
        for _ in range(4):
            a = P.rpc.call(f"{ma.url()}/dir/assign?collection={col}")
            P.rpc.call(f"http://{a['url']}/{a['fid']}", "POST",
                       rng.randbytes(rng.randrange(1, 9000)))
            fids.append(a["fid"])
            wait_shipped(P, va, vid)
        moved = P.rpc.call_json(f"http://{va.url()}/admin/lease/move",
                                payload={"volume": vid, "to": "B",
                                         "timeout": 20.0})
        for f in fids[:2]:
            P.rpc.call(f"http://{vb.url()}/{f}", "POST",
                       rng.randbytes(rng.randrange(1, 9000)))
            wait_shipped(P, vb, vid)
        leases = (va.leases.get(vid), vb.leases.get(vid))
        maps = (crc_map(P, ma.url(), fids), crc_map(P, mb.url(), fids))
    finally:
        stop_all(vb, va, mb, ma)
    return {"fids": fids, "moved": moved, "maps": maps,
            "leases": [(le.cluster_id, le.epoch) for le in leases],
            "a": snapshot(str(root / "a")), "b": snapshot(str(root / "b"))}


def test_lease_sidecars_byte_identical_across_packages(tmp_path, monkeypatch):
    """Same writes and lease move in each package's two regions, on
    pinned clocks: both regions' `.lease`, `.rlog`, `.rwm`, `.dat` and
    `.idx` files are byte-identical across packages, and the two
    regions' CRC maps agree."""
    clock = pin_clocks(monkeypatch)
    monkeypatch.setattr(time, "time_ns", clock.time_ns)
    for pkg in PACKAGES:
        P = pkg_ns(pkg)
        monkeypatch.setattr(P.raft, "random", random.Random(1))
        monkeypatch.setattr(P.lease, "time", clock)
    out = []
    for pkg in PACKAGES:
        random.seed(0)
        d = tmp_path / pkg
        d.mkdir()
        out.append(_geo_files(pkg, d))
    assert out[1] == out[0]
    state = out[1]
    assert state["maps"][0] == state["maps"][1]
    assert state["leases"] == [("B", 2), ("B", 2)]
    assert any(name.endswith(".lease") for name in state["a"])
    assert any(name.endswith(".lease") for name in state["b"])
