"""The port's disaster recovery (the `.rlog` change log, the shipper,
cross-cluster mirroring and the cluster.mirror.* verbs) held against
the JAX package's.

Mirrors tests/test_dr.py.  The change-log cases run once per package on
pinned clocks and must observe the same values and leave byte-identical
`.rlog`/`.rwm` files.  The mirror cases run the same scenario against
each package's mirror fixture (the `pkg` parameter) with the reference
test's assertions.  `test_mirrored_files_byte_identical_across_packages`
holds both packages' primaries and standbys byte for byte after the same
writes, deletes and shipping.  The fsck case builds `volume.fsck -crc
-json`'s `volumes` map from the ids it wrote (the filer that fsck walks
is not ported yet).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

import pytest

from _torch_cluster import (PACKAGES, device_kw,  # noqa: F401
                            hermetic_port_state, pin_clocks)
from _torch_mirror import (clean, crc_map, mirror_pair, pkg_ns, rlog_status,
                           stop_all, volume_server, wait, wait_shipped)
from _torch_storage import snapshot

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _clean_both():
    for pkg in PACKAGES:
        clean(pkg_ns(pkg))
    yield
    for pkg in PACKAGES:
        clean(pkg_ns(pkg))


# -- change-log cases: equal observations, byte-identical files ---------------


def _roundtrip(rl, d):
    rec = rl.LogRecord(7, rl.OP_WRITE, 0xDEADBEEF, 1234, 77, 999_000)
    buf = rec.to_bytes()
    return {"size": len(buf), "back": rl.LogRecord.from_bytes(buf) == rec,
            "flip_tail": rl.LogRecord.from_bytes(buf[:-1] + bytes(
                [buf[-1] ^ 1])), "flip_head": rl.LogRecord.from_bytes(
                bytes([buf[0] ^ 0x80]) + buf[1:]),
            "short": rl.LogRecord.from_bytes(buf[:rl.RECORD_SIZE - 1]),
            "bytes": buf}


def _append_reopen(rl, d):
    base = str(d / "7")
    log = rl.ReplicationLog(base)
    seqs = [log.append(rl.OP_WRITE, 100 + i, 9, 64) for i in range(5)]
    recs = [r.seq for r in log.read_from(1, 100)]
    mid = [r.seq for r in log.read_from(3, 2)]
    log.close()
    log2 = rl.ReplicationLog(base)
    out = {"seqs": seqs, "recs": recs, "mid": mid,
           "bounds": (log2.first_seq, log2.last_seq),
           "next": log2.append(rl.OP_DELETE, 100, 0, 0)}
    log2.close()
    return out


def _torn_tail(rl, d):
    base = str(d / "8")
    log = rl.ReplicationLog(base)
    for i in range(3):
        log.append(rl.OP_WRITE, i, 0, 10)
    log.close()
    with open(base + ".rlog", "ab") as f:
        f.write(b"\xfe" * 17)
    log2 = rl.ReplicationLog(base)
    out = {"last": log2.last_seq,
           "recs": [r.seq for r in log2.read_from(1, 10)]}
    log2.close()
    return out


def _crc_bad_tail(rl, d):
    base = str(d / "9")
    log = rl.ReplicationLog(base)
    for i in range(3):
        log.append(rl.OP_WRITE, i, 0, 10)
    log.close()
    with open(base + ".rlog", "r+b") as f:
        f.seek(2 * rl.RECORD_SIZE + 5)
        f.write(b"\xff")
    log2 = rl.ReplicationLog(base)
    out = {"last": log2.last_seq, "next": log2.append(rl.OP_WRITE, 9, 0, 10)}
    log2.close()
    return out


def _rotten_head(rl, d):
    base = str(d / "10")
    log = rl.ReplicationLog(base)
    for i in range(3):
        log.append(rl.OP_WRITE, i, 0, 10)
    log.set_acked(2)
    log.close()
    with open(base + ".rlog", "r+b") as f:
        f.seek(3)
        f.write(b"\xff")
    log2 = rl.ReplicationLog(base)
    out = {"state": (log2.first_seq, log2.last_seq, log2.acked_seq),
           "next": log2.append(rl.OP_WRITE, 9, 0, 10)}
    log2.close()
    return out


def _missing_log(rl, d):
    base = str(d / "11")
    log = rl.ReplicationLog(base)
    for i in range(3):
        log.append(rl.OP_WRITE, i, 0, 10)
    log.set_acked(3)
    log.close()
    (d / "11.rlog").unlink()
    log2 = rl.ReplicationLog(base)
    out = {"last": log2.last_seq, "pending": log2.pending(),
           "next": log2.append(rl.OP_WRITE, 9, 0, 10)}
    log2.close()
    return out


def _compact(rl, d):
    base = str(d / "12")
    log = rl.ReplicationLog(base)
    for i in range(5):
        log.append(rl.OP_WRITE, i, 0, 10)
    log.set_acked(3)
    out = {"dropped": log.compact(),
           "recs": [dataclasses.astuple(r) for r in log.read_from(1, 100)],
           "bounds": (log.first_seq, log.last_seq), "pending": log.pending()}
    log.close()
    log2 = rl.ReplicationLog(base)
    out["reopened"] = (log2.first_seq, log2.last_seq)
    out["next"] = log2.append(rl.OP_WRITE, 9, 0, 10)
    log2.set_acked(7)
    log2.compact()
    out["acked_all"] = [dataclasses.astuple(r)
                        for r in log2.read_from(1, 100)]
    log2.close()
    return out


def _watermark(rl, d):
    path = str(d / "13.rwm")
    wm = rl.Watermark(path)
    wm.set(5)
    wm.set(3)
    out = {"value": wm.value, "reopened": rl.Watermark(path).value}
    wm.remove()
    out["removed"] = rl.Watermark(path).value
    return out


RLOG_CASES = {"record_roundtrip_and_crc_gate": _roundtrip,
              "append_read_reopen_resume": _append_reopen,
              "torn_partial_tail_truncated_on_open": _torn_tail,
              "crc_bad_tail_stepped_back_over": _crc_bad_tail,
              "rotten_head_resets_and_resumes_from_watermark": _rotten_head,
              "missing_log_resumes_seq_from_watermark": _missing_log,
              "compact_drops_acked_prefix_keeps_seq_chain": _compact,
              "watermark_is_monotonic_and_durable": _watermark}


@pytest.mark.parametrize("case", sorted(RLOG_CASES))
def test_change_log_case(case, tmp_path, monkeypatch):
    out = []
    for pkg in PACKAGES:
        ns = iter(range(1_700_000_000 * 10**9, 1_800_000_000 * 10**9))
        monkeypatch.setattr(time, "time_ns", lambda: next(ns))
        d = tmp_path / pkg
        d.mkdir()
        obs = RLOG_CASES[case](pkg_ns(pkg).rlog, d)
        out.append((obs, snapshot(str(d))))
    assert out[1] == out[0]
    obs = out[1][0]
    expect = {
        "record_roundtrip_and_crc_gate": lambda o: o["size"] == 40
        and o["back"] and o["flip_tail"] is o["flip_head"] is o["short"]
        is None,
        "append_read_reopen_resume": lambda o: o["recs"] == [1, 2, 3, 4, 5]
        and o["mid"] == [3, 4] and o["bounds"] == (1, 5) and o["next"] == 6,
        "torn_partial_tail_truncated_on_open": lambda o: o["last"] == 3,
        "crc_bad_tail_stepped_back_over": lambda o: o["last"] == 2
        and o["next"] == 3,
        "rotten_head_resets_and_resumes_from_watermark":
            lambda o: o["state"] == (0, 2, 2) and o["next"] == 3,
        "missing_log_resumes_seq_from_watermark": lambda o: o["last"] == 3
        and o["pending"] == 0 and o["next"] == 4,
        "compact_drops_acked_prefix_keeps_seq_chain":
            lambda o: o["dropped"] == 3 and o["bounds"] == (4, 6)
            and o["reopened"] == (4, 6) and o["next"] == 7
            and len(o["acked_all"]) == 1,
        "watermark_is_monotonic_and_durable": lambda o: o == {
            "value": 5, "reopened": 5, "removed": 0},
    }
    assert expect[case](obs), obs


# -- the two-cluster mirror, per package -----------------------------------------


@pytest.fixture(scope="module", params=PACKAGES)
def mirror(request, tmp_path_factory):
    P = pkg_ns(request.param)
    root = tmp_path_factory.mktemp(f"mirror-{request.param}")
    servers = mirror_pair(P, root)
    yield (P,) + servers
    pr_master, pr_vs, sb_master, sb_vs = servers
    stop_all(pr_vs, pr_master, sb_vs, sb_master)


_COL_N = [0]


def _put(mir, data, collection=None):
    """A journaled write on the primary (tests/test_dr.py `_put`)."""
    P, pr_master, pr_vs = mir[0], mir[1], mir[2]
    if collection is None:
        _COL_N[0] += 1
        collection = f"drcol{_COL_N[0]}"
        P.rpc.call(f"{pr_master.url()}/vol/grow?count=1"
                   f"&collection={collection}", "POST")
    a = P.rpc.call(f"{pr_master.url()}/dir/assign?collection={collection}")
    vid = int(a["fid"].split(",")[0])
    v = pr_vs.store.find_volume(vid)
    if v.rlog is None:
        v.enable_rlog()
    P.rpc.call(f"http://{a['url']}/{a['fid']}", "POST", data)
    return vid, a["fid"], collection


def test_mirror_converges_byte_identical(mirror):
    P, _pm, pr_vs, sb_master, _sbv = mirror
    payloads = [f"mirror payload {i} ".encode() * 32 for i in range(3)]
    vid, fid0, col = _put(mirror, payloads[0])
    fids = [fid0] + [_put(mirror, p, collection=col)[1] for p in payloads[1:]]
    wait_shipped(P, pr_vs, vid)
    sbc = P.client.WeedClient(sb_master.url())
    assert [sbc.download(f) for f in fids] == payloads
    st = rlog_status(P, pr_vs, vid)
    assert st["acked_seq"] == st["last_seq"] >= len(payloads)


def test_tombstone_propagates_and_never_resurrects(mirror):
    P, _pm, pr_vs, sb_master, sb_vs = mirror
    vid, fid, col = _put(mirror, b"doomed needle " * 16)
    wait_shipped(P, pr_vs, vid)
    sbc = P.client.WeedClient(sb_master.url())
    assert sbc.download(fid)
    P.rpc.call(f"http://{pr_vs.url()}/{fid}", "DELETE")
    wait_shipped(P, pr_vs, vid)
    with pytest.raises(P.rpc.RpcError) as ei:
        sbc.download(fid)
    assert ei.value.status == 404
    v = pr_vs.store.find_volume(vid)
    recs = v.rlog.read_from(1, 1000)
    body = {"volume": vid, "collection": col, "version": v.version,
            "replication": "000", "ttl": "",
            "records": [{"seq": r.seq, "op": r.op, "needle_id": r.needle_id,
                         "cookie": r.cookie, "size": r.size,
                         "ts_ns": r.ts_ns, "blob": None} for r in recs]}
    out = P.rpc.call_json(f"http://{sb_vs.url()}/admin/replication/apply",
                          "POST", body)
    assert out["applied"] == 0 and out["skipped"] == len(recs)
    with pytest.raises(P.rpc.RpcError):
        sbc.download(fid)


def test_journal_commit_points_and_quarantine_stays_local(mirror):
    P, _pm, pr_vs, _sbm, _sbv = mirror
    rl = P.rlog
    vid, fid, col = _put(mirror, b"journaled write " * 16)
    v = pr_vs.store.find_volume(vid)
    _vid, key, cookie = P.types.parse_file_id(fid)
    assert any(r.op == rl.OP_WRITE and r.needle_id == key
               and r.cookie == cookie and r.size > 0
               for r in v.rlog.read_from(1, 100))
    P.rpc.call(f"http://{pr_vs.url()}/{fid}", "DELETE")
    recs = v.rlog.read_from(1, 100)
    assert recs[-1].op == rl.OP_DELETE and recs[-1].needle_id == key
    _vid2, fid2, _c = _put(mirror, b"healthy elsewhere " * 16,
                           collection=col)
    wait_shipped(P, pr_vs, vid)
    last = v.rlog.last_seq
    _vid2, key2, _ck2 = P.types.parse_file_id(fid2)
    assert v.quarantine_needle(key2)
    assert v.rlog.last_seq == last
    P.rpc.call_json(f"http://{pr_vs.url()}/admin/delete_volume", "POST",
                    {"volume": vid})
    pr_vs._send_heartbeat(full=True)


def test_duplicate_delivery_is_a_noop(mirror):
    P, _pm, pr_vs, sb_master, _sbv = mirror
    resends = P.metrics.replication_resends_total
    before = resends.value(reason="duplicate")
    P.fault.arm("wan.duplicate", "fail*1")
    payload = b"delivered twice, stored once " * 8
    vid, fid, _col = _put(mirror, payload)
    wait_shipped(P, pr_vs, vid)
    assert resends.value(reason="duplicate") == before + 1
    assert P.client.WeedClient(sb_master.url()).download(fid) == payload


def heal_after_partition(mirror) -> None:
    P, _pm, pr_vs, sb_master, _sbv = mirror
    P.fault.arm("wan.partition", "fail*1000")
    payload = b"written during the partition " * 8
    vid, fid, _col = _put(mirror, payload)
    sh = pr_vs.shipper
    wait(lambda: sh.lag_view()["volumes"].get(str(vid), {})
         .get("lag_seq", 0) > 0, 20, "partition never showed up as lag")
    time.sleep(0.2)  # several ticks: the watermark must hold
    st = rlog_status(P, pr_vs, vid)
    assert st["pending"] > 0 and st["acked_seq"] == 0
    clean(P)
    sh.kick()
    wait_shipped(P, pr_vs, vid)
    assert P.client.WeedClient(sb_master.url()).download(fid) == payload
    lag_observed(sh)
    assert sh.lag_view()["volumes"][str(vid)]["lag_seq"] == 0


def test_partition_holds_watermark_then_heals(mirror):
    heal_after_partition(mirror)


def test_heal_reads_the_lag_the_shipper_observed_after_its_ack(mirror,
                                                               monkeypatch):
    """The heal as a loaded host can order it: the shipper acks the
    batch, then the test reads its lag rows before the shipper observes
    the lag again.  Here a volume's observation that would clear its lag
    waits until a read of `lag_view()` has found the row stale (log
    acked, row still lagging), so that read always comes first.  A
    heal that asserts on the first read fails here."""
    _P, _pm, pr_vs, _sbm, _sbv = mirror
    sh = pr_vs.shipper
    stale_read: dict[int, threading.Event] = {}

    def event(vid: int) -> threading.Event:
        return stale_read.setdefault(vid, threading.Event())

    observe, view = sh._observe_lag, sh.lag_view
    reader = threading.get_ident()  # the test's reads, not the beats'

    def observe_after_a_stale_read(vid, rlog):
        if rlog.pending() == 0 and (sh._lag.get(vid) or {}).get("lag_seq"):
            event(vid).wait(20)
        observe(vid, rlog)

    def lag_view():
        out = view()
        if threading.get_ident() != reader:
            return out
        for key, row in out["volumes"].items():
            v = pr_vs.store.find_volume(int(key))
            if row["lag_seq"] and v is not None and v.rlog is not None \
                    and v.rlog.pending() == 0:
                event(int(key)).set()
        return out

    monkeypatch.setattr(sh, "_observe_lag", observe_after_a_stale_read)
    monkeypatch.setattr(sh, "lag_view", lag_view)
    try:
        heal_after_partition(mirror)
    finally:
        for ev in stale_read.values():
            ev.set()


def lag_observed(sh) -> None:
    """Wait until the shipper's lag rows (what a beat carries) show
    nothing pending.  Both packages' `_ship_volume` ack the log before
    they observe the lag again, so right after `wait_shipped` a row
    can still hold the lag observed before the batch went out, and on
    a loaded host that is more than the 0.05 s SLO."""
    wait(lambda: all(r["lag_seq"] == 0 for r in
                     sh.lag_view()["volumes"].values()), 20,
         "the shipper never observed its lag after the ack")


def test_healthz_degrades_on_lag_slo_breach_and_recovers(mirror):
    P, pr_master, pr_vs, _sbm, _sbv = mirror
    sh = pr_vs.shipper
    vid, _fid, col = _put(mirror, b"slo probe " * 8)
    wait_shipped(P, pr_vs, vid)
    lag_observed(sh)
    pr_vs._send_heartbeat(full=True)
    status, doc = P.rpc.call_status(f"{pr_master.url()}/cluster/healthz")
    assert status == 200, doc.get("problems")
    assert doc["replication"]["lag_slo"] == 0.05
    sh.paused = True
    try:
        _put(mirror, b"stuck behind the pause " * 8, collection=col)
        wait(lambda: sh.lag_view()["volumes"].get(str(vid), {})
             .get("lag_seconds", 0.0) > 0.05, 20,
             "paused shipper stopped observing lag")
        pr_vs._send_heartbeat(full=True)
        status, doc = P.rpc.call_status(f"{pr_master.url()}/cluster/healthz")
        assert status == 503
        assert any("replication lag" in p and "exceeds SLO" in p
                   for p in doc["problems"]), doc["problems"]
    finally:
        sh.paused = False
        sh.kick()
    wait_shipped(P, pr_vs, vid)
    lag_observed(sh)
    pr_vs._send_heartbeat(full=True)
    status, doc = P.rpc.call_status(f"{pr_master.url()}/cluster/healthz")
    assert status == 200, doc.get("problems")


def test_raft_leader_failover_with_records_in_flight(mirror):
    P, pr_master, pr_vs, sb_master, _sbv = mirror
    P.fault.arm("wan.partition", "fail*1000")
    payload = b"survives the election " * 8
    vid, fid, _col = _put(mirror, payload)
    raft = pr_master.raft
    with raft._lock:
        raft._become_follower(raft.current_term + 1, None)
    wait(pr_master.is_leader, 20, "raft never re-elected")
    clean(P)
    pr_vs.shipper.kick()
    wait_shipped(P, pr_vs, vid)
    assert P.client.WeedClient(sb_master.url()).download(fid) == payload
    st = rlog_status(P, pr_vs, vid)
    assert st["acked_seq"] == st["last_seq"] > 0


def test_fsck_crc_map_proves_cross_cluster_convergence(mirror):
    """test_dr.py's convergence proof: the node-address-free CRC map of
    every written needle, through each cluster's master, compares
    equal once everything shipped."""
    P, pr_master, pr_vs, sb_master, _sbv = mirror
    rng = random.Random(7)
    vid, fid0, col = _put(mirror, rng.randbytes(1200))
    fids = [fid0] + [_put(mirror, rng.randbytes(rng.randrange(1, 9000)),
                          collection=col)[1] for _ in range(5)]
    wait_shipped(P, pr_vs, vid)
    pr_map = crc_map(P, pr_master.url(), fids)
    sb_map = crc_map(P, sb_master.url(), fids)
    assert pr_map == sb_map
    assert len(pr_map[str(vid)]) == len(fids)
    assert all(len(c) == 1 and c[0] for c in pr_map[str(vid)].values())


def test_mirror_shell_status_pause_resume(mirror):
    P, pr_master, pr_vs, sb_master, _sbv = mirror
    pr_vs._send_heartbeat(full=True)
    env = P.shell.CommandEnv(pr_master.url(), **device_kw(P.pkg))
    run = P.shell.run_command
    try:
        out = run(env, "cluster.mirror.status")
        assert "peer(s):" in out and sb_master.url() in out
        assert "lag SLO: 0.05s" in out
        run(env, "cluster.mirror.pause")
        assert pr_vs.shipper.paused
        pr_vs._send_heartbeat(full=True)
        assert "paused:" in run(env, "cluster.mirror.status")
        run(env, "cluster.mirror.resume")
        assert not pr_vs.shipper.paused
        doc = P.rpc.call(f"{pr_master.url()}/cluster/mirror")
        assert doc["paired"] and sb_master.url() in doc["peers"]
    finally:
        env.close()


def test_replication_metrics_promcheck(mirror):
    P, _pm, pr_vs, _sbm, _sbv = mirror
    P.fault.arm("wan.duplicate", "fail*1")
    vid, _fid, _col = _put(mirror, b"promcheck traffic " * 32)
    wait_shipped(P, pr_vs, vid)
    text = P.rpc.call(f"http://{pr_vs.url()}/metrics").decode()
    for fam in ("SeaweedFS_replication_shipped_bytes_total",
                "SeaweedFS_replication_resends_total",
                "SeaweedFS_replication_lag_seconds_total",
                "SeaweedFS_replication_lag_seconds"):
        assert fam in text, f"{fam} missing from /metrics"
    assert P.promcheck.validate_exposition(text) == []


# -- function-scoped chaos, per package -------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_restart_both_sides_resumes_from_watermarks(pkg, tmp_path):
    P = pkg_ns(pkg)
    sb_master = P.master.MasterServer(volume_size_limit_mb=16,
                                      meta_dir=str(tmp_path / "sbmeta"),
                                      pulse_seconds=60)
    sb_master.start()
    (tmp_path / "sb").mkdir()
    (tmp_path / "pr").mkdir()
    sb_port, pr_port = P.rpc.free_port(), P.rpc.free_port()
    pr_master = P.master.MasterServer(volume_size_limit_mb=16,
                                      meta_dir=str(tmp_path / "prmeta"),
                                      pulse_seconds=60)
    pr_master.start()

    def new_sb_vs():
        return volume_server(P, sb_master.url(), tmp_path / "sb",
                             port=sb_port, max_volume_counts=[50],
                             pulse_seconds=60)

    def new_pr_vs():
        return volume_server(P, pr_master.url(), tmp_path / "pr",
                             port=pr_port, max_volume_counts=[50],
                             pulse_seconds=60,
                             replicate_peer=sb_master.url(),
                             replicate_interval=0.05)

    live = [new_pr_vs(), new_sb_vs()]
    for s in live:
        s.start()
    try:
        P.rpc.call(f"{pr_master.url()}/vol/grow?count=1&collection=restart",
                   "POST")
        payloads = {}

        def put(data):
            a = P.rpc.call(f"{pr_master.url()}/dir/assign?collection=restart")
            vid = int(a["fid"].split(",")[0])
            v = live[0].store.find_volume(vid)
            if v.rlog is None:
                v.enable_rlog()
            P.rpc.call(f"http://{a['url']}/{a['fid']}", "POST", data)
            payloads[a["fid"]] = data
            return vid

        vid = put(b"before the outage " * 16)
        wait_shipped(P, live[0], vid)
        live[1].stop()
        for i in range(3):
            put(f"during the outage {i} ".encode() * 16)
        v = live[0].store.find_volume(vid)
        wait(lambda: v.rlog.pending() >= 3, 20)
        time.sleep(0.2)
        assert v.rlog.pending() >= 3, "watermark must hold while down"
        live[1] = new_sb_vs()
        live[1].start()
        P.resilience.reset_breakers()
        live[0].shipper.kick()
        wait_shipped(P, live[0], vid, timeout=30)
        acked_before_restart = v.rlog.acked_seq
        live[0].stop()
        live[0] = new_pr_vs()
        live[0].start()
        v = live[0].store.find_volume(vid)
        assert v.rlog is not None
        assert v.rlog.acked_seq == acked_before_restart
        assert v.rlog.pending() == 0
        assert put(b"after the restart " * 16) == vid
        wait_shipped(P, live[0], vid, timeout=30)
        sbc = P.client.WeedClient(sb_master.url())
        for fid, data in payloads.items():
            assert sbc.download(fid) == data
    finally:
        stop_all(*live, pr_master, sb_master)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cutover_under_load_zero_client_visible_errors(pkg, tmp_path):
    P = pkg_ns(pkg)
    sb_master = P.master.MasterServer(volume_size_limit_mb=16,
                                      meta_dir=str(tmp_path / "sbmeta"),
                                      pulse_seconds=60)
    sb_master.start()
    (tmp_path / "sb").mkdir()
    (tmp_path / "pr").mkdir()
    sb_vs = volume_server(P, sb_master.url(), tmp_path / "sb",
                          max_volume_counts=[50], pulse_seconds=60)
    sb_vs.start()
    pr_master = P.master.MasterServer(volume_size_limit_mb=16,
                                      meta_dir=str(tmp_path / "prmeta"),
                                      pulse_seconds=60)
    pr_master.start()
    pr_vs = volume_server(P, pr_master.url(), tmp_path / "pr",
                          max_volume_counts=[50], pulse_seconds=60,
                          replicate_peer=sb_master.url(),
                          replicate_interval=0.05)
    pr_vs.start()
    env = None
    stop = threading.Event()
    th = None
    try:
        P.rpc.call(f"{pr_master.url()}/vol/grow?count=1&collection=cut",
                   "POST")
        a = P.rpc.call(f"{pr_master.url()}/dir/assign?collection=cut")
        pr_vs.store.find_volume(int(a["fid"].split(",")[0])).enable_rlog()
        P.rpc.call(f"http://{a['url']}/{a['fid']}", "POST", b"cutover seed")
        acked, errors = [], []

        def writer():
            pc = P.client.WeedClient(pr_master.url())
            sc = P.client.WeedClient(sb_master.url())
            i = 0
            while not stop.is_set():
                data = f"cutover payload {i} ".encode() * 8
                i += 1
                try:
                    try:
                        fid = pc.upload_data(data, collection="cut")
                    except Exception:  # noqa: BLE001 — drained away
                        fid = sc.upload_data(data, collection="cutsb")
                    acked.append((fid, data))
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))
                time.sleep(0.005)

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        wait(lambda: len(acked) >= 5, 20, "no primary-acked traffic")
        env = P.shell.CommandEnv(pr_master.url(), **device_kw(pkg))
        P.shell.run_command(env, "lock")
        out = P.shell.run_command(
            env, "cluster.mirror.cutover -grace 1 -timeout 30")
        n_at_cutover = len(acked)
        wait(lambda: len(acked) >= n_at_cutover + 3, 20,
             "no standby-acked traffic after the cutover")
        stop.set()
        th.join(timeout=20)
        assert not th.is_alive()
        assert "cutover complete" in out
        assert pr_vs.shipper.paused
        assert errors == [], errors[:3]
        sbc = P.client.WeedClient(sb_master.url())
        for fid, data in acked:
            assert sbc.download(fid) == data
    finally:
        stop.set()
        if th is not None:
            th.join(timeout=20)
        if env is not None:
            env.close()
        stop_all(pr_vs, sb_vs, pr_master, sb_master)


# -- both packages' mirrors, byte for byte -------------------------------------------


def _mirror_files(pkg, root):
    """One package's mirror fed a fixed run of writes, an overwrite and
    a delete; every file of both volume servers once all has shipped."""
    P = pkg_ns(pkg)
    pr_master, pr_vs, sb_master, sb_vs = mirror_pair(P, root)
    try:
        rng = random.Random(11)
        P.rpc.call(f"{pr_master.url()}/vol/grow?count=1&collection=twin",
                   "POST")
        fids = []
        for i in range(12):
            a = P.rpc.call(f"{pr_master.url()}/dir/assign?collection=twin")
            vid = int(a["fid"].split(",")[0])
            v = pr_vs.store.find_volume(vid)
            if v.rlog is None:
                v.enable_rlog()
            P.rpc.call(f"http://{a['url']}/{a['fid']}", "POST",
                       rng.randbytes(rng.randrange(1, 20000)))
            fids.append(a["fid"])
            # One record per batch: what the standby appends then does
            # not depend on how the shipper's ticks fall.
            wait_shipped(P, pr_vs, vid)
        P.rpc.call(f"http://{pr_vs.url()}/{fids[3]}", "POST",
                   b"overwritten " * 40)
        wait_shipped(P, pr_vs, vid)
        P.rpc.call(f"http://{pr_vs.url()}/{fids[5]}", "DELETE")
        wait_shipped(P, pr_vs, vid)
        maps = (crc_map(P, pr_master.url(), fids[:5] + fids[6:]),
                crc_map(P, sb_master.url(), fids[:5] + fids[6:]))
        pr_vs._send_heartbeat(full=True)
    finally:
        stop_all(pr_vs, pr_master, sb_vs, sb_master)
    return {"fids": fids, "maps": maps,
            "primary": snapshot(str(root / "pr")),
            "standby": snapshot(str(root / "sb"))}


def test_mirrored_files_byte_identical_across_packages(tmp_path, monkeypatch):
    """Same writes into each package's mirror, on pinned clocks: the
    primaries' and the standbys' `.dat`, `.idx`, `.rlog`, `.rwm` and
    applied watermarks are byte-identical across packages, and each
    standby's CRC map equals its primary's."""
    clock = pin_clocks(monkeypatch)
    monkeypatch.setattr(time, "time_ns", clock.time_ns)
    # The raft election loop draws its timeouts from `random` as often
    # as the scheduler lets it: give it its own stream, so that the
    # assigns' cookies come from the seeded module stream alone.
    for pkg in PACKAGES:
        monkeypatch.setattr(pkg_ns(pkg).raft, "random", random.Random(1))
    out = []
    for pkg in PACKAGES:
        random.seed(0)
        d = tmp_path / pkg
        d.mkdir()
        out.append(_mirror_files(pkg, d))
    assert out[1] == out[0]
    state = out[1]
    assert state["maps"][0] == state["maps"][1]
    exts = {name.rsplit(".", 1)[-1] for name in state["standby"]}
    assert {"dat", "idx"} <= exts
    assert {"dat", "idx", "rlog", "rwm"} <= \
        {name.rsplit(".", 1)[-1] for name in state["primary"]}
