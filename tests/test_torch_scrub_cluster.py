"""Scrub and self-healing on a live cluster: the cluster and kill -9
cases of tests/test_scrub.py, each run once for the JAX package and
once for the port (`pkg`).  Bit-rot on one replica is found, quarantined
and healed from the sibling; a CRC-failing GET repairs inline; a single
copy answers 500 and reports degraded; rot in an EC shard is healed
through the volume server's EC decode path (`_repair_ec_block`); a disk
read fault surfaces once; HEAD carries the needle CRC; volume.scrub and
volume.check.disk heal diverged replicas without resurrecting deletes
or erasing the healthy copy of a quarantined needle; and a volume
server killed with SIGKILL mid-burst loses no acknowledged write."""

from __future__ import annotations

import glob
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from _torch_cluster import (PORT, LiveCluster, cluster_deadline,  # noqa: F401
                            hermetic_port_state, mod, pkg)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cluster(pkg, tmp_path):
    c = LiveCluster(pkg, tmp_path, n=2,
                    master_kw={"volume_size_limit_mb": 16},
                    vs_kw={"max_volume_counts": [50]})
    yield c
    mod(pkg, "fault").disarm_all()
    c.stop()


def _grow_and_corrupt_write(cluster, collection, replication=""):
    """One volume in `collection`, one clean needle, then one needle
    whose local copy is bit-rotted at write time (volume.corrupt)."""
    rpc, fault = cluster.rpc, mod(cluster.pkg, "fault")
    rep = f"&replication={replication}" if replication else ""
    rpc.call(f"{cluster.url()}/vol/grow?count=1&collection={collection}"
             f"{rep}", "POST")
    a1 = rpc.call(f"{cluster.url()}/dir/assign?collection={collection}{rep}")
    rpc.call(f"http://{a1['url']}/{a1['fid']}", "POST", b"clean needle")
    a2 = rpc.call(f"{cluster.url()}/dir/assign?collection={collection}{rep}")
    payload = b"soon to be rotten " * 32
    fault.arm("volume.corrupt", "fail*1")
    try:
        rpc.call(f"http://{a2['url']}/{a2['fid']}", "POST", payload)
    finally:
        fault.disarm_all()
    return int(a2["fid"].split(",")[0]), a2["url"], a2["fid"], payload


def _types_since(pkg, seq):
    return {ev["type"] for ev in mod(pkg, "events").JOURNAL.snapshot()
            if ev["seq"] > seq}


def _repairs(pkg):
    return mod(pkg, "stats.metrics").needle_repairs_total


def test_self_healing_replicated_volume(cluster):
    rpc, pkg = cluster.rpc, cluster.pkg
    seq0 = mod(pkg, "events").JOURNAL._seq
    vid, url, fid, payload = _grow_and_corrupt_write(cluster, "healrep",
                                                     "001")
    before = _repairs(pkg).value(source="replica")
    out = rpc.call_json(f"http://{url}/admin/scrub", "POST", {"volume": vid})
    report = next(r for r in out["volumes"]
                  if r["id"] == vid and r["kind"] == "volume")
    assert report["corrupt"] == 1 and report["quarantined"] == 1
    status, doc = rpc.call_status(f"{cluster.url()}/cluster/healthz")
    assert status == 503 and not doc["healthy"]
    assert any(f"volume {vid}" in p and "corrupt" in p
               for p in doc["problems"]), doc["problems"]
    assert {"scrub.start", "scrub.finish", "needle.corrupt",
            "volume.quarantine"} <= _types_since(pkg, seq0)
    out = rpc.call_json(f"http://{url}/admin/scrub", "POST",
                        {"volume": vid, "repair": True})
    assert out["repaired"] == 1
    assert _repairs(pkg).value(source="replica") == before + 1
    status, doc = rpc.call_status(f"{cluster.url()}/cluster/healthz")
    assert status == 200 and doc["healthy"], doc["problems"]
    assert "needle.repaired" in _types_since(pkg, seq0)
    assert bytes(rpc.call(f"http://{url}/{fid}")) == payload


def test_degraded_read_repairs_inline(cluster):
    rpc, pkg = cluster.rpc, cluster.pkg
    _vid, url, fid, payload = _grow_and_corrupt_write(cluster, "degread",
                                                      "001")
    before = _repairs(pkg).value(source="replica")
    assert bytes(rpc.call(f"http://{url}/{fid}")) == payload
    assert _repairs(pkg).value(source="replica") == before + 1
    assert bytes(rpc.call(f"http://{url}/{fid}")) == payload
    assert _repairs(pkg).value(source="replica") == before + 1


def test_unrepairable_corruption_quarantines(cluster):
    rpc = cluster.rpc
    vid, url, fid, _payload = _grow_and_corrupt_write(cluster, "noheal")
    with pytest.raises(rpc.RpcError) as ei:
        rpc.call(f"http://{url}/{fid}")
    assert ei.value.status == 500
    status, doc = rpc.call_status(f"{cluster.url()}/cluster/healthz")
    assert status == 503
    assert any(f"volume {vid}" in p for p in doc["problems"])
    st = rpc.call(f"http://{url}/admin/scrub/status")
    assert next(r for r in st["volumes"]
                if r["id"] == vid)["corrupt_count"] == 1


def test_self_healing_ec_volume(cluster):
    """Rot injected into an EC shard at encode time is caught by the
    shard-checksum scrub and healed through the EC decode path."""
    rpc, pkg = cluster.rpc, cluster.pkg
    fault = mod(pkg, "fault")
    seq0 = mod(pkg, "events").JOURNAL._seq
    col = "healec"
    rpc.call(f"{cluster.url()}/vol/grow?count=1&collection={col}", "POST")
    a = rpc.call(f"{cluster.url()}/dir/assign?collection={col}")
    payload = b"erasure coded payload " * 64
    rpc.call(f"http://{a['url']}/{a['fid']}", "POST", payload)
    vid, url = int(a["fid"].split(",")[0]), a["url"]
    fault.arm("volume.corrupt", "fail*1")
    try:
        rpc.call_json(f"http://{url}/admin/ec/generate", "POST",
                      {"volume": vid})
    finally:
        fault.disarm_all()
    rpc.call_json(f"http://{url}/admin/ec/mount", "POST", {"volume": vid})
    before = _repairs(pkg).value(source="ec")
    out = rpc.call_json(f"http://{url}/admin/scrub", "POST", {"volume": vid})
    ec_report = next(r for r in out["volumes"] if r["kind"] == "ec")
    assert ec_report["corrupt"] >= 1 and ec_report["unrepaired"] >= 1
    status, doc = rpc.call_status(f"{cluster.url()}/cluster/healthz")
    assert status == 503
    assert any(f"ec volume {vid}" in p and "corrupt shard block" in p
               for p in doc["problems"]), doc["problems"]
    out = rpc.call_json(f"http://{url}/admin/scrub", "POST",
                        {"volume": vid, "repair": True})
    ec_report = next(r for r in out["volumes"] if r["kind"] == "ec")
    assert ec_report["repaired"] >= 1 and ec_report["unrepaired"] == 0
    assert _repairs(pkg).value(source="ec") > before
    assert "needle.repaired" in _types_since(pkg, seq0)
    status, doc = rpc.call_status(f"{cluster.url()}/cluster/healthz")
    assert status == 200 and doc["healthy"], doc["problems"]
    # The repaired shard bytes are the true bytes: read through EC.
    cluster.server(url).store.delete_volume(vid)
    assert bytes(rpc.call(f"http://{url}/{a['fid']}")) == payload
    out = rpc.call_json(f"http://{url}/admin/scrub", "POST", {"volume": vid})
    assert out["corrupt"] == 0


def test_disk_read_fault_surfaces_then_heals(cluster):
    rpc = cluster.rpc
    rpc.call(f"{cluster.url()}/vol/grow?count=1&collection=diskread",
             "POST")
    a = rpc.call(f"{cluster.url()}/dir/assign?collection=diskread")
    rpc.call(f"http://{a['url']}/{a['fid']}", "POST", b"sector data")
    mod(cluster.pkg, "fault").arm("disk.read", "fail*1")
    with pytest.raises(rpc.RpcError) as ei:
        rpc.call(f"http://{a['url']}/{a['fid']}")
    assert ei.value.status == 500
    assert bytes(rpc.call(f"http://{a['url']}/{a['fid']}")) == b"sector data"


def test_head_returns_needle_checksum(cluster):
    import urllib.request
    rpc = cluster.rpc
    rpc.call(f"{cluster.url()}/vol/grow?count=1&collection=headcrc", "POST")
    a = rpc.call(f"{cluster.url()}/dir/assign?collection=headcrc")
    out = rpc.call(f"http://{a['url']}/{a['fid']}", "POST", b"crc me")
    req = urllib.request.Request(f"http://{a['url']}/{a['fid']}",
                                 method="HEAD")
    resp = urllib.request.urlopen(req, timeout=10)
    resp.read()
    assert resp.headers["X-Needle-Checksum"] == out["eTag"]


def test_volume_scrub_and_check_disk_shell_commands(cluster):
    """volume.check.disk brings back a needle one holder never got and
    propagates a delete one holder missed, never resurrecting it."""
    rpc = cluster.rpc
    col = "checkdisk"
    rpc.call(f"{cluster.url()}/vol/grow?count=1&collection={col}"
             f"&replication=001", "POST")
    a = rpc.call(f"{cluster.url()}/dir/assign?collection={col}"
                 f"&replication=001")
    rpc.call(f"http://{a['url']}/{a['fid']}?type=replicate", "POST",
             b"diverge me")
    vid = int(a["fid"].split(",")[0])
    b = rpc.call(f"{cluster.url()}/dir/assign?collection={col}"
                 f"&replication=001")
    rpc.call(f"http://{b['url']}/{b['fid']}", "POST", b"delete me")
    rpc.call(f"http://{b['url']}/{b['fid']}?type=replicate", "DELETE")
    locs = [loc["url"] for loc in rpc.call(
        f"{cluster.url()}/dir/lookup?volumeId={vid}")["locations"]]
    sibling = next(u for u in locs if u != a["url"])
    env = cluster.env()
    env.lock()
    out = cluster.run(env, f"volume.check.disk -volumeId {vid} -n")
    assert "would repair" in out and "would delete" in out
    out = cluster.run(env, f"volume.check.disk -volumeId {vid}")
    assert "repaired needle" in out and "propagated delete" in out
    assert bytes(rpc.call(f"http://{sibling}/{a['fid']}")) == b"diverge me"
    for u in locs:
        with pytest.raises(rpc.RpcError) as ei:
            rpc.call(f"http://{u}/{b['fid']}")
        assert ei.value.status == 404
    out = cluster.run(env, f"volume.scrub -volumeId {vid}")
    assert f"volume {vid}" in out and "corrupt 0" in out


def test_check_disk_never_deletes_healthy_copy_of_quarantined(cluster):
    rpc = cluster.rpc
    vid, url, fid, payload = _grow_and_corrupt_write(cluster, "quarcheck",
                                                     "001")
    rpc.call_json(f"http://{url}/admin/scrub", "POST", {"volume": vid})
    locs = [loc["url"] for loc in rpc.call(
        f"{cluster.url()}/dir/lookup?volumeId={vid}")["locations"]]
    sibling = next(u for u in locs if u != url)
    env = cluster.env()
    env.lock()
    out = cluster.run(env, f"volume.check.disk -volumeId {vid}")
    assert "propagated delete" not in out
    assert "repaired quarantined needle" in out
    assert bytes(rpc.call(f"http://{sibling}/{fid}")) == payload
    assert bytes(rpc.call(f"http://{url}/{fid}")) == payload
    assert rpc.call_status(f"{cluster.url()}/cluster/healthz")[0] == 200


def test_kill9_remount_loses_no_acked_writes(pkg, tmp_path):
    """SIGKILL a subprocess volume server (`python -m <pkg> volume`, the
    port's with -device=cpu) mid-upload-burst: on remount every
    acknowledged write reads back and any torn tail is truncated."""
    rpc = mod(pkg, "cluster.rpc")
    t = mod(pkg, "core.types")
    volume_cls = mod(pkg, "storage.volume").Volume
    master = mod(pkg, "cluster.master").MasterServer(
        volume_size_limit_mb=64, meta_dir=str(tmp_path / "meta"),
        pulse_seconds=60)
    master.start()
    vport = rpc.free_port()
    data = tmp_path / "vsdata"
    data.mkdir()
    device = ["-device=cpu"] if pkg == PORT else []
    proc = subprocess.Popen(
        [sys.executable, "-m", pkg, "volume", f"-port={vport}",
         f"-dir={data}", "-max=8", f"-mserver=127.0.0.1:{master.server.port}",
         *device], cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    acked: list[tuple[str, bytes]] = []
    try:
        deadline = time.time() + 60
        while not list(master.topo.leaves()):
            assert time.time() < deadline, "subprocess vs never registered"
            assert proc.poll() is None, "subprocess vs exited"
            time.sleep(0.2)
        rpc.call(f"{master.url()}/vol/grow?count=2", "POST")
        client = mod(pkg, "cluster.client").WeedClient(master.url())
        stop = threading.Event()
        lock = threading.Lock()

        def writer(k: int) -> None:
            i = 0
            while not stop.is_set():
                payload = f"worker {k} write {i} ".encode() * 8
                try:
                    fid = client.upload_data(payload)
                except Exception:  # noqa: BLE001 — server died mid-PUT
                    return
                with lock:
                    acked.append((fid, payload))
                i += 1

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        deadline = time.time() + 30
        while len(acked) < 80 and time.time() < deadline:
            time.sleep(0.02)
        os.kill(proc.pid, signal.SIGKILL)
        stop.set()
        for th in threads:
            th.join(timeout=30)
        proc.wait(timeout=10)
        assert len(acked) >= 20, "burst never got going"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        master.stop()
    volumes = {}
    try:
        for dat in glob.glob(str(data / "*.dat")):
            vid = int(os.path.basename(dat)[:-4])
            v = volume_cls(str(data), "", vid, create=False,
                           use_worker=False)
            volumes[vid] = v
            assert v.dat_size() == os.path.getsize(dat)
            assert v.dat_size() % t.NEEDLE_PADDING_SIZE == 0
        lost = []
        for fid, payload in acked:
            vid, key, cookie = t.parse_file_id(fid)
            try:
                if volumes[vid].read_needle(key, cookie).data != payload:
                    lost.append((fid, "bytes differ"))
            except Exception as e:  # noqa: BLE001
                lost.append((fid, str(e)))
        assert not lost, f"{len(lost)}/{len(acked)} acked writes lost"
    finally:
        for v in volumes.values():
            v.close()
