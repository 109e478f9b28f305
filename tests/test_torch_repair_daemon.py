"""The port's durability autopilot (cluster/repair_daemon.py) against
seaweedfs_tpu's: the master-only cases of tests/test_repair_daemon.py
(a returning node cancels its queued repair, the dead-node sweep
snapshots holdings before it unregisters, the failure-domain audit
warns and never answers 503), each run for both packages with the
journal events and reports held equal; and the EC rebuild branch on a
live cluster of each package, rebuilding a lost shard holder's shards
byte-equal to the originals."""

from __future__ import annotations

import json
import random

import pytest
import torch

from _torch_cluster import (PACKAGES, PORT, LiveCluster, both,  # noqa: F401
                            cluster_deadline, hermetic_port_state, mod,
                            pin_clocks)

pytestmark = pytest.mark.torch


def _master(pkg):
    return mod(pkg, "cluster.master").MasterServer(port=0)


def _beat(m, body: dict) -> None:
    m._heartbeat({}, json.dumps(body).encode())


def _events(pkg, seq: int, type_: str) -> list:
    return [e for e in mod(pkg, "events").JOURNAL.snapshot(type_=type_)
            if e["seq"] > seq]


def _seq(pkg) -> int:
    return mod(pkg, "events").JOURNAL._seq


def test_returning_node_cancels_queued_repair(monkeypatch):
    """Resurrection before the executor picks the task up: the healed
    deficit leaves the queue with a repair.cancel, nothing executes."""
    pin_clocks(monkeypatch)
    vol = {"id": 4242, "collection": "rz", "size": 0, "file_count": 0,
           "replica_placement": 1}

    def run(pkg):
        seq = _seq(pkg)
        m = _master(pkg)
        try:
            _beat(m, {"ip": "127.0.0.1", "port": 4101, "volumes": [vol]})
            m.repair._degraded_since[("replicate", 4242)] = 0.0
            m.repair.reconcile()
            queued = [t.vid for t in m.repair._queue]
            assert queued == [4242]
            _beat(m, {"ip": "127.0.0.1", "port": 4102, "volumes": [vol]})
            m.repair.reconcile()
            assert not m.repair._queue
        finally:
            m.server.stop()
        cancels = [e["attrs"] for e in _events(pkg, seq, "repair.cancel")
                   if e["attrs"].get("volume") == 4242]
        assert cancels and cancels[0]["reason"] == "healed"
        return queued, cancels
    both(run)


def test_sweep_snapshot_precedes_unregister(monkeypatch):
    """heartbeat.lost reports the node's pre-death holdings even when the
    unregister races a sync that drains the node's dicts."""
    pin_clocks(monkeypatch)
    vols = [{"id": 100 + i, "collection": "", "size": 0, "file_count": 0,
             "replica_placement": 0} for i in range(3)]
    shards = [{"id": 900, "shard_bits": 0b11, "collection": ""},
              {"id": 901, "shard_bits": 0b100, "collection": ""}]

    def run(pkg):
        seq = _seq(pkg)
        m = _master(pkg)
        try:
            _beat(m, {"ip": "127.0.0.1", "port": 5101, "volumes": vols,
                      "ec_shards": shards})
            dn = next(iter(m.topo.leaves()))
            assert len(dn.volumes) == 3 and len(dn.ec_shards) == 2
            real = m.topo.unregister_data_node

            def racing_unregister(node):
                node.volumes.clear()
                node.ec_shards.clear()
                return real(node)

            m.topo.unregister_data_node = racing_unregister
            dn.last_seen = 0.0
            m._sweep_dead_nodes()
        finally:
            m.server.stop()
        lost = [e["attrs"] for e in _events(pkg, seq, "heartbeat.lost")
                if e["node"] == "127.0.0.1:5101"]
        assert lost and lost[-1]["volumes"] == 3
        assert lost[-1]["ec_shards"] == 2
        return lost
    both(run)


def test_placement_audit_warns_never_503(monkeypatch):
    """Replicas all in one rack against a 010 placement, and an EC
    stripe on one node, surface as healthz warnings, never as 503."""
    pin_clocks(monkeypatch)
    vol = {"id": 7, "collection": "", "size": 0, "file_count": 0,
           "replica_placement": 10}

    def run(pkg):
        m = _master(pkg)
        try:
            for port in (6101, 6102):
                _beat(m, {"ip": "127.0.0.1", "port": port, "rack": "rackA",
                          "volumes": [vol]})
            _beat(m, {"ip": "127.0.0.1", "port": 6103, "rack": "rackB",
                      "ec_shards": [{"id": 55, "shard_bits": (1 << 14) - 1,
                                     "collection": ""}]})
            ok, doc = m.health_report()
        finally:
            m.server.stop()
        warnings = doc["placement"]["warnings"]
        assert any("volume 7" in w and "rack" in w for w in warnings)
        assert any("ec volume 55" in w and "14 shards" in w
                   for w in warnings)
        assert ok and doc["healthy"]
        doc.pop("slo")  # the master's own request sketch: none here
        doc.pop("leader")
        return doc
    both(run)


def _spread_ec(cluster, blob: bytes):
    """Encode one volume rs(10,4) on its holder, spread the shards 5/5/4
    over the first three servers and drop the original."""
    rpc = cluster.rpc
    client = cluster.client()
    fid = client.upload_data(blob, collection="ecrep")
    vid = int(fid.split(",")[0])
    src = client.lookup(vid)[0]["url"]
    rpc.call_json(f"http://{src}/admin/ec/generate", "POST", {"volume": vid})
    spread = dict(zip((vs.url() for vs in cluster.servers),
                      ([0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11, 12, 13])))
    for url, shards in spread.items():
        if url != src:
            rpc.call_json(f"http://{url}/admin/ec/copy_shard", "POST",
                          {"volume": vid, "source": src, "shards": shards,
                           "copy_ecx": True})
    for url, shards in spread.items():
        rpc.call_json(f"http://{url}/admin/ec/mount", "POST", {"volume": vid})
        rpc.call_json(f"http://{url}/admin/ec/delete_shards", "POST",
                      {"volume": vid, "shards": [
                          s for s in range(14) if s not in shards]})
    rpc.call_json(f"http://{src}/admin/delete_volume", "POST",
                  {"volume": vid})
    cluster.freshen()
    return vid, fid


@pytest.mark.usefixtures("cluster_deadline")
def test_armed_daemons_rebuild_lost_ec_shards_live(tmp_path, monkeypatch):
    """Both packages' masters armed with -repair, a live cluster of four
    volume servers, one RS volume spread 5/5/4: the 4-shard holder dies
    and the dead-node sweep unregisters it, leaving the stripe at its
    decode minimum.  Each daemon's EC branch (`_rebuild_ec` over the
    package's `batch_rebuild`) rebuilds shards 10-13 byte-equal to the
    originals, the needle reads back, and no EC deficit is left."""
    pin_clocks(monkeypatch)
    blob = bytes(range(256)) * 1024
    rebuilt = {}
    for pkg in PACKAGES:
        random.seed(0)
        cluster = LiveCluster(pkg, tmp_path / pkg, n=4, master_kw={
            "volume_size_limit_mb": 16, "repair_enabled": True})
        try:
            master, servers = cluster.master, cluster.servers
            if pkg == PORT:
                master.repair._mesh = mod(
                    pkg, "parallel.cluster_rebuild").make_mesh(
                        [torch.device("cpu")])
            vid, fid = _spread_ec(cluster, blob)
            holder = servers[2]
            originals = {sid: bytes(cluster.rpc.call(
                f"http://{holder.url()}/admin/ec/shard_file?volume={vid}"
                f"&shard={sid}")) for sid in range(10, 14)}
            holder.stop()
            dn = next(n for n in master.topo.leaves()
                      if n.url() == holder.url())
            dn.last_seen = 0.0
            master._sweep_dead_nodes()
            locs = master.topo.lookup_ec_shards(vid)
            assert {s for s, dns in locs.locations.items() if dns} == \
                set(range(10))
            out = master.repair.run_now(kinds=["ec"], timeout=120.0)
            assert any(r["outcome"] == "ok" and r["kind"] == "ec"
                       for r in out["results"]), out
            locs = master.topo.lookup_ec_shards(vid)
            assert {s for s, dns in locs.locations.items() if dns} == \
                set(range(14))
            assert not [t for t in master.repair.scan() if t.kind == "ec"]
            got = {}
            for sid in range(10, 14):
                url = locs.locations[sid][0].url()
                got[sid] = bytes(cluster.rpc.call(
                    f"http://{url}/admin/ec/shard_file?volume={vid}"
                    f"&shard={sid}"))
            assert got == originals
            cluster.freshen()
            assert bytes(cluster.rpc.call(
                f"http://{servers[0].url()}/{fid}")) == blob
            rebuilt[pkg] = got
        finally:
            cluster.stop()
    assert rebuilt[PORT] == rebuilt[PACKAGES[0]]
