"""The port's durability autopilot (cluster/repair_daemon.py) against
seaweedfs_tpu's: the master-only cases of tests/test_repair_daemon.py
(a returning node cancels its queued repair, the dead-node sweep
snapshots holdings before it unregisters, the failure-domain audit
warns and never answers 503), each run for both packages with the
journal events and reports held equal; and the EC rebuild branch, whose
network half comes with the volume server (ROADMAP queue 1, slice 8b):
neither a disarmed daemon nor the replica path reaches it, and reaching
it fails loudly."""

from __future__ import annotations

import json

import pytest

from _torch_cluster import (both, hermetic_port_state,  # noqa: F401
                            mod, pin_clocks)
from seaweedfs_tpu_torch.cluster.master import MasterServer
from seaweedfs_tpu_torch.cluster.repair_daemon import RepairDaemon

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


def test_rebuild_ec_is_not_reached_and_fails_loudly(monkeypatch):
    """A disarmed daemon never enqueues, the replica path never calls the
    EC rebuild, and reaching it raises NotImplementedError (its network
    half is slice 8b) instead of reporting success."""
    reached = []
    real = RepairDaemon._rebuild_ec
    monkeypatch.setattr(RepairDaemon, "_rebuild_ec",
                        lambda self, t: reached.append(t.vid))
    m = MasterServer(port=0)
    try:
        vol = {"id": 11, "collection": "", "size": 0, "file_count": 0,
               "replica_placement": 1}
        _beat(m, {"ip": "127.0.0.1", "port": 7101, "volumes": [vol]})
        # An EC stripe short of 4 shards: a deficit the daemon sees.
        _beat(m, {"ip": "127.0.0.1", "port": 7102, "ec_shards": [
            {"id": 12, "shard_bits": (1 << 10) - 1, "collection": ""}]})
        assert {t.kind for t in m.repair.scan()} == {"replicate", "ec"}
        m.repair.tick()  # disarmed: nothing is enqueued
        assert not m.repair._queue and reached == []
        out = m.repair.run_now(kinds=["replicate"], timeout=10.0)
        assert reached == [] and out["results"]
        assert all(r["kind"] == "replicate" for r in out["results"])
        task = next(t for t in m.repair.scan() if t.kind == "ec")
        with pytest.raises(NotImplementedError, match="8b"):
            real(m.repair, task)
    finally:
        m.server.stop()
