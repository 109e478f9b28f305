"""One master of each package in one process, fed the same cluster.

A simulated cluster of 16 volume servers (2 DCs x 2 racks x 4 nodes,
`-max=7`, every slot a volume of placement 010 in collection "" or
"pics", one RS volume's 14 EC shards on 14 nodes, SLO, tenant, flow and
disk views, node 0 carrying K1/K2 ledger rows) heartbeats into a
seaweedfs_tpu MasterServer and a seaweedfs_tpu_torch MasterServer over
HTTP (chip_smoke.cluster_heartbeats, the function phase 9 uses at 64
nodes).  Both masters then get the same request sequence, with
`random` seeded alike before each pair of calls and the wall clock
pinned in both packages, and every answer's status and JSON must be
equal between them.  On both transports.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import threading
import types

import pytest

from _torch_cluster import (PACKAGES, hermetic_port_state,  # noqa: F401
                            mod, pin_clocks)

pytestmark = pytest.mark.torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_PORT = 41000
EC_VID = 1
# "acme" stores 16 x 2 MB against a 1 MB hard quota: its assigns get 403.
TENANTS = (("acme", "", 2_000_000, 40), ("beta", "pics", 5_000, 3))
TENANT_RULES = "acme max_bytes=1000000\n"
DEVICE_VIEW = {
    "kernels": [
        {"kernel": "encode_crc_kernel", "codec": "rs", "dtype": "int8",
         "geometry": "4x10x4194304", "count": 26, "seconds": 0.001552,
         "bytes": 1_090_519_040, "work": 13_958_643_712,
         "achieved_p50": 0.29, "achieved_p95": 0.31},
        {"kernel": "reconstruct_kernel", "codec": "rs", "dtype": "int8",
         "geometry": "4x10x4194304", "count": 26, "seconds": 0.000967,
         "bytes": 1_090_519_040, "work": 13_958_643_712,
         "achieved_p50": 0.47, "achieved_p95": 0.5}],
    "occupancy": {"latest": {}, "collapsed": {}, "streaks": {},
                  "any_collapsed": False}}
PEAKS = {"version": 2, "backend": "cuda",
         "device_kind": "NVIDIA H100 80GB HBM3",
         "matmul_flops": {"int8": 9.57e14, "bf16": 7.85e14},
         "membw_bps": 2.86e12, "h2d_bps": 5.24e10, "d2h_bps": 5.52e10,
         "host_stream_bps": 1.0e10, "probe_seconds": 1.0}
# Fields normalised before the comparison, each with its reason:
# - "leader" (/cluster/healthz, /cluster/device): the master's own URL,
#   a different free port per master;
# - "slo" (/cluster/healthz): folds in the master's own request-latency
#   sketch, which is wall time of this process's requests.
NORMALISED = ("leader", "slo")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _normalise(doc):
    if isinstance(doc, dict):
        return {k: "<normalised>" if k in NORMALISED else _normalise(v)
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_normalise(v) for v in doc]
    return doc


class Twin:
    """The two masters and the one HTTP client that feeds them."""

    def __init__(self, masters):
        from seaweedfs_tpu_torch.cluster import rpc
        self.masters = masters
        self.rpc = rpc
        self.step = 0

    def call(self, path: str, method: str = "GET", body=None,
             headers=None) -> tuple:
        """The same request to both masters, `random` seeded alike
        before each; both answers, normalised, must be equal."""
        self.step += 1
        answers = []
        for m in self.masters:
            random.seed(self.step)
            status, doc = self.rpc.call_status(
                m.url() + path, method,
                None if body is None else json.dumps(body).encode(),
                headers=headers)
            answers.append((status, _normalise(doc)))
        assert answers[1] == answers[0], path
        return answers[1]

    def beat(self, hb: dict) -> None:
        self.call("/heartbeat", "POST", hb)


@pytest.mark.parametrize("transport", ["threads", "aio"])
def test_masters_answer_alike(transport, tmp_path, monkeypatch):
    cs = _chip_smoke()
    pin_clocks(monkeypatch)
    for pkg in PACKAGES:
        roofline = mod(pkg, "stats.roofline")
        monkeypatch.setattr(roofline, "probe_peaks", lambda *a, **k: PEAKS)
        # This process's own ledger is not the masters' to report.
        monkeypatch.setattr(roofline.LEDGER, "heartbeat_view", lambda: {
            "kernels": [], "occupancy": {}})
    rules = tmp_path / "tenants.txt"
    rules.write_text(TENANT_RULES)
    hbs = cs.cluster_heartbeats(
        2, 2, 4, 7, size_limit=30000 << 20, seed=3, base_port=BASE_PORT,
        ec_vid=EC_VID, ec_collection="smoke", collections=("", "pics"),
        tenants=TENANTS, device=DEVICE_VIEW)
    vols, ec = cs.declared_locations(hbs)
    masters = []
    for pkg in PACKAGES:
        m = mod(pkg, "cluster.master").MasterServer(
            volume_size_limit_mb=30000, default_replication="010",
            transport=transport, tenant_rules=str(rules))
        # The forced sweep below stands for the pulse's: a background
        # sweep would drop nodes at an instant of its own.
        m._sweeper = threading.Thread(target=lambda: None)
        masters.append(m)
    seqs = [mod(pkg, "events").JOURNAL._seq for pkg in PACKAGES]
    try:
        for m in masters:
            m.start()
        twin = Twin(masters)
        for hb in hbs:
            twin.beat(hb)
        status, top = twin.call("/dir/status")
        assert top["topology"]["volumes"] == 2 * len(vols) == 16 * 7
        assert top["topology"]["ecShards"] == 14

        fids = []
        for q in ("count=1", "count=5", "collection=pics",
                  "collection=pics&count=5", "replication=010",
                  "replication=000", "collection=nobody", "count=1"):
            status, doc = twin.call("/dir/assign?" + q)
            if q in ("replication=000", "collection=nobody"):
                # No declared volume: the grow path finds every slot full.
                assert status >= 400
            else:
                assert status == 200 and int(doc["fid"].split(",")[0]) in vols
                fids.append(doc["fid"])
        status, doc = twin.call("/dir/assign", headers={
            "X-Weed-Tenant": "acme"})
        assert status == 403 and "QuotaExceeded" in doc["error"]
        status, doc = twin.call("/dir/assign?collection=pics", headers={
            "X-Weed-Tenant": "beta"})
        assert status == 200
        assert len(set(fids)) == len(fids)

        for vid in sorted(vols)[::7] + [EC_VID]:
            status, doc = twin.call(f"/dir/lookup?volumeId={vid}")
            assert status == 200
            if vid == EC_VID:
                assert {s: [x["url"] for x in locs] for s, locs in
                        doc["ecShards"].items()} == ec
            else:
                assert sorted(x["url"] for x in doc["locations"]) == \
                    vols[vid]
        twin.call("/dir/lookup?volumeId=9999")
        for path in ("/vol/list", "/dir/status"):
            status, doc = twin.call(path)
            assert status == 200, doc
        status, doc = twin.call("/cluster/healthz")
        # acme's hard quota is the one problem: 503 for a load balancer.
        assert status == 503 and len(doc["problems"]) == 1
        assert doc["problems"][0].startswith("tenant acme: hard quota")
        status, doc = twin.call("/cluster/device")
        assert doc["kernels"] and doc["peaks"] == PEAKS
        assert {r["kernel"] for r in doc["kernels"]} == {
            "encode_crc_kernel", "reconstruct_kernel"}

        gone = next(i for i, hb in enumerate(hbs) if i and hb["ec_shards"])
        twin.beat(cs.goodbye_beat(hbs[gone]))
        held = sorted(v for v, urls in vols.items()
                      if cs.node_key(hbs[gone]) in urls)
        status, doc = twin.call(f"/dir/lookup?volumeId={held[0]}")
        assert cs.node_key(hbs[gone]) not in [x["url"]
                                              for x in doc["locations"]]

        # Three pulses later every node but `stale` has beaten again; the
        # sweep must drop exactly that one.
        clock = mod("seaweedfs_tpu", "cluster.master").time
        clock.now += 15.0
        stale = next(i for i, hb in enumerate(hbs)
                     if i not in (0, gone) and hb["ec_shards"])
        for i, hb in enumerate(hbs):
            if i not in (gone, stale):
                twin.beat(cs.delta_beat(hb, 2))
        for m in masters:
            m._sweep_dead_nodes()
        held = sorted(v for v, urls in vols.items()
                      if cs.node_key(hbs[stale]) in urls)
        status, doc = twin.call(f"/dir/lookup?volumeId={held[0]}")
        assert [x["url"] for x in doc["locations"]] == [
            u for u in vols[held[0]] if u != cs.node_key(hbs[stale])]
        status, doc = twin.call(f"/dir/lookup?volumeId={EC_VID}")
        assert len(doc["ecShards"]) == 12
        for path in ("/dir/status", "/cluster/healthz", "/vol/list"):
            twin.call(path)
        for pkg, seq in zip(PACKAGES, seqs):
            kinds = {e["type"] for e in mod(pkg, "events").JOURNAL.snapshot()
                     if e["seq"] > seq}
            # The masters never grew a volume, so never dialled a node.
            assert not kinds & {"volume.grow", "volume.assign"}
            assert {"node.drained", "heartbeat.lost"} <= kinds
    finally:
        for m in masters:
            m.stop()


def test_chip_smoke_phase_cluster_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.phase_cluster on the CPU at 200 assigns and lookups per
    transport and a 4 MiB window: the masters start from the port's
    entry point with the JAX package blocked, and every check of the
    phase runs (the peaks' backend is the CPU's here).  The subprocess
    masters read the peaks this process probed from the disk cache."""
    import torch

    from _torch_cluster import count_plain_launches
    from seaweedfs_tpu_torch.ec import encoder
    from seaweedfs_tpu_torch.stats import roofline

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "REPO", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setenv("SEAWEEDFS_TPU_ROOFLINE_CACHE", str(tmp_path / "pk"))
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setattr(encoder, "fused_crc_enabled", lambda *a, **k: True)
    count_plain_launches(monkeypatch)
    monkeypatch.setitem(roofline.PROBE_SIZES, "cpu", {
        "m": 32, "membw_bytes": 4096, "copy_bytes": 4096, "reps": 1})
    roofline.probe_peaks("cpu", force=True)
    for name, value in (("CLUSTER_ASSIGNS", 200), ("CLUSTER_LOOKUPS", 200),
                        ("CLUSTER_WINDOW_MIB", 4)):
        monkeypatch.setattr(cs, name, value)
    dev = torch.device("cpu")
    # The ledger holds K1/K2 rows, as after phases 4, 6 and 8.
    cs.cluster_window(torch, dev, 1)
    with cs.hooks("armed"):
        out = cs.phase_cluster(torch, dev, types.SimpleNamespace(seed=0))
    assert out["window_launches"] == {"rs_bitmatrix": 2,
                                      "rs_bitmatrix_crc": 2}
    for transport in ("threads", "aio"):
        res = out[transport]
        assert res["assign"]["requests"] == res["lookup"]["requests"] == 200
        assert res["device"]["peaks_backend"] == "cpu"
        assert res["device"]["window_rows"] == {"encode_crc_kernel": 1,
                                                "reconstruct_kernel": 1}
        assert res["master_rss_mib"] > 0
