"""The gate of the port's cluster slice: the cluster half of
`__graft_entry__.dryrun_multichip`, run by each package on a live
in-process cluster and held byte for byte between them.

Each package brings up a master and three volume servers (volume limit
16 MB), grows two volumes and uploads needles of 2 KiB to 1 MiB made
from one seed into them, then runs `lock` and
`ec.encode -volumeId a,b -batch` through its own shell.  The
full-heartbeat shard locations must cover all 14 shards and every
needle must read back; shards 1 and 12 of both volumes are then
deleted, `ec.rebuild -batch` restores them and every needle reads back
again.  `random` is seeded alike and the clocks pinned in both packages
(`pin_clocks`), so the two clusters write the same needle bytes.

Every shard file in each cluster, after encode and after rebuild,
equals by shard id the same package's `write_ec_files` of a copy of
the sealed `.dat`, and the other package's; so do the `.ecx` and
`.vif` bodies on every holder, and each shard's `.ecc` block CRCs.
The tolerance is zero.
"""

from __future__ import annotations

import glob
import json
import os
import random

import numpy as np
import pytest

from _torch_cluster import (PACKAGES, PORT, LiveCluster,  # noqa: F401
                            cluster_deadline, hermetic_port_state, mod,
                            pin_clocks)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]

SEED = 7
N_NEEDLES = 24


def _needles() -> list[bytes]:
    """Log-uniform 2 KiB - 1 MiB payloads from SEED."""
    rng = np.random.default_rng(SEED)
    sizes = np.exp(rng.uniform(np.log(2 << 10), np.log(1 << 20),
                               N_NEEDLES)).astype(int)
    return [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in sizes]


def _holdings(cluster, vid: int) -> dict:
    """Every shard file of `vid` on disk across the cluster, by shard
    id, with the .ecx/.vif bodies and .ecc CRCs of each holder."""
    out = {"shards": {}, "ecx": set(), "vif": set(), "ecc": {}}
    for vs in cluster.servers:
        d = vs.store.locations[0].directory
        for path in glob.glob(os.path.join(d, f"{vid}.ec[0-9][0-9]")):
            sid = int(path[-2:])
            assert sid not in out["shards"], f"shard {sid} held twice"
            out["shards"][sid] = open(path, "rb").read()
        base = os.path.join(d, str(vid))
        if os.path.exists(base + ".ecx"):
            out["ecx"].add(open(base + ".ecx", "rb").read())
            out["vif"].add(open(base + ".vif", "rb").read())
            with open(base + ".ecc") as f:
                for sid, crcs in json.load(f)["shards"].items():
                    if int(sid) in out["shards"]:
                        out["ecc"][int(sid)] = crcs
    return out


def _reference_encode(pkg: str, src_base: str, dst_base: str) -> dict:
    """The package's single-volume write_ec_files of a copy of the .dat."""
    for ext in (".dat", ".idx"):
        with open(src_base + ext, "rb") as f, open(dst_base + ext, "wb") as g:
            g.write(f.read())
    encoder = mod(pkg, "ec.encoder")
    encoder.write_ec_files(dst_base,
                           **({"device": "cpu"} if pkg == PORT else {}))
    encoder.write_sorted_file_from_idx(dst_base)
    with open(dst_base + ".ecc") as f:
        ecc = {int(s): c for s, c in json.load(f)["shards"].items()}
    return {"shards": {s: open(dst_base + f".ec{s:02d}", "rb").read()
                       for s in range(14)},
            "ecx": open(dst_base + ".ecx", "rb").read(), "ecc": ecc}


def _scenario(pkg: str, root) -> dict:
    random.seed(SEED)
    cluster = LiveCluster(pkg, root / pkg,
                          master_kw={"volume_size_limit_mb": 16})
    try:
        rpc = cluster.rpc
        client = cluster.client()
        rpc.call_json(f"{cluster.url()}/vol/grow?count=2", "POST")
        fids = [(client.upload_data(p), p) for p in _needles()]
        vids = sorted({int(f.split(",")[0]) for f, _ in fids})
        assert len(vids) == 2, vids
        expected = {}
        for vid in vids:
            holder = cluster.server(client.lookup(vid)[0]["url"])
            v = holder.store.find_volume(vid)
            v.sync()
            expected[vid] = _reference_encode(
                pkg, v.file_name(), str(root / f"{pkg}-golden-{vid}"))

        env = cluster.env()
        cluster.run(env, "lock")
        out = cluster.run(env, "ec.encode -volumeId "
                          + ",".join(map(str, vids)) + " -batch")
        for vid in vids:
            assert f"volume {vid} -> ec shards" in out, out
        cluster.freshen()
        for vid in vids:
            assert sorted(env.ec_shard_locations(vid)) == list(range(14))
        for fid, payload in fids:
            assert bytes(client.download(fid)) == payload
        encoded = {vid: _holdings(cluster, vid) for vid in vids}

        for vid in vids:
            locs = env.ec_shard_locations(vid)
            for sid in (1, 12):
                rpc.call_json(f"http://{locs[sid][0]}/admin/ec/delete_shards",
                              "POST", {"volume": vid, "shards": [sid]})
        cluster.freshen()
        out = cluster.run(env, "ec.rebuild -batch")
        for vid in vids:
            assert f"volume {vid}: rebuilt shards [1, 12]" in out, out
        cluster.freshen()
        for vid in vids:
            assert sorted(env.ec_shard_locations(vid)) == list(range(14))
        for fid, payload in fids:
            assert bytes(client.download(fid)) == payload
        rebuilt = {vid: _holdings(cluster, vid) for vid in vids}
        return {"fids": [f for f, _ in fids], "expected": expected,
                "encoded": encoded, "rebuilt": rebuilt}
    finally:
        cluster.stop()


def test_cluster_ec_gate_matches_reference(tmp_path, monkeypatch):
    pin_clocks(monkeypatch)
    runs = {pkg: _scenario(pkg, tmp_path) for pkg in PACKAGES}
    ref, port = runs[PACKAGES[0]], runs[PORT]
    assert port["fids"] == ref["fids"]
    for run in (ref, port):
        for vid, golden in run["expected"].items():
            for stage in ("encoded", "rebuilt"):
                got = run[stage][vid]
                assert got["shards"] == golden["shards"], (stage, vid)
                assert got["ecx"] == {golden["ecx"]}, (stage, vid)
                assert got["ecc"] == golden["ecc"], (stage, vid)
                assert len(got["vif"]) == 1, (stage, vid)
    for stage in ("expected", "encoded", "rebuilt"):
        assert port[stage] == ref[stage], stage
