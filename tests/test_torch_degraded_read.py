"""The degraded read across nodes, RS and LRC, held between packages.

Each package encodes one volume on its holder (`/admin/ec/generate`
with the codec), spreads the shards so that node A holds shard 0 alone,
node B shards 1-6 and node C shards 7-13, and stops node A.  A read of
the first needle (whose one interval lies in shard 0) through node B
then finds shard 0 neither locally nor on its stopped holder and
reconstructs it from the codec's planned survivors: RS reads ten, LRC
the five other members of shard 0's local group.  Both packages must
answer the same bytes, count the same `ec_repair_read_bytes_total`,
reach the same `ec.repair.local` events (LRC only), and observe the
`reconstruct_device` and `host_staging` stages once per reconstruct.
"""

from __future__ import annotations

import random

import pytest

from _torch_cluster import (PACKAGES, LiveCluster,  # noqa: F401
                            cluster_deadline, hermetic_port_state, mod)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]

PLACEMENT = ([0], [1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12, 13])


def _scenario(pkg: str, root, codec: str, monkeypatch) -> dict:
    random.seed(0)  # the master's volume picks and cookies
    cluster = LiveCluster(pkg, root / pkg)
    try:
        rpc = cluster.rpc
        client = cluster.client()
        fids = [(client.upload_data(bytes([i]) * (3000 + 97 * i)), i)
                for i in range(12)]
        vid = int(fids[0][0].split(",")[0])
        src = client.lookup(vid)[0]["url"]
        rpc.call_json(f"http://{src}/admin/ec/generate", "POST",
                      {"volume": vid, "codec": codec})
        for vs, shards in zip(cluster.servers, PLACEMENT):
            if vs.url() != src:
                rpc.call_json(f"http://{vs.url()}/admin/ec/copy_shard",
                              "POST", {"volume": vid, "source": src,
                                       "shards": shards, "copy_ecx": True})
        for vs, shards in zip(cluster.servers, PLACEMENT):
            rpc.call_json(f"http://{vs.url()}/admin/ec/mount", "POST",
                          {"volume": vid})
            rpc.call_json(f"http://{vs.url()}/admin/ec/delete_shards",
                          "POST", {"volume": vid, "shards": [
                              s for s in range(14) if s not in shards]})
        rpc.call_json(f"http://{src}/admin/delete_volume", "POST",
                      {"volume": vid})
        cluster.freshen()
        cluster.servers[0].stop()

        counter = mod(pkg, "stats.metrics").ec_repair_read_bytes_total
        before = counter.value(codec=codec)
        journal = mod(pkg, "events").JOURNAL
        seq = journal._seq
        vs_mod = mod(pkg, "cluster.volume_server")
        stages: list[str] = []
        real = vs_mod.observe_ec_stage

        def observe(stage, seconds, nbytes=0):
            stages.append(stage)
            real(stage, seconds, nbytes)

        monkeypatch.setattr(vs_mod, "observe_ec_stage", observe)
        fid, i = fids[0]
        data = bytes(rpc.call(f"http://{cluster.servers[1].url()}/{fid}"))
        monkeypatch.setattr(vs_mod, "observe_ec_stage", real)
        assert data == bytes([i]) * (3000 + 97 * i)
        local = [{k: e["attrs"][k] for k in ("vid", "shard", "codec",
                                             "reads", "bytes")}
                 for e in journal.snapshot(type_="ec.repair.local")
                 if e["seq"] > seq]
        return {"data": data, "gathered": counter.value(codec=codec) - before,
                "local": local,
                "stages": {s: stages.count(s) for s in
                           ("shard_gather", "reconstruct_device",
                            "host_staging")}}
    finally:
        cluster.stop()


@pytest.mark.parametrize("codec,reads", [("rs", 10), ("lrc", 5)])
def test_degraded_read_across_nodes(codec, reads, tmp_path, monkeypatch):
    runs = [_scenario(pkg, tmp_path, codec, monkeypatch) for pkg in PACKAGES]
    assert runs[1] == runs[0]
    run = runs[1]
    # One reconstruct: each stage observed once.
    assert run["stages"] == {"shard_gather": 1, "reconstruct_device": 1,
                             "host_staging": 1}
    assert run["gathered"] > 0 and run["gathered"] % reads == 0
    if codec == "lrc":
        assert [e["reads"] for e in run["local"]] == [5]
        assert run["local"][0]["shard"] == 0
    else:
        assert run["local"] == []
