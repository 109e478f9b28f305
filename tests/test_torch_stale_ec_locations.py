"""A degraded read through a volume server whose cached EC shard map
predates a rebuild, in both packages.

An LRC volume of 14 needles (7 MiB, the volume's collection's only
volume) spread over three servers loses shards 1 and 6 (one per
local group); every server reads every needle, which caches a 12-shard
map on each (trusted for 7 minutes).  `ec.rebuild` puts 1 and 6 back,
then shards 4, 9, 12 and 13 are lost, and the master hears of both
through full beats, while the servers keep their maps.  A read through
a server that holds neither rebuilt shard must solve each interval on
a lost shard.  Its cached map still lacks 1 and 6 and still names the
old holders of 4, 9, 12 and 13: eight intervals are reachable through
it, not enough.  The JAX package answers 500 (and drops the map, so a
later read succeeds); the port asks the master once for a fresh map,
finds 1 and 6 where the rebuild put them, and answers every read.
"""

from __future__ import annotations

import pytest

from _torch_cluster import (PACKAGES, PORT, LiveCluster,  # noqa: F401
                            cluster_deadline, hermetic_port_state, mod)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]


def _beat(cluster) -> None:
    for vs in cluster.servers:
        vs._send_heartbeat(full=True)


def scenario(pkg: str, root) -> dict:
    cluster = LiveCluster(pkg, root / pkg)
    try:
        rpc = cluster.rpc
        client = cluster.client()
        # One volume of its own collection takes every needle: with the
        # default layout's seven volumes, the process's `random` state
        # decides how many land in the encoded one, and one needle can
        # sit where no shard is lost.
        rpc.call_json(f"{cluster.url()}/vol/grow?count=1&collection=stale",
                      "POST")
        payloads = {}
        for i in range(14):
            data = bytes((i * 29 + j) % 253 for j in range(512 * 1024 - i))
            payloads[client.upload_data(data, collection="stale")] = data
        vids = {int(f.split(",")[0]) for f in payloads}
        assert len(vids) == 1, vids
        vid = vids.pop()
        cluster.freshen()
        env = cluster.env()
        cluster.run(env, "lock")
        cluster.run(env, f"ec.encode -volumeId {vid} -codec lrc")
        cluster.freshen()

        def drop(shards):
            for sid, urls in env.ec_shard_locations(vid).items():
                if sid in shards:
                    for url in urls:
                        rpc.call_json(
                            f"http://{url}/admin/ec/delete_shards", "POST",
                            {"volume": vid, "shards": [sid]})
            _beat(cluster)

        def read_all(vs) -> list:
            out = []
            for fid, data in payloads.items():
                status, body = rpc.call_status(f"http://{vs.url()}/{fid}")
                out.append(status if status != 200 or bytes(body) == data
                           else "differs")
            return out

        drop([1, 6])
        cluster.freshen()
        first = [read_all(vs) for vs in cluster.servers]
        cluster.run(env, f"ec.rebuild -volumeId {vid} -batch")
        _beat(cluster)
        rebuilt = env.ec_shard_locations(vid)
        drop([4, 9, 12, 13])
        reader = next(vs for vs in cluster.servers
                      if vs.url() not in rebuilt[1] + rebuilt[6])
        return {"first": first, "stale": read_all(reader),
                "again": read_all(reader)}
    finally:
        cluster.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_read_through_a_stale_ec_map_solves_in_the_port_only(pkg, tmp_path):
    out = scenario(pkg, tmp_path)
    n = len(out["again"])
    assert n == 14, out
    assert out["first"] == [[200] * n] * 3, out
    assert out["again"] == [200] * n, out
    if pkg == PORT:
        assert out["stale"] == [200] * n, out
    else:
        assert 500 in out["stale"], out
