"""The in-process cluster cases of tests/test_cluster.py, each run once
for the JAX package and once for the port (`pkg`): a master and three
volume servers on two racks, driven through the package's own client —
upload/download/delete, spread over volumes, replicated writes and
their failover, unknown lookups, the topology the heartbeats build,
vacuum, collections, the EC admin lifecycle and the all-or-fail
replication fan-out."""

from __future__ import annotations

import pytest

from _torch_cluster import (LiveCluster, cluster_deadline,  # noqa: F401
                            hermetic_port_state, pkg)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]


@pytest.fixture
def cluster(pkg, tmp_path):
    c = LiveCluster(pkg, tmp_path, racks=["rack0", "rack1", "rack0"])
    yield c
    c.stop()


def test_upload_download_delete(cluster):
    client = cluster.client()
    fid = client.upload_data(b"hello cluster", name="greeting.txt")
    assert "," in fid
    assert client.download(fid) == b"hello cluster"
    client.delete(fid)
    with pytest.raises(cluster.rpc.RpcError) as ei:
        client.download(fid)
    assert ei.value.status == 404


def test_many_uploads_spread(cluster):
    client = cluster.client()
    fids = [client.upload_data(f"obj-{i}".encode()) for i in range(50)]
    assert len({f.split(",")[0] for f in fids}) > 1  # multiple volumes
    for i, fid in enumerate(fids):
        assert client.download(fid) == f"obj-{i}".encode()


def test_replicated_write_and_failover(cluster):
    client = cluster.client()
    fid = client.upload_data(b"replicated!", replication="001")
    vid = int(fid.split(",")[0])
    locs = client.lookup(vid)
    assert len(locs) == 2
    for loc in locs:
        out = cluster.rpc.call(f"http://{loc['url']}/{fid}")
        assert bytes(out) == b"replicated!"
    # Kill the first replica server; the read fails over to the other.
    cluster.server(locs[0]["url"]).stop()
    client.cache._m.clear()
    assert client.download(fid) == b"replicated!"


def test_lookup_unknown_volume(cluster):
    with pytest.raises(cluster.rpc.RpcError) as ei:
        cluster.rpc.call(f"{cluster.url()}/dir/lookup?volumeId=999")
    assert ei.value.status == 404


def test_heartbeat_registers_topology(cluster):
    status = cluster.rpc.call(f"{cluster.url()}/dir/status")
    dc = status["topology"]["children"][0]
    assert {r["id"] for r in dc["children"]} == {"rack0", "rack1"}
    assert sum(len(r["children"]) for r in dc["children"]) == 3


def test_vacuum_via_master(cluster):
    client = cluster.client()
    fids = [client.upload_data(b"x" * 2000) for _ in range(30)]
    for fid in fids[:20]:
        client.delete(fid)
    out = cluster.rpc.call_json(
        f"{cluster.url()}/vol/vacuum?garbageThreshold=0.1", "POST", {})
    assert out["vacuumed"]
    for fid in fids[20:]:
        assert client.download(fid) == b"x" * 2000


def test_collection_lifecycle(cluster):
    client = cluster.client()
    fid = client.upload_data(b"in-collection", collection="photos")
    assert client.download(fid) == b"in-collection"
    cols = cluster.rpc.call(f"{cluster.url()}/col/list")
    assert "photos" in cols["collections"]
    cluster.rpc.call_json(f"{cluster.url()}/col/delete?collection=photos",
                          "POST", {})
    cols = cluster.rpc.call(f"{cluster.url()}/col/list")
    assert "photos" not in cols["collections"]


def test_ec_lifecycle_over_cluster(cluster):
    """Generate shards, spread four of them, mount, read back through
    the EC path, survive shard deletion."""
    rpc = cluster.rpc
    client = cluster.client()
    fid = client.upload_data(b"ec-payload-0")
    vid = int(fid.split(",")[0])
    fids = [fid] + [client.upload_data(f"ec-payload-{i}".encode())
                    for i in range(1, 20)]
    fids = [f for f in fids if int(f.split(",")[0]) == vid]
    src = client.lookup(vid)[0]["url"]
    rpc.call_json(f"http://{src}/admin/ec/generate", "POST",
                  {"volume": vid})
    dst = next(vs.url() for vs in cluster.servers if vs.url() != src)
    rpc.call_json(f"http://{dst}/admin/ec/copy_shard", "POST",
                  {"volume": vid, "source": src,
                   "shards": [10, 11, 12, 13], "copy_ecx": True})
    rpc.call_json(f"http://{src}/admin/ec/mount", "POST", {"volume": vid})
    out = rpc.call_json(f"http://{dst}/admin/ec/mount", "POST",
                        {"volume": vid})
    assert out["shards"] == [10, 11, 12, 13]
    rpc.call_json(f"http://{src}/admin/delete_volume", "POST",
                  {"volume": vid})
    for f in fids:
        assert bytes(rpc.call(f"http://{src}/{f}")).startswith(
            b"ec-payload-")
    assert bytes(rpc.call(f"http://{src}/{fids[0]}")) == b"ec-payload-0"
    # The source loses its parity copies: reads still decode locally.
    rpc.call_json(f"http://{src}/admin/ec/delete_shards", "POST",
                  {"volume": vid, "shards": [10, 11, 12, 13]})
    assert bytes(rpc.call(f"http://{src}/{fids[0]}")) == b"ec-payload-0"
    lookup = rpc.call(f"{cluster.url()}/dir/lookup?volumeId={vid}")
    assert "ecShards" in lookup


def test_replicated_write_fails_when_sibling_down(cluster):
    """All-or-fail fan-out (store_replicate.go): a write to a replicated
    volume errors when a sibling replica is down."""
    client = cluster.client()
    fid = client.upload_data(b"seed", replication="001")
    vid = int(fid.split(",")[0])
    locs = client.lookup(vid)
    assert len(locs) == 2
    cluster.server(locs[1]["url"]).stop()
    with pytest.raises(cluster.rpc.RpcError) as ei:
        cluster.rpc.call(f"http://{locs[0]['url']}/{vid},777700000001",
                         "POST", b"must not half-land")
    assert ei.value.status == 500
    assert "replication failed" in ei.value.message


def test_replicated_write_acked_when_master_refuses_lookup(cluster):
    """A reference fault both packages keep (ROADMAP queue 3): when the
    primary's master lookup fails, `_replicate` returns ("the local write
    stands") and a write to a `001` volume whose sibling is down is
    acknowledged with one copy.  Go's store_replicate.go fails it.  The
    sibling-down case above asks for the 500, and any failed lookup (a
    refusal, a timeout, two dead pooled connections to the master in
    the reference's client) turns it into this acknowledgement."""
    client = cluster.client()
    fid = client.upload_data(b"seed", replication="001")
    vid = int(fid.split(",")[0])
    locs = client.lookup(vid)
    primary = cluster.server(locs[0]["url"])
    cluster.server(locs[1]["url"]).stop()
    primary._vol_loc_cache.clear()

    def refuse(query, body):
        raise cluster.rpc.RpcError(503, "lookup refused")

    cluster.master.server.route("GET", "/dir/lookup", refuse)
    late = f"{vid},777700000001"
    out = cluster.rpc.call(f"http://{primary.url()}/{late}", "POST",
                           b"acked with one copy")
    assert out["size"] > 0
    assert bytes(cluster.rpc.call(f"http://{primary.url()}/{late}")) \
        == b"acked with one copy"


def test_replicated_write_acked_once_while_sibling_drained(cluster):
    """The same fault when the master answers: a drained sibling's
    goodbye unregisters it, the primary's lookup then lists the primary
    alone, and a write to the `001` volume is acknowledged with one
    copy, which the sibling never gets.  Both packages keep it (ROADMAP
    queue 3); store_replicate.go refuses a write with fewer locations
    than the placement's copies.  In the rolling restart of
    tests/test_overload.py such a needle has no replica left to read
    while its one holder restarts."""
    client = cluster.client()
    fid = client.upload_data(b"seed", replication="001")
    vid = int(fid.split(",")[0])
    locs = client.lookup(vid)
    primary = cluster.server(locs[0]["url"])
    sibling = cluster.server(locs[1]["url"])
    sibling.drain(grace=0)
    primary._vol_loc_cache.clear()
    late = f"{vid},777700000001"
    out = cluster.rpc.call(f"http://{primary.url()}/{late}", "POST",
                           b"acked with one copy")
    assert out["size"] > 0
    lookup = cluster.rpc.call(f"{cluster.url()}/dir/lookup?volumeId={vid}")
    assert [loc["url"] for loc in lookup["locations"]] == [primary.url()]
    with pytest.raises(cluster.rpc.RpcError) as ei:
        cluster.rpc.call(f"http://{sibling.url()}/{late}")
    assert ei.value.status == 404
