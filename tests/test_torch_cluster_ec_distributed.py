"""Distributed EC reads with shards spread so that no server holds a
full set: the cases of tests/test_cluster_ec_distributed.py and
tests/test_ec_degraded_parallel.py, each run once for the JAX package
and once for the port (`pkg`).  Remote shard reads, the locate-only
HEAD, reconstruction across servers, too many shards lost, a gzip
needle through the EC ladder, the tiered location-cache freshness, the
parallel fan-out of a degraded read, and the location map dropped after
a failed reconstruction."""

from __future__ import annotations

import gzip
import time

import pytest

from _torch_cluster import (LiveCluster, cluster_deadline,  # noqa: F401
                            hermetic_port_state, mod, pkg)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]

DELAY = 0.4


@pytest.fixture
def cluster(pkg, tmp_path):
    c = LiveCluster(pkg, tmp_path)
    yield c
    c.stop()


def _spread(cluster):
    """Upload objects, EC-encode, spread shards 5/5/4, drop originals."""
    rpc, servers = cluster.rpc, cluster.servers
    client = cluster.client()
    fid0 = client.upload_data(b"payload-zero")
    vid = int(fid0.split(",")[0])
    fids = [fid0] + [client.upload_data(f"payload-{i}".encode())
                     for i in range(1, 25)]
    fids = [f for f in fids if int(f.split(",")[0]) == vid]
    src = client.lookup(vid)[0]["url"]
    rpc.call_json(f"http://{src}/admin/ec/generate", "POST", {"volume": vid})
    spread = {servers[0].url(): [0, 1, 2, 3, 4],
              servers[1].url(): [5, 6, 7, 8, 9],
              servers[2].url(): [10, 11, 12, 13]}
    for url, shards in spread.items():
        if url != src:
            rpc.call_json(f"http://{url}/admin/ec/copy_shard", "POST",
                          {"volume": vid, "source": src, "shards": shards,
                           "copy_ecx": True})
    for url, shards in spread.items():
        rpc.call_json(f"http://{url}/admin/ec/mount", "POST",
                      {"volume": vid})
        rpc.call_json(f"http://{url}/admin/ec/delete_shards", "POST",
                      {"volume": vid,
                       "shards": [s for s in range(14) if s not in shards]})
    rpc.call_json(f"http://{src}/admin/delete_volume", "POST",
                  {"volume": vid})
    cluster.freshen()
    return vid, fids


def _lose(cluster, vid, shards):
    cluster.rpc.call_json(
        f"http://{cluster.servers[0].url()}/admin/ec/delete_shards", "POST",
        {"volume": vid, "shards": shards})
    cluster.freshen()


def test_remote_shard_reads(cluster):
    vid, fids = _spread(cluster)
    for vs in cluster.servers:
        for fid in fids[:5]:
            data = bytes(cluster.rpc.call(f"http://{vs.url()}/{fid}"))
            if fid == fids[0]:
                assert data == b"payload-zero"
            else:
                assert data.startswith(b"payload-")


def test_head_on_ec_volume_checks_existence(cluster):
    """HEAD on an EC volume is a locate-only probe: 200 for a live
    needle, 404 for an absent key."""
    vid, fids = _spread(cluster)
    url = cluster.servers[0].url()
    assert cluster.rpc.call(f"http://{url}/{fids[0]}", "HEAD") is not None
    cookie = fids[0].split(",")[1][-8:]
    with pytest.raises(cluster.rpc.RpcError) as ei:
        cluster.rpc.call(f"http://{url}/{vid},deadbeef{cookie}", "HEAD")
    assert ei.value.status == 404


def test_reconstruction_across_servers(cluster):
    vid, fids = _spread(cluster)
    _lose(cluster, vid, [0, 1, 2, 3])  # 10 shards stay reachable
    for vs in (cluster.servers[0], cluster.servers[2]):
        data = cluster.rpc.call(f"http://{vs.url()}/{fids[0]}")
        assert bytes(data) == b"payload-zero"


def test_too_many_lost_cluster_wide(cluster):
    vid, fids = _spread(cluster)
    _lose(cluster, vid, [0, 1, 2, 3, 4])  # only 9 survive
    with pytest.raises(cluster.rpc.RpcError):
        cluster.rpc.call(f"http://{cluster.servers[1].url()}/{fids[0]}")


def test_gzip_needle_through_ec_path(cluster):
    """A gzip-stored needle read from shards decompresses for plain
    readers and passes through for gzip-accepting ones."""
    rpc = cluster.rpc
    client = cluster.client()
    text = b"compress me through erasure coding\n" * 100
    r = client.upload(text, name="doc.txt")
    assert r["is_compressed"]
    vid = int(r["fid"].split(",")[0])
    src = client.lookup(vid)[0]["url"]
    for path in ("generate", "mount"):
        rpc.call_json(f"http://{src}/admin/ec/{path}", "POST",
                      {"volume": vid})
    rpc.call_json(f"http://{src}/admin/delete_volume", "POST",
                  {"volume": vid})
    cluster.freshen()
    assert rpc.call(f"http://{src}/{r['fid']}") == text
    resp, conn = rpc._request(f"http://{src}/{r['fid']}", "GET", None, 10.0,
                              req_headers={"Accept-Encoding": "gzip"})
    raw = resp.read()
    rpc._finish(conn, resp)
    assert resp.getheader("content-encoding") == "gzip"
    assert gzip.decompress(raw) == text


def test_loc_ttl_tiers(pkg):
    vs = mod(pkg, "cluster.volume_server").VolumeServer
    urls = ["h1:1"]
    assert vs._loc_ttl({s: urls for s in range(9)}) == 11.0
    assert vs._loc_ttl({s: urls for s in range(12)}) == 7 * 60.0
    assert vs._loc_ttl({s: urls for s in range(14)}) == 37 * 60.0
    assert vs._loc_ttl({}) == 11.0


def test_degraded_read_latency_is_one_fetch(cluster, monkeypatch):
    """A degraded read gathers its survivors in parallel: the wall is
    near one fetch delay, far below their serial sum."""
    vid, fids = _spread(cluster)
    _lose(cluster, vid, [0, 1, 2, 3])
    rpc = cluster.rpc
    real_call = rpc.call
    fetches = []

    def slow_call(url, *args, **kwargs):
        if "/admin/ec/shard_read" in url:
            fetches.append(url)
            time.sleep(DELAY)
        return real_call(url, *args, **kwargs)

    monkeypatch.setattr(rpc, "call", slow_call)
    t0 = time.monotonic()
    data = rpc.call(f"http://{cluster.servers[2].url()}/{fids[0]}")
    elapsed = time.monotonic() - t0
    assert bytes(data) == b"payload-zero"
    assert len(fetches) >= 5, fetches
    serial_floor = len(fetches) * DELAY
    assert elapsed < min(serial_floor * 0.6, serial_floor - 2 * DELAY), (
        f"degraded read took {elapsed:.2f}s for {len(fetches)} remote "
        f"fetches (serial would be >= {serial_floor:.2f}s)")


def test_failed_reconstruction_drops_location_cache(cluster):
    vid, fids = _spread(cluster)
    _lose(cluster, vid, [0, 1, 2, 3, 4])
    with pytest.raises(cluster.rpc.RpcError):
        cluster.rpc.call(f"http://{cluster.servers[1].url()}/{fids[0]}")
    assert vid not in cluster.servers[1]._ec_loc_cache
