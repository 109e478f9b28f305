"""A master's volume growth after its pooled connections to a volume
server went stale, in both packages.

A volume server stops while this process still pools connections to
its port, and a new one starts on that port and registers (a restarted
server, or a test server given a port an earlier server of the process
used).  The master's first `POST /admin/assign_volume` to it pops the
dead connections.  In the reference it raises
`ConnectionResetError`, the grow swallows the failure (`volume_growth
.grow_by_type`, the master's `_grow_n`) and the volume id is spent: an
explicit grow answers `{"count": 0}`, the next assign grows seven
volumes from id 2 and writes land on any of them, and a grow that finds
no other slot answers 406 "no free volumes and cannot grow".  The port
drops the dead connections and grows volume 1."""

from __future__ import annotations

import threading

import pytest

from _torch_cluster import (PACKAGES, LiveCluster,  # noqa: F401
                            hermetic_port_state, mod)

pytestmark = pytest.mark.torch

STALE = 4  # connections left pooled to the stopped server


def _stale_pool(pkg: str) -> int:
    """A server of `pkg` on a free port that leaves STALE connections in
    this process's pool, stopped; returns its port."""
    rpc = mod(pkg, "cluster.rpc")
    srv = rpc.JsonHttpServer()
    barrier = threading.Barrier(STALE, timeout=10)

    def hold(_query, _body):
        barrier.wait()  # STALE calls at once ride STALE connections
        return {}

    srv.route("GET", "/hold", hold)
    srv.start()
    try:
        threads = [threading.Thread(
            target=rpc.call, args=(srv.url() + "/hold",))
            for _ in range(STALE)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(rpc._pool._idle[("http", srv.host, srv.port)]) >= STALE
    finally:
        srv.stop()
    return srv.port


@pytest.mark.parametrize("pkg", PACKAGES)
def test_grow_after_a_volume_server_restarted_on_its_port(pkg, tmp_path):
    port = _stale_pool(pkg)
    cluster = LiveCluster(pkg, tmp_path, n=0)
    try:
        cluster.add_server(port=port)
        rpc = cluster.rpc
        assert rpc.call(f"{cluster.url()}/dir/status")
        grown = rpc.call(f"{cluster.url()}/vol/grow?count=1&collection=g",
                         "POST")
        fid = cluster.client().upload_data(b"x" * 100, collection="g")
        vid = int(fid.split(",")[0])
        if pkg == "seaweedfs_tpu":
            assert grown == {"count": 0}
            assert 2 <= vid <= 8
        else:
            assert grown == {"count": 1}
            assert vid == 1
    finally:
        cluster.stop()
