"""The batched EC paths over a live cluster: the cases of
tests/test_batch_encode.py and tests/test_batch_rebuild.py, each run
once for the JAX package and once for the port (`pkg`).

`ec.encode -batch` pulls the quiet volumes' .dat/.idx from their
servers, encodes them on the volume axis, scatters the shards and .ecx,
mounts them and deletes the originals; every shard must equal the same
package's single-volume `write_ec_files` of that .dat.  `ec.rebuild
-batch` gathers survivors from their holders, rebuilds every volume's
missing shards grouped by survivor signature, and scatters them back
byte-equal to the originals — failing over dead holders, skipping
unrecoverable volumes, and saying so when there is nothing to do.  The
port's shell runs its kernels on the CPU (`CommandEnv(device="cpu")`).
"""

from __future__ import annotations

import pytest

from _torch_cluster import (PACKAGES, PORT, LiveCluster,  # noqa: F401
                            cluster_deadline, hermetic_port_state, mod, pkg)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]


@pytest.fixture
def cluster(pkg, tmp_path):
    c = LiveCluster(pkg, tmp_path)
    yield c
    c.stop()


def _fill_volumes(cluster, n_volumes=3, objs_per_volume=6,
                  tag="batch-encode"):
    client = cluster.client()
    cluster.rpc.call_json(f"{cluster.url()}/vol/grow?count={n_volumes}",
                          "POST")
    by_vid: dict[int, list] = {}
    i = 0
    while any(len(v) < objs_per_volume
              for v in by_vid.values()) or len(by_vid) < n_volumes:
        payload = f"{tag}-{i}".encode() * (i % 9 + 1)
        fid = client.upload_data(payload)
        by_vid.setdefault(int(fid.split(",")[0]), []).append((payload, fid))
        i += 1
        assert i <= 400, "volume growth failed"
    vids = sorted(by_vid)[:n_volumes]
    return client, {vid: by_vid[vid] for vid in vids}


def _shard_bytes(cluster, url, vid, sid=None, ext=None) -> bytes:
    what = f"ext={ext}" if ext else f"shard={sid}"
    return bytes(cluster.rpc.call(
        f"http://{url}/admin/ec/shard_file?volume={vid}&{what}"))


def test_batch_encode_through_shell(cluster, tmp_path):
    pkg, rpc = cluster.pkg, cluster.rpc
    client, volumes = _fill_volumes(cluster)
    vids = sorted(volumes)
    env = cluster.env()
    cluster.freshen()
    encoder = mod(pkg, "ec.encoder")
    to_ext = mod(pkg, "ec").to_ext
    kw = {"device": "cpu"} if pkg == PORT else {}
    expected: dict[int, dict[int, bytes]] = {}
    ecx: dict[int, bytes] = {}
    (tmp_path / "expected").mkdir()
    for vid in vids:
        url = env.volume_locations(vid)[0]
        base = str(tmp_path / "expected" / str(vid))
        for ext in (".dat", ".idx"):
            rpc.call_to_file(f"http://{url}/admin/volume_file?volume={vid}"
                             f"&ext={ext}", base + ext)
        encoder.write_ec_files(base, **kw)
        encoder.write_sorted_file_from_idx(base)
        expected[vid] = {s: open(base + to_ext(s), "rb").read()
                         for s in range(14)}
        ecx[vid] = open(base + ".ecx", "rb").read()

    cluster.run(env, "lock")
    out = cluster.run(env, "ec.encode -volumeId " + ",".join(map(str, vids))
                      + " -batch")
    for vid in vids:
        assert f"volume {vid} -> ec shards" in out, out
    cluster.freshen()
    for vid, pairs in volumes.items():
        assert env.volume_locations(vid) == []
        locs = env.ec_shard_locations(vid)
        assert sorted(locs) == list(range(14)), (vid, sorted(locs))
        for sid in range(14):
            assert _shard_bytes(cluster, locs[sid][0], vid, sid) == \
                expected[vid][sid], (vid, sid)
        assert _shard_bytes(cluster, locs[0][0], vid, ext=".ecx") == ecx[vid]
        for payload, fid in pairs:
            assert bytes(client.download(fid)) == payload


def test_batch_encode_skips_missing_volume(cluster):
    _client, volumes = _fill_volumes(cluster, n_volumes=1)
    vid = next(iter(volumes))
    env = cluster.env()
    cluster.freshen()
    cluster.run(env, "lock")
    out = cluster.run(env, f"ec.encode -volumeId 9999,{vid} -batch")
    assert "volume 9999: SKIPPED" in out
    assert f"volume {vid} -> ec shards" in out


SPREAD = ([0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11, 12, 13])


def _make_ec_volumes(cluster, n_volumes=3):
    """Grow volumes, upload into each, EC-encode and spread 5/5/4."""
    rpc = cluster.rpc
    client, volumes = _fill_volumes(cluster, n_volumes, tag="batch-rebuild")
    for vid in volumes:
        src = client.lookup(vid)[0]["url"]
        rpc.call_json(f"http://{src}/admin/ec/generate", "POST",
                      {"volume": vid})
        for vs, shards in zip(cluster.servers, SPREAD):
            if vs.url() != src:
                rpc.call_json(f"http://{vs.url()}/admin/ec/copy_shard",
                              "POST", {"volume": vid, "source": src,
                                       "shards": shards, "copy_ecx": True})
        for vs, shards in zip(cluster.servers, SPREAD):
            rpc.call_json(f"http://{vs.url()}/admin/ec/mount", "POST",
                          {"volume": vid})
            rpc.call_json(f"http://{vs.url()}/admin/ec/delete_shards",
                          "POST", {"volume": vid, "shards": [
                              s for s in range(14) if s not in shards]})
        rpc.call_json(f"http://{src}/admin/delete_volume", "POST",
                      {"volume": vid})
    cluster.freshen()
    return client, volumes


def _drop(cluster, env, vid, sid) -> bytes:
    """Delete shard `sid` of `vid` from its holder; return its bytes."""
    holder = env.ec_shard_locations(vid)[sid][0]
    original = _shard_bytes(cluster, holder, vid, sid)
    cluster.rpc.call_json(f"http://{holder}/admin/ec/delete_shards", "POST",
                          {"volume": vid, "shards": [sid]})
    return original


def test_batch_rebuild_through_shell(cluster):
    client, volumes = _make_ec_volumes(cluster)
    vids = sorted(volumes)
    env = cluster.env()
    # Two volumes lose the same shards (one group, V=2), the third
    # others (a second group).
    lost = {vids[0]: [0, 3], vids[1]: [0, 3], vids[2]: [12, 13]}
    originals = {(vid, sid): _drop(cluster, env, vid, sid)
                 for vid, sids in lost.items() for sid in sids}
    cluster.freshen()
    cluster.run(env, "lock")
    out = cluster.run(env, "ec.rebuild -batch")
    for vid in vids:
        assert f"volume {vid}: rebuilt shards" in out
    cluster.freshen()
    for (vid, sid), original in originals.items():
        locs = env.ec_shard_locations(vid)
        assert sorted(locs) == list(range(14))
        assert _shard_bytes(cluster, locs[sid][0], vid, sid) == original
    for pairs in volumes.values():
        for payload, fid in pairs:
            assert bytes(client.download(fid)) == payload


def test_batch_rebuild_fails_over_flaky_holders(cluster):
    """A dead first holder of every shard must not fail the batch."""
    _client, volumes = _make_ec_volumes(cluster, n_volumes=2)
    real_env = cluster.env()
    originals = {vid: _drop(cluster, real_env, vid, 1) for vid in volumes}
    cluster.freshen()

    class FlakyEnv:
        def __getattr__(self, name):
            return getattr(real_env, name)

        def ec_shard_locations(self, vid):
            return {sid: ["127.0.0.1:1"] + urls for sid, urls in
                    real_env.ec_shard_locations(vid).items()}

    rebuild = mod(cluster.pkg, "parallel.cluster_rebuild")
    mesh = real_env.mesh() if cluster.pkg == PORT else None
    out = "\n".join(rebuild.batch_rebuild(FlakyEnv(), mesh=mesh))
    assert all(f"volume {vid}: rebuilt shards" in out for vid in volumes)
    cluster.freshen()
    for vid, original in originals.items():
        locs = real_env.ec_shard_locations(vid)
        assert sorted(locs) == list(range(14))
        assert _shard_bytes(cluster, locs[1][0], vid, 1) == original


def test_fetch_shard_exhausts_holders_with_clear_error(pkg):
    rebuild = mod(pkg, "parallel.cluster_rebuild")
    with pytest.raises(mod(pkg, "cluster.rpc").RpcError) as ei:
        rebuild._fetch_shard(["127.0.0.1:1", "127.0.0.1:2"], 7, 3)
    assert "7.3 unreachable on any holder" in ei.value.message


def test_batch_rebuild_skips_unrecoverable(cluster):
    _client, volumes = _make_ec_volumes(cluster, n_volumes=1)
    vid = next(iter(volumes))
    env = cluster.env()
    for sid in range(5):  # only 9 survive
        _drop(cluster, env, vid, sid)
    cluster.freshen()
    cluster.run(env, "lock")
    out = cluster.run(env, "ec.rebuild -batch")
    assert "SKIPPED" in out and str(vid) in out


def test_batch_rebuild_nothing_to_do(cluster):
    _make_ec_volumes(cluster, n_volumes=1)
    env = cluster.env()
    cluster.run(env, "lock")
    assert cluster.run(env, "ec.rebuild -batch") == "nothing to rebuild"


def test_plan_rebuilds_groups_by_signature(cluster):
    _client, volumes = _make_ec_volumes(cluster)
    vids = sorted(volumes)
    env = cluster.env()
    for vid, sid in ((vids[0], 1), (vids[1], 1), (vids[2], 13)):
        _drop(cluster, env, vid, sid)
    cluster.freshen()
    plan = mod(cluster.pkg, "parallel.cluster_rebuild").plan_rebuilds(env)
    assert len(plan.groups) == 2
    sig_two = [vs for vs in plan.groups.values() if len(vs) == 2]
    assert len(sig_two) == 1
    assert {v for v, _ in sig_two[0]} == {vids[0], vids[1]}
    assert not plan.skipped


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_default_mesh_follows_reference(n):
    """The batch mesh of `ec.encode/ec.rebuild -batch`: byte columns on
    a "col" axis of 2 when the device count is even, volumes on "vol" —
    the reference's make_mesh, here over n CPU devices."""
    import jax
    import torch
    ref = mod(PACKAGES[0], "parallel.cluster_rebuild").make_mesh(
        jax.devices()[:n])
    port = mod(PORT, "parallel.cluster_rebuild").make_mesh(
        [torch.device("cpu")] * n)
    assert dict(port.shape) == dict(ref.shape)
    assert dict(port.shape) == {"vol": n // 2 if n % 2 == 0 else n,
                                "col": 2 if n % 2 == 0 else 1}
