"""The admin shell against a live in-process cluster: the cases of
tests/test_shell.py and tests/test_admin_cron.py, each run once for the
JAX package and once for the port (`pkg`).  The real command
implementations drive a master and three volume servers: the lock gate,
help, volume.list, the ec.encode → ec.balance → ec.rebuild → ec.decode
lifecycle, volume.balance/move, volume.fix.replication, the collection
commands, volumeServer.evacuate, and the master's admin-script cron
(lock/unlock around each round, failures recorded, a held lock aborts
the round, the thread fires on its interval)."""

from __future__ import annotations

import time

import pytest

from _torch_cluster import (LiveCluster, cluster_deadline,  # noqa: F401
                            hermetic_port_state, mod, pkg)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]


@pytest.fixture
def cluster(pkg, tmp_path):
    c = LiveCluster(pkg, tmp_path)
    yield c
    c.stop()


@pytest.fixture
def env(cluster):
    return cluster.env()


def _upload_some(cluster, n=20):
    """(client, vid, [(payload, fid), ...]) for one volume."""
    client = cluster.client()
    pairs = [(f"shell-payload-{i}".encode(),
              client.upload_data(f"shell-payload-{i}".encode()))
             for i in range(n)]
    vid = int(pairs[0][1].split(",")[0])
    return client, vid, [(p, f) for p, f in pairs
                         if int(f.split(",")[0]) == vid]


def test_lock_required(cluster, env):
    with pytest.raises(mod(cluster.pkg, "shell").ShellError, match="lock"):
        cluster.run(env, "ec.encode -volumeId 1")


def test_help_lists_commands(cluster, env):
    out = cluster.run(env, "help")
    for name in ("ec.encode", "ec.rebuild", "ec.balance", "ec.decode",
                 "volume.balance", "volume.fix.replication", "lock"):
        assert name in out


def test_volume_list(cluster, env):
    _client, vid, _fids = _upload_some(cluster)
    cluster.freshen()
    out = cluster.run(env, "volume.list")
    assert f"volume id:{vid}" in out
    assert "DataNode" in out


def test_ec_encode_balance_rebuild_decode_lifecycle(cluster, env):
    rpc, servers = cluster.rpc, cluster.servers
    client, vid, fids = _upload_some(cluster)
    cluster.freshen()
    cluster.run(env, "lock")
    out = cluster.run(env, f"ec.encode -volumeId {vid}")
    assert f"volume {vid}" in out
    cluster.freshen()
    assert sorted(env.ec_shard_locations(vid)) == list(range(14))
    for vs in servers:
        assert vs.store.find_volume(vid) is None
    for payload, fid in fids[:3]:
        assert bytes(rpc.call(f"http://{servers[0].url()}/{fid}")) == payload

    cluster.run(env, "ec.balance")
    cluster.freshen()
    counts = {vs.url(): 0 for vs in servers}
    for sid, urls in env.ec_shard_locations(vid).items():
        assert len(urls) == 1, f"shard {sid} duplicated"
        counts[urls[0]] += 1
    assert max(counts.values()) - min(counts.values()) <= 1

    victim = servers[0]
    have = sorted(sid for sid, urls in env.ec_shard_locations(vid).items()
                  if victim.url() in urls)
    rpc.call_json(f"http://{victim.url()}/admin/ec/delete_shards", "POST",
                  {"volume": vid, "shards": have[:2]})
    cluster.freshen()
    assert len(env.ec_shard_locations(vid)) == 12
    assert "rebuilt" in cluster.run(env, f"ec.rebuild -volumeId {vid}")
    cluster.freshen()
    assert sorted(env.ec_shard_locations(vid)) == list(range(14))

    assert "decoded" in cluster.run(env, f"ec.decode -volumeId {vid}")
    cluster.freshen()
    assert env.ec_shard_locations(vid) == {}
    assert len(env.volume_locations(vid)) == 1
    client.cache.forget(vid)
    for payload, fid in fids:
        assert client.download(fid) == payload


def test_volume_balance_and_move(cluster, env):
    client = cluster.client()
    cluster.rpc.call_json(f"{cluster.url()}/vol/grow?count=6", payload={})
    cluster.freshen()
    cluster.run(env, "lock")
    cluster.run(env, "volume.balance")
    cluster.freshen()
    counts = [len(n["volumes"]) for n in env.data_nodes()]
    assert max(counts) - min(counts) <= 1

    fid = client.upload_data(b"move-me")
    vid = int(fid.split(",")[0])
    src = env.volume_locations(vid)[0]
    dst = next(n["url"] for n in env.data_nodes() if n["url"] != src)
    cluster.run(env, f"volume.move -volumeId {vid} -source {src} "
                     f"-target {dst}")
    cluster.freshen()
    client.cache.forget(vid)
    assert client.download(fid) == b"move-me"
    assert dst in env.volume_locations(vid)
    assert src not in env.volume_locations(vid)


def test_volume_fix_replication(cluster, env):
    client = cluster.client()
    a = client.assign(replication="001")
    fid = a["fid"]
    cluster.rpc.call(f"http://{a['url']}/{fid}", "POST", b"replicated-data")
    vid = int(fid.split(",")[0])
    cluster.freshen()
    locs = env.volume_locations(vid)
    assert len(locs) == 2
    env.vs_call(locs[1], "/admin/delete_volume", {"volume": vid})
    cluster.freshen()
    assert len(env.volume_locations(vid)) == 1
    cluster.run(env, "lock")
    assert f"volume {vid}" in cluster.run(env, "volume.fix.replication")
    cluster.freshen()
    assert len(env.volume_locations(vid)) == 2


def test_collection_commands(cluster, env):
    cluster.client().upload_data(b"x", collection="photos")
    cluster.freshen()
    assert "photos" in cluster.run(env, "collection.list")
    cluster.run(env, "lock")
    assert "photos" in cluster.run(env,
                                   "collection.delete -collection photos")


def test_evacuate(cluster, env):
    client, vid, fids = _upload_some(cluster, n=5)
    cluster.freshen()
    node = env.volume_locations(vid)[0]
    cluster.run(env, "lock")
    assert "->" in cluster.run(env, f"volumeServer.evacuate -node {node}")
    cluster.freshen()
    assert node not in env.volume_locations(vid)
    client.cache.forget(vid)
    payload, fid = fids[0]
    assert client.download(fid) == payload


# -- the master's admin-script cron (tests/test_admin_cron.py) ---------------

@pytest.fixture
def cron(pkg, tmp_path):
    c = LiveCluster(pkg, tmp_path, n=1, master_kw={
        "admin_scripts": "volume.list\nec.encode -volumeId={vid}",
        "admin_script_interval": 3600})  # fired by hand
    yield c
    c.stop()


def test_cron_round_runs_scripts_with_lock(cron):
    master = cron.master
    client = cron.client()
    fid = client.upload_data(b"cron-me")
    vid = int(fid.split(",")[0])
    master.admin_scripts = ["volume.list", f"ec.encode -volumeId={vid} -force"]
    runs = master.run_admin_scripts()
    lines = [line for _ts, line, _ok, _out in runs]
    assert lines[0] == "lock" and lines[-1] == "unlock"
    assert all(ok for _ts, line, ok, out in runs), runs
    cron.freshen()
    locs = cron.rpc.call(f"{master.url()}/dir/lookup?volumeId={vid}")
    assert len(locs.get("ecShards", {})) == 14
    assert bytes(client.download(fid)) == b"cron-me"
    assert master.admin_script_runs


def test_cron_records_failures_and_continues(cron):
    cron.master.admin_scripts = ["definitely.not.a.command", "volume.list"]
    by_line = {line: ok for _ts, line, ok, _out
               in cron.master.run_admin_scripts()}
    assert by_line["definitely.not.a.command"] is False
    assert by_line["volume.list"] is True


def test_cron_aborts_round_when_lock_held(cron):
    """An operator holding the exclusive lease stops the whole round."""
    operator = cron.env()
    cron.run(operator, "lock")
    cron.master.admin_scripts = ["volume.list"]
    runs = cron.master.run_admin_scripts()
    assert [line for _ts, line, _ok, _out in runs] == ["lock"]
    assert runs[0][2] is False
    cron.run(operator, "unlock")
    runs = cron.master.run_admin_scripts()
    assert [line for _ts, line, ok, _out in runs if ok][:2] == \
        ["lock", "volume.list"]


def test_cron_thread_fires_on_interval(pkg, tmp_path):
    master = mod(pkg, "cluster.master").MasterServer(
        meta_dir=str(tmp_path), admin_scripts="volume.list",
        admin_script_interval=0.2)
    master.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not master.admin_script_runs:
            time.sleep(0.1)
        assert any(line == "volume.list" and ok
                   for _ts, line, ok, _out in master.admin_script_runs)
    finally:
        master.stop()
