"""Three reference faults that arrive with the filer and its gRPC
plane, pinned in both packages.

- `filer/abstract_sql.py` `_upsert` (reproduced in the port, for
  parity): an INSERT that fails is retried as an UPDATE only when the
  driver's message says "unique" or "duplicate".  A driver that reports
  a duplicate key by code alone fails the write outright, and an
  unrelated error whose text holds either word becomes an UPDATE.
- `cluster/client.py` `_grpc_master_call` (fixed in the port): the
  reference's master gRPC bridge flattens a follower's 503 into an
  in-message error, which the client re-raises instead of rotating to
  the next master seed.  The port's bridge answers UNAVAILABLE, and its
  client rotates as the JSON plane does on a 503.
- `cluster/client.py` `delete` and `cluster/volume_server.py`
  `_delete_needle` (fixed in the port): a needle's delete finds no
  locations once its volume is erasure-coded, and the volume server has
  no delete for an EC volume, so a file the filer deletes leaves its
  chunks live on EC volumes for good.  The port deletes through the
  shard holders, each tombstoning its own .ecx.
"""

from __future__ import annotations

import sqlite3

import pytest

from _torch_cluster import (PACKAGES, PORT, grpc_pair_port,  # noqa: F401
                            hermetic_port_state, mod)
from _torch_twin import Recorder

pytestmark = pytest.mark.torch


class _CodeOnlyDriver:
    """A DBAPI connection over sqlite whose INSERTs fail with `error`
    once `armed`, as a driver that reports by code would."""

    def __init__(self, error: Exception):
        self.db = sqlite3.connect(":memory:", check_same_thread=False)
        self.error = error
        self.armed = False

    def execute(self, sql, args=()):
        if self.armed and sql.startswith("INSERT"):
            raise self.error
        return self.db.execute(sql, args)

    def commit(self):
        self.db.commit()

    def rollback(self):
        self.db.rollback()

    def close(self):
        self.db.close()


def _upsert_outcomes(pkg: str) -> dict:
    sql = mod(pkg, "filer.abstract_sql")
    entry = mod(pkg, "filer.entry")
    out = {}
    for name, error in (
            ("duplicate_by_code", sqlite3.IntegrityError("(1062, '')")),
            ("unrelated_says_duplicate",
             sqlite3.OperationalError("duplicate packet on the wire"))):
        conn = _CodeOnlyDriver(error)
        store = sql.AbstractSqlStore(conn, sql.MysqlDialect())
        store.insert_entry(entry.Entry(
            path="/a/f", attributes=entry.Attributes(uid=1)))
        conn.armed = True
        try:
            store.insert_entry(entry.Entry(
                path="/a/f", attributes=entry.Attributes(uid=2)))
            got = ("updated", store.find_entry("/a/f").attributes.uid)
        except Exception as e:  # noqa: BLE001 — the outcome is the result
            got = ("raised", type(e).__name__, str(e))
        out[name] = got
        conn.close()
    return out


def test_sql_upsert_matches_driver_text_in_both_packages():
    """A duplicate key reported by code alone fails the write; an
    unrelated error that says "duplicate" is turned into an UPDATE; the
    same in both packages."""
    ref, port = (_upsert_outcomes(pkg) for pkg in PACKAGES)
    assert port == ref
    assert port == {
        "duplicate_by_code": ("raised", "IntegrityError", "(1062, '')"),
        "unrelated_says_duplicate": ("updated", 2)}


def _follower_then_leader(pkg: str, tmp_path) -> tuple:
    rpc = mod(pkg, "cluster.rpc")
    grpc_mod = mod(pkg, "pb.master_grpc")
    masters, planes = [], []
    answer = {"fid": "3,01637037d6", "url": "127.0.0.1:1",
              "publicUrl": "127.0.0.1:1", "count": 1}

    def follower(query, body):
        raise rpc.RpcError(503, "not the leader; redial")

    try:
        for i, handler in enumerate((follower, lambda q, b: dict(answer))):
            m = mod(pkg, "cluster.master").MasterServer(
                port=grpc_pair_port(),
                meta_dir=str(tmp_path / f"{pkg}{i}"), pulse_seconds=60)
            m._assign = handler
            m.start()
            masters.append(m)
            g = grpc_mod.MasterGrpcServer(m)
            g.start()
            planes.append(g)
        client = mod(pkg, "cluster.client").WeedClient(
            [m.url() for m in masters], use_grpc=True)
        try:
            got = ("ok", client.assign(), client.master_url
                   == masters[1].url())
        except rpc.RpcError as e:
            got = ("raised", e.status, e.message)
        client.close()
        return got
    finally:
        for g in planes:
            g.stop()
        for m in masters:
            m.stop()


def test_grpc_assign_rotates_past_a_follower_in_the_port_only(tmp_path):
    """Two master seeds over gRPC, the first answering an assign with a
    follower's 503: the JAX package's client raises the flattened error
    (status 500), the port's rotates to the second seed and returns its
    answer."""
    ref = _follower_then_leader(PACKAGES[0], tmp_path)
    port = _follower_then_leader(PORT, tmp_path)
    assert ref == ("raised", 500, "not the leader; redial")
    assert Recorder().norm(port) == Recorder().norm(
        ("ok", {"fid": "3,01637037d6", "url": "127.0.0.1:1",
                "publicUrl": "127.0.0.1:1", "count": 1}, True))


def _delete_on_ec_volume(pkg: str, root) -> dict:
    from _torch_cluster import LiveCluster
    cluster = LiveCluster(pkg, root / pkg, n=4)
    try:
        rpc = cluster.rpc
        client = cluster.client()
        by_vid: dict = {}
        payload: dict = {}
        for i in range(24):
            data = f"ec-delete-{i}".encode() * 100
            fid = client.upload_data(data)
            payload[fid] = data
            by_vid.setdefault(int(fid.split(",")[0]), []).append(fid)
        vid, fids = max(by_vid.items(), key=lambda kv: len(kv[1]))
        assert len(fids) >= 2
        env = cluster.env()
        cluster.run(env, "lock")
        assert f"volume {vid} -> ec shards" in cluster.run(
            env, f"ec.encode -volumeId {vid}")
        cluster.freshen()
        # A rebuild first: it copies a fresh .ecx onto the rebuilding
        # holder, under the index its mounted volume holds open.
        locs = env.ec_shard_locations(vid)
        for sid in (1, 12):
            rpc.call_json(f"http://{locs[sid][0]}/admin/ec/delete_shards",
                          "POST", {"volume": vid, "shards": [sid]})
        cluster.freshen()
        assert "rebuilt shards [1, 12]" in cluster.run(env, "ec.rebuild")
        cluster.freshen()
        try:
            client.delete(fids[0])
            deleted = ("ok",)
        except rpc.RpcError as e:
            deleted = ("raised", e.status, e.message)
        cluster.freshen()
        reads, on_disk = [], []
        key = mod(pkg, "core.types").parse_file_id(fids[0])[1]
        for vs in cluster.servers:  # every holder answers from its .ecx
            status, _body = rpc.call_status(f"http://{vs.url()}/{fids[0]}")
            reads.append(status)
            ecx = bytes(rpc.call(f"http://{vs.url()}/admin/ec/shard_file?"
                                 f"volume={vid}&ext=.ecx"))
            on_disk.append(any(
                e.key == key and mod(pkg, "core.types").size_is_valid(e.size)
                for e in mod(pkg, "core.idx").iter_index(ecx)))
        return {"delete": deleted, "reads": reads, "live_on_disk": on_disk,
                "sibling_reads_back": bytes(client.download(fids[-1]))
                == payload[fids[-1]]}
    finally:
        cluster.stop()


def test_filer_chunk_delete_lands_on_ec_volumes_in_the_port_only(tmp_path):
    """A needle's delete once its volume is erasure-coded and two of its
    shards rebuilt (what a filer's chunk delete does after `ec.encode`):
    the JAX package's client finds no locations and the needle stays
    readable on every holder (an orphan no fsck can clear); the port's
    deletes it through the shard holders, each of which then answers
    404 and holds the tombstone in the .ecx on its disk (the file fsck
    and later copies read), the rebuilding holder too."""
    ref = _delete_on_ec_volume(PACKAGES[0], tmp_path)
    port = _delete_on_ec_volume(PORT, tmp_path)
    assert ref["delete"][:2] == ("raised", 404)
    assert ref["reads"] == [200] * 4
    assert ref["live_on_disk"] == [True] * 4
    assert port["delete"] == ("ok",)
    assert port["reads"] == [404] * 4
    assert port["live_on_disk"] == [False] * 4
    assert port["sibling_reads_back"] and ref["sibling_reads_back"]
