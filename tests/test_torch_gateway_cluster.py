"""The gate of the gateway slice: a gateway-fronted EC cluster run by
each package in this process and held between them.

Each package brings up a master, four volume servers (volume limit
16 MB), a filer over them (256 KiB chunks, the embedded store for a
directory), an S3 gateway with an admin and a read-only identity,
WebDAV and a message broker.  From a seed, one writer puts S3 objects
through SigV4 with aws-chunked bodies (multi-chunk ones, small ones,
two CSVs and one multipart upload), WebDAV files two levels deep, and
messages to a 2-partition topic; the read-only identity's PUT must be
refused.  The broker stops (its partition tails flushed to the filer)
and the filer's chunk deletes are flushed; `volume.fsck` runs; `lock`
and `ec.encode` encode every volume that holds the namespace.  The
volume Query RPC runs on a CSV chunk of an encoded volume.  The chunk
caches are emptied and the volume server holding shard 0 of the first
volume stops; the broker starts again.  Then everything is read back
through its gateway: every S3 object, S3 Select over each CSV, every
WebDAV file, every message from offset 0 of each partition.

Held equal across the packages, and each byte to what was written:
every object, file and message (key and value; a message's stamp is
the wall clock), the Select output (also equal to Python's csv module's
answer), the ListObjectsV2 XML before and after the kill (masked:
LastModified, and the multipart ETag, which names the upload id), every
WebDAV PROPFIND listing, and `volume.fsck` before the encode.  In each
package the reads after the kill must reconstruct at least one interval.
Two places differ by reference faults the port fixes (ROADMAP queue 3):
after the encode the JAX package's `volume.fsck` reports every chunk
missing (no `locations` for an EC volume) where the port's reports none;
and the JAX package's volume Query RPC answers 404 for a needle of an
EC volume (`store.find_volume` finds only plain volumes), where the
port reads it through the EC ladder and answers the SELECT.
"""

from __future__ import annotations

import csv
import glob
import hashlib
import hmac
import io
import json
import os
import random
import re
import struct
import urllib.parse
import zlib

import numpy as np
import pytest

from _torch_cluster import (PACKAGES, PORT, LiveCluster,  # noqa: F401
                            cluster_deadline, hermetic_port_state, mod,
                            pin_clocks, seed_placement)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]

SEED = 13
CHUNK = 256 << 10
BUCKET = "gate"
ADMIN = ("AKIDGATEADMIN", "gate/admin/secret")
READER = ("AKIDGATEREADER", "gate/reader/secret")
IDENTITIES = {"identities": [
    {"name": "admin",
     "credentials": [{"accessKey": ADMIN[0], "secretKey": ADMIN[1]}],
     "actions": ["Admin", "Read", "Write", "List"]},
    {"name": "reader",
     "credentials": [{"accessKey": READER[0], "secretKey": READER[1]}],
     "actions": ["Read", "List"]}]}
FLOOR = 700
SELECT = f"SELECT id, score FROM S3Object WHERE score > {FLOOR}"
TOPIC = ("gate", "events")
PARTITIONS = 2
DAV_DIRS = ("/dav", "/dav/a", "/dav/a/b", "/dav/c")


def _data() -> dict:
    rng = np.random.default_rng(SEED)

    def blob(lo, hi):
        n = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    objects = {f"large/o{i}.bin": blob(300 << 10, 1200 << 10)
               for i in range(4)}
    objects.update({f"small/s{i:02d}.bin": blob(1 << 10, 16 << 10)
                    for i in range(24)})
    for i in range(2):
        rows = ["id,name,score"] + [
            f"{j},u{int(rng.integers(1 << 16))},{int(rng.integers(1000))}"
            for j in range(3000)]
        objects[f"csv/c{i}.csv"] = ("\n".join(rows) + "\n").encode()
    parts = [blob(200 << 10, 400 << 10) for _ in range(3)]
    dav = {f"{DAV_DIRS[1 + i % 3]}/f{i}.bin": blob(1 << 10, 600 << 10)
           for i in range(8)}
    messages = [(f"k{i}", rng.integers(0, 256, 1024, dtype=np.uint8)
                 .tobytes()) for i in range(120)]
    return {"objects": objects, "parts": parts, "dav": dav,
            "messages": messages}


def _plain_select(data: bytes) -> bytes:
    return b"".join(
        json.dumps({"id": r["id"], "score": r["score"]},
                   separators=(",", ":")).encode() + b"\n"
        for r in csv.DictReader(io.StringIO(data.decode()))
        if float(r["score"]) > FLOOR)


class _S3:
    """SigV4 header auth with aws-chunked bodies, as SDKs send them."""

    def __init__(self, pkg, url, ak, sk):
        self.pkg, self.url, self.ak, self.sk = pkg, url, ak, sk
        self.rpc = mod(pkg, "cluster.rpc")
        self.sigv4 = mod(pkg, "s3api.sigv4")

    def _chunked(self, body: bytes, signed: dict) -> bytes:
        auth = signed["Authorization"]
        prev = auth.rsplit("Signature=", 1)[1]
        scope = auth.split("Credential=", 1)[1].split(",", 1)[0] \
            .split("/", 1)[1]
        date, region, service, _t = scope.split("/")
        key = mod(self.pkg, "s3api.auth").derive_signing_key(
            self.sk, date, region, service)
        out = bytearray()
        for off in list(range(0, len(body), 64 << 10)) + [len(body)]:
            piece = body[off:off + (64 << 10)] if off < len(body) else b""
            sts = "\n".join(("AWS4-HMAC-SHA256-PAYLOAD",
                             signed["x-amz-date"], scope, prev,
                             hashlib.sha256(b"").hexdigest(),
                             hashlib.sha256(piece).hexdigest()))
            prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
            out += f"{len(piece):x};chunk-signature={prev}\r\n".encode()
            out += piece + b"\r\n"
        return bytes(out)

    def call(self, method, path, query="", body=b"", streaming=False):
        url = self.url + urllib.parse.quote(path) + (
            f"?{query}" if query else "")
        if streaming:
            hdrs = {"Content-Encoding": "aws-chunked",
                    "x-amz-decoded-content-length": str(len(body))}
            signed = self.sigv4.sign_request(
                method, url, hdrs, b"", self.ak, self.sk,
                payload_hash="STREAMING-AWS4-HMAC-SHA256-PAYLOAD")
            body = self._chunked(body, signed)
        else:
            signed = self.sigv4.sign_request(method, url, {}, body,
                                             self.ak, self.sk)
        signed.pop("Host")
        return self.rpc.call_status(url, method, body or None,
                                    timeout=120.0, headers=signed)


def _records(data: bytes) -> bytes:
    """The Records payload of an AWS event stream."""
    out, pos = bytearray(), 0
    while pos < len(data):
        total, hlen = struct.unpack_from(">II", data, pos)
        assert struct.unpack_from(">I", data, pos + total - 4)[0] \
            == zlib.crc32(data[pos:pos + total - 4])
        if b":event-type" in data[pos + 12:pos + 12 + hlen] and \
                b"Records" in data[pos + 12:pos + 12 + hlen]:
            out += data[pos + 12 + hlen:pos + total - 4]
        pos += total
    return bytes(out)


_MASK = (re.compile(rb"<LastModified>[^<]*</LastModified>"),
         re.compile(rb"<ETag>&quot;[0-9a-f]{32}-\d+&quot;</ETag>"))


def _list_v2(s3) -> bytes:
    """Every ListObjectsV2 page of the bucket (3 keys a page), masked."""
    out, token = b"", ""
    while True:
        q = "list-type=2&max-keys=3" + (
            f"&continuation-token={urllib.parse.quote(token)}"
            if token else "")
        status, body = s3.call("GET", f"/{BUCKET}", q)
        assert status == 200
        body = bytes(body)
        for m in _MASK:
            body = m.sub(b"<masked/>", body)
        out += body
        if b"<IsTruncated>true</IsTruncated>" not in body:
            return out
        token = re.search(rb"<NextContinuationToken>([^<]+)<",
                          body).group(1).decode()


def _propfind(rpc, durl: str) -> dict:
    out = {}
    for d in DAV_DIRS:
        status, body = rpc.call_status(durl + d + "/", "PROPFIND",
                                       headers={"Depth": "1"})
        assert status == 207
        out[d] = sorted(re.findall(rb"<(?:\w+:)?href>([^<]+)<", bytes(body)))
    return out


def _namespace_vids(proxy) -> list:
    """Volume ids of every chunk of every entry of the namespace."""
    vids, stack = set(), ["/"]
    while stack:
        d = stack.pop()
        for e in proxy.list_all(d):
            if e["is_directory"]:
                stack.append(e["FullPath"])
                continue
            for c in (proxy.meta(e["FullPath"]) or {}).get("chunks", []):
                vids.add(int(c["file_id"].split(",")[0]))
    return sorted(vids)


def _count_reconstructs(pkg: str, monkeypatch) -> list:
    cls = mod(pkg, "cluster.volume_server").VolumeServer
    real = cls._reconstruct_shard_interval
    seen: list = []

    def counted(self, ev, sid, off, size):
        seen.append((ev.vid, sid, off, size))
        return real(self, ev, sid, off, size)
    monkeypatch.setattr(cls, "_reconstruct_shard_interval", counted)
    return seen


def _consume(pkg, burl) -> list:
    c = mod(pkg, "messaging").MessagingClient(burl)
    out = []
    for p in range(PARTITIONS):
        since, got = 0, []
        while True:
            page = c.fetch(*TOPIC, p, since_ns=since, limit=50)
            if not page["messages"]:
                break
            got += [(m["key"], hashlib.sha256(m["value"]).hexdigest())
                    for m in page["messages"]]
            since = page["messages"][-1]["ts_ns"]
        out.append(got)
    return out


def _scenario(pkg: str, root, monkeypatch) -> dict:
    random.seed(SEED)
    seed_placement(monkeypatch, pkg, SEED)
    # A partition tail also flushes once it is 2 s old, so the number
    # of segments (chunks, and fsck's count) would follow the run's
    # speed: here tails flush by size and on the broker's stop only.
    init = mod(pkg, "messaging.topic_log").TopicPartitionLog.__init__
    monkeypatch.setattr(init, "__defaults__",
                        (init.__defaults__[0], float("inf")))
    data = _data()
    cluster = LiveCluster(pkg, root / pkg, n=4,
                          master_kw={"volume_size_limit_mb": 16})
    servers: list = []
    broker = None
    try:
        rpc = cluster.rpc
        fs = mod(pkg, "filer.server").FilerServer(
            cluster.url(), port=0, store_path=str(root / pkg / "filer"),
            chunk_size=CHUNK)
        fs.start()
        servers.append(fs)
        auth = mod(pkg, "s3api.auth")
        s3 = mod(pkg, "s3api.server").S3ApiServer(
            fs.url(), identities=auth.identities_from_dict(IDENTITIES))
        s3.start()
        servers.append(s3)
        dav = mod(pkg, "webdav").WebDavServer(fs.url())
        dav.start()
        servers.append(dav)
        broker = mod(pkg, "messaging.broker").MessageBroker(fs.url())
        broker.start()
        admin = _S3(pkg, s3.url(), *ADMIN)
        reader = _S3(pkg, s3.url(), *READER)

        # -- write through every gateway ---------------------------------
        assert admin.call("PUT", f"/{BUCKET}")[0] == 200
        objects = dict(data["objects"])
        for key, body in sorted(objects.items()):
            assert admin.call("PUT", f"/{BUCKET}/{key}", body=body,
                              streaming=True)[0] == 200
        status, body = admin.call("POST", f"/{BUCKET}/multi/mp.bin",
                                  "uploads")
        assert status == 200
        upload = re.search(rb"<UploadId>([^<]+)<", bytes(body)).group(1) \
            .decode()
        for n, part in enumerate(data["parts"], 1):
            assert admin.call("PUT", f"/{BUCKET}/multi/mp.bin",
                              f"partNumber={n}&uploadId={upload}", part,
                              streaming=True)[0] == 200
        done = "".join(f"<Part><PartNumber>{n}</PartNumber></Part>"
                       for n in range(1, len(data["parts"]) + 1))
        assert admin.call("POST", f"/{BUCKET}/multi/mp.bin",
                          f"uploadId={upload}",
                          f"<CompleteMultipartUpload>{done}"
                          "</CompleteMultipartUpload>".encode())[0] == 200
        objects["multi/mp.bin"] = b"".join(data["parts"])
        assert reader.call("PUT", f"/{BUCKET}/denied.bin", body=b"no",
                           streaming=True)[0] == 403
        durl = dav.url()
        for d in DAV_DIRS:
            assert rpc.call_status(durl + d, "MKCOL")[0] == 201
        for path, body in sorted(data["dav"].items()):
            assert rpc.call_status(durl + path, "PUT", body)[0] in (200, 201)
        client = mod(pkg, "messaging").MessagingClient(broker.url())
        client.configure_topic(*TOPIC, partition_count=PARTITIONS)
        for key, value in data["messages"]:
            client.publish(*TOPIC, value, key=key)
        published = _consume(pkg, broker.url())
        # Flush the broker's tails to the filer and its registration's
        # deletes to the volumes.
        broker.stop()
        broker = None
        fs.filer.flush_deletions()
        listing = {"s3": _list_v2(admin), "dav": _propfind(rpc, durl)}

        # -- fsck, lock; ec.encode every volume of the namespace ---------
        env = mod(pkg, "shell").CommandEnv(
            cluster.url(), filer_url=fs.url(),
            **({"device": "cpu"} if pkg == PORT else {}))
        cluster._envs.append(env)
        fsck_before = cluster.run(env, "volume.fsck")
        proxy = mod(pkg, "filer.client").FilerProxy(fs.url())
        vids = _namespace_vids(proxy)
        cluster.run(env, "lock")
        out = cluster.run(env, "ec.encode -volumeId "
                          + ",".join(map(str, vids)))
        for vid in vids:
            assert f"volume {vid} -> ec shards" in out, out
        cluster.freshen()

        # The volume Query RPC on a CSV chunk of an encoded volume.
        fid = proxy.meta(f"/buckets/{BUCKET}/csv/c0.csv")["chunks"][0][
            "file_id"]
        holder = next(vs for vs in cluster.servers
                      if int(fid.split(",")[0]) in vs.ec_volumes)
        query = rpc.call_status(
            f"http://{holder.url()}/query", "POST", json.dumps({
                "fid": fid, "query": SELECT, "input_format": "csv"})
            .encode())

        # -- stop a holder; read everything back through each gateway ----
        victim = next(
            vs for vs in cluster.servers if glob.glob(os.path.join(
                vs.store.locations[0].directory, f"*{vids[0]}.ec00")))
        victim.stop()
        cluster.freshen()
        mod(pkg, "storage.chunk_cache").CACHE.reset()
        reconstructed = _count_reconstructs(pkg, monkeypatch)
        read = {}
        for key in sorted(objects):
            status, body = admin.call("GET", f"/{BUCKET}/{key}")
            assert status == 200 and bytes(body) == objects[key], key
            read[key] = hashlib.sha256(bytes(body)).hexdigest()
        selects = {}
        for key in ("csv/c0.csv", "csv/c1.csv"):
            req = ("<SelectObjectContentRequest><Expression>"
                   f"{SELECT.replace('>', '&gt;')}</Expression>"
                   "<InputSerialization><CSV><FileHeaderInfo>USE"
                   "</FileHeaderInfo></CSV></InputSerialization>"
                   "<OutputSerialization><JSON/></OutputSerialization>"
                   "</SelectObjectContentRequest>").encode()
            status, body = admin.call("POST", f"/{BUCKET}/{key}",
                                      "select&select-type=2", req)
            assert status == 200
            selects[key] = _records(bytes(body))
            assert selects[key] == _plain_select(objects[key])
        for path, body in sorted(data["dav"].items()):
            status, got = rpc.call_status(durl + path)
            assert status == 200 and bytes(got) == body, path
        broker = mod(pkg, "messaging.broker").MessageBroker(fs.url())
        broker.start()
        consumed = _consume(pkg, broker.url())
        assert consumed == published
        want = sorted((k, hashlib.sha256(v).hexdigest())
                      for k, v in data["messages"])
        assert sorted(m for p in consumed for m in p) == want
        assert reconstructed, "no read crossed a lost interval"
        after = {"s3": _list_v2(admin), "dav": _propfind(rpc, durl)}
        assert after == listing
        broker.stop()
        broker = None
        fs.filer.flush_deletions()
        return {"read": read, "selects": selects, "messages": consumed,
                "listing": listing, "fsck_before": fsck_before,
                "fsck_after": cluster.run(env, "volume.fsck"),
                "query": query, "n_chunks": int(fsck_before.split()[1])}
    finally:
        if broker is not None:
            broker.stop()
        for s in reversed(servers):
            s.stop()
        cluster.stop()


def test_gateway_cluster_gate_matches_reference(tmp_path, monkeypatch):
    pin_clocks(monkeypatch)
    ref, port = (_scenario(pkg, tmp_path, monkeypatch) for pkg in PACKAGES)
    n = ref["n_chunks"]
    # The reference faults the port fixes: every chunk is on an EC
    # volume now, and only the port's fsck finds its holders; only the
    # port's Query RPC reads a needle of an EC volume.
    assert ref.pop("fsck_after").startswith(f"checked {n} chunks, {n} "
                                            "missing")
    assert port.pop("fsck_after") == f"checked {n} chunks, 0 missing"
    status, body = ref.pop("query")
    assert status == 404 and "not on this server" in str(body)
    status, body = port.pop("query")
    objects = _data()["objects"]
    assert status == 200 and bytes(body) == _plain_select(
        objects["csv/c0.csv"])
    for key in ("read", "selects", "messages", "listing", "fsck_before",
                "n_chunks"):
        assert port[key] == ref[key], key
    assert ref["fsck_before"] == f"checked {n} chunks, 0 missing"


def _streamed_put_notes(pkg: str, root, body: bytes) -> tuple:
    """One aws-chunked S3 PUT of `body` into a one-server cluster of
    `pkg`: the wire-flow ledger notes the PUT cost (every read of a
    server's streamed request body is one) and the object read back."""
    cluster = LiveCluster(pkg, root / pkg, n=1)
    servers: list = []
    try:
        fs = mod(pkg, "filer.server").FilerServer(cluster.url(), port=0)
        fs.start()
        servers.append(fs)
        s3 = mod(pkg, "s3api.server").S3ApiServer(
            fs.url(), identities=mod(pkg, "s3api.auth")
            .identities_from_dict(IDENTITIES))
        s3.start()
        servers.append(s3)
        admin = _S3(pkg, s3.url(), *ADMIN)
        assert admin.call("PUT", f"/{BUCKET}")[0] == 200
        ledger = mod(pkg, "stats.flows").LEDGER
        real = ledger.note
        calls = [0]

        def note(*a, **k):
            calls[0] += 1
            return real(*a, **k)
        ledger.note = note
        try:
            assert admin.call("PUT", f"/{BUCKET}/big.bin", body=body,
                              streaming=True)[0] == 200
        finally:
            del ledger.note
        status, got = admin.call("GET", f"/{BUCKET}/big.bin")
        return calls[0], status, bytes(got)
    finally:
        for s in reversed(servers):
            s.stop()
        cluster.stop()


def test_aws_chunked_put_reads_in_blocks_in_the_port_only(tmp_path):
    """The JAX package's aws-chunked reader reads each chunk's header
    line a byte at a time, and every read of a streamed request body is
    a wire-flow ledger note under a lock: ~85 notes per 64 KiB chunk.
    The port's reads the body in blocks through a buffer.  Both store
    the same bytes."""
    body = np.random.default_rng(SEED).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    ref, port = (_streamed_put_notes(pkg, tmp_path, body)
                 for pkg in PACKAGES)
    assert ref[1:] == port[1:] == (200, body)
    assert ref[0] >= port[0] + 16 * 80, (ref[0], port[0])
