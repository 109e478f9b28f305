"""MongoDB-backed FilerStore speaking the wire protocol (OP_MSG +
BSON) over a raw socket — no SDK.

Reference: weed/filer/mongodb/mongodb_store.go — one `filemeta`
collection of {directory, name, meta} docs with a unique
(directory, name) index; insert = upsert update, listing = find with
name $gt/$gte + ascending name sort + limit, DeleteFolderChildren =
deleteMany on directory; KV rides the same collection under
genDirAndName ("/etc/kv" directory).

The transport is MongoDB's modern OP_MSG framing (opcode 2013, one
kind-0 body section) carrying command documents (`update`, `find`,
`delete`, `createIndexes`) — the subset every driver since 3.6 uses —
with a from-scratch minimal BSON codec below.  The same no-SDK wire
pattern as the Kafka/RESP/etcd backends; tests run against an
in-process mini-mongo server (tests/_mini_mongo.py)."""

from __future__ import annotations

import json
import struct

from ..utils.wireclient import WireClient
from .entry import Entry
from .filerstore import (FilerStore, FilerStoreError, NotFound, _norm,
                         split_dir_name)

# -- minimal BSON ------------------------------------------------------------
# Types used by the filer commands: double, string, doc, array, binary,
# bool, null, int32, int64.

_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


def bson_encode(doc: dict) -> bytes:
    out = bytearray()
    for k, v in doc.items():
        key = k.encode() + b"\x00"
        if isinstance(v, bool):
            out += b"\x08" + key + (b"\x01" if v else b"\x00")
        elif isinstance(v, int):
            if -(1 << 31) <= v < (1 << 31):
                out += b"\x10" + key + _I32.pack(v)
            else:
                out += b"\x12" + key + _I64.pack(v)
        elif isinstance(v, float):
            out += b"\x01" + key + _F64.pack(v)
        elif isinstance(v, str):
            b = v.encode()
            out += b"\x02" + key + _I32.pack(len(b) + 1) + b + b"\x00"
        elif isinstance(v, (bytes, bytearray)):
            out += b"\x05" + key + _I32.pack(len(v)) + b"\x00" + bytes(v)
        elif isinstance(v, dict):
            out += b"\x03" + key + bson_encode(v)
        elif isinstance(v, (list, tuple)):
            out += b"\x04" + key + bson_encode(
                {str(i): x for i, x in enumerate(v)})
        elif v is None:
            out += b"\x0a" + key
        else:
            raise FilerStoreError(f"bson: cannot encode {type(v)}")
    return _I32.pack(len(out) + 5) + bytes(out) + b"\x00"


def bson_decode(buf: bytes, offset: int = 0) -> tuple[dict, int]:
    """Returns (doc, next_offset)."""
    total = _I32.unpack_from(buf, offset)[0]
    end = offset + total - 1  # the trailing \x00
    i = offset + 4
    doc: dict = {}
    while i < end:
        t = buf[i]
        i += 1
        z = buf.index(b"\x00", i)
        key = buf[i:z].decode()
        i = z + 1
        if t == 0x01:
            doc[key] = _F64.unpack_from(buf, i)[0]
            i += 8
        elif t == 0x02:
            n = _I32.unpack_from(buf, i)[0]
            doc[key] = buf[i + 4:i + 4 + n - 1].decode()
            i += 4 + n
        elif t in (0x03, 0x04):
            sub, i = bson_decode(buf, i)
            doc[key] = list(sub.values()) if t == 0x04 else sub
        elif t == 0x05:
            n = _I32.unpack_from(buf, i)[0]
            doc[key] = bytes(buf[i + 5:i + 5 + n])
            i += 5 + n
        elif t == 0x08:
            doc[key] = bool(buf[i])
            i += 1
        elif t == 0x0A:
            doc[key] = None
        elif t == 0x10:
            doc[key] = _I32.unpack_from(buf, i)[0]
            i += 4
        elif t == 0x12:
            doc[key] = _I64.unpack_from(buf, i)[0]
            i += 8
        else:
            raise FilerStoreError(f"bson: unsupported type 0x{t:02x}")
    return doc, end + 1


# -- OP_MSG transport --------------------------------------------------------

OP_MSG = 2013
_HDR = struct.Struct("<iiii")


class MongoClient(WireClient):
    """One-command-at-a-time OP_MSG client; connection lifecycle (lock,
    redial-once, close) comes from WireClient."""

    def __init__(self, host: str = "localhost", port: int = 27017,
                 timeout: float = 10.0):
        super().__init__(host, port, timeout)
        self._req_id = 0

    def _roundtrip(self, doc: dict) -> dict:
        self._req_id += 1
        body = b"\x00\x00\x00\x00" + b"\x00" + bson_encode(doc)
        msg = _HDR.pack(16 + len(body), self._req_id, 0, OP_MSG) + body
        self._sock.sendall(msg)
        hdr = self._recv_exact(16)
        length, _rid, _rto, opcode = _HDR.unpack(hdr)
        payload = self._recv_exact(length - 16)
        if opcode != OP_MSG:
            raise FilerStoreError(f"unexpected opcode {opcode}")
        # flagBits(4) + kind byte(1) + body document
        reply, _ = bson_decode(payload, 5)
        if reply.get("ok") != 1 and reply.get("ok") != 1.0:
            raise FilerStoreError(
                f"mongo error: {reply.get('errmsg', reply)}")
        # Write commands report per-document failures with ok:1 —
        # e.g. a lost upsert race on the unique index comes back as
        # writeErrors, which must not pass as success.
        if reply.get("writeErrors"):
            raise FilerStoreError(
                f"mongo write error: {reply['writeErrors']}")
        return reply

    def command(self, doc: dict) -> dict:
        return self._call(lambda: self._roundtrip(doc))


class MongoStore(FilerStore):
    """filer.toml `[mongodb]` store (mongodb_store.go:22)."""

    name = "mongodb"
    COLLECTION = "filemeta"

    def __init__(self, host: str = "localhost", port: int = 27017,
                 database: str = "seaweedfs",
                 client: MongoClient | None = None):
        self.db = database
        self.client = client or MongoClient(host, port)
        # Unique (directory, name) index, like indexUnique().
        try:
            self.client.command({
                "createIndexes": self.COLLECTION, "$db": self.db,
                "indexes": [{"key": {"directory": 1, "name": 1},
                             "name": "directory_1_name_1",
                             "unique": True}]})
        except FilerStoreError:
            pass  # index exists / server predates the command shape

    def _upsert(self, d: str, name: str, meta: bytes) -> None:
        self.client.command({
            "update": self.COLLECTION, "$db": self.db,
            "updates": [{"q": {"directory": d, "name": name},
                         "u": {"$set": {"meta": meta}},
                         "upsert": True}]})

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_dir_name(entry.path)
        self._upsert(d, name, json.dumps(entry.to_dict()).encode())

    update_entry = insert_entry

    def _find_one(self, d: str, name: str) -> bytes | None:
        out = self.client.command({
            "find": self.COLLECTION, "$db": self.db,
            "filter": {"directory": d, "name": name}, "limit": 1,
            "singleBatch": True, "batchSize": 1})
        batch = out.get("cursor", {}).get("firstBatch", [])
        if not batch:
            return None
        return batch[0].get("meta")

    def find_entry(self, path: str) -> Entry:
        d, name = split_dir_name(path)
        meta = self._find_one(d, name)
        if not meta:
            raise NotFound(path)
        return Entry.from_dict(json.loads(meta))

    def delete_entry(self, path: str) -> None:
        d, name = split_dir_name(path)
        self.client.command({
            "delete": self.COLLECTION, "$db": self.db,
            "deletes": [{"q": {"directory": d, "name": name},
                         "limit": 1}]})

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        # The reference clears one level (deleteMany on directory); the
        # conformance contract here is a full-subtree clear, so recurse
        # through child directories first.
        while True:
            entries = self.list_directory_entries(path, "", True, 1024)
            if not entries:
                break
            for e in entries:
                if e.is_directory:
                    self.delete_folder_children(e.path)
            self.client.command({
                "delete": self.COLLECTION, "$db": self.db,
                "deletes": [{"q": {"directory": path}, "limit": 0}]})

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               include_start: bool,
                               limit: int) -> list[Entry]:
        d = _norm(dir_path)
        op = "$gte" if include_start else "$gt"
        # singleBatch + batchSize=limit: everything arrives in
        # firstBatch, so no getMore cursor walk is needed and no
        # server-side cursor leaks (real mongod otherwise caps the
        # first batch at 101 documents).
        out = self.client.command({
            "find": self.COLLECTION, "$db": self.db,
            "filter": {"directory": d,
                       "name": {op: start_file_name}},
            "sort": {"name": 1}, "limit": limit,
            "singleBatch": True, "batchSize": limit})
        batch = out.get("cursor", {}).get("firstBatch", [])
        return [Entry.from_dict(json.loads(doc["meta"]))
                for doc in batch if doc.get("meta")]

    # -- kv (same collection, genDirAndName — mongodb_store_kv.go) ----------

    _KV_DIR = "/etc/kv"

    def kv_put(self, key: str, value: bytes) -> None:
        self._upsert(self._KV_DIR, key, bytes(value))

    def kv_get(self, key: str) -> bytes | None:
        return self._find_one(self._KV_DIR, key)  # b"" is a value

    def kv_delete(self, key: str) -> None:
        self.client.command({
            "delete": self.COLLECTION, "$db": self.db,
            "deletes": [{"q": {"directory": self._KV_DIR, "name": key},
                         "limit": 1}]})

    def close(self) -> None:
        self.client.close()
