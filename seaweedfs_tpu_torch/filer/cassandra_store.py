"""Cassandra-backed FilerStore speaking the CQL binary protocol v4
over a raw socket — no SDK.

Reference: weed/filer/cassandra/cassandra_store.go — a `filemeta`
table partitioned by directory with name clustering, driven by five
statements (kept byte-for-byte here, they ARE the compatibility
surface):

    INSERT INTO filemeta (directory,name,meta) VALUES(?,?,?) USING TTL ?
    SELECT meta FROM filemeta WHERE directory=? AND name=?
    DELETE FROM filemeta WHERE directory=? AND name=?
    DELETE FROM filemeta WHERE directory=?
    SELECT NAME, meta FROM filemeta WHERE directory=? AND name>[=]?
        ORDER BY NAME ASC LIMIT ?

KV rides the same table (cassandra_store_kv.go).  The transport is the
native protocol the gocql driver speaks: v4 frames
(version/flags/stream/opcode/length), STARTUP→READY handshake, QUERY
with positional values, ROWS results.  Tests run against an in-process
mini-cassandra (tests/_mini_cassandra.py)."""

from __future__ import annotations

import json
import struct

from ..utils.wireclient import WireClient
from .entry import Entry
from .filerstore import (FilerStore, FilerStoreError, NotFound, _norm,
                         split_dir_name)

# Protocol v4 opcodes.
OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_QUERY = 0x07
OP_RESULT = 0x08

RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002

CONSISTENCY_QUORUM = 0x0004


def _string_map(m: dict[str, str]) -> bytes:
    out = struct.pack(">H", len(m))
    for k, v in m.items():
        kb, vb = k.encode(), v.encode()
        out += struct.pack(">H", len(kb)) + kb
        out += struct.pack(">H", len(vb)) + vb
    return out


def _long_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">i", len(b)) + b


def _value(v) -> bytes:
    """[bytes] — int32 length + payload.  Ints serialize as CQL `int`
    (4 bytes): the only int-typed bind markers in the five statements
    are `USING TTL ?` and `LIMIT ?`, both `int` columns server-side —
    an 8-byte value would fail real Cassandra's type check."""
    if v is None:
        return struct.pack(">i", -1)
    if isinstance(v, int):
        b = struct.pack(">i", v)
    elif isinstance(v, str):
        b = v.encode()
    else:
        b = bytes(v)
    return struct.pack(">i", len(b)) + b


class CqlClient(WireClient):
    """Single-connection CQL v4 client: STARTUP handshake, then one
    QUERY frame per call; connection lifecycle (lock, redial-once,
    close) comes from WireClient."""

    def __init__(self, host: str = "localhost", port: int = 9042,
                 keyspace: str = "seaweedfs", timeout: float = 10.0):
        super().__init__(host, port, timeout)
        self.keyspace = keyspace
        self._stream = 0

    def _handshake(self) -> None:
        op, _ = self._roundtrip(
            OP_STARTUP, _string_map({"CQL_VERSION": "3.0.0"}))
        if op != OP_READY:
            raise FilerStoreError(f"cassandra startup answered 0x{op:x}")
        self._exec_locked(f'USE "{self.keyspace}"')

    def _roundtrip(self, opcode: int, body: bytes) -> tuple[int, bytes]:
        self._stream = (self._stream + 1) % 32768
        frame = struct.pack(">BBhBi", 0x04, 0, self._stream, opcode,
                            len(body)) + body
        self._sock.sendall(frame)
        hdr = self._recv_exact(9)
        _ver, _flags, _stream, op, length = struct.unpack(">BBhBi", hdr)
        payload = self._recv_exact(length) if length else b""
        if op == OP_ERROR:
            code = struct.unpack_from(">i", payload)[0]
            n = struct.unpack_from(">H", payload, 4)[0]
            msg = payload[6:6 + n].decode()
            raise FilerStoreError(f"cassandra error 0x{code:x}: {msg}")
        return op, payload

    def _exec_locked(self, cql: str, values: tuple = ()):
        body = _long_string(cql)
        flags = 0x01 if values else 0x00
        body += struct.pack(">HB", CONSISTENCY_QUORUM, flags)
        if values:
            body += struct.pack(">H", len(values))
            for v in values:
                body += _value(v)
        op, payload = self._roundtrip(OP_QUERY, body)
        if op != OP_RESULT:
            raise FilerStoreError(f"unexpected opcode 0x{op:x}")
        kind = struct.unpack_from(">i", payload)[0]
        if kind != RESULT_ROWS:
            return []
        return self._parse_rows(payload)

    @staticmethod
    def _parse_rows(payload: bytes) -> list[list[bytes | None]]:
        i = 4
        meta_flags, col_count = struct.unpack_from(">ii", payload, i)
        i += 8
        if meta_flags & 0x0001:  # global table spec: ks + table
            for _ in range(2):
                n = struct.unpack_from(">H", payload, i)[0]
                i += 2 + n
        for _ in range(col_count):  # per-column specs
            if not meta_flags & 0x0001:
                for _ in range(2):
                    n = struct.unpack_from(">H", payload, i)[0]
                    i += 2 + n
            n = struct.unpack_from(">H", payload, i)[0]  # col name
            i += 2 + n
            opt = struct.unpack_from(">H", payload, i)[0]  # type id
            i += 2
            if opt == 0x0022:  # list<...>: one nested option (unused)
                i += 2
        rows_count = struct.unpack_from(">i", payload, i)[0]
        i += 4
        rows = []
        for _ in range(rows_count):
            row = []
            for _ in range(col_count):
                n = struct.unpack_from(">i", payload, i)[0]
                i += 4
                if n < 0:
                    row.append(None)
                else:
                    row.append(payload[i:i + n])
                    i += n
            rows.append(row)
        return rows

    def execute(self, cql: str, values: tuple = ()):
        return self._call(lambda: self._exec_locked(cql, values))


class CassandraStore(FilerStore):
    """filer.toml `[cassandra]` store (cassandra_store.go:30)."""

    name = "cassandra"

    SQL_INSERT = ("INSERT INTO filemeta (directory,name,meta) "
                  "VALUES(?,?,?) USING TTL ? ")
    SQL_FIND = "SELECT meta FROM filemeta WHERE directory=? AND name=?"
    SQL_DELETE = "DELETE FROM filemeta WHERE directory=? AND name=?"
    SQL_DELETE_DIR = "DELETE FROM filemeta WHERE directory=?"
    SQL_LIST_EXCLUSIVE = ("SELECT NAME, meta FROM filemeta "
                          "WHERE directory=? AND name>? "
                          "ORDER BY NAME ASC LIMIT ?")
    SQL_LIST_INCLUSIVE = ("SELECT NAME, meta FROM filemeta "
                          "WHERE directory=? AND name>=? "
                          "ORDER BY NAME ASC LIMIT ?")

    def __init__(self, host: str = "localhost", port: int = 9042,
                 keyspace: str = "seaweedfs",
                 client: CqlClient | None = None):
        self.client = client or CqlClient(host, port, keyspace)

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_dir_name(entry.path)
        meta = json.dumps(entry.to_dict()).encode()
        self.client.execute(self.SQL_INSERT,
                            (d, name, meta,
                             entry.attributes.ttl_sec))

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        d, name = split_dir_name(path)
        rows = self.client.execute(self.SQL_FIND, (d, name))
        if not rows or rows[0][0] is None:
            raise NotFound(path)
        return Entry.from_dict(json.loads(rows[0][0]))

    def delete_entry(self, path: str) -> None:
        d, name = split_dir_name(path)
        self.client.execute(self.SQL_DELETE, (d, name))

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        # One partition per directory level; recurse into child
        # directories so the whole subtree clears (the filer recurses
        # in the reference).
        while True:
            entries = self.list_directory_entries(path, "", True, 1024)
            if not entries:
                break
            for e in entries:
                if e.is_directory:
                    self.delete_folder_children(e.path)
            self.client.execute(self.SQL_DELETE_DIR, (path,))

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               include_start: bool,
                               limit: int) -> list[Entry]:
        d = _norm(dir_path)
        cql = self.SQL_LIST_INCLUSIVE if include_start \
            else self.SQL_LIST_EXCLUSIVE
        rows = self.client.execute(cql, (d, start_file_name, limit))
        return [Entry.from_dict(json.loads(meta))
                for _name, meta in rows if meta is not None]

    # -- kv: same table (cassandra_store_kv.go) -----------------------------

    _KV_DIR = "/etc/kv"

    def kv_put(self, key: str, value: bytes) -> None:
        self.client.execute(self.SQL_INSERT,
                            (self._KV_DIR, key, bytes(value), 0))

    def kv_get(self, key: str) -> bytes | None:
        rows = self.client.execute(self.SQL_FIND, (self._KV_DIR, key))
        if not rows or rows[0][0] is None:
            return None
        return bytes(rows[0][0])

    def kv_delete(self, key: str) -> None:
        self.client.execute(self.SQL_DELETE, (self._KV_DIR, key))

    def close(self) -> None:
        self.client.close()
