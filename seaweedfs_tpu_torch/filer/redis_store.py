"""Redis-backed FilerStore speaking RESP2 over a raw socket — no SDK.

Reference: weed/filer/redis/universal_redis_store.go — entry meta at
key = full path (SET/GET/DEL), directory membership in a set per
directory (SADD/SREM/SMEMBERS on `dir + "\\x00"`), listing =
SMEMBERS + client-side sort/slice + per-name GET, and
DeleteFolderChildren = SMEMBERS + DEL each child + DEL the set.
Entries with a TTL ride redis expiry (`SET ... EX ttl`), like the
reference's `Set(key, value, ttl)`.

The wire client is the same no-SDK pattern as the Kafka/SQS/Pub/Sub
queues (replication/): RESP2 is an array of bulk strings out, one
typed reply back.  Tests run it against an in-process mini-RESP server
(tests/test_filer_stores.py) — the kafka-queue test pattern.
"""

from __future__ import annotations

import json

from ..utils.wireclient import WireClient
from .entry import Entry
from .filerstore import FilerStore, FilerStoreError, NotFound, _norm

DIR_LIST_MARKER = "\x00"


class RespError(FilerStoreError):
    """Server-side -ERR reply."""


class RespClient(WireClient):
    """Minimal RESP2 client: encode one command as an array of bulk
    strings, parse one typed reply.  Connection lifecycle (lock,
    redial-once, close) comes from WireClient."""

    def __init__(self, host: str, port: int, password: str = "",
                 database: int = 0, timeout: float = 10.0):
        super().__init__(host, port, timeout)
        self.password, self.database = password, database
        self._rf = None

    # -- wire ----------------------------------------------------------------

    def _on_connect(self) -> None:
        self._rf = self._sock.makefile("rb", buffering=1 << 16)

    def _handshake(self) -> None:
        if self.password:
            self._roundtrip(("AUTH", self.password))
        if self.database:
            self._roundtrip(("SELECT", str(self.database)))

    @staticmethod
    def _encode(args: tuple) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(out)

    def _read_reply(self):
        line = self._rf.readline()
        if not line:
            raise ConnectionError("redis closed the connection")
        kind, rest = line[:1], line[1:-2]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = self._rf.read(n + 2)
            if len(data) < n + 2:
                raise ConnectionError("short bulk reply")
            return data[:-2]
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._read_reply() for _ in range(n)]
        raise FilerStoreError(f"bad RESP type byte {kind!r}")

    def _roundtrip(self, args: tuple):
        self._sock.sendall(self._encode(args))
        return self._read_reply()

    def call(self, *args):
        return self._call(lambda: self._roundtrip(args))

    def close_nolock(self) -> None:
        if self._rf is not None:
            try:
                self._rf.close()
            except OSError:
                pass
            self._rf = None
        super().close_nolock()


def _dir_and_name(path: str) -> tuple[str, str]:
    if path == "/":
        return "", ""
    d, name = path.rsplit("/", 1)
    return d or "/", name


def _dir_list_key(dir_path: str) -> str:
    return dir_path + DIR_LIST_MARKER


class RedisStore(FilerStore):
    """filer.toml `[redis]` store (redis_store.go:15 over the
    universal client above)."""

    name = "redis"

    def __init__(self, host: str = "localhost", port: int = 6379,
                 password: str = "", database: int = 0,
                 client: RespClient | None = None):
        self.client = client or RespClient(host, port, password, database)

    # -- entries -------------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        path = _norm(entry.path)
        value = json.dumps(entry.to_dict()).encode()
        ttl = entry.attributes.ttl_sec
        if ttl > 0:
            self.client.call("SET", path, value, "EX", ttl)
        else:
            self.client.call("SET", path, value)
        d, name = _dir_and_name(path)
        if name:
            self.client.call("SADD", _dir_list_key(d), name)

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        path = _norm(path)
        data = self.client.call("GET", path)
        if data is None:
            raise NotFound(path)
        return Entry.from_dict(json.loads(data))

    def delete_entry(self, path: str) -> None:
        path = _norm(path)
        self.client.call("DEL", path)
        d, name = _dir_and_name(path)
        if name:
            self.client.call("SREM", _dir_list_key(d), name)

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        members = self.client.call("SMEMBERS", _dir_list_key(path)) or []
        for m in members:
            name = m.decode() if isinstance(m, bytes) else m
            child = path.rstrip("/") + "/" + name
            # Recurse only into directories (checked from the child's
            # meta, which we fetch anyway-adjacent): plain files would
            # cost two wasted round-trips each on a real network.
            meta = self.client.call("GET", child)
            if meta is not None:
                try:
                    if json.loads(meta).get("is_directory"):
                        self.delete_folder_children(child)
                except ValueError:
                    pass
            self.client.call("DEL", child)
        self.client.call("DEL", _dir_list_key(path))

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               include_start: bool,
                               limit: int) -> list[Entry]:
        dir_path = _norm(dir_path)
        members = self.client.call(
            "SMEMBERS", _dir_list_key(dir_path)) or []
        names = sorted(m.decode() if isinstance(m, bytes) else m
                       for m in members)
        out: list[Entry] = []
        for name in names:
            if start_file_name:
                if include_start and name < start_file_name:
                    continue
                if not include_start and name <= start_file_name:
                    continue
            child = (dir_path.rstrip("/") or "") + "/" + name
            data = self.client.call("GET", child)
            if data is None:
                continue  # expired / raced delete: skip, like the ref
            out.append(Entry.from_dict(json.loads(data)))
            if len(out) >= limit:
                break
        return out

    # -- kv ------------------------------------------------------------------

    def kv_put(self, key: str, value: bytes) -> None:
        self.client.call("SET", "kv:" + key, bytes(value))

    def kv_get(self, key: str) -> bytes | None:
        data = self.client.call("GET", "kv:" + key)
        return bytes(data) if data is not None else None

    def kv_delete(self, key: str) -> None:
        self.client.call("DEL", "kv:" + key)

    def close(self) -> None:
        self.client.close()
