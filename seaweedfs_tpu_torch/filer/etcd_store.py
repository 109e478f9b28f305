"""etcd-backed FilerStore over the v3 KV gRPC API — no SDK.

Reference: weed/filer/etcd/etcd_store.go — entry meta at key =
`dir + "\\x00" + name` (DIR_FILE_SEPARATOR), listing = prefix Range
over `dir + "\\x00" [+ start]`, DeleteFolderChildren = prefix
DeleteRange.  The client speaks etcdserverpb.KV (Range/Put/
DeleteRange) through raw grpcio generic calls against the
wire-compatible proto subset in pb/etcd.proto, the same no-SDK pattern
as the Kafka/SQS/Pub/Sub queues.  Tests run it against an in-process
mini-etcd gRPC server (tests/_mini_etcd.py)."""

from __future__ import annotations

import json

from ..pb import etcd_pb2 as pb
from .entry import Entry
from .filerstore import FilerStore, NotFound, _norm, split_dir_name

DIR_FILE_SEPARATOR = "\x00"


class EtcdClient:
    """Three-RPC etcd v3 KV client over a raw grpcio channel."""

    def __init__(self, endpoint: str = "localhost:2379",
                 timeout: float = 10.0):
        import grpc
        self.timeout = timeout
        self._chan = grpc.insecure_channel(endpoint)
        svc = "/etcdserverpb.KV/"

        def unary(name, resp_cls):
            return self._chan.unary_unary(
                svc + name,
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString)
        self._range = unary("Range", pb.RangeResponse)
        self._put = unary("Put", pb.PutResponse)
        self._delete = unary("DeleteRange", pb.DeleteRangeResponse)

    def put(self, key: bytes, value: bytes) -> None:
        self._put(pb.PutRequest(key=key, value=value),
                  timeout=self.timeout, wait_for_ready=True)

    def get(self, key: bytes) -> bytes | None:
        out = self._range(pb.RangeRequest(key=key),
                          timeout=self.timeout, wait_for_ready=True)
        return out.kvs[0].value if out.kvs else None

    def range_prefix(self, prefix: bytes, start: bytes | None = None,
                     limit: int = 0) -> list:
        """Keys in [start or prefix, prefix-bump), ascending by key."""
        end = prefix[:-1] + bytes((prefix[-1] + 1,))
        out = self._range(pb.RangeRequest(
            key=start if start is not None else prefix,
            range_end=end, limit=limit,
            sort_order=pb.RangeRequest.ASCEND,
            sort_target=pb.RangeRequest.KEY),
            timeout=self.timeout, wait_for_ready=True)
        return list(out.kvs)

    def delete(self, key: bytes) -> int:
        out = self._delete(pb.DeleteRangeRequest(key=key),
                           timeout=self.timeout, wait_for_ready=True)
        return out.deleted

    def delete_prefix(self, prefix: bytes) -> int:
        end = prefix[:-1] + bytes((prefix[-1] + 1,))
        out = self._delete(
            pb.DeleteRangeRequest(key=prefix, range_end=end),
            timeout=self.timeout, wait_for_ready=True)
        return out.deleted

    def close(self) -> None:
        self._chan.close()


def _gen_key(dir_path: str, name: str) -> bytes:
    return (dir_path + DIR_FILE_SEPARATOR + name).encode()


class EtcdStore(FilerStore):
    """filer.toml `[etcd]` store (etcd_store.go:15)."""

    name = "etcd"

    def __init__(self, endpoint: str = "localhost:2379",
                 client: EtcdClient | None = None):
        self.client = client or EtcdClient(endpoint)

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_dir_name(entry.path)
        self.client.put(_gen_key(d, name),
                        json.dumps(entry.to_dict()).encode())

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        d, name = split_dir_name(path)
        data = self.client.get(_gen_key(d, name))
        if data is None:
            raise NotFound(path)
        return Entry.from_dict(json.loads(data))

    def delete_entry(self, path: str) -> None:
        d, name = split_dir_name(path)
        self.client.delete(_gen_key(d, name))

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        # One level per prefix; recurse through subdirectories so the
        # whole subtree clears (the filer recurses in the reference;
        # the conformance contract here is a full-subtree clear).
        prefix = (path + DIR_FILE_SEPARATOR).encode()
        for kv in self.client.range_prefix(prefix):
            try:
                e = Entry.from_dict(json.loads(kv.value))
            except ValueError:
                continue
            if e.is_directory:
                self.delete_folder_children(e.path)
        self.client.delete_prefix(prefix)

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               include_start: bool,
                               limit: int) -> list[Entry]:
        d = _norm(dir_path)
        prefix = (d + DIR_FILE_SEPARATOR).encode()
        start = None
        if start_file_name:
            start = prefix + start_file_name.encode()
        kvs = self.client.range_prefix(
            prefix, start=start, limit=limit + 1 if start else limit)
        out: list[Entry] = []
        for kv in kvs:
            name = kv.key[len(prefix):].decode()
            if start_file_name and not include_start \
                    and name == start_file_name:
                continue
            out.append(Entry.from_dict(json.loads(kv.value)))
            if len(out) >= limit:
                break
        return out

    # -- kv: raw keys, like the reference (no \x00 => no collision) ---------

    def kv_put(self, key: str, value: bytes) -> None:
        self.client.put(key.encode(), bytes(value))

    def kv_get(self, key: str) -> bytes | None:
        return self.client.get(key.encode())

    def kv_delete(self, key: str) -> None:
        self.client.delete(key.encode())

    def close(self) -> None:
        self.client.close()
