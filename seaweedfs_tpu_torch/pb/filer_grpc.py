"""gRPC facade for the filer: the reference's `SeaweedFiler` service.

Reference: weed/server/filer_grpc_server*.go + pb/filer.proto.  Bridges
to the SAME Filer/FilerServer internals the HTTP plane uses; the gRPC
port rides HTTP port + 10000 like the master plane.
"""

from __future__ import annotations

import json
from concurrent import futures

import grpc

from ..filer.entry import Attributes, Entry, FileChunk
from ..filer.filer import FilerError, NotFound
from . import filer_pb2 as pb

GRPC_PORT_DELTA = 10_000


def _join(directory: str, name: str) -> str:
    return (directory.rstrip("/") + "/" + name) if name else \
        (directory or "/")


# -- Entry <-> pb conversion -------------------------------------------------

def entry_to_pb(e: Entry) -> "pb.Entry":
    a = e.attributes
    out = pb.Entry(
        name=e.name, is_directory=e.is_directory,
        attributes=pb.FuseAttributes(
            file_size=e.size(), mtime=int(a.mtime),
            file_mode=a.mode, uid=a.uid, gid=a.gid,
            crtime=int(a.crtime), mime=a.mime,
            replication=a.replication, collection=a.collection,
            ttl_sec=a.ttl_sec, user_name=a.user_name,
            group_name=list(a.group_names),
            symlink_target=a.symlink_target,
            md5=bytes.fromhex(a.md5) if a.md5 else b""),
        hard_link_id=e.hard_link_id.encode("utf-8", "surrogateescape"),
        hard_link_counter=e.hard_link_counter)
    for k, v in e.extended.items():
        out.extended[k] = v.encode() if isinstance(v, str) else v
    for c in e.chunks:
        out.chunks.append(pb.FileChunk(
            file_id=c.file_id, offset=c.offset, size=c.size,
            mtime=c.mtime, e_tag=c.etag,
            cipher_key=bytes.fromhex(c.cipher_key)
            if c.cipher_key else b"",
            is_chunk_manifest=c.is_chunk_manifest))
    return out


def entry_from_pb(directory: str, p: "pb.Entry") -> Entry:
    a = p.attributes
    attrs = Attributes(
        mtime=float(a.mtime), crtime=float(a.crtime),
        mode=a.file_mode or 0o660, uid=a.uid, gid=a.gid,
        mime=a.mime, ttl_sec=a.ttl_sec, user_name=a.user_name,
        group_names=list(a.group_name),
        symlink_target=a.symlink_target,
        md5=a.md5.hex() if a.md5 else "",
        replication=a.replication, collection=a.collection)
    chunks = [FileChunk(
        file_id=c.file_id, offset=c.offset, size=c.size,
        mtime=c.mtime, etag=c.e_tag,
        is_chunk_manifest=c.is_chunk_manifest,
        cipher_key=c.cipher_key.hex() if c.cipher_key else "")
        for c in p.chunks]
    return Entry(
        path=_join(directory, p.name), is_directory=p.is_directory,
        attributes=attrs, chunks=chunks,
        extended={k: v.decode("utf-8", "surrogateescape")
                  for k, v in p.extended.items()},
        hard_link_id=p.hard_link_id.decode("utf-8", "surrogateescape")
        if p.hard_link_id else "",
        hard_link_counter=p.hard_link_counter)


class FilerGrpcServer:
    """Serves filer_pb.SeaweedFiler over grpc bridged to a
    FilerServer."""

    SERVICE = "filer_pb.SeaweedFiler"

    def __init__(self, filer_server, host: str = "127.0.0.1",
                 port: int | None = None, max_workers: int = 16,
                 credentials=None):
        self.fs = filer_server
        self.port = port if port is not None \
            else filer_server.server.port + GRPC_PORT_DELTA
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        unary = grpc.unary_unary_rpc_method_handler
        stream_out = grpc.unary_stream_rpc_method_handler
        handlers = {
            "LookupDirectoryEntry": unary(
                self._lookup_entry,
                request_deserializer=(
                    pb.LookupDirectoryEntryRequest.FromString),
                response_serializer=(
                    pb.LookupDirectoryEntryResponse.SerializeToString)),
            "ListEntries": stream_out(
                self._list_entries,
                request_deserializer=pb.ListEntriesRequest.FromString,
                response_serializer=(
                    pb.ListEntriesResponse.SerializeToString)),
            "CreateEntry": unary(
                self._create_entry,
                request_deserializer=pb.CreateEntryRequest.FromString,
                response_serializer=(
                    pb.CreateEntryResponse.SerializeToString)),
            "UpdateEntry": unary(
                self._update_entry,
                request_deserializer=pb.UpdateEntryRequest.FromString,
                response_serializer=(
                    pb.UpdateEntryResponse.SerializeToString)),
            "AppendToEntry": unary(
                self._append_to_entry,
                request_deserializer=pb.AppendToEntryRequest.FromString,
                response_serializer=(
                    pb.AppendToEntryResponse.SerializeToString)),
            "DeleteEntry": unary(
                self._delete_entry,
                request_deserializer=pb.DeleteEntryRequest.FromString,
                response_serializer=(
                    pb.DeleteEntryResponse.SerializeToString)),
            "AtomicRenameEntry": unary(
                self._rename_entry,
                request_deserializer=(
                    pb.AtomicRenameEntryRequest.FromString),
                response_serializer=(
                    pb.AtomicRenameEntryResponse.SerializeToString)),
            "AssignVolume": unary(
                self._assign_volume,
                request_deserializer=pb.AssignVolumeRequest.FromString,
                response_serializer=(
                    pb.AssignVolumeResponse.SerializeToString)),
            "LookupVolume": unary(
                self._lookup_volume,
                request_deserializer=pb.LookupVolumeRequest.FromString,
                response_serializer=(
                    pb.LookupVolumeResponse.SerializeToString)),
            "CollectionList": unary(
                self._collection_list,
                request_deserializer=pb.CollectionListRequest.FromString,
                response_serializer=(
                    pb.CollectionListResponse.SerializeToString)),
            "DeleteCollection": unary(
                self._delete_collection,
                request_deserializer=(
                    pb.DeleteCollectionRequest.FromString),
                response_serializer=(
                    pb.DeleteCollectionResponse.SerializeToString)),
            "Statistics": unary(
                self._statistics,
                request_deserializer=pb.StatisticsRequest.FromString,
                response_serializer=(
                    pb.StatisticsResponse.SerializeToString)),
            "GetFilerConfiguration": unary(
                self._get_configuration,
                request_deserializer=(
                    pb.GetFilerConfigurationRequest.FromString),
                response_serializer=(
                    pb.GetFilerConfigurationResponse.SerializeToString)),
            "SubscribeMetadata": stream_out(
                self._subscribe_metadata,
                request_deserializer=(
                    pb.SubscribeMetadataRequest.FromString),
                response_serializer=(
                    pb.SubscribeMetadataResponse.SerializeToString)),
            "SubscribeLocalMetadata": stream_out(
                self._subscribe_metadata,
                request_deserializer=(
                    pb.SubscribeMetadataRequest.FromString),
                response_serializer=(
                    pb.SubscribeMetadataResponse.SerializeToString)),
            "KeepConnected": grpc.stream_stream_rpc_method_handler(
                self._keep_connected,
                request_deserializer=pb.KeepConnectedRequest.FromString,
                response_serializer=(
                    pb.KeepConnectedResponse.SerializeToString)),
            "LocateBroker": unary(
                self._locate_broker,
                request_deserializer=pb.LocateBrokerRequest.FromString,
                response_serializer=(
                    pb.LocateBrokerResponse.SerializeToString)),
            "KvGet": unary(
                self._kv_get,
                request_deserializer=pb.KvGetRequest.FromString,
                response_serializer=pb.KvGetResponse.SerializeToString),
            "KvPut": unary(
                self._kv_put,
                request_deserializer=pb.KvPutRequest.FromString,
                response_serializer=pb.KvPutResponse.SerializeToString),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(self.SERVICE,
                                                  handlers),))
        if credentials is not None:
            bound = self._server.add_secure_port(
                f"{host}:{self.port}", credentials)
        else:
            bound = self._server.add_insecure_port(
                f"{host}:{self.port}")
        if bound == 0:
            raise OSError(
                f"gRPC bind failed on {host}:{self.port} (in use?)")
        self.port = bound
        self.host = host

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(grace)

    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    # -- entry CRUD ----------------------------------------------------------

    def _lookup_entry(self, req, ctx):
        try:
            e = self.fs.filer.find_entry(_join(req.directory, req.name))
        except NotFound:
            ctx.abort(grpc.StatusCode.NOT_FOUND,
                      f"{req.directory}/{req.name} not found")
        return pb.LookupDirectoryEntryResponse(entry=entry_to_pb(e))

    def _list_entries(self, req, ctx):
        last = req.startFromFileName
        inclusive = req.inclusiveStartFrom
        remaining = req.limit or (1 << 31)
        while remaining > 0 and ctx.is_active():
            page_size = min(remaining, 1024)
            page = self.fs.filer.list_entries(
                req.directory or "/", last, inclusive, page_size)
            if not page:
                return
            for e in page:
                if req.prefix and not e.name.startswith(req.prefix):
                    continue
                yield pb.ListEntriesResponse(entry=entry_to_pb(e))
                remaining -= 1
                if remaining <= 0:
                    return
            last, inclusive = page[-1].name, False
            if len(page) < page_size:
                return  # a SHORT page ends the directory — a full one
                # may hide prefix-filtered entries further on

    def _signed(self, signatures):
        return self.fs.filer.with_signatures(list(signatures)) \
            if signatures else _NullCtx()

    def _create_entry(self, req, ctx):
        entry = entry_from_pb(req.directory, req.entry)
        try:
            with self._signed(req.signatures):
                self.fs.filer.create_entry(entry, o_excl=req.o_excl)
        except FilerError as e:
            return pb.CreateEntryResponse(error=str(e))
        return pb.CreateEntryResponse()

    def _update_entry(self, req, ctx):
        entry = entry_from_pb(req.directory, req.entry)
        try:
            with self._signed(req.signatures):
                self.fs.filer.update_entry(entry)
        except (NotFound, FilerError) as e:
            ctx.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return pb.UpdateEntryResponse()

    def _append_to_entry(self, req, ctx):
        path = _join(req.directory, req.entry_name)
        try:
            e = self.fs.filer.find_entry(path).clone()
        except NotFound:
            # First append creates the file, like the reference
            # (filer_grpc_server.go AppendToEntry on ErrNotFound).
            e = Entry(path=path, attributes=Attributes(mode=0o644))
        offset = e.size()
        for c in req.chunks:
            e.chunks.append(FileChunk(
                file_id=c.file_id, offset=offset, size=c.size,
                mtime=c.mtime, etag=c.e_tag,
                cipher_key=c.cipher_key.hex() if c.cipher_key else ""))
            offset += c.size
        self.fs.filer.create_entry(e)
        return pb.AppendToEntryResponse()

    def _delete_entry(self, req, ctx):
        path = _join(req.directory, req.name)
        try:
            with self._signed(req.signatures):
                self.fs.filer.delete_entry(
                    path, recursive=req.is_recursive,
                    delete_chunks=req.is_delete_data)
        except NotFound:
            return pb.DeleteEntryResponse()  # idempotent, like the ref
        except FilerError as e:
            if req.ignore_recursive_error:
                return pb.DeleteEntryResponse()
            return pb.DeleteEntryResponse(error=str(e))
        return pb.DeleteEntryResponse()

    def _rename_entry(self, req, ctx):
        try:
            self.fs.filer.rename(_join(req.old_directory, req.old_name),
                                 _join(req.new_directory, req.new_name))
        except NotFound as e:
            ctx.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except FilerError as e:
            ctx.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return pb.AtomicRenameEntryResponse()

    # -- volume ops ----------------------------------------------------------

    def _assign_volume(self, req, ctx):
        from ..cluster import rpc as jrpc
        # TTL grammar has no seconds unit (volume_ttl.go m/h/d/w/M/y):
        # round seconds up to minutes like the reference SecondsToTTL.
        ttl = f"{-(-req.ttl_sec // 60)}m" if req.ttl_sec else ""
        try:
            out = self.fs.client.assign(
                count=req.count or 1, collection=req.collection,
                replication=req.replication or None, ttl=ttl,
                data_center=req.data_center)
        except jrpc.RpcError as e:
            return pb.AssignVolumeResponse(error=e.message)
        return pb.AssignVolumeResponse(
            file_id=out.get("fid", ""), url=out.get("url", ""),
            public_url=out.get("publicUrl", ""),
            count=out.get("count", 1), auth=out.get("auth", ""),
            collection=req.collection, replication=req.replication)

    def _lookup_volume(self, req, ctx):
        from ..cluster import rpc as jrpc
        resp = pb.LookupVolumeResponse()
        for vid_str in req.volume_ids:
            try:
                locs = self.fs.client.lookup(
                    int(vid_str.split(",")[0]), include_ec=True)
            except (jrpc.RpcError, ValueError):
                locs = []
            entry = resp.locations_map[vid_str]
            for loc in locs:
                entry.locations.add(
                    url=loc["url"],
                    public_url=loc.get("publicUrl", loc["url"]))
        return resp

    def _collection_list(self, req, ctx):
        out = self.fs.client._master_call("/col/list")
        resp = pb.CollectionListResponse()
        for name in out.get("collections", []):
            resp.collections.add(name=name)
        return resp

    def _delete_collection(self, req, ctx):
        from ..cluster import rpc as jrpc
        try:
            jrpc.call(f"{self.fs.client.master_url}/col/delete"
                      f"?collection={req.collection}", "POST")
        except jrpc.RpcError as e:
            if e.status != 404:
                ctx.abort(grpc.StatusCode.INTERNAL, e.message)
        return pb.DeleteCollectionResponse()

    def _statistics(self, req, ctx):
        # Aggregate from the master topology dump - the filer has
        # no volume state of its own (the reference filer proxies
        # its master the same way).
        used = files = count = 0
        limit = 0
        try:
            vl = self.fs.client._master_call("/vol/list")
            for dc in vl["topology"]["data_centers"]:
                for rack in dc["racks"]:
                    for n in rack["nodes"]:
                        for v in n["volumes"]:
                            if req.collection and \
                                    v.get("collection", "") != \
                                    req.collection:
                                continue
                            used += v["size"]
                            files += v["file_count"]
                            count += 1
            limit = vl.get("volume_size_limit", 0)
        except Exception:  # noqa: BLE001 - master down: zeros
            pass
        return pb.StatisticsResponse(
            replication=req.replication, collection=req.collection,
            ttl=req.ttl, total_size=count * limit, used_size=used,
            file_count=files)

    def _get_configuration(self, req, ctx):
        BUCKETS_PATH = "/buckets"  # filer_buckets.go DirBucketsPath
        return pb.GetFilerConfigurationResponse(
            masters=list(self.fs.client.masters),
            replication=self.fs.replication or "",
            collection=self.fs.collection,
            max_mb=self.fs.chunk_size >> 20,
            dir_buckets=BUCKETS_PATH,
            cipher=self.fs.cipher,
            signature=self.fs.filer.signature)

    # -- streams / misc ------------------------------------------------------

    def _subscribe_metadata(self, req, ctx):
        from ..filer.server import _MetaTail
        tail = _MetaTail(self.fs.filer, req.since_ns,
                         req.signature, req.path_prefix)
        buf = b""
        with tail:
            while ctx.is_active():
                piece = tail.read()
                if piece == b"":
                    return
                buf += piece
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    doc = json.loads(line)
                    if doc.get("_cursor_only"):
                        continue
                    ev = pb.EventNotification(
                        signatures=doc.get("signatures", []))
                    if doc.get("old_entry"):
                        old = Entry.from_dict(doc["old_entry"])
                        ev.old_entry.CopyFrom(entry_to_pb(old))
                    if doc.get("new_entry"):
                        new = Entry.from_dict(doc["new_entry"])
                        ev.new_entry.CopyFrom(entry_to_pb(new))
                    yield pb.SubscribeMetadataResponse(
                        directory=doc.get("directory", ""),
                        event_notification=ev,
                        ts_ns=doc.get("ts_ns", 0))

    def _keep_connected(self, request_iterator, ctx):
        for _req in request_iterator:
            yield pb.KeepConnectedResponse()

    def _locate_broker(self, req, ctx):
        # Broker placement lives in filer KV under the messaging
        # convention (messaging/broker consistent-hash registry).
        raw = self.fs.filer.store.kv_get(f"broker.{req.resource}")
        if raw:
            resp = pb.LocateBrokerResponse(found=True)
            resp.resources.add(grpc_addresses=raw.decode(),
                               resource_count=1)
            return resp
        return pb.LocateBrokerResponse(found=False)

    def _kv_get(self, req, ctx):
        value = self.fs.filer.store.kv_get(
            req.key.decode("utf-8", "surrogateescape"))
        if value is None:
            return pb.KvGetResponse(error="not found")
        return pb.KvGetResponse(value=value)

    def _kv_put(self, req, ctx):
        self.fs.filer.store.kv_put(
            req.key.decode("utf-8", "surrogateescape"), req.value)
        return pb.KvPutResponse()


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
