"""gRPC facade for the volume server: the reference's `VolumeServer`
maintenance service.

Reference: weed/server/volume_grpc_*.go + pb/volume_server.proto.
Bridges to the same Store/handler code the JSON admin plane uses; gRPC
port = HTTP port + 10000 like the other planes.
"""

from __future__ import annotations

import json
import os
import time
from concurrent import futures

import grpc

from ..cluster import rpc as jrpc
from ..core import types as t
from . import volume_server_pb2 as pb

GRPC_PORT_DELTA = 10_000
_CHUNK = 1 << 20


def _get_json_path(doc, path: str):
    """Dotted-path lookup into a parsed JSON doc (the gjson subset the
    Query RPC's selections use)."""
    cur = doc
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur


def _filter_match(doc, field: str, op: str, value: str) -> bool:
    """query/json/query_json.go filterJson semantics: missing field
    fails, empty operand means existence, strings compare lexically
    ('%'/'!%' are wildcard matches), numbers compare as float64."""
    if not field:
        return True  # no filter at all
    got = _get_json_path(doc, field)
    if got is None:
        return False
    if not op:
        return True
    if isinstance(got, bool):
        want = value.lower() == "true"
        if op == "=":
            return got is want
        if op == "!=":
            return got is not want
        return False
    if isinstance(got, (int, float)):
        try:
            num = float(value)
        except ValueError:
            return False
        return {"=": got == num, "!=": got != num, "<": got < num,
                "<=": got <= num, ">": got > num,
                ">=": got >= num}.get(op, False)
    if isinstance(got, str):
        if op in ("%", "!%"):
            import fnmatch
            hit = fnmatch.fnmatchcase(got, value)
            return hit if op == "%" else not hit
        return {"=": got == value, "!=": got != value,
                "<": got < value, "<=": got <= value,
                ">": got > value, ">=": got >= value}.get(op, False)
    return False


class VolumeGrpcServer:
    """Serves volume_server_pb.VolumeServer bridged to a VolumeServer
    instance (the JSON-plane object)."""

    SERVICE = "volume_server_pb.VolumeServer"

    def __init__(self, volume_server, host: str = "127.0.0.1",
                 port: int | None = None, max_workers: int = 16,
                 credentials=None):
        self.vs = volume_server
        self.port = port if port is not None \
            else volume_server.server.port + GRPC_PORT_DELTA
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        unary = grpc.unary_unary_rpc_method_handler
        stream_out = grpc.unary_stream_rpc_method_handler
        spec = {
            "BatchDelete": (self._batch_delete,
                            pb.BatchDeleteRequest,
                            pb.BatchDeleteResponse),
            "VacuumVolumeCheck": (self._vacuum_check,
                                  pb.VacuumVolumeCheckRequest,
                                  pb.VacuumVolumeCheckResponse),
            "VacuumVolumeCompact": (self._vacuum_compact,
                                    pb.VacuumVolumeCompactRequest,
                                    pb.VacuumVolumeCompactResponse),
            "VacuumVolumeCommit": (self._vacuum_commit,
                                   pb.VacuumVolumeCommitRequest,
                                   pb.VacuumVolumeCommitResponse),
            "VacuumVolumeCleanup": (self._vacuum_cleanup,
                                    pb.VacuumVolumeCleanupRequest,
                                    pb.VacuumVolumeCleanupResponse),
            "DeleteCollection": (self._delete_collection,
                                 pb.DeleteCollectionRequest,
                                 pb.DeleteCollectionResponse),
            "AllocateVolume": (self._allocate_volume,
                               pb.AllocateVolumeRequest,
                               pb.AllocateVolumeResponse),
            "VolumeSyncStatus": (self._sync_status,
                                 pb.VolumeSyncStatusRequest,
                                 pb.VolumeSyncStatusResponse),
            "VolumeMount": (self._mount, pb.VolumeMountRequest,
                            pb.VolumeMountResponse),
            "VolumeUnmount": (self._unmount, pb.VolumeUnmountRequest,
                              pb.VolumeUnmountResponse),
            "VolumeDelete": (self._delete, pb.VolumeDeleteRequest,
                             pb.VolumeDeleteResponse),
            "VolumeMarkReadonly": (self._mark_readonly,
                                   pb.VolumeMarkReadonlyRequest,
                                   pb.VolumeMarkReadonlyResponse),
            "VolumeMarkWritable": (self._mark_writable,
                                   pb.VolumeMarkWritableRequest,
                                   pb.VolumeMarkWritableResponse),
            "VolumeConfigure": (self._configure,
                                pb.VolumeConfigureRequest,
                                pb.VolumeConfigureResponse),
            "VolumeStatus": (self._status, pb.VolumeStatusRequest,
                             pb.VolumeStatusResponse),
            "VolumeCopy": (self._volume_copy, pb.VolumeCopyRequest,
                           pb.VolumeCopyResponse),
            "ReadVolumeFileStatus": (self._file_status,
                                     pb.ReadVolumeFileStatusRequest,
                                     pb.ReadVolumeFileStatusResponse),
            "VolumeEcShardsGenerate": (
                self._ec_generate, pb.VolumeEcShardsGenerateRequest,
                pb.VolumeEcShardsGenerateResponse),
            "VolumeEcShardsRebuild": (
                self._ec_rebuild, pb.VolumeEcShardsRebuildRequest,
                pb.VolumeEcShardsRebuildResponse),
            "VolumeEcShardsCopy": (
                self._ec_copy, pb.VolumeEcShardsCopyRequest,
                pb.VolumeEcShardsCopyResponse),
            "VolumeEcShardsDelete": (
                self._ec_delete, pb.VolumeEcShardsDeleteRequest,
                pb.VolumeEcShardsDeleteResponse),
            "VolumeEcShardsMount": (
                self._ec_mount, pb.VolumeEcShardsMountRequest,
                pb.VolumeEcShardsMountResponse),
            "VolumeEcShardsUnmount": (
                self._ec_unmount, pb.VolumeEcShardsUnmountRequest,
                pb.VolumeEcShardsUnmountResponse),
            "VolumeEcBlobDelete": (
                self._ec_blob_delete, pb.VolumeEcBlobDeleteRequest,
                pb.VolumeEcBlobDeleteResponse),
            "VolumeEcShardsToVolume": (
                self._ec_to_volume, pb.VolumeEcShardsToVolumeRequest,
                pb.VolumeEcShardsToVolumeResponse),
            "VolumeServerStatus": (self._server_status,
                                   pb.VolumeServerStatusRequest,
                                   pb.VolumeServerStatusResponse),
            "VolumeServerLeave": (self._leave,
                                  pb.VolumeServerLeaveRequest,
                                  pb.VolumeServerLeaveResponse),
            "VolumeNeedleStatus": (self._needle_status,
                                   pb.VolumeNeedleStatusRequest,
                                   pb.VolumeNeedleStatusResponse),
        }
        handlers = {
            name: unary(impl, request_deserializer=req.FromString,
                        response_serializer=resp.SerializeToString)
            for name, (impl, req, resp) in spec.items()
        }
        streams = {
            "Query": (self._query, pb.QueryRequest, pb.QueriedStripe),
            "CopyFile": (self._copy_file, pb.CopyFileRequest,
                         pb.CopyFileResponse),
            "VolumeIncrementalCopy": (
                self._incremental_copy, pb.VolumeIncrementalCopyRequest,
                pb.VolumeIncrementalCopyResponse),
            "VolumeTailSender": (self._tail_sender,
                                 pb.VolumeTailSenderRequest,
                                 pb.VolumeTailSenderResponse),
            "VolumeEcShardRead": (self._ec_shard_read,
                                  pb.VolumeEcShardReadRequest,
                                  pb.VolumeEcShardReadResponse),
            "VolumeTierMoveDatToRemote": (
                self._tier_to_remote,
                pb.VolumeTierMoveDatToRemoteRequest,
                pb.VolumeTierMoveDatToRemoteResponse),
            "VolumeTierMoveDatFromRemote": (
                self._tier_from_remote,
                pb.VolumeTierMoveDatFromRemoteRequest,
                pb.VolumeTierMoveDatFromRemoteResponse),
        }
        for name, (impl, req, resp) in streams.items():
            handlers[name] = stream_out(
                impl, request_deserializer=req.FromString,
                response_serializer=resp.SerializeToString)
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

    # -- helpers -------------------------------------------------------------

    def _volume_or_abort(self, vid: int, ctx):
        v = self.vs.store.find_volume(vid)
        if v is None:
            ctx.abort(grpc.StatusCode.NOT_FOUND,
                      f"volume {vid} not on this server")
        return v

    def _call(self, handler, ctx, body: dict, query: dict | None = None):
        """Run a JSON-plane handler, mapping RpcError -> grpc status."""
        try:
            return handler(query or {},
                           json.dumps(body).encode())
        except jrpc.RpcError as e:
            code = {404: grpc.StatusCode.NOT_FOUND,
                    409: grpc.StatusCode.ALREADY_EXISTS,
                    400: grpc.StatusCode.INVALID_ARGUMENT,
                    403: grpc.StatusCode.PERMISSION_DENIED}.get(
                e.status, grpc.StatusCode.INTERNAL)
            ctx.abort(code, e.message)

    # -- needle / batch ops --------------------------------------------------

    def _batch_delete(self, req, ctx):
        resp = pb.BatchDeleteResponse()
        for fid in req.file_ids:
            r = resp.results.add(file_id=fid)
            try:
                vid, key, cookie = t.parse_file_id(fid)
                v = self.vs.store.find_volume(vid)
                if v is None:
                    r.status, r.error = 404, f"volume {vid} not here"
                    continue
                if not req.skip_cookie_check:
                    n = self.vs.store.read_needle(vid, key, cookie)
                    r.size = len(n.data)
                freed = self.vs.store.delete_needle(vid, key)
                r.status = 202
                r.size = r.size or freed
            except Exception as e:  # noqa: BLE001 — per-fid result
                r.status, r.error = 500, str(e)
        return resp

    def _needle_status(self, req, ctx):
        v = self._volume_or_abort(req.volume_id, ctx)
        hit = v.nm.get(req.needle_id)
        if hit is None:
            ctx.abort(grpc.StatusCode.NOT_FOUND,
                      f"needle {req.needle_id:x} not found")
        _offset, size = hit
        return pb.VolumeNeedleStatusResponse(
            needle_id=req.needle_id, size=size,
            last_modified=int(v.last_modified),
            ttl=str(v.super_block.ttl))

    # -- vacuum 4-step -------------------------------------------------------

    def _vacuum_check(self, req, ctx):
        v = self._volume_or_abort(req.volume_id, ctx)
        return pb.VacuumVolumeCheckResponse(
            garbage_ratio=v.garbage_ratio())

    def _vacuum_compact(self, req, ctx):
        # Staging state + guard live on the Volume (storage/vacuum.py),
        # so compacts from the JSON admin plane or CLI serialize with
        # this one instead of interleaving .cpd/.cpx writes; re-running
        # compact replaces a stale staged snapshot like the reference.
        from ..storage.vacuum import compact
        v = self._volume_or_abort(req.volume_id, ctx)
        compact(v)
        return pb.VacuumVolumeCompactResponse()

    def _vacuum_commit(self, req, ctx):
        from ..storage.vacuum import VacuumError, commit_compact
        v = self._volume_or_abort(req.volume_id, ctx)
        try:
            commit_compact(v)
        except VacuumError as e:
            ctx.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return pb.VacuumVolumeCommitResponse(is_read_only=v.readonly)

    def _vacuum_cleanup(self, req, ctx):
        from ..storage.vacuum import cleanup_compact
        v = self._volume_or_abort(req.volume_id, ctx)
        cleanup_compact(v)
        return pb.VacuumVolumeCleanupResponse()

    # -- volume lifecycle ----------------------------------------------------

    def _delete_collection(self, req, ctx):
        for loc in self.vs.store.locations:
            for vid, v in list(loc.volumes.items()):
                if v.collection == req.collection:
                    self.vs.store.delete_volume(vid)
        self.vs._send_heartbeat(full=True)
        return pb.DeleteCollectionResponse()

    def _allocate_volume(self, req, ctx):
        self._call(self.vs._admin_assign_volume, ctx,
                   {"volume": req.volume_id,
                    "collection": req.collection,
                    "replication": req.replication or "000",
                    "ttl": req.ttl})
        return pb.AllocateVolumeResponse()

    def _sync_status(self, req, ctx):
        v = self._volume_or_abort(req.volume_id, ctx)
        base = v.file_name()
        idx_size = os.path.getsize(base + ".idx") \
            if os.path.exists(base + ".idx") else 0
        return pb.VolumeSyncStatusResponse(
            volume_id=req.volume_id, collection=v.collection,
            replication=str(v.super_block.replica_placement),
            ttl=str(v.super_block.ttl), tail_offset=v.dat_size(),
            compact_revision=v.super_block.compaction_revision,
            idx_file_size=idx_size)

    def _mount(self, req, ctx):
        self._call(self.vs._admin_mount, ctx,
                   {"volume": req.volume_id})
        return pb.VolumeMountResponse()

    def _unmount(self, req, ctx):
        self._call(self.vs._admin_unmount, ctx,
                   {"volume": req.volume_id})
        return pb.VolumeUnmountResponse()

    def _delete(self, req, ctx):
        self._call(self.vs._admin_delete_volume, ctx,
                   {"volume": req.volume_id})
        return pb.VolumeDeleteResponse()

    def _mark_readonly(self, req, ctx):
        self._call(self.vs._admin_readonly, ctx,
                   {"volume": req.volume_id, "readonly": True})
        return pb.VolumeMarkReadonlyResponse()

    def _mark_writable(self, req, ctx):
        self._call(self.vs._admin_readonly, ctx,
                   {"volume": req.volume_id, "readonly": False})
        return pb.VolumeMarkWritableResponse()

    def _configure(self, req, ctx):
        try:
            self.vs.store.configure_volume(req.volume_id,
                                           req.replication)
            self.vs._send_heartbeat(full=True)
        except Exception as e:  # noqa: BLE001 — error-in-message shape
            return pb.VolumeConfigureResponse(error=str(e))
        return pb.VolumeConfigureResponse()

    def _status(self, req, ctx):
        v = self._volume_or_abort(req.volume_id, ctx)
        return pb.VolumeStatusResponse(is_read_only=v.readonly)

    def _volume_copy(self, req, ctx):
        self._call(self.vs._copy_volume, ctx,
                   {"volume": req.volume_id,
                    "source": req.source_data_node,
                    "collection": req.collection})
        v = self.vs.store.find_volume(req.volume_id)
        return pb.VolumeCopyResponse(
            last_append_at_ns=int(v.last_modified * 1e9) if v else 0)

    def _file_status(self, req, ctx):
        v = self._volume_or_abort(req.volume_id, ctx)
        base = v.file_name()

        def _stat(ext):
            try:
                st = os.stat(base + ext)
                return int(st.st_mtime), st.st_size
            except OSError:
                return 0, 0
        idx_ts, idx_size = _stat(".idx")
        dat_ts, dat_size = _stat(".dat")
        return pb.ReadVolumeFileStatusResponse(
            volume_id=req.volume_id,
            idx_file_timestamp_seconds=idx_ts, idx_file_size=idx_size,
            dat_file_timestamp_seconds=dat_ts, dat_file_size=dat_size,
            file_count=v.file_count(),
            compaction_revision=v.super_block.compaction_revision,
            collection=v.collection)

    # -- bulk streams --------------------------------------------------------

    def _query(self, req, ctx):
        """The Query RPC (pb/volume_server.proto:92,
        server/volume_grpc_query.go): for each file id, read the
        needle, filter its JSON lines by (field operand value), project
        the selections, and stream one QueriedStripe per file whose
        records are concatenated `{sel:raw,...}` objects — the
        reference's json.ToJson shape, selection names unquoted and
        values raw, kept byte-identical for wire parity.  (The
        reference leaves CSVInput unimplemented in this RPC; CSV rides
        the HTTP /query plane here too.)"""
        import json as _json

        from ..core import types as t
        selections = list(req.selections)
        flt = (req.filter.field, req.filter.operand, req.filter.value)
        for fid in req.from_file_ids:
            try:
                vid, key, cookie = t.parse_file_id(fid)
            except ValueError as e:
                ctx.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            v = self.vs.store.find_volume(vid)
            if v is None:
                ctx.abort(grpc.StatusCode.NOT_FOUND,
                          f"volume {vid} not on this server")
            try:
                n = self.vs.store.read_needle(vid, key, cookie)
            except Exception as e:  # noqa: BLE001 — not found / cookie
                ctx.abort(grpc.StatusCode.NOT_FOUND, str(e))
            records = bytearray()
            for line in n.data.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = _json.loads(line)
                except ValueError:
                    continue
                if not _filter_match(doc, *flt):
                    continue
                records += b"{"
                for i, sel in enumerate(selections):
                    if i:
                        records += b","
                    records += sel.encode() + b":"
                    val = _get_json_path(doc, sel)
                    records += _json.dumps(
                        val, separators=(",", ":")).encode()
                records += b"}"
            yield pb.QueriedStripe(records=bytes(records))

    def _copy_file(self, req, ctx):
        if req.is_ec_volume:
            base = self.vs._volume_base(req.volume_id)
        else:
            v = self.vs.store.find_volume(req.volume_id)
            base = v.file_name() if v is not None \
                else self.vs._volume_base(req.volume_id)
        path = base + req.ext
        if not os.path.exists(path):
            if req.ignore_source_file_not_found:
                return
            ctx.abort(grpc.StatusCode.NOT_FOUND, f"{path} not found")
        stop = req.stop_offset or (1 << 62)
        sent = 0
        with open(path, "rb") as f:
            while sent < stop and ctx.is_active():
                piece = f.read(min(_CHUNK, stop - sent))
                if not piece:
                    return
                yield pb.CopyFileResponse(file_content=piece)
                sent += len(piece)

    def _incremental_copy(self, req, ctx):
        from ..storage.volume_backup import read_incremental
        v = self._volume_or_abort(req.volume_id, ctx)
        blob = read_incremental(v, req.since_ns)
        for i in range(0, len(blob), _CHUNK):
            if not ctx.is_active():
                return
            yield pb.VolumeIncrementalCopyResponse(
                file_content=blob[i:i + _CHUNK])

    def _tail_sender(self, req, ctx):
        from ..storage.volume_backup import read_incremental
        v = self._volume_or_abort(req.volume_id, ctx)
        blob = read_incremental(v, req.since_ns)
        # Raw appended records ride needle_body; a consumer appends
        # them verbatim (the JSON plane's /admin/volume_tail serves the
        # same byte stream).
        for i in range(0, len(blob), _CHUNK):
            if not ctx.is_active():
                return
            last = i + _CHUNK >= len(blob)
            yield pb.VolumeTailSenderResponse(
                needle_body=blob[i:i + _CHUNK], is_last_chunk=last)
        if not blob:
            yield pb.VolumeTailSenderResponse(is_last_chunk=True)

    # -- erasure coding ------------------------------------------------------

    def _ec_generate(self, req, ctx):
        self._call(self.vs._ec_generate, ctx,
                   {"volume": req.volume_id,
                    "collection": req.collection})
        return pb.VolumeEcShardsGenerateResponse()

    def _ec_rebuild(self, req, ctx):
        out = self._call(self.vs._ec_rebuild, ctx,
                         {"volume": req.volume_id})
        return pb.VolumeEcShardsRebuildResponse(
            rebuilt_shard_ids=out.get("rebuilt_shards", []))

    def _ec_copy(self, req, ctx):
        self._call(self.vs._ec_copy_shard, ctx,
                   {"volume": req.volume_id,
                    "source": req.source_data_node,
                    "shards": list(req.shard_ids),
                    "copy_ecx": req.copy_ecx_file,
                    "copy_ecj": req.copy_ecj_file,
                    "copy_vif": req.copy_vif_file})
        return pb.VolumeEcShardsCopyResponse()

    def _ec_delete(self, req, ctx):
        self._call(self.vs._ec_delete_shards, ctx,
                   {"volume": req.volume_id,
                    "shards": list(req.shard_ids)})
        return pb.VolumeEcShardsDeleteResponse()

    def _ec_mount(self, req, ctx):
        self._call(self.vs._ec_mount, ctx, {"volume": req.volume_id})
        return pb.VolumeEcShardsMountResponse()

    def _ec_unmount(self, req, ctx):
        self._call(self.vs._ec_unmount, ctx, {"volume": req.volume_id})
        return pb.VolumeEcShardsUnmountResponse()

    def _ec_shard_read(self, req, ctx):
        ev = self.vs.ec_volumes.get(req.volume_id)
        if ev is None or req.shard_id not in ev.shards:
            ctx.abort(grpc.StatusCode.NOT_FOUND,
                      f"shard {req.volume_id}.{req.shard_id} not here")
        shard = ev.shards[req.shard_id]
        remaining = req.size
        offset = req.offset
        while remaining > 0 and ctx.is_active():
            piece = shard.read_at(offset, min(_CHUNK, remaining))
            if not piece:
                return
            yield pb.VolumeEcShardReadResponse(data=piece)
            offset += len(piece)
            remaining -= len(piece)

    def _ec_blob_delete(self, req, ctx):
        ev = self.vs.ec_volumes.get(req.volume_id)
        if ev is None:
            ctx.abort(grpc.StatusCode.NOT_FOUND,
                      f"ec volume {req.volume_id} not here")
        ev.delete_needle(req.file_key)
        return pb.VolumeEcBlobDeleteResponse()

    def _ec_to_volume(self, req, ctx):
        self._call(self.vs._ec_to_volume, ctx,
                   {"volume": req.volume_id,
                    "collection": req.collection})
        return pb.VolumeEcShardsToVolumeResponse()

    # -- tiering / status ----------------------------------------------------

    def _tier_to_remote(self, req, ctx):
        out = self._call(self.vs._tier_upload, ctx,
                         {"volume": req.volume_id,
                          "dest": req.destination_backend_name,
                          "keep_local": req.keep_local_dat_file})
        remote = out.get("remote", {})
        yield pb.VolumeTierMoveDatToRemoteResponse(
            processed=remote.get("file_size", 0),
            processedPercentage=100.0)

    def _tier_from_remote(self, req, ctx):
        self._call(self.vs._tier_download, ctx,
                   {"volume": req.volume_id,
                    "keep_remote": req.keep_remote_dat_file})
        v = self.vs.store.find_volume(req.volume_id)
        yield pb.VolumeTierMoveDatFromRemoteResponse(
            processed=v.dat_size() if v else 0,
            processedPercentage=100.0)

    def _server_status(self, req, ctx):
        from ..stats.sysstats import disk_status, memory_status
        resp = pb.VolumeServerStatusResponse()
        for loc in self.vs.store.locations:
            d = disk_status(loc.directory)
            resp.disk_statuses.add(
                dir=d["dir"], all=d["all"], used=d["used"],
                free=d["free"], percent_free=d["percent_free"],
                percent_used=d["percent_used"])
        m = memory_status()
        resp.memory_status.CopyFrom(pb.MemStatus(
            all=m.get("vms", 0), used=m.get("rss", 0),
            self=m.get("rss", 0)))
        return resp

    def _leave(self, req, ctx):
        self._call(self.vs._admin_leave, ctx, {})
        return pb.VolumeServerLeaveResponse()
