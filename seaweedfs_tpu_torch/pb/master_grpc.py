"""gRPC facade for the master: the reference's `Seaweed` service.

Reference: weed/server/master_grpc_server*.go + pb/master.proto.  Every
RPC bridges to the SAME handler/topology code the JSON/HTTP plane uses,
so the two planes can't drift; the gRPC port rides the reference's
convention of HTTP port + 10000 (pb/grpc_client_server.go
ParseServerToGrpcAddress).

Stubs are not generated (no grpcio-tools in the image): the service is
registered through grpc's generic-handler API with the protoc-generated
message classes, which is wire-identical.
"""

from __future__ import annotations

import json
from concurrent import futures

import grpc

from ..cluster import rpc as jrpc
from ..trace import tracer as _tracer
from . import master_pb2 as pb

GRPC_PORT_DELTA = 10_000  # grpc port = http port + 10000


def _begin_grpc_span(ctx, name: str):
    """Server span for one facade RPC: the gRPC plane bypasses the
    JsonHttpServer middleware, so the traceparent riding the invocation
    metadata (cluster/client._grpc_trace_metadata) is extracted here —
    the same contract as the HTTP header."""
    if not _tracer.recording_on():
        return None  # stock deployment: zero tracing cost (the HTTP
        #              middleware is gated the same way at setup)
    tp = ""
    try:
        for k, v in ctx.invocation_metadata() or ():
            if k == "traceparent":
                tp = v
                break
    except Exception:  # noqa: BLE001 — a trace must never fail an RPC
        pass
    return _tracer.begin_server_span("master", "GRPC", name, tp)


def _vinfo_dict(v: "pb.VolumeInformationMessage") -> dict:
    return {"id": v.id, "size": v.size, "collection": v.collection,
            "file_count": v.file_count, "delete_count": v.delete_count,
            "deleted_byte_count": v.deleted_byte_count,
            "read_only": v.read_only,
            "replica_placement": v.replica_placement,
            "version": v.version, "ttl": v.ttl,
            "compact_revision": v.compact_revision,
            "max_file_key": 0}


def _short_vinfo_dict(v) -> dict:
    return {"id": v.id, "collection": v.collection,
            "replica_placement": v.replica_placement,
            "version": v.version, "ttl": v.ttl}


class MasterGrpcServer:
    """Serves master_pb.Seaweed over a grpc.Server bridged to a
    MasterServer instance."""

    SERVICE = "master_pb.Seaweed"

    def __init__(self, master, host: str = "127.0.0.1",
                 port: int | None = None, max_workers: int = 16,
                 credentials=None):
        self.master = master
        self.port = port if port is not None \
            else master.server.port + GRPC_PORT_DELTA
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        unary = grpc.unary_unary_rpc_method_handler
        handlers = {
            "Assign": unary(
                self._assign,
                request_deserializer=pb.AssignRequest.FromString,
                response_serializer=pb.AssignResponse.SerializeToString),
            "LookupVolume": unary(
                self._lookup_volume,
                request_deserializer=pb.LookupVolumeRequest.FromString,
                response_serializer=(
                    pb.LookupVolumeResponse.SerializeToString)),
            "Statistics": unary(
                self._statistics,
                request_deserializer=pb.StatisticsRequest.FromString,
                response_serializer=(
                    pb.StatisticsResponse.SerializeToString)),
            "CollectionList": unary(
                self._collection_list,
                request_deserializer=pb.CollectionListRequest.FromString,
                response_serializer=(
                    pb.CollectionListResponse.SerializeToString)),
            "CollectionDelete": unary(
                self._collection_delete,
                request_deserializer=(
                    pb.CollectionDeleteRequest.FromString),
                response_serializer=(
                    pb.CollectionDeleteResponse.SerializeToString)),
            "VolumeList": unary(
                self._volume_list,
                request_deserializer=pb.VolumeListRequest.FromString,
                response_serializer=(
                    pb.VolumeListResponse.SerializeToString)),
            "LookupEcVolume": unary(
                self._lookup_ec_volume,
                request_deserializer=pb.LookupEcVolumeRequest.FromString,
                response_serializer=(
                    pb.LookupEcVolumeResponse.SerializeToString)),
            "GetMasterConfiguration": unary(
                self._get_configuration,
                request_deserializer=(
                    pb.GetMasterConfigurationRequest.FromString),
                response_serializer=(
                    pb.GetMasterConfigurationResponse.SerializeToString)),
            "ListMasterClients": unary(
                self._list_clients,
                request_deserializer=(
                    pb.ListMasterClientsRequest.FromString),
                response_serializer=(
                    pb.ListMasterClientsResponse.SerializeToString)),
            "LeaseAdminToken": unary(
                self._lease_admin_token,
                request_deserializer=pb.LeaseAdminTokenRequest.FromString,
                response_serializer=(
                    pb.LeaseAdminTokenResponse.SerializeToString)),
            "ReleaseAdminToken": unary(
                self._release_admin_token,
                request_deserializer=(
                    pb.ReleaseAdminTokenRequest.FromString),
                response_serializer=(
                    pb.ReleaseAdminTokenResponse.SerializeToString)),
            "SendHeartbeat": grpc.stream_stream_rpc_method_handler(
                self._send_heartbeat,
                request_deserializer=pb.Heartbeat.FromString,
                response_serializer=(
                    pb.HeartbeatResponse.SerializeToString)),
            "KeepConnected": grpc.stream_stream_rpc_method_handler(
                self._keep_connected,
                request_deserializer=pb.KeepConnectedRequest.FromString,
                response_serializer=pb.VolumeLocation.SerializeToString),
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

    # -- unary bridges -------------------------------------------------------

    def _assign(self, req: "pb.AssignRequest", ctx):
        query = {"count": str(req.count or 1)}
        if req.collection:
            query["collection"] = req.collection
        if req.replication:
            query["replication"] = req.replication
        if req.ttl:
            query["ttl"] = req.ttl
        if req.data_center:
            query["dataCenter"] = req.data_center
        if req.rack:
            query["rack"] = req.rack
        if req.data_node:
            query["dataNode"] = req.data_node
        span = _begin_grpc_span(ctx, "/master_pb.Seaweed/Assign")
        status = 200  # in-message errors must not trace as "ok"
        try:
            out = self.master._assign(query, b"")
        except jrpc.RpcError as e:
            status = e.status
            if e.status == 503:
                # Not the leader, or no leader yet: the JSON plane's 503
                # keeps its meaning as UNAVAILABLE, so a client rotates
                # to its next master seed (the reference flattens it
                # into an in-message error, which a client re-raises).
                ctx.abort(grpc.StatusCode.UNAVAILABLE, e.message)
            return pb.AssignResponse(error=e.message)
        except BaseException:
            status = 500  # span MUST end: grpc worker threads are
            raise         # pooled, a leaked span mis-parents later RPCs
        finally:
            _tracer.end_server_span(span, status)
        return pb.AssignResponse(
            fid=out.get("fid", ""), url=out.get("url", ""),
            public_url=out.get("publicUrl", ""),
            count=out.get("count", 1), auth=out.get("auth", ""))

    def _lookup_volume(self, req: "pb.LookupVolumeRequest", ctx):
        span = _begin_grpc_span(ctx, "/master_pb.Seaweed/LookupVolume")
        status = 200
        try:
            return self._lookup_volume_inner(req)
        except BaseException:
            status = 500
            raise
        finally:
            _tracer.end_server_span(span, status)

    def _lookup_volume_inner(self, req: "pb.LookupVolumeRequest"):
        resp = pb.LookupVolumeResponse()
        for vid_str in req.volume_ids:
            entry = resp.volume_id_locations.add(volume_id=vid_str)
            try:
                out = self.master._lookup(
                    {"volumeId": vid_str,
                     "collection": req.collection}, b"")
            except jrpc.RpcError as e:
                entry.error = e.message
                continue
            except ValueError as e:  # malformed id: per-entry error,
                entry.error = str(e)  # never a transport failure
                continue
            for loc in out.get("locations", []):
                entry.locations.add(url=loc["url"],
                                    public_url=loc.get("publicUrl", ""))
            if not out.get("locations") and out.get("ecShards"):
                # EC-only volumes answer through LookupEcVolume; the
                # plain lookup mirrors the reference's error here.
                entry.error = "volume is erasure coded"
        return resp

    def _statistics(self, req: "pb.StatisticsRequest", ctx):
        topo = self.master.topo
        used = files = count = 0
        with topo._lock:
            for dn in topo.leaves():
                for v in dn.volumes.values():
                    if req.collection and \
                            v.collection != req.collection:
                        continue
                    used += v.size
                    files += v.file_count
                    count += 1
        return pb.StatisticsResponse(
            replication=req.replication, collection=req.collection,
            ttl=req.ttl,
            total_size=count * topo.volume_size_limit,
            used_size=used, file_count=files)

    def _collection_list(self, req, ctx):
        out = self.master._col_list({}, b"")
        resp = pb.CollectionListResponse()
        for name in out.get("collections", []):
            resp.collections.add(name=name)
        return resp

    def _collection_delete(self, req, ctx):
        try:
            self.master._col_delete({"collection": req.name}, b"")
        except jrpc.RpcError as e:
            ctx.abort(grpc.StatusCode.NOT_FOUND, e.message)
        return pb.CollectionDeleteResponse()

    def _volume_list(self, req, ctx):
        out = self.master._vol_list({}, b"")
        topo_pb = pb.TopologyInfo(id="topo")
        for dc in out["topology"]["data_centers"]:
            dc_pb = topo_pb.data_center_infos.add(id=dc["id"])
            for rack in dc["racks"]:
                rack_pb = dc_pb.rack_infos.add(id=rack["id"])
                for n in rack["nodes"]:
                    dn_pb = rack_pb.data_node_infos.add(
                        id=n["url"],
                        volume_count=len(n["volumes"]),
                        max_volume_count=n["max_volume_count"])
                    for v in n["volumes"]:
                        dn_pb.volume_infos.add(
                            id=v["id"], size=v["size"],
                            collection=v.get("collection", ""),
                            file_count=v["file_count"],
                            delete_count=v.get("delete_count", 0),
                            deleted_byte_count=v.get(
                                "deleted_byte_count", 0),
                            read_only=v.get("read_only", False),
                            replica_placement=v.get(
                                "replica_placement", 0),
                            version=v.get("version", 3),
                            ttl=v.get("ttl", 0),
                            compact_revision=v.get(
                                "compact_revision", 0))
                    for e in n["ec_shards"]:
                        dn_pb.ec_shard_infos.add(
                            id=e["id"], ec_index_bits=e["shard_bits"])
        return pb.VolumeListResponse(
            topology_info=topo_pb,
            volume_size_limit_mb=out["volume_size_limit"] >> 20)

    def _lookup_ec_volume(self, req, ctx):
        try:
            out = self.master._lookup(
                {"volumeId": str(req.volume_id)}, b"")
        except jrpc.RpcError as e:
            ctx.abort(grpc.StatusCode.NOT_FOUND, e.message)
        if not out.get("ecShards"):
            # A plain replicated volume answers through LookupVolume;
            # OK-but-empty here would read as "all shards lost".
            ctx.abort(grpc.StatusCode.NOT_FOUND,
                      f"ec volume {req.volume_id} not found")
        resp = pb.LookupEcVolumeResponse(volume_id=req.volume_id)
        for sid, locs in sorted(out.get("ecShards", {}).items(),
                                key=lambda kv: int(kv[0])):
            entry = resp.shard_id_locations.add(shard_id=int(sid))
            for loc in locs:
                entry.locations.add(url=loc["url"],
                                    public_url=loc.get("publicUrl", ""))
        return resp

    def _get_configuration(self, req, ctx):
        return pb.GetMasterConfigurationResponse(
            default_replication=self.master.default_replication,
            leader=self.master.leader_url())

    def _list_clients(self, req, ctx):
        # Watcher streams are anonymous on the JSON plane: an honest
        # empty list beats fabricated "addresses" a ported filer would
        # try (and fail) to dial.
        return pb.ListMasterClientsResponse(grpc_addresses=[])

    def _lease_admin_token(self, req, ctx):
        body = json.dumps({"name": req.lock_name or "shell",
                           "token": req.previous_token or None}).encode()
        try:
            out = self.master._admin_lease({}, body)
        except jrpc.RpcError as e:
            ctx.abort(grpc.StatusCode.ABORTED, e.message)
        return pb.LeaseAdminTokenResponse(token=out["token"],
                                          lock_ts_ns=0)

    def _release_admin_token(self, req, ctx):
        self.master._admin_release(
            {}, json.dumps({"token": req.previous_token}).encode())
        return pb.ReleaseAdminTokenResponse()

    # -- streaming bridges ---------------------------------------------------

    def _send_heartbeat(self, request_iterator, ctx):
        """Bidi heartbeat: each pb.Heartbeat maps onto the exact dict
        the HTTP /heartbeat route ingests, so a gRPC volume server and
        a JSON one register identically."""
        last_max = 0  # per-stream capacity memory
        for hb in request_iterator:
            doc = {"ip": hb.ip, "port": hb.port,
                   "public_url": hb.public_url,
                   "data_center": hb.data_center or "DefaultDataCenter",
                   "rack": hb.rack or "DefaultRack"}
            # proto3's absent-field 0 must neither register a node that
            # can never host volumes nor RESET a capacity an earlier
            # message on this stream established (an omitted key makes
            # the JSON handler apply its default of 7).
            if hb.max_volume_count > 0:
                last_max = hb.max_volume_count
            if last_max > 0:
                doc["max_volume_count"] = last_max
            if hb.volumes or hb.has_no_volumes:
                doc["volumes"] = [_vinfo_dict(v) for v in hb.volumes]
            if hb.new_volumes or hb.deleted_volumes:
                doc["new_volumes"] = [_short_vinfo_dict(v)
                                      for v in hb.new_volumes]
                doc["deleted_volumes"] = [_short_vinfo_dict(v)
                                          for v in hb.deleted_volumes]
            if hb.ec_shards or hb.has_no_ec_shards:
                doc["ec_shards"] = [
                    {"id": e.id, "collection": e.collection,
                     "shard_bits": e.ec_index_bits}
                    for e in hb.ec_shards]
            for field, key in ((hb.new_ec_shards, "new_ec_shards"),
                               (hb.deleted_ec_shards,
                                "deleted_ec_shards")):
                if field:
                    doc[key] = [
                        {"id": e.id, "collection": e.collection,
                         "shard_bits": e.ec_index_bits}
                        for e in field]
            out = self.master._heartbeat({}, json.dumps(doc).encode())
            yield pb.HeartbeatResponse(
                volume_size_limit=out.get(
                    "volume_size_limit",
                    self.master.topo.volume_size_limit),
                leader=out.get("leader") or "")

    def _keep_connected(self, request_iterator, ctx):
        """Location push: bridges the JSON plane's /cluster/watch
        EventStream into VolumeLocation messages."""
        try:
            _status, stream, _hdrs = self.master._cluster_watch({}, b"")
        except jrpc.RpcError as e:
            ctx.abort(grpc.StatusCode.UNAVAILABLE, e.message)
            return
        # Tight keepalive tick: after server.stop() cancels the RPC the
        # handler is parked in stream.read() until the next tick, and
        # grpc's non-daemon workers hold process exit for that long.
        stream.heartbeat = 1.0
        with stream:
            while ctx.is_active():
                line = stream.read()
                if line == b"":
                    return  # stream ended (deposed leader / overflow)
                if line.strip() == b"":
                    continue  # keepalive
                doc = json.loads(line)
                yield pb.VolumeLocation(
                    url=doc.get("url", ""),
                    public_url=doc.get("public_url", ""),
                    new_vids=doc.get("new_vids", []),
                    deleted_vids=doc.get("deleted_vids", []),
                    leader=doc.get("leader", ""))
