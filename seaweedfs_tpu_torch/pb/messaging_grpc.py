"""gRPC facade for the messaging broker: the reference's
`SeaweedMessaging` service.

Reference: weed/messaging/broker/broker_grpc_server*.go +
pb/messaging.proto.  Bridges onto the same topic logs / consistent-hash
placement the HTTP plane uses; port = HTTP port + 10000.
"""

from __future__ import annotations

import json
import time
from concurrent import futures

import grpc

from ..cluster import rpc as jrpc
from . import messaging_pb2 as pb

GRPC_PORT_DELTA = 10_000


def _status_of(e: "jrpc.RpcError"):
    return {404: grpc.StatusCode.NOT_FOUND,
            409: grpc.StatusCode.ALREADY_EXISTS,
            400: grpc.StatusCode.INVALID_ARGUMENT}.get(
        e.status, grpc.StatusCode.INTERNAL)


class MessagingGrpcServer:
    """Serves messaging_pb.SeaweedMessaging bridged to a
    MessageBroker."""

    SERVICE = "messaging_pb.SeaweedMessaging"

    # Streams hold a worker for their whole life (unlike the
    # unary-dominated master/filer planes), so the pool must exceed the
    # expected live subscriber count or unary config RPCs starve.
    def __init__(self, broker, host: str = "127.0.0.1",
                 port: int | None = None, max_workers: int = 64,
                 credentials=None):
        self.broker = broker
        self.port = port if port is not None \
            else broker.server.port + GRPC_PORT_DELTA
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        unary = grpc.unary_unary_rpc_method_handler
        handlers = {
            "DeleteTopic": unary(
                self._delete_topic,
                request_deserializer=pb.DeleteTopicRequest.FromString,
                response_serializer=(
                    pb.DeleteTopicResponse.SerializeToString)),
            "ConfigureTopic": unary(
                self._configure_topic,
                request_deserializer=(
                    pb.ConfigureTopicRequest.FromString),
                response_serializer=(
                    pb.ConfigureTopicResponse.SerializeToString)),
            "GetTopicConfiguration": unary(
                self._get_configuration,
                request_deserializer=(
                    pb.GetTopicConfigurationRequest.FromString),
                response_serializer=(
                    pb.GetTopicConfigurationResponse.SerializeToString)),
            "FindBroker": unary(
                self._find_broker,
                request_deserializer=pb.FindBrokerRequest.FromString,
                response_serializer=(
                    pb.FindBrokerResponse.SerializeToString)),
            "Publish": grpc.stream_stream_rpc_method_handler(
                self._publish,
                request_deserializer=pb.PublishRequest.FromString,
                response_serializer=(
                    pb.PublishResponse.SerializeToString)),
            "Subscribe": grpc.stream_stream_rpc_method_handler(
                self._subscribe,
                request_deserializer=pb.SubscriberMessage.FromString,
                response_serializer=(
                    pb.BrokerMessage.SerializeToString)),
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

    # -- topic config --------------------------------------------------------

    def _configure_topic(self, req, ctx):
        self._bridge(ctx, self.broker._configure, json.dumps(
            {"namespace": req.namespace, "topic": req.topic,
             "partition_count":
             req.configuration.partition_count or 4}).encode())
        return pb.ConfigureTopicResponse()

    def _bridge(self, ctx, handler, body: bytes):
        try:
            return handler({}, body)
        except jrpc.RpcError as e:
            ctx.abort(_status_of(e), e.message)

    def _get_configuration(self, req, ctx):
        try:
            cfg = self.broker._load_config(req.namespace, req.topic)
        except jrpc.RpcError as e:
            ctx.abort(_status_of(e), e.message)
        return pb.GetTopicConfigurationResponse(
            configuration=pb.TopicConfiguration(
                partition_count=cfg["partition_count"]))

    def _delete_topic(self, req, ctx):
        self._bridge(ctx, self.broker._delete_topic, json.dumps(
            {"namespace": req.namespace, "topic": req.topic}).encode())
        return pb.DeleteTopicResponse()

    def _find_broker(self, req, ctx):
        owner = self.broker._owner_of(req.namespace, req.topic,
                                      req.parition)
        return pb.FindBrokerResponse(broker=owner or self.broker.url())

    # -- streams -------------------------------------------------------------

    def _publish(self, request_iterator, ctx):
        """Bidi publish: init names the topic/partition, each data
        message appends to the partition log; wrong-owner partitions
        redirect (broker_grpc_server_publish.go)."""
        ns = topic = None
        partition = 0
        for req in request_iterator:
            if req.HasField("init"):
                ns, topic = req.init.namespace, req.init.topic
                partition = req.init.partition
                try:
                    cfg = self.broker._load_config(ns, topic)
                except jrpc.RpcError as e:
                    ctx.abort(_status_of(e), e.message)
                owner = self.broker._owner_of(ns, topic, partition)
                if owner and owner != self.broker.url():
                    yield pb.PublishResponse(
                        redirect=pb.PublishResponse.RedirectMessage(
                            new_broker=owner))
                    return
                yield pb.PublishResponse(
                    config=pb.PublishResponse.ConfigMessage(
                        partition_count=cfg["partition_count"]))
                continue
            if req.data.is_close:
                yield pb.PublishResponse(is_closed=True)
                return
            if ns is None:
                ctx.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "publish before init")
            log = self.broker._log(ns, topic, partition)
            log.append(
                req.data.key.decode("utf-8", "surrogateescape"),
                bytes(req.data.value),
                {k: v.decode("utf-8", "surrogateescape")
                 for k, v in req.data.headers.items()} or None)

    def _subscribe(self, request_iterator, ctx):
        """Bidi subscribe: init picks the start position, then the
        stream polls the partition log and pushes messages; acks are
        accepted and ignored (the poll cursor is positional, like the
        HTTP plane's since_ns)."""
        init = None
        for req in request_iterator:
            if req.HasField("init"):
                init = req.init
                break
            if req.is_close:
                return
        if init is None:
            return
        # Keep draining the request stream in the background so a
        # client's is_close (or acks) are seen while we poll the log.
        import threading
        closed = threading.Event()

        def drain():
            try:
                for req2 in request_iterator:
                    if req2.is_close:
                        closed.set()
                        return
            except Exception:  # noqa: BLE001 — client gone
                closed.set()

        threading.Thread(target=drain, daemon=True).start()
        owner = self.broker._owner_of(init.namespace, init.topic,
                                      init.partition)
        if owner and owner != self.broker.url():
            ctx.abort(grpc.StatusCode.FAILED_PRECONDITION,
                      f"partition owned by {owner}")
        log = self.broker._log(init.namespace, init.topic,
                               init.partition)
        SP = pb.SubscriberMessage.InitMessage
        if init.startPosition == SP.EARLIEST:
            cursor = 0
        elif init.startPosition == SP.TIMESTAMP:
            cursor = init.timestampNs
        else:  # LATEST
            cursor = log.last_ts_ns()
        while ctx.is_active() and not closed.is_set():
            if log.last_ts_ns() <= cursor:
                # Idle guard: last_ts_ns is memoized, read_since is a
                # filer directory scan — never poll storage while the
                # partition has nothing new.
                time.sleep(0.05)
                continue
            msgs = log.read_since(cursor, 1000)
            if not msgs:
                time.sleep(0.05)
                continue
            for m in msgs:
                value = m["value"]
                if isinstance(value, str):
                    value = value.encode()
                elif not isinstance(value, (bytes, bytearray)):
                    # HTTP publishers may send any JSON value; bytes()
                    # would corrupt ints and crash on lists/dicts.
                    value = json.dumps(value).encode()
                key = m.get("key", "")
                out = pb.Message(
                    event_time_ns=m["ts_ns"],
                    key=key.encode("utf-8", "surrogateescape")
                    if isinstance(key, str) else bytes(key),
                    value=bytes(value))
                for hk, hv in (m.get("headers") or {}).items():
                    out.headers[hk] = hv.encode() \
                        if isinstance(hv, str) else bytes(hv)
                yield pb.BrokerMessage(data=out)
                cursor = m["ts_ns"]
