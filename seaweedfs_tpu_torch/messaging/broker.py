"""Message broker server.

Reference: weed/messaging/broker/broker_server.go (MessageBroker),
broker_grpc_server_publish.go / _subscribe.go (the 6 SeaweedMessaging
RPCs, pb/messaging.proto:11-29), topic_manager.go.  Broker liveness
rides the filer: each broker registers itself under
/topics/.system/brokers/ and FindBroker consistent-hashes the live set.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time

from ..cluster import rpc
from ..filer.client import FilerProxy
from .consistent_hash import HashRing
from .topic_log import TopicPartitionLog, partition_dir

BROKER_DIR = "/topics/.system/brokers"
LIVENESS_TTL = 10.0


class MessageBroker:
    def __init__(self, filer_url: str, host: str = "127.0.0.1",
                 port: int = 0, register_interval: float = 3.0,
                 ssl_context=None):
        self.filer = FilerProxy(filer_url)
        self.server = rpc.JsonHttpServer(host, port,
                                         ssl_context=ssl_context)
        self.register_interval = register_interval
        self._logs: dict[tuple[str, str, int], TopicPartitionLog] = {}
        self._lock = threading.Lock()
        # Hot-path caches: publish/fetch would otherwise hit the filer
        # N+1 times per message (config GET + registry list + one GET
        # per broker).  Both TTLs sit well under LIVENESS_TTL.
        self._config_cache: dict[tuple[str, str],
                                 tuple[float, dict]] = {}
        self._ring_cache: tuple[float, dict[str, str]] | None = None
        self._stop = threading.Event()
        s = self.server
        s.route("POST", "/topics/configure", self._configure)
        s.route("POST", "/topics/delete", self._delete_topic)
        s.route("GET", "/topics/config", self._get_config)
        s.route("POST", "/publish", self._publish)
        s.route("GET", "/subscribe", self._subscribe)
        s.route("GET", "/find_broker", self._find_broker)
        s.route("GET", "/status", self._status)
        self._register_thread = threading.Thread(
            target=self._register_loop, daemon=True,
            name="broker-register")
        self._flush_thread = threading.Thread(
            target=self._flush_loop, daemon=True, name="broker-flush")

    # -- lifecycle -----------------------------------------------------------

    def _flush_loop(self) -> None:
        """Persist aged partition tails (log_buffer's interval flush)."""
        while not self._stop.wait(1.0):
            with self._lock:
                logs = list(self._logs.values())
            for log in logs:
                try:
                    log.maybe_flush()
                except Exception:  # noqa: BLE001 — filer hiccup; the
                    pass           # tail stays buffered for next tick

    def start(self) -> None:
        self.server.start()
        self._register_once()
        self._register_thread.start()
        self._flush_thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            logs = list(self._logs.values())
        for log in logs:
            try:
                log.flush()
            except Exception:  # noqa: BLE001 — shutdown best effort
                pass
        try:
            self.filer.delete(f"{BROKER_DIR}/{self._id()}")
        except Exception:  # noqa: BLE001
            pass
        self.server.stop()

    def url(self) -> str:
        return self.server.url()

    def _id(self) -> str:
        return f"{self.server.host}:{self.server.port}"

    # -- broker registry (LocateBroker / KeepConnected analog) ---------------

    def _register_once(self) -> None:
        self.filer.put(f"{BROKER_DIR}/{self._id()}",
                       json.dumps({"url": self.url(),
                                   "ts": time.time()}).encode(),
                       "application/json")

    def _register_loop(self) -> None:
        while not self._stop.wait(self.register_interval):
            try:
                self._register_once()
            except Exception:  # noqa: BLE001 — filer down; retry
                pass

    def live_brokers(self) -> dict[str, str]:
        """id -> url for brokers whose registration is fresh (cached
        ~1s so placement checks stay off the filer hot path)."""
        with self._lock:
            cached = self._ring_cache
        if cached is not None and time.monotonic() - cached[0] < 1.0:
            return cached[1]
        out = self._scan_live_brokers()
        with self._lock:
            self._ring_cache = (time.monotonic(), out)
        return out

    def _scan_live_brokers(self) -> dict[str, str]:
        out: dict[str, str] = {}
        now = time.time()
        for e in self.filer.list_all(BROKER_DIR):
            try:
                with self.filer.get(f"{BROKER_DIR}/{e['name']}") as r:
                    d = json.loads(r.read())
                if now - d.get("ts", 0) <= LIVENESS_TTL:
                    out[e["name"]] = d["url"]
            except Exception:  # noqa: BLE001 — racing dereg
                continue
        return out

    # -- topic config (ConfigureTopic / GetTopicConfiguration) ---------------

    @staticmethod
    def _config_path(namespace: str, topic: str) -> str:
        return f"/topics/{namespace}/{topic}/.config"

    def _configure(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        ns, topic = req["namespace"], req["topic"]
        cfg = {"namespace": ns, "topic": topic,
               "partition_count": int(req.get("partition_count", 4))}
        self.filer.put(self._config_path(ns, topic),
                       json.dumps(cfg).encode(), "application/json")
        with self._lock:
            self._config_cache.pop((ns, topic), None)
        return cfg

    def _load_config(self, ns: str, topic: str) -> dict:
        with self._lock:
            hit = self._config_cache.get((ns, topic))
        if hit is not None and time.monotonic() - hit[0] < 5.0:
            return hit[1]
        try:
            with self.filer.get(self._config_path(ns, topic)) as r:
                cfg = json.loads(r.read())
        except Exception:  # noqa: BLE001
            raise rpc.RpcError(
                404, f"topic {ns}/{topic} not configured") from None
        with self._lock:
            self._config_cache[(ns, topic)] = (time.monotonic(), cfg)
        return cfg

    def _get_config(self, query: dict, body: bytes) -> dict:
        return self._load_config(query["namespace"], query["topic"])

    def _delete_topic(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        ns, topic = req["namespace"], req["topic"]
        with self._lock:
            for key in [k for k in self._logs
                        if k[0] == ns and k[1] == topic]:
                del self._logs[key]
            self._config_cache.pop((ns, topic), None)
        self.filer.delete(f"/topics/{ns}/{topic}", recursive=True)
        return {"deleted": f"{ns}/{topic}"}

    # -- publish / subscribe -------------------------------------------------

    def _log(self, ns: str, topic: str, partition: int
             ) -> TopicPartitionLog:
        with self._lock:
            key = (ns, topic, partition)
            log = self._logs.get(key)
            if log is None:
                log = TopicPartitionLog(self.filer, ns, topic, partition)
                self._logs[key] = log
            return log

    def _partition_of(self, key: str, count: int) -> int:
        if not key:
            return int(time.time_ns()) % count
        return int.from_bytes(
            hashlib.md5(key.encode()).digest()[:4], "big") % count

    def _publish(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        ns, topic = req["namespace"], req["topic"]
        cfg = self._load_config(ns, topic)
        key = req.get("key", "")
        partition = req.get("partition")
        if partition is None:
            partition = self._partition_of(key,
                                           cfg["partition_count"])
        owner = self._owner_of(ns, topic, partition)
        if owner and owner != self.url():
            # Not this broker's partition: redirect the producer
            # (broker_grpc_server_publish.go redirects via broker list).
            return {"redirect": owner, "partition": partition}
        value = req.get("value", "")
        if req.get("value_b64"):
            import base64
            value = base64.b64decode(value)
        ts = self._log(ns, topic, partition).append(
            key, value, req.get("headers"))
        return {"partition": partition, "ts_ns": ts}

    def _subscribe(self, query: dict, body: bytes) -> dict:
        ns, topic = query["namespace"], query["topic"]
        partition = int(query.get("partition", 0))
        since = int(query.get("since_ns", 0))
        limit = int(query.get("limit", 1000))
        owner = self._owner_of(ns, topic, partition)
        if owner and owner != self.url():
            return {"redirect": owner, "partition": partition}
        log = self._log(ns, topic, partition)
        # Snapshot the head BEFORE scanning: a message appended mid-scan
        # must not advance the cursor past itself unseen.
        head = log.last_ts_ns()
        msgs = log.read_since(since, limit)
        out = []
        for m in msgs:
            v = m["value"]
            if isinstance(v, (bytes, bytearray)):
                import base64
                m = dict(m)
                m["value"] = base64.b64encode(bytes(v)).decode()
                m["value_b64"] = True
            out.append(m)
        return {"messages": out,
                "last_ns": msgs[-1]["ts_ns"] if msgs else
                max(since, head)}

    # -- placement (FindBroker) ----------------------------------------------

    def _owner_of(self, ns: str, topic: str, partition: int
                  ) -> str | None:
        brokers = self.live_brokers()
        if not brokers:
            return None
        ring = HashRing(sorted(brokers.values()))
        return ring.locate(f"{ns}/{topic}/{partition}")

    def _find_broker(self, query: dict, body: bytes) -> dict:
        ns, topic = query["namespace"], query["topic"]
        partition = int(query.get("partition", 0))
        owner = self._owner_of(ns, topic, partition)
        if owner is None:
            raise rpc.RpcError(503, "no live brokers")
        return {"broker": owner, "partition": partition}

    def _status(self, query: dict, body: bytes) -> dict:
        return {"id": self._id(), "brokers": self.live_brokers(),
                "local_partitions": [
                    {"namespace": k[0], "topic": k[1], "partition": k[2]}
                    for k in self._logs]}
