"""Notification queues: the input side of one-way replication.

Reference: weed/notification/ (pluggable message queues — kafka, AWS SQS,
GCP Pub/Sub, gocdk) feeding weed/replication/sub/.  The filer publishes
every meta event to the configured queue; `filer.replicate` consumes the
queue and drives sinks.

The in-process MemoryQueue and the durable FileQueue (JSONL spool,
resumable by offset) are always available; SqsQueue speaks the real AWS
SQS query API with stdlib HTTP + the in-repo sig v4 signer (no SDK —
weed/notification/aws_sqs/aws_sqs_pub.go), KafkaQueue (kafka.py)
speaks the Kafka wire protocol directly over TCP, and PubSubQueue
(pubsub.py) speaks the Pub/Sub REST API with RS256 service-account
auth from libcrypto — all three broker queues are real.  gocdk, the
reference's Go-Cloud-Development-Kit portability shim over those same
brokers, stays a registry stub (it is Go-ecosystem glue, not a broker).
"""

from __future__ import annotations

import json
import os
import queue as _queue
import threading
import time
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Callable


class NotificationQueue:
    def publish(self, key: str, message: dict) -> None:
        raise NotImplementedError

    def consume(self, fn: Callable[[str, dict], None]) -> None:
        """Deliver queued messages to fn(key, message); returns when the
        queue is drained (poll-style consumption)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryQueue(NotificationQueue):
    def __init__(self) -> None:
        self._items: list[tuple[str, dict]] = []
        self._lock = threading.Lock()

    def publish(self, key: str, message: dict) -> None:
        with self._lock:
            self._items.append((key, message))

    def consume(self, fn: Callable[[str, dict], None]) -> None:
        while True:
            with self._lock:
                if not self._items:
                    return
                key, msg = self._items.pop(0)
            fn(key, msg)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class FileQueue(NotificationQueue):
    """Durable JSONL spool with a persisted consumer offset — survives
    producer/consumer restarts, like an SQS queue with checkpointing."""

    def __init__(self, path: str):
        self.path = path
        self.offset_path = path + ".offset"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()

    def publish(self, key: str, message: dict) -> None:
        line = json.dumps({"key": key, "message": message},
                          separators=(",", ":")) + "\n"
        with self._lock, open(self.path, "a") as f:
            f.write(line)
            f.flush()

    def _offset(self) -> int:
        try:
            with open(self.offset_path) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def consume(self, fn: Callable[[str, dict], None]) -> None:
        if not os.path.exists(self.path):
            return
        pos = self._offset()
        with open(self.path) as f:
            f.seek(pos)
            while True:
                line = f.readline()
                if not line:
                    break
                if not line.endswith("\n"):
                    break  # partial write; retry next consume
                try:
                    item = json.loads(line)
                except json.JSONDecodeError:
                    continue
                fn(item["key"], item["message"])
                pos = f.tell()
                # Checkpoint after each successful delivery: at-least-
                # once on crash, never skipping an undelivered message.
                with open(self.offset_path, "w") as of:
                    of.write(str(pos))


def _xml_findall(root, tag: str):
    """Namespace-agnostic element search (SQS responses carry the
    doc namespace; a fake test endpoint may not)."""
    return [el for el in root.iter() if el.tag.split("}")[-1] == tag]



class _SendSpool:
    """Bounded in-order send spool drained by one daemon thread.

    publish() must never block the caller on the network: the filer
    publishes under its meta-log lock, so a slow endpoint would stall
    every namespace mutation.  Past the bound, events are dropped (with
    a counter) rather than backpressuring the filer — the durable
    FileQueue is the right choice when loss is unacceptable.

    close() is terminal: the sender drains-and-discards whatever
    remains and exits within ~1s (a sentinel would block put() forever
    on a full spool), and later put()s are counted as dropped.  Every
    get() is matched by task_done(), so flush()'s join() can never
    deadlock — including flush() after close().
    """

    MAX = 65536

    def __init__(self, send: Callable, name: str, maxsize: int = MAX):
        self._send = send
        self._name = name
        self.dropped = 0
        self._q: "_queue.Queue" = _queue.Queue(maxsize=maxsize)
        self._sender: threading.Thread | None = None
        self._lock = threading.Lock()
        self._closed = threading.Event()

    def put(self, item) -> None:
        if self._closed.is_set():
            self.dropped += 1  # closed is terminal: drop, don't
            return             # respawn a sender per late event
        self._ensure_sender()
        try:
            self._q.put_nowait(item)
        except _queue.Full:
            self.dropped += 1

    def _ensure_sender(self) -> None:
        with self._lock:
            if self._sender is None or not self._sender.is_alive():
                self._sender = threading.Thread(
                    target=self._loop, daemon=True, name=self._name)
                self._sender.start()

    def _loop(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=1.0)
            except _queue.Empty:
                if self._closed.is_set():
                    return
                continue
            try:
                if self._closed.is_set():
                    # close() already gave up waiting: discard instead
                    # of spending up to 70s per event on a dead
                    # endpoint, so the thread (and the spool it pins)
                    # actually terminates.
                    self.dropped += 1
                else:
                    self._send(item)
            except Exception:  # noqa: BLE001 — a dead endpoint drops
                self.dropped += 1  # the event; never wedges the loop
            finally:
                self._q.task_done()

    def flush(self, timeout: float | None = None) -> None:
        """Block until every spooled publish has been attempted (tests,
        graceful shutdown).  `timeout` bounds the wait.

        Waits on the queue's all_tasks_done condition directly instead
        of spawning a join() helper thread: a timed-out flush must not
        pin a thread (plus the spool it references) until the sends
        eventually finish — which on a dead endpoint is never."""
        q = self._q
        with q.all_tasks_done:
            if timeout is None:
                while q.unfinished_tasks:
                    q.all_tasks_done.wait()
                return
            deadline = time.monotonic() + timeout
            while q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                q.all_tasks_done.wait(remaining)

    def close(self) -> None:
        if self._sender is not None and self._sender.is_alive():
            self.flush(timeout=5.0)
        self._closed.set()


class SqsQueue(NotificationQueue):
    """AWS SQS over its HTTP query API — stdlib urllib + the in-repo
    sig v4 signer, no SDK (weed/notification/aws_sqs).

    Messages carry the same JSON envelope as FileQueue:
    {"key": ..., "message": ...} so the replicate worker is
    queue-agnostic.  consume() drains with short-poll ReceiveMessage
    batches and deletes each message only after fn() returns —
    at-least-once, like the reference's sqs consumer."""

    API_VERSION = "2012-11-05"

    def __init__(self, queue_url: str, access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1",
                 wait_seconds: int = 0):
        self.queue_url = queue_url.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.wait_seconds = wait_seconds
        self._spool = _SendSpool(self._call, "sqs-sender")

    @property
    def dropped(self) -> int:
        return self._spool.dropped

    def _call(self, params: dict) -> ET.Element:
        body = urllib.parse.urlencode(
            {**params, "Version": self.API_VERSION}).encode()
        headers = {"Content-Type":
                   "application/x-www-form-urlencoded"}
        if self.access_key:
            from ..s3api.sigv4 import sign_request
            headers = sign_request("POST", self.queue_url, headers,
                                   body, self.access_key,
                                   self.secret_key, region=self.region,
                                   service="sqs")
        req = urllib.request.Request(self.queue_url, data=body,
                                     method="POST", headers=headers)
        with urllib.request.urlopen(req, timeout=70) as resp:
            return ET.fromstring(resp.read() or b"<empty/>")

    def publish(self, key: str, message: dict) -> None:
        self._spool.put({
            "Action": "SendMessage",
            "MessageBody": json.dumps({"key": key, "message": message},
                                      separators=(",", ":"))})

    def flush(self, timeout: float | None = None) -> None:
        self._spool.flush(timeout)

    def close(self) -> None:
        self._spool.close()

    def consume(self, fn: Callable[[str, dict], None]) -> None:
        # Short polling (wait_seconds=0) samples a subset of SQS
        # backend hosts and can return empty while messages remain, so
        # "drained" needs consecutive empty receives; one empty long
        # poll is already authoritative.
        drained_after = 1 if self.wait_seconds > 0 else 3
        empty = 0
        while True:
            root = self._call({"Action": "ReceiveMessage",
                               "MaxNumberOfMessages": "10",
                               "WaitTimeSeconds":
                               str(self.wait_seconds)})
            messages = _xml_findall(root, "Message")
            if not messages:
                empty += 1
                if empty >= drained_after:
                    return
                continue
            empty = 0
            for msg in messages:
                bodies = _xml_findall(msg, "Body")
                handles = _xml_findall(msg, "ReceiptHandle")
                if not bodies or not handles:
                    continue
                try:
                    item = json.loads(bodies[0].text or "")
                except json.JSONDecodeError:
                    item = None
                # Anything not carrying our {key, message} envelope is
                # a poison message (foreign publisher on the same
                # queue): deliver nothing but still delete, or it
                # reappears after the visibility timeout and wedges
                # every future consume() on the same crash.
                if isinstance(item, dict) and "key" in item \
                        and "message" in item:
                    fn(item["key"], item["message"])
                # Delete AFTER delivery: a crash mid-fn redelivers
                # (at-least-once), never drops.
                self._call({"Action": "DeleteMessage",
                            "ReceiptHandle": handles[0].text or ""})


_STUB_QUEUES = ("gocdk",)


def queue_for_spec(spec: str, **kw) -> NotificationQueue:
    """'memory://', 'file:///path/spool.jsonl',
    'kafka://broker:9092/topic',
    'sqs://sqs.us-east-1.amazonaws.com/123456789012/queue' (keyword
    args: access_key/secret_key/region; http_endpoint=True for a
    plain-http test endpoint)."""
    scheme, _, rest = spec.partition("://")
    if scheme == "memory":
        return MemoryQueue()
    if scheme == "file":
        return FileQueue("/" + rest.lstrip("/"))
    if scheme == "kafka":
        bootstrap, _, topic = rest.partition("/")
        from .kafka import KafkaQueue
        return KafkaQueue(bootstrap, topic or "seaweedfs", **kw)
    if scheme == "sqs":
        proto = "http" if kw.pop("http_endpoint", False) else "https"
        return SqsQueue(f"{proto}://{rest}", **kw)
    if scheme == "pubsub":
        project, _, topic = rest.partition("/")
        from .pubsub import PubSubQueue
        return PubSubQueue(project, topic or "seaweedfs", **kw)
    if scheme in _STUB_QUEUES:
        raise NotImplementedError(
            f"{scheme} queue is a registry stub; add it behind "
            f"NotificationQueue (see weed/notification/{scheme})")
    raise ValueError(f"unknown queue spec: {spec}")


class AsyncPublisher(NotificationQueue):
    """Decorator that takes publish() off the caller's thread: a
    networked queue (Kafka TCP, Pub/Sub HTTP) rides a _SendSpool so it
    never blocks the filer's meta-log lock.  consume()/close()
    delegate to the inner queue.  (SqsQueue carries its own spool.)"""

    def __init__(self, inner: NotificationQueue):
        self.inner = inner
        self._spool = _SendSpool(
            lambda item: self.inner.publish(*item), "notify-sender")

    @property
    def dropped(self) -> int:
        return self._spool.dropped

    def publish(self, key: str, message: dict) -> None:
        self._spool.put((key, message))

    def flush(self, timeout: float | None = None) -> None:
        self._spool.flush(timeout)

    def consume(self, fn: Callable[[str, dict], None]) -> None:
        self.inner.consume(fn)

    def close(self) -> None:
        self._spool.close()
        self.inner.close()


class LogQueue(NotificationQueue):
    """notification.log: events go to the process log — the reference's
    debugging sink (weed/notification/log/log_queue.go).  consume() is
    a no-op drain; nothing is stored."""

    def publish(self, key: str, message: dict) -> None:
        from ..utils import glog
        glog.infof("notify %s: %s", key,
                   json.dumps(message, separators=(",", ":"))[:512])

    def consume(self, fn: Callable[[str, dict], None]) -> None:
        return


def queue_from_config(cfg) -> NotificationQueue | None:
    """Build the filer's notification queue from notification.toml
    (weed/notification/configuration.go LoadConfiguration: the first
    `enabled = true` section wins)."""
    if cfg is None:
        return None
    if cfg.get_bool("notification.file_queue.enabled"):
        d = cfg.get_string("notification.file_queue.dir",
                           "/tmp/weed_notify")
        return FileQueue(os.path.join(d, "events.jsonl"))
    if cfg.get_bool("notification.kafka.enabled"):
        from .kafka import KafkaQueue
        return AsyncPublisher(KafkaQueue(
            cfg.get_string("notification.kafka.hosts",
                           "localhost:9092").split(",")[0],
            cfg.get_string("notification.kafka.topic", "seaweedfs")))
    if cfg.get_bool("notification.aws_sqs.enabled"):
        return SqsQueue(
            cfg.get_string("notification.aws_sqs.sqs_queue_url"),
            access_key=cfg.get_string(
                "notification.aws_sqs.aws_access_key_id"),
            secret_key=cfg.get_string(
                "notification.aws_sqs.aws_secret_access_key"),
            region=cfg.get_string("notification.aws_sqs.region",
                                  "us-east-1"))
    if cfg.get_bool("notification.google_pub_sub.enabled"):
        from .pubsub import PubSubQueue
        sa = None
        creds = cfg.get_string(
            "notification.google_pub_sub.google_application_credentials")
        if creds:
            with open(creds) as f:
                sa = json.load(f)
        kw = {}
        endpoint = cfg.get_string(
            "notification.google_pub_sub.endpoint")
        if endpoint:
            kw["endpoint"] = endpoint
        return AsyncPublisher(PubSubQueue(
            cfg.get_string("notification.google_pub_sub.project_id"),
            cfg.get_string("notification.google_pub_sub.topic",
                           "seaweedfs"),
            subscription=cfg.get_string(
                "notification.google_pub_sub.subscription", ""),
            service_account=sa, **kw))
    if cfg.get_bool("notification.log.enabled"):
        return LogQueue()
    return None
