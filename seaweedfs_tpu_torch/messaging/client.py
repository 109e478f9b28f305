"""Messaging client: publisher/subscriber following broker redirects.

Reference: weed/messaging/msgclient/ — producers and consumers locate
the owning broker per (topic, partition) via FindBroker and follow
redirects when placement moves.
"""

from __future__ import annotations

import base64
import json
import time
from typing import Callable

from ..cluster import rpc


class MessagingClient:
    def __init__(self, broker_url: str):
        self.broker_url = broker_url.rstrip("/")

    # -- admin ---------------------------------------------------------------

    def configure_topic(self, namespace: str, topic: str,
                        partition_count: int = 4) -> dict:
        return rpc.call_json(
            self.broker_url + "/topics/configure",
            payload={"namespace": namespace, "topic": topic,
                     "partition_count": partition_count})

    def delete_topic(self, namespace: str, topic: str) -> dict:
        return rpc.call_json(self.broker_url + "/topics/delete",
                             payload={"namespace": namespace,
                                      "topic": topic})

    def topic_config(self, namespace: str, topic: str) -> dict:
        return rpc.call(self.broker_url + "/topics/config"
                        f"?namespace={namespace}&topic={topic}")

    # -- produce -------------------------------------------------------------

    def publish(self, namespace: str, topic: str, value,
                key: str = "", headers: dict | None = None) -> dict:
        payload = {"namespace": namespace, "topic": topic, "key": key,
                   "headers": headers or {}}
        if isinstance(value, (bytes, bytearray)):
            payload["value"] = base64.b64encode(bytes(value)).decode()
            payload["value_b64"] = True
        else:
            payload["value"] = value
        url = self.broker_url
        for _hop in range(3):  # follow placement redirects
            try:
                out = rpc.call_json(url + "/publish", payload=payload)
            except OSError:
                # Redirect target died but its registration hasn't
                # expired yet: retryable until the ring re-forms.
                raise rpc.RpcError(
                    503, f"partition owner {url} unreachable; "
                    f"retry after placement settles") from None
            if "redirect" not in out:
                return out
            # Pin the partition the redirecting broker chose: keyless
            # publishes roll a random partition per broker, so without
            # this the next hop can re-roll and bounce us back.
            payload["partition"] = out["partition"]
            url = out["redirect"].rstrip("/")
        raise rpc.RpcError(503, "publish redirect loop")

    # -- consume -------------------------------------------------------------

    def fetch(self, namespace: str, topic: str, partition: int,
              since_ns: int = 0, limit: int = 1000) -> dict:
        url = self.broker_url
        for _hop in range(3):
            try:
                out = rpc.call(
                    url + f"/subscribe?namespace={namespace}"
                    f"&topic={topic}&partition={partition}"
                    f"&since_ns={since_ns}&limit={limit}")
            except OSError:
                raise rpc.RpcError(
                    503, f"partition owner {url} unreachable; "
                    f"retry after placement settles") from None
            if "redirect" not in out:
                for m in out["messages"]:
                    if m.pop("value_b64", False):
                        m["value"] = base64.b64decode(m["value"])
                return out
            url = out["redirect"].rstrip("/")
        raise rpc.RpcError(503, "subscribe redirect loop")

    def subscribe(self, namespace: str, topic: str, partition: int,
                  fn: Callable[[dict], None], since_ns: int = 0,
                  poll_interval: float = 0.2,
                  stop_check: Callable[[], bool] | None = None) -> None:
        """Poll-tail one partition, invoking fn per message (blocking;
        the streaming Subscribe RPC as a poll loop)."""
        offset = since_ns
        while stop_check is None or not stop_check():
            out = self.fetch(namespace, topic, partition, offset)
            for m in out["messages"]:
                fn(m)
            new_off = out.get("last_ns", offset)
            if new_off <= offset:
                time.sleep(poll_interval)
            offset = new_off
