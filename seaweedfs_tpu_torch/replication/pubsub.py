"""GCP Pub/Sub notification queue over its REST API — no SDK.

Reference: weed/notification/google_pub_sub (cloud.google.com/go/pubsub)
and weed/replication/sub/notification_google_pub_sub.go.  This build
authenticates the way the SDK does under the hood — an RS256-signed
service-account JWT grant exchanged at the token endpoint for a bearer
token (RFC 7523) — with the RSA-SHA256 primitive from libcrypto
(utils/cipher.rs256_sign) and everything else stdlib HTTP + JSON.

publish  -> POST v1/projects/{p}/topics/{t}:publish
consume  -> POST v1/projects/{p}/subscriptions/{s}:pull, then
            :acknowledge after delivery (at-least-once)

QUARANTINED: nothing in the tree constructs this queue outside
`queue_for_spec("pubsub://...")` — cross-cluster disaster recovery now
rides the volume-level change-log shipper (rlog.py + shipper.py), not
a cloud queue.  Kept (with its auth/wire tests) for operators who feed
filer events into Pub/Sub; the public surface is pinned by `__all__`
below and everything else may change or be removed.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.request

from .notification import NotificationQueue

__all__ = ["PubSubQueue", "make_service_account_jwt"]

_SCOPE = "https://www.googleapis.com/auth/pubsub"


def _b64url(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


def make_service_account_jwt(sa: dict, audience: str,
                             scope: str = _SCOPE,
                             lifetime: int = 3600,
                             now: int | None = None) -> str:
    """RS256 service-account JWT (RFC 7523 grant assertion)."""
    from ..utils.cipher import rs256_sign
    now = int(time.time()) if now is None else now
    header = {"alg": "RS256", "typ": "JWT"}
    if sa.get("private_key_id"):
        header["kid"] = sa["private_key_id"]
    claims = {"iss": sa["client_email"], "scope": scope,
              "aud": audience, "iat": now, "exp": now + lifetime}
    signing_input = (_b64url(json.dumps(header).encode()) + "." +
                     _b64url(json.dumps(claims).encode()))
    sig = rs256_sign(sa["private_key"].encode(), signing_input.encode())
    return signing_input + "." + _b64url(sig)


class PubSubQueue(NotificationQueue):
    """Publish/consume the {key, message} envelope on one topic +
    subscription.  `service_account` is the parsed key-file JSON
    (client_email / private_key / token_uri).  Endpoint overridable for
    emulators (the Pub/Sub emulator speaks the same REST surface)."""

    def __init__(self, project: str, topic: str,
                 subscription: str = "",
                 service_account: dict | None = None,
                 endpoint: str = "https://pubsub.googleapis.com"):
        self.project = project
        self.topic = topic
        self.subscription = subscription or f"{topic}.seaweedfs"
        self.sa = service_account
        self.endpoint = endpoint.rstrip("/")
        self._token = ""
        self._token_exp = 0.0
        self._token_lock = threading.Lock()

    # -- auth ----------------------------------------------------------------

    def _bearer(self) -> str:
        if self.sa is None:
            return ""  # emulator mode: no auth
        with self._token_lock:
            if time.time() < self._token_exp - 60:
                return self._token
            token_uri = self.sa.get(
                "token_uri", "https://oauth2.googleapis.com/token")
            assertion = make_service_account_jwt(self.sa, token_uri)
            body = ("grant_type=urn%3Aietf%3Aparams%3Aoauth%3A"
                    "grant-type%3Ajwt-bearer&assertion="
                    + assertion).encode()
            req = urllib.request.Request(
                token_uri, data=body, method="POST",
                headers={"Content-Type":
                         "application/x-www-form-urlencoded"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                doc = json.loads(resp.read())
            self._token = doc["access_token"]
            self._token_exp = time.time() + int(
                doc.get("expires_in", 3600))
            return self._token

    def _call(self, path: str, payload: dict) -> dict:
        headers = {"Content-Type": "application/json"}
        token = self._bearer()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        req = urllib.request.Request(
            f"{self.endpoint}/v1/{path}",
            data=json.dumps(payload).encode(), method="POST",
            headers=headers)
        with urllib.request.urlopen(req, timeout=70) as resp:
            return json.loads(resp.read() or b"{}")

    # -- NotificationQueue ----------------------------------------------------

    def publish(self, key: str, message: dict) -> None:
        value = json.dumps({"key": key, "message": message},
                           separators=(",", ":")).encode()
        self._call(
            f"projects/{self.project}/topics/{self.topic}:publish",
            {"messages": [{"data": base64.b64encode(value).decode(),
                           "attributes": {"key": key}}]})

    def consume(self, fn) -> None:
        sub = f"projects/{self.project}/subscriptions/" \
              f"{self.subscription}"
        # returnImmediately pulls may return empty while a backlog
        # exists (why Google deprecated the flag): require consecutive
        # empty pulls before declaring the queue drained.
        empty = 0
        while True:
            out = self._call(f"{sub}:pull",
                             {"maxMessages": 10,
                              "returnImmediately": True})
            received = out.get("receivedMessages", [])
            if not received:
                empty += 1
                if empty >= 3:
                    return
                continue
            empty = 0
            ack_ids = []
            for rm in received:
                raw = base64.b64decode(
                    rm.get("message", {}).get("data", ""))
                try:
                    doc = json.loads(raw)
                except json.JSONDecodeError:
                    doc = None
                if isinstance(doc, dict) and "key" in doc \
                        and "message" in doc:
                    fn(doc["key"], doc["message"])
                # foreign/undecodable messages are acked too, or they
                # redeliver forever (same poison policy as SqsQueue)
                ack_ids.append(rm["ackId"])
            # Ack AFTER delivery: a crash mid-batch redelivers.
            self._call(f"{sub}:acknowledge", {"ackIds": ack_ids})
