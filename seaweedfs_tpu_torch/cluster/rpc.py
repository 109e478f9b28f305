"""HTTP/JSON control plane of the port.

So far only the error type the fault plane raises for an armed
``status`` spec (``fault/registry.py``); the servers and the client pool
of ``seaweedfs_tpu/cluster/rpc.py`` come with the cluster slice.
"""

from __future__ import annotations


class RpcError(Exception):
    def __init__(self, status: int, message: str,
                 headers: dict | None = None,
                 retry_after: float | None = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message
        # Extra response headers a handler wants on its error answer
        # (Retry-After on 429/503 sheds and drain refusals).
        self.headers = dict(headers or {})
        # Parsed Retry-After from a server's answer (client side):
        # RetryPolicy honors it as a backoff floor on 429/503.
        self.retry_after = retry_after
