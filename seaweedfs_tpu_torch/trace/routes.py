"""`/debug/traces` endpoint + per-server tracing setup.

`setup_server_tracing(server, service)` is called by all three server
roles at construction: it tags the JsonHttpServer so the rpc
middleware opens a server span per request, and — ONLY when the
operator opted in with SEAWEEDFS_TPU_TRACES=1 (the same stance as
`/debug/pprof`: unauthenticated debug surfaces are an operator
decision) — mounts the JSON endpoint:

    GET /debug/traces?limit=N     newest-first trace summaries
    GET /debug/traces?trace=<id>  every local span of one trace

This module deliberately avoids importing cluster.rpc (rpc imports the
tracer; a back-import would cycle), so handlers return plain
(status, dict) tuples instead of raising RpcError.
"""

from __future__ import annotations

import os

from .tracer import BUFFER


def _traces_handler(query: dict, body: bytes):
    trace_id = query.get("trace", "")
    if trace_id:
        spans = BUFFER.get(trace_id)
        if spans is None:
            return (404, {"error": f"trace {trace_id} not found"})
        spans.sort(key=lambda s: s["start"])
        return {"trace_id": trace_id, "spans": spans}
    try:
        limit = int(query.get("limit", 100))
    except ValueError:
        limit = 100
    return {"traces": BUFFER.summaries(limit),
            "dropped": BUFFER.dropped}


def traces_route_enabled() -> bool:
    return os.environ.get("SEAWEEDFS_TPU_TRACES", "") in ("1", "true")


def setup_server_tracing(server, service: str) -> None:
    """Enable the server-span middleware for `server` and mount
    /debug/traces when the operator opted in.

    Recording follows the consumer: without the endpoint (or an
    explicit SEAWEEDFS_TPU_TRACE=1 for in-process consumers) the ring
    would be unreadable, so a stock deployment pays zero per-request
    tracing cost — no Span allocation, no urandom ids, no buffer lock
    on the hot request loop."""
    if traces_route_enabled():
        server.trace_service = service
        server.route("GET", "/debug/traces", _traces_handler)
    elif os.environ.get("SEAWEEDFS_TPU_TRACE", "") in ("1", "true"):
        server.trace_service = service
