"""`/debug/events` endpoint — the per-process journal over HTTP.

Mounted by every server role at construction (master, volume server,
filer), like `/metrics`: events are operational state transitions, not
request payloads, so unlike /debug/traces and /debug/faults there is
no opt-in gate — only a kill switch (SEAWEEDFS_TPU_EVENTS=0).

    GET /debug/events                         the whole ring
    GET /debug/events?type=T&since=TS&severity=S&limit=N

Filters compose; `since` is a unix timestamp (float), `limit` keeps
the newest N matches.  The response carries the journal's process
`token` and per-event `seq` so cross-server aggregation (`events.ls`,
the master's `/cluster/events`) can deduplicate roles that share one
in-process journal.

Like trace/routes.py, this module must not import cluster.rpc (rpc
registers the events counter and would cycle), so handlers return
plain (status, dict) tuples instead of raising RpcError.
"""

from __future__ import annotations

import os

from .journal import JOURNAL, TYPES


def events_enabled() -> bool:
    return os.environ.get("SEAWEEDFS_TPU_EVENTS", "") \
        not in ("0", "false")


def _events_handler(query: dict, body: bytes):
    type_ = query.get("type", "")
    if type_ and type_ not in TYPES:
        return (400, {"error": f"unknown event type {type_!r}",
                      "types": sorted(TYPES)})
    try:
        since = float(query.get("since", 0) or 0)
        limit = int(query.get("limit", 0) or 0)
    except ValueError:
        return (400, {"error": "since/limit must be numbers"})
    severity = query.get("severity", "")
    return {"token": JOURNAL.token,
            "emitted": JOURNAL.emitted,
            "dropped": JOURNAL.dropped,
            "events": JOURNAL.snapshot(type_=type_, since=since,
                                       severity=severity, limit=limit)}


def setup_event_routes(server) -> None:
    """Mount /debug/events on `server` unless killed by env."""
    if events_enabled():
        server.route("GET", "/debug/events", _events_handler)
