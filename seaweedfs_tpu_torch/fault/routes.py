"""`/debug/faults` endpoint — runtime fault arming, mirroring the
`/debug/traces` pattern (trace/routes.py).

Mounted by every server role at construction, but ONLY when the
operator opted into fault injection: SEAWEEDFS_TPU_FAULTS present in
the environment (its value arms initial points; empty string just
mounts the endpoint) or SEAWEEDFS_TPU_FAULTS_DEBUG=1.  A stock
deployment exposes no fault surface and pays nothing.

    GET  /debug/faults                    catalog + armed state + seed
    POST /debug/faults?point=P&spec=S     arm P with spec S
    POST /debug/faults?point=P&spec=off   disarm P
    POST /debug/faults?disarm=all         disarm everything

Like trace/routes.py, this module must not import cluster.rpc (rpc
imports the fault registry), so handlers return (status, dict) tuples
instead of raising RpcError.
"""

from __future__ import annotations

import os

from . import registry


def faults_route_enabled() -> bool:
    return ("SEAWEEDFS_TPU_FAULTS" in os.environ
            or os.environ.get("SEAWEEDFS_TPU_FAULTS_DEBUG", "")
            in ("1", "true"))


def _ls_handler(query: dict, body: bytes):
    return {"seed": os.environ.get("SEAWEEDFS_TPU_FAULTS_SEED", "0"),
            "points": registry.snapshot()}


def _set_handler(query: dict, body: bytes):
    if query.get("disarm", "") == "all":
        registry.disarm_all()
        return {"disarmed": "all"}
    point = query.get("point", "")
    if not point:
        return (400, {"error": "point= required (or disarm=all)"})
    spec = query.get("spec", "")
    if spec in ("", "off", "none"):
        registry.disarm(point)
        return {"point": point, "armed": False}
    try:
        fs = registry.arm(point, spec)
    except ValueError as e:
        return (400, {"error": str(e)})
    return {"point": point, "armed": True, "state": fs.describe()}


def setup_fault_routes(server) -> None:
    """Mount /debug/faults on `server` when the operator opted in."""
    if faults_route_enabled():
        server.route("GET", "/debug/faults", _ls_handler)
        server.route("POST", "/debug/faults", _set_handler)
