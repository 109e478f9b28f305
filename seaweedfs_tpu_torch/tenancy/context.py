"""Per-request principal context: which tenant (and which originating
client) this thread is working for.

Mirrors the trace plane's propagation model exactly (trace/tracer.py
`_local` + rpc._request header injection): the rpc middleware resolves
the principal ONCE at the front door — S3 identity via the
X-Weed-Tenant header the gateway stamps, an explicit client header, or
the collection as fallback — parks it in a threading.local, and every
outbound hop that thread makes (filer→master assign, filer→volume
chunk fetch, volume→replica) auto-forwards it as headers.  That is
what fixes the proxy-leg attribution hole: the volume server's
/debug/hot names the real principal, not the filer's own IP.

Internal cluster traffic (X-Weed-Priority: low / ?type=replicate)
stays tenant-exempt like the low-priority lane: the admission plane
never queues or throttles it by tenant, though attribution headers
still ride for observability.
"""

from __future__ import annotations

import threading

_local = threading.local()


def set_principal(tenant: str, client: str = "") -> None:
    _local.tenant = tenant
    _local.client = client


def clear_principal() -> None:
    _local.tenant = ""
    _local.client = ""


def current_tenant() -> str:
    return getattr(_local, "tenant", "")


def current_client() -> str:
    return getattr(_local, "client", "")
