"""Tenancy & QoS plane: per-tenant accounting, quotas, and
weighted-fair admission.

The multi-tenant isolation layer the per-role overload controls
(admission lanes, 429 shedding, SLO burn) cannot provide on their own:
one hot principal must not fill the read lane, evict everyone's chunk
cache, or write the cluster into its ENOSPC reserve.

- `quota`: declarative per-tenant rules (line grammar or TOML, same
  loader style as lifecycle/policy.py) — max_bytes / max_objects /
  max_rps / max_mbps, hard or soft, plus a DRR weight.
- `accounting`: per-(tenant, collection) live usage counters on the
  data roles, carried on heartbeats, merged into a master-side rollup
  with durable snapshots so restarts don't zero usage.
- `qos`: token buckets (req/s + write MB/s) and a deficit-round-robin
  scheduler over per-tenant sub-queues inside each admission lane.
- `context`: the per-request principal (tenant + originating client),
  resolved once in the rpc middleware and auto-forwarded on every
  outbound hop like the traceparent.
"""

from .accounting import TenantUsage, UsageRollup  # noqa: F401
from .context import (clear_principal, current_client,  # noqa: F401
                      current_tenant, set_principal)
from .qos import DrrQueue, TenantBuckets, TokenBucket  # noqa: F401
from .quota import (QuotaError, QuotaPolicy, QuotaRule,  # noqa: F401
                    load_rules, parse_rules_text, parse_rules_toml,
                    parse_size)

TENANT_HEADER = "X-Weed-Tenant"
CLIENT_HEADER = "X-Weed-Client"
