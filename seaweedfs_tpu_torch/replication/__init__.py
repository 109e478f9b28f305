"""Cross-cluster replication: the change-log mirror and the geo lease
plane (the port's copy of `seaweedfs_tpu/replication/__init__.py`).

The LIVE plane is volume-level async mirroring (rlog.py + shipper.py +
lease.py): every committed write/delete journals to a durable
per-volume change log (`<volume>.rlog`) and a background shipper tails
it to a peer cluster (`-replicate.peer`), idempotently applied and
watermarked on both sides so kill -9 anywhere loses nothing acked.
With `-geo.cluster.id` set, per-volume `.lease` sidecars key shipping
direction and epoch-fence writes so two regions can run active/active.
`__all__` is pinned to exactly this plane.

Not ported yet (ROADMAP queue 1, slice 11): the reference's quarantined
filer-event plane (replicator, sink, notification, kafka, pubsub),
which feeds the filer and `weed watch`.
"""

from .lease import LeaseTable, VolumeLease  # noqa: F401
from .rlog import ReplicationLog, Watermark  # noqa: F401
from .shipper import ReplicationShipper  # noqa: F401

__all__ = ["LeaseTable", "ReplicationLog", "ReplicationShipper",
           "VolumeLease", "Watermark"]
