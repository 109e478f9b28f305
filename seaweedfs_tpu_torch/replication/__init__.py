"""Cross-cluster replication: the change-log mirror and the geo lease
plane (the port's copy of `seaweedfs_tpu/replication/__init__.py`).

The LIVE plane is volume-level async mirroring (rlog.py + shipper.py +
lease.py): every committed write/delete journals to a durable
per-volume change log (`<volume>.rlog`) and a background shipper tails
it to a peer cluster (`-replicate.peer`), idempotently applied and
watermarked on both sides so kill -9 anywhere loses nothing acked.
With `-geo.cluster.id` set, per-volume `.lease` sidecars key shipping
direction and epoch-fence writes so two regions can run active/active
(README "Disaster recovery > Geo active/active").  `__all__` is pinned
to exactly this plane.

QUARANTINED: the filer-event replication port (replicator.py + sink.py
+ notification.py — reference weed/replication/replicator.go and
sink/) predates the change-log shipper and is not wired into any
server role.  Its names (Replicator, FilerSink, LocalSink, S3Sink,
ReplicationSink, NotificationQueue, FileQueue, MemoryQueue,
queue_for_spec) stay importable for existing tooling via lazy
`__getattr__`, but they are deliberately OUT of `__all__`; new code
must not grow dependencies on them (tests/test_replication.py pins
the boundary).

The old mtime-diff `filer.sync` walker was superseded by the change-log
shipper and removed.
"""

from .lease import LeaseTable, VolumeLease  # noqa: F401
from .rlog import ReplicationLog, Watermark  # noqa: F401
from .shipper import ReplicationShipper  # noqa: F401

# The supported surface: the change-log mirror + geo leases, nothing
# from the quarantined filer-event plane.
__all__ = ["LeaseTable", "ReplicationLog", "ReplicationShipper",
           "VolumeLease", "Watermark"]

# Legacy filer-event names resolve lazily (PEP 562) so importing the
# live plane never pays for — or accidentally revives — the
# quarantined one.
_QUARANTINED = {
    "FileQueue": "notification",
    "MemoryQueue": "notification",
    "NotificationQueue": "notification",
    "queue_for_spec": "notification",
    "Replicator": "replicator",
    "FilerSink": "sink",
    "LocalSink": "sink",
    "ReplicationSink": "sink",
    "S3Sink": "sink",
}


def __getattr__(name: str):
    mod = _QUARANTINED.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
