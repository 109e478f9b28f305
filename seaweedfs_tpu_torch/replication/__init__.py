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

The reference's quarantined filer-event plane predates the shipper
and is wired into no server role.  Its notification queues
(notification.py) are ported, since the filer publishes its meta events
to them; they stay importable by name through a lazy `__getattr__`, out
of `__all__`.  The rest of that plane (replicator, sink, kafka, pubsub)
is not ported yet (ROADMAP queue 1, slice 11b): asking for one of its
names raises AttributeError naming that slice.
"""

from .lease import LeaseTable, VolumeLease  # noqa: F401
from .rlog import ReplicationLog, Watermark  # noqa: F401
from .shipper import ReplicationShipper  # noqa: F401

__all__ = ["LeaseTable", "ReplicationLog", "ReplicationShipper",
           "VolumeLease", "Watermark"]


# Legacy filer-event names resolve lazily (PEP 562) so importing the
# live plane never pays for the quarantined one.
_QUARANTINED = {
    "FileQueue": "notification",
    "MemoryQueue": "notification",
    "NotificationQueue": "notification",
    "queue_for_spec": "notification",
}
_SLICE_11B = ("Replicator", "FilerSink", "LocalSink", "ReplicationSink",
              "S3Sink")


def __getattr__(name: str):
    mod = _QUARANTINED.get(name)
    if mod is None:
        if name in _SLICE_11B:
            raise AttributeError(
                f"{name} is not ported yet (ROADMAP queue 1, slice 11b)")
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
