"""Metrics & system stats (reference: weed/stats/).

metrics.py is a from-scratch Prometheus client (counters, gauges,
histograms, text exposition, push-gateway loop — stats/metrics.go);
sysstats.py reads disk/memory figures (stats/disk.go, memory.go).
"""

from .hotkeys import HotKeyTracker, SpaceSaving  # noqa: F401
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsPusher, Registry, ec_stage_bytes,
                      ec_stage_seconds, global_registry,
                      observe_ec_stage)
from .promcheck import validate_exposition  # noqa: F401
from .sketch import QuantileSketch, WindowedSketch  # noqa: F401
from .sysstats import disk_status, memory_status  # noqa: F401

# stats.slo is NOT imported here: it imports the event journal, which
# imports stats.metrics — importing it at package-init time would
# cycle.  The port has no stats.slo yet.
