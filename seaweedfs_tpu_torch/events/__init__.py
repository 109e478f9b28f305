"""Cluster event journal subsystem (see journal.py for the design).

Public surface:

- `emit(type, node=, severity=, **attrs)`: record one cluster event;
  the type must be in the static `TYPES` catalog.
- `JOURNAL`: the process-global bounded event ring.
- `TYPES` / `SEVERITIES`: the static catalogs.
- `setup_event_routes(server)`: mounts /debug/events.
- `events_total`: the `SeaweedFS_events_total{type=}` counter every
  server registers on its /metrics scrape.
"""

from .journal import (JOURNAL, SEVERITIES, TYPES,  # noqa: F401
                      EventJournal, emit, events_total)
from .routes import events_enabled, setup_event_routes  # noqa: F401
