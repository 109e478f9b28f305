"""The reference's event-journal suite (tests/test_events.py), run in
both packages: the journal's ring, sinks and filters, `/debug/events`,
the health rollup, `events.ls` and `/cluster/events` over a raft master
and volume servers, a volume server in a process of its own.  Its
`test_every_event_type_is_emitted` cases are in
test_torch_event_type_twins.py, so that `--dist loadfile` spreads the
file's run.  Each case runs through `_torch_twin`: the reference's own
asserts in each package, and the values they compare must be equal
across the two (masked fields: see `_torch_twin`).  The port's `volume`
subprocess gets `-device=cpu`, as any caller of the port on a host
without a card must pass.

Excluded from the record comparison (outcome compared, operands not):
- test_debug_events_endpoint_filters, `out['token'] == JOURNAL.token`:
  each process's journal draws its token from `os.urandom` at import,
  so the two packages' tokens differ by design.
- test_events_ls_and_cluster_aggregation, `ts == sorted(ts)`: the
  stamps of every event in the merged timeline, whose count depends on
  how many beats and sweeps each package's run saw.

`test_events_ls_and_cluster_aggregation` reads the events that the
reference's earlier cases left on its module-scoped cluster; the twin
runs the four it reads (ec.encode.finish, heartbeat.lost,
volume.assign, volume.grow) before it on the same servers, in the
reference's order.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWIN = TwinFile(
    "test_events.py",
    port_subs=(('"seaweedfs_tpu_torch", "volume",',
                '"seaweedfs_tpu_torch", "volume", "-device=cpu",'),),
    prelude={"test_events_ls_and_cluster_aggregation": tuple(
        f"test_every_event_type_is_emitted[{t}]" for t in (
            "ec.encode.finish", "heartbeat.lost", "volume.assign",
            "volume.grow"))},
    unrecorded={
        "test_debug_events_endpoint_filters": (
            "out['token'] == JOURNAL.token",),
        "test_events_ls_and_cluster_aggregation": ("ts == sorted(ts)",)})
CASES = [c for c in TWIN.ids()
         if not c.startswith("test_every_event_type_is_emitted[")]


@pytest.mark.parametrize("case", CASES)
def test_event_case_in_both_packages(case, tmp_path):
    TWIN.run(case, tmp_path)
