"""`test_every_event_type_is_emitted` of the reference's event-journal
suite (tests/test_events.py), one case per event type, run in both
packages: each type's emit site driven through its real code path on a
raft master and volume servers, the event landing in the journal with
a trace id.  Each case runs through `_torch_twin`: the reference's own
asserts in each package, and the values they compare must be equal
across the two (masked fields: see `_torch_twin`).

Excluded from the record comparison (outcome compared, operands not):
- test_every_event_type_is_emitted[replication.rollback], its
  `pytest.raises` message ("raises"): the injected fault's message
  names the volume id, which depends on where each package's master
  placed the volume; under load the two placements can differ.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWIN = TwinFile("test_events.py", unrecorded={
    "test_every_event_type_is_emitted[replication.rollback]": ("raises",)})
CASES = [c for c in TWIN.ids()
         if c.startswith("test_every_event_type_is_emitted[")]


@pytest.mark.parametrize("case", CASES)
def test_event_type_case_in_both_packages(case, tmp_path):
    TWIN.run(case, tmp_path)
