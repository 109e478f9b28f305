"""The port's message broker (`messaging/`: consistent hash, topic logs,
broker, client) held against the JAX package's.

Every case of tests/test_messaging.py runs in both packages through `_torch_twin`:
the same seeded inputs, the reference's own asserts in each, and the
values those asserts compare must be equal across the two (masked
fields: see `_torch_twin`).

The fixture's volume server beats every 5 s in both packages (`subs`),
not every 60 s as the file sets it: its master (a 5 s pulse) sweeps a
node silent for 10 s, and a case whose first write came later than that
after the server's start got a 406 from the master's assign ("no free
volumes and cannot grow"), as the port's half did under xdist's load.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWIN = TwinFile("test_messaging.py", subs=(
    ("pulse_seconds=60)", "pulse_seconds=5)"),))


@pytest.mark.parametrize("case", TWIN.ids())
def test_messaging_case_in_both_packages(case, tmp_path):
    TWIN.run(case, tmp_path)
