"""The port's message broker (`messaging/`: consistent hash, topic logs,
broker, client) held against the JAX package's.

Every case of tests/test_messaging.py runs in both packages through `_torch_twin`:
the same seeded inputs, the reference's own asserts in each, and the
values those asserts compare must be equal across the two (masked
fields: see `_torch_twin`).
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWIN = TwinFile("test_messaging.py")


@pytest.mark.parametrize("case", TWIN.ids())
def test_messaging_case_in_both_packages(case, tmp_path):
    TWIN.run(case, tmp_path)
