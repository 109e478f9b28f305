"""The reference's robustness suites, run in both packages: fault
injection through the `fault` registry (tests/test_chaos.py,
tests/test_faults.py) and overload shedding, slow-client reaping and
the rolling restart (tests/test_overload.py); the event journal's suite
is in test_torch_event_twins.py and test_torch_event_type_twins.py.
Each case runs through `_torch_twin`: the reference's own asserts in
each package, and the values they compare must be equal across the two
(masked fields: see `_torch_twin`).  The port's `volume` subprocesses
get `-device=cpu`, as any caller of the port on a host without a card
must pass.

Excluded from the record comparison (outcome compared, operands not):
- test_faults.py::test_every_fault_point_is_reachable[tier.read], its
  `pytest.raises` message ("raises"): the injected fault's message
  names the holder's directory, which depends on where each package's
  master placed the volume; under load the two placements can differ.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWINS = {
    "test_chaos.py": TwinFile("test_chaos.py"),
    "test_overload.py": TwinFile("test_overload.py", port_subs=((
        '"seaweedfs_tpu_torch", "volume",',
        '"seaweedfs_tpu_torch", "volume", "-device=cpu",'),)),
    "test_faults.py": TwinFile("test_faults.py", unrecorded={
        "test_every_fault_point_is_reachable[tier.read]": ("raises",)}),
}
CASES = [(f, c) for f, twin in TWINS.items() for c in twin.ids()]


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{f}::{c}" for f, c in CASES])
def test_robustness_case_in_both_packages(name, case, tmp_path):
    TWINS[name].run(case, tmp_path)
