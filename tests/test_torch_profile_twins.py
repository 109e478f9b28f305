"""The reference's profiling suites, run in both packages: the pprof
endpoints, the sampler's rate and `-cpuprofile` (tests/test_pprof_ui.py)
and the time-attribution plane, per-request phase budgets, lock
contention and `cluster.profile` over a subprocess cluster
(tests/test_attribution.py).  Each case runs through `_torch_twin`: the
reference's own asserts in each package, and the values they compare
must be equal across the two (masked fields: see `_torch_twin`).

Mapped in the port's copy (`port_subs`): the `-cpuprofile` case's
child process does not call the reference's `jaxenv.force_cpu` (the
port has no JAX to pin), and the subprocess cluster's volume servers
take `-device=cpu`, as any caller of the port on a host without a card
must pass.

Excluded from the record comparison (outcome compared, operands not):
- test_pprof_ui.py::test_sample_stacks_rate_drift_compensated,
  `elapsed == pytest.approx(0.5, abs=0.1)`: the sampler's wall time over
  its 0.5 s window, which depends on the host's scheduling in each run.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWINS = {
    "test_pprof_ui.py": TwinFile("test_pprof_ui.py", port_subs=((
        '"from seaweedfs_tpu_torch.utils.jaxenv import force_cpu; '
        'force_cpu()\\n"\n', ""),), unrecorded={
        "test_sample_stacks_rate_drift_compensated": (
            "elapsed == pytest.approx(0.5, abs=0.1)",)}),
    "test_attribution.py": TwinFile("test_attribution.py", port_subs=((
        '"-max=10", f"-mserver=127.0.0.1:{mport}"',
        '"-max=10", f"-mserver=127.0.0.1:{mport}", "-device=cpu"'),)),
}
CASES = [(f, c) for f, twin in TWINS.items() for c in twin.ids()]


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{f}::{c}" for f, c in CASES])
def test_profile_case_in_both_packages(name, case, tmp_path):
    TWINS[name].run(case, tmp_path)
