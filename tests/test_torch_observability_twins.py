"""The reference's tracing, metrics and wire-flow suites, run in both
packages: W3C trace context, the span ring and `/debug/traces`, and the
EC stage histograms (tests/test_trace.py); the metrics registry, its
exposition and push (tests/test_metrics.py); the per-purpose byte
ledger, the cluster traffic matrix and bandwidth budgets
(tests/test_flows.py).  Each case runs through `_torch_twin`: the
reference's own asserts in each package, and the values they compare
must be equal across the two (masked fields: see `_torch_twin`).

Names mapped in the port's copy (`port_subs`): the reference's
interpret-mode `PallasCoder` is the port's `CudaCoder` with
`device="cpu"` (its kernels' plain versions).
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWINS = {
    "test_trace.py": TwinFile("test_trace.py", port_subs=(
        ("from seaweedfs_tpu_torch.ops.coder_pallas import PallasCoder",
         "from seaweedfs_tpu_torch.ops.coder_cuda import CudaCoder"),
        ("PallasCoder(interpret=True)", 'CudaCoder(device="cpu")'),
    )),
    "test_metrics.py": TwinFile("test_metrics.py"),
    "test_flows.py": TwinFile("test_flows.py"),
}
CASES = [(f, c) for f, twin in TWINS.items() for c in twin.ids()]


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{f}::{c}" for f, c in CASES])
def test_observability_case_in_both_packages(name, case, tmp_path):
    TWINS[name].run(case, tmp_path)
