"""The port's master gRPC plane (`pb/master_grpc.py`) and the client's
gRPC master transport (`cluster/client.py`)
held against the JAX package's.

Every case of tests/test_master_grpc.py runs in both packages through
`_torch_twin`: the same seeded inputs, the reference's own asserts in
each, and the values those asserts compare must be equal across the
two (masked fields: see `_torch_twin`).
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

# test_weedclient_grpc_transport stops the gRPC plane and expects the
# next call to raise: UNAVAILABLE once the plane has closed its port,
# CANCELLED when the call reaches it while it still shuts down, which a
# loaded host makes happen in either package.  Either status records
# alike; any other error still records as it is.
TWIN = TwinFile("test_master_grpc.py", grpc_alike={
    "test_weedclient_grpc_transport": ("UNAVAILABLE", "CANCELLED")})


@pytest.mark.parametrize("case", TWIN.ids())
def test_master_grpc_case_in_both_packages(case, tmp_path):
    TWIN.run(case, tmp_path)
