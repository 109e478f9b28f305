"""The port's S3 gateway against a subprocess cluster of each package,
held against the JAX package's.

Every case of tests/test_s3_conformance.py runs in both packages through `_torch_twin`:
the same seeded inputs, the reference's own asserts in each, and the
values those asserts compare must be equal across the two (masked
fields: see `_torch_twin`).  The port's `server` subprocess gets
`-device=cpu`, as any caller of the port on a host without a card must
pass; both packages' `server` ports come from `_torch_cluster.grpc_pair_port`.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

# The reference's `server` ports are ephemeral ones it binds and closes
# (another connection may take one before the subprocess binds it): both
# packages' copies take them below the ephemeral range, with port +
# 10000 free for the gRPC planes (test_torch_gateway_twins.py).
FREE_PORT = """def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
"""
GRPC_PAIR_PORT = """def _free_port() -> int:
    from _torch_cluster import grpc_pair_port
    return grpc_pair_port()
"""
TWIN = TwinFile("test_s3_conformance.py", port_subs=(
    ('"seaweedfs_tpu_torch", "server",',
     '"seaweedfs_tpu_torch", "server", "-device=cpu",'),),
    subs=((FREE_PORT, GRPC_PAIR_PORT),))


@pytest.mark.parametrize("case", TWIN.ids())
def test_s3_conformance_case_in_both_packages(case, tmp_path):
    TWIN.run(case, tmp_path)
