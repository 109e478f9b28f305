"""The gateway cases of other JAX-package test files, run in both
packages: tiering through the repo's own S3 gateway
(tests/test_tier.py), the gateway's quota and SlowDown XML
(tests/test_tenancy.py) and `server -s3 -webdav` from the command line
(tests/test_cli.py).  Each case runs through `_torch_twin`: the
reference's own asserts in each package, and the values they compare
must be equal across the two (masked fields: see `_torch_twin`).  The
port's `server` subprocess gets `-device=cpu`, as any caller of the port
on a host without a card must pass, and both packages' `server` ports
come from `_torch_cluster.grpc_pair_port`.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

# test_cli.py picks the `server` subprocess's five ports by binding port
# 0 and closing it: ephemeral ports, which any outbound connection of
# the host may take as its source port before the subprocess binds them
# seconds later, and whose gRPC planes (+10000) may lie there too.  Both
# packages' copies take them where every server of the port's tests
# does, below the ephemeral range with port + 10000 free.
FREE_PORT = """    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]
"""
GRPC_PAIR_PORT = """    def free_port():
        from _torch_cluster import grpc_pair_port
        return grpc_pair_port()
"""

TWINS = {
    # The reference runs the shell case second on its module-scoped
    # stack, after the roundtrip; so does the twin, on the same servers.
    "test_tier.py": (TwinFile("test_tier.py", prelude={
        "test_tier_rpcs_and_shell": ("test_s3_backend_tier_roundtrip",)}), (
        "test_s3_backend_tier_roundtrip", "test_tier_rpcs_and_shell")),
    "test_tenancy.py": (TwinFile("test_tenancy.py"), (
        "test_s3_quota_and_slowdown_xml",)),
    "test_cli.py": (TwinFile("test_cli.py", port_subs=(
        ('"seaweedfs_tpu_torch", "server",',
         '"seaweedfs_tpu_torch", "server", "-device=cpu",'),),
        subs=((FREE_PORT, GRPC_PAIR_PORT),)), (
        "test_server_full_stack_s3_webdav",)),
}
CASES = [(f, c) for f, (twin, names) in TWINS.items()
         for c in twin.ids() if c.split("[")[0] in names]


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{f}::{c}" for f, c in CASES])
def test_gateway_case_in_both_packages(name, case, tmp_path):
    TWINS[name][0].run(case, tmp_path)
