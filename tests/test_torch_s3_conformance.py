"""The port's S3 gateway against a subprocess cluster of each package,
held against the JAX package's.

Every case of tests/test_s3_conformance.py runs in both packages through `_torch_twin`:
the same seeded inputs, the reference's own asserts in each, and the
values those asserts compare must be equal across the two (masked
fields: see `_torch_twin`).  The port's `server` subprocess gets
`-device=cpu`, as any caller of the port on a host without a card must
pass.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWIN = TwinFile("test_s3_conformance.py", port_subs=(
    ('"seaweedfs_tpu_torch", "server",',
     '"seaweedfs_tpu_torch", "server", "-device=cpu",'),))


@pytest.mark.parametrize("case", TWIN.ids())
def test_s3_conformance_case_in_both_packages(case, tmp_path):
    TWIN.run(case, tmp_path)
