"""The reference's push-stream and TLS suites, run in both packages:
the filer's metadata subscriptions and the master's location pushes
(tests/test_push_streams.py), and mutual TLS between the roles with the
repo's security.toml (tests/test_tls.py).  Each case runs through
`_torch_twin`: the reference's own asserts in each package, and the
values they compare must be equal across the two (masked fields: see
`_torch_twin`).

Excluded from the record comparison (outcome compared, operands not):
- test_tls.py::test_client_without_cert_rejected, its `pytest.raises`
  message ("raises"): in TLS 1.3 the client finishes its handshake
  before the server refuses the missing certificate, and whether its
  next read meets the server's alert (`SSLError`, certificate
  required) or the closed connection (`SSLEOFError`) depends on timing.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWINS = {
    "test_push_streams.py": TwinFile("test_push_streams.py"),
    "test_tls.py": TwinFile("test_tls.py", unrecorded={
        "test_client_without_cert_rejected": ("raises",)}),
}
CASES = [(f, c) for f, twin in TWINS.items() for c in twin.ids()]


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{f}::{c}" for f, c in CASES])
def test_stream_tls_case_in_both_packages(name, case, tmp_path):
    TWINS[name].run(case, tmp_path)
