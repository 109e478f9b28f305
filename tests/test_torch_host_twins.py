"""The reference's suites of host modules, run in both packages: needle
ciphers and compression (tests/test_cipher_compress.py), image
resizing and orientation (tests/test_images.py), the filer's metadata
log (tests/test_meta_log.py) and its ordered KV store
(tests/test_ordered_kv.py).  Each case runs through `_torch_twin`: the
reference's own asserts in each package, and the values they compare
must be equal across the two (masked fields: see `_torch_twin`).
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWINS = {
    "test_cipher_compress.py": TwinFile("test_cipher_compress.py"),
    "test_images.py": TwinFile("test_images.py"),
    "test_meta_log.py": TwinFile("test_meta_log.py"),
    "test_ordered_kv.py": TwinFile("test_ordered_kv.py"),
}
CASES = [(f, c) for f, twin in TWINS.items() for c in twin.ids()]


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{f}::{c}" for f, c in CASES])
def test_host_case_in_both_packages(name, case, tmp_path):
    TWINS[name].run(case, tmp_path)
