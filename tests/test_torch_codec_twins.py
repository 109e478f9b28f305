"""The reference's codec and coder suites, run in both packages: the
codec registry, LRC(10,2,2) and its cluster acceptance flow
(tests/test_codecs.py), GF(2^8) arithmetic (tests/test_gf256.py), the
numpy oracle coder (tests/test_coder_numpy.py), the native row mix
(tests/test_coder_native.py) and the coders' edge cases
(tests/test_coder_edge_cases.py).  Each case runs through `_torch_twin`:
the reference's own asserts in each package, and the values they
compare must be equal across the two (masked fields: see
`_torch_twin`).

Names mapped in the port's copy (`port_subs`): the reference's device
backends `jax` and `pallas` are the port's `torch` and `cuda`, and
every coder the port builds takes `device="cpu"` (the port's default is
the card; on the CPU the `cuda` backend runs its kernels' plain
versions, as the reference runs Pallas in interpret mode).
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

_CPU_CODERS = (
    ('new_coder(backend="numpy", codec=',
     'new_coder(device="cpu", backend="numpy", codec='),)

TWINS = {
    "test_codecs.py": TwinFile("test_codecs.py", port_subs=_CPU_CODERS + (
        ('for backend in ("jax", "pallas"):',
         'for backend in ("torch", "cuda"):'),
        ('new_coder(backend=backend, codec="lrc")',
         'new_coder(backend=backend, codec="lrc", device="cpu")'),
        ('new_coder(backend="numpy",\n',
         'new_coder(device="cpu", backend="numpy",\n'),
        ("EcVolume(base, large_block_size=LARGE,",
         'EcVolume(base, device="cpu", large_block_size=LARGE,'))),
    "test_gf256.py": TwinFile("test_gf256.py"),
    "test_coder_numpy.py": TwinFile("test_coder_numpy.py"),
    "test_coder_native.py": TwinFile("test_coder_native.py"),
    "test_coder_edge_cases.py": TwinFile("test_coder_edge_cases.py"),
}
CASES = [(f, c) for f, twin in TWINS.items() for c in twin.ids()]


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{f}::{c}" for f, c in CASES])
def test_codec_case_in_both_packages(name, case, tmp_path):
    TWINS[name].run(case, tmp_path)
