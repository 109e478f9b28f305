"""The reference's device roofline suite (tests/test_roofline.py), run
in both packages through `_torch_twin`: the kernel catalog and cost
model, the peak probe and its cache, the ledger's rows and
conservation, the pipeline occupancy timelines, and `/debug/device`,
`/cluster/device`, healthz and `cluster.roofline` on a master and a
volume server.  The reference's own asserts run in each package, and
the values they compare must be equal across the two (masked fields:
see `_torch_twin`).

Names mapped in the port's copy (`port_subs`): `coder_pallas` is the
port's `coder_cuda` and `PallasCoder` its `CudaCoder` with
`device="cpu"` (the kernels' plain versions, as the reference runs
Pallas in interpret mode).  The reference's fence,
`coder_pallas.jax.block_until_ready`, is where a Pallas launch's time
ends; the port's timer ends after the kernel call itself, which on the
CPU is the plain version `coder_cuda.apply_bitmatrix_torch`, so the
fencing case slows that call by the same 50 ms.  The reference memoises
one peaks doc (`roofline._peaks`, None until probed); the port one per
device (a dict keyed by `_device_key`), so the fake peaks go under the
CPU's key and a cleared memo is an empty dict.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWINS = {
    "test_roofline.py": TwinFile("test_roofline.py", port_subs=(
        ("from seaweedfs_tpu_torch.ops import coder_pallas",
         "from seaweedfs_tpu_torch.ops import coder_cuda"),
        ("from seaweedfs_tpu_torch.ops.coder_pallas import PallasCoder",
         "from seaweedfs_tpu_torch.ops.coder_cuda import CudaCoder"),
        ("PallasCoder(10, 4)", 'CudaCoder(10, 4, device="cpu")'),
        ("PallasCoder(4, 2)", 'CudaCoder(4, 2, device="cpu")'),
        ('monkeypatch.setattr(coder_pallas, "_record_roofline", boom)',
         'monkeypatch.setattr(coder_cuda, "_record_roofline", boom)'),
        ("real_fence = coder_pallas.jax.block_until_ready",
         "real_fence = coder_cuda.apply_bitmatrix_torch"),
        ("    def slow_fence(x):\n"
         "        time.sleep(0.05)\n"
         "        return real_fence(x)",
         "    def slow_fence(*x):\n"
         "        time.sleep(0.05)\n"
         "        return real_fence(*x)"),
        ('monkeypatch.setattr(coder_pallas.jax, "block_until_ready",',
         'monkeypatch.setattr(coder_cuda, "apply_bitmatrix_torch",'),
        ('monkeypatch.setattr(roofline, "_peaks", dict(FAKE_PEAKS))',
         'monkeypatch.setattr(roofline, "_peaks", '
         '{roofline._device_key(None): dict(FAKE_PEAKS)})'),
        ('monkeypatch.setattr(roofline, "_peaks", None)',
         'monkeypatch.setattr(roofline, "_peaks", {})'),
    )),
}
CASES = [(f, c) for f, twin in TWINS.items() for c in twin.ids()]


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{f}::{c}" for f, c in CASES])
def test_roofline_case_in_both_packages(name, case, tmp_path):
    TWINS[name].run(case, tmp_path)
