"""The reference's device-coder suite (tests/test_coder_jax.py), run in
both packages through `_torch_twin`: the reference's own asserts in
each package, and the values they compare must be equal across the two
(masked fields: see `_torch_twin`).

Names mapped in the port's copy (`port_subs`): `JaxCoder` is the port's
`TorchCoder` and `PallasCoder` its `CudaCoder`, both with
`device="cpu"` (on the CPU `CudaCoder` runs its kernels' plain
versions, as the reference runs Pallas in interpret mode);
`coder_pallas.BLOCK_N` is `coder_cuda.BLOCK_N`, the port's tile;
`SEAWEEDFS_TPU_CODER` and its backends `jax` and `pallas` are
`SEAWEEDFS_TORCH_CODER`, `torch` and `cuda`, and `new_coder` takes
`device="cpu"`.  The message of an unknown backend names the port's
variable and backends; `record_subs` maps them back to the reference's.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWINS = {
    "test_coder_jax.py": TwinFile("test_coder_jax.py", port_subs=(
        ("from seaweedfs_tpu_torch.ops.coder_jax import JaxCoder",
         "from seaweedfs_tpu_torch.ops.coder_torch import TorchCoder"),
        ("from seaweedfs_tpu_torch.ops.coder_pallas import BLOCK_N, "
         "PallasCoder",
         "from seaweedfs_tpu_torch.ops.coder_cuda import BLOCK_N, "
         "CudaCoder"),
        ("JaxCoder(10, 4)", 'TorchCoder(10, 4, device="cpu")'),
        ("JaxCoder(16, 4)", 'TorchCoder(16, 4, device="cpu")'),
        ("isinstance(new_coder(), JaxCoder)",
         'isinstance(new_coder(device="cpu"), TorchCoder)'),
        ("PallasCoder(10, 4)", 'CudaCoder(10, 4, device="cpu")'),
        ("SEAWEEDFS_TPU_CODER", "SEAWEEDFS_TORCH_CODER"),
        ('"SEAWEEDFS_TORCH_CODER", "jax")',
         '"SEAWEEDFS_TORCH_CODER", "torch")'),
        ("isinstance(new_coder(), NumpyCoder)",
         'isinstance(new_coder(device="cpu"), NumpyCoder)'),
        ("        new_coder()\n", '        new_coder(device="cpu")\n'),
        ('for b in ("numpy", "jax", "pallas"):',
         'for b in ("numpy", "torch", "cuda"):'),
        ("c = new_coder(backend=b)", 'c = new_coder(backend=b, device="cpu")'),
    ), record_subs=(
        ("SEAWEEDFS_TORCH_CODER", "SEAWEEDFS_TPU_CODER"),
        ("('cuda', 'torch', 'native', 'numpy')",
         "('numpy', 'native', 'jax', 'pallas')"),
    )),
}
CASES = [(f, c) for f, twin in TWINS.items() for c in twin.ids()]


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{f}::{c}" for f, c in CASES])
def test_coder_case_in_both_packages(name, case, tmp_path):
    TWINS[name].run(case, tmp_path)
