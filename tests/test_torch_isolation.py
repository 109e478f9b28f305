"""The PyTorch port stands alone: it imports neither jax nor
seaweedfs_tpu, and its entry points never fall back to the CPU unasked.

The pytest process has already imported JAX (tests/conftest.py), so the
import check runs in a subprocess with both names blocked.
"""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from seaweedfs_tpu_torch.ops.erasure import new_coder

pytestmark = pytest.mark.torch

# One intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests in other files must not lose their cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "seaweedfs_tpu_torch")
BANNED = ("jax", "jaxlib", "seaweedfs_tpu")

_BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "seaweedfs_tpu"):
    sys.modules[name] = None
import os, pkgutil, importlib, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
import seaweedfs_tpu_torch
for m in pkgutil.walk_packages(seaweedfs_tpu_torch.__path__,
                               "seaweedfs_tpu_torch."):
    importlib.import_module(m.name)
from seaweedfs_tpu_torch.core.needle import Needle
from seaweedfs_tpu_torch.ec.encoder import (rebuild_ec_files, write_ec_files,
                                            write_sorted_file_from_idx)
from seaweedfs_tpu_torch.ec.volume import EcVolume
from seaweedfs_tpu_torch.ops.erasure import host_array, new_coder
from seaweedfs_tpu_torch.storage.dat_writer import DatWriter
rng = np.random.default_rng(0)
coder = new_coder(device="cpu")
data = rng.integers(0, 256, (10, 5000), dtype=np.uint8)
assert host_array(coder.encode(data)).shape == (4, 5000)
with tempfile.TemporaryDirectory() as d:
    base = os.path.join(d, "7")
    payloads = {i: rng.bytes(int(rng.integers(1, 3000))) for i in range(1, 40)}
    with DatWriter(base) as w:
        for i, p in payloads.items():
            w.write_needle(Needle(cookie=i, id=i, data=p))
    write_sorted_file_from_idx(base)
    write_ec_files(base, device="cpu", large_block_size=10000,
                   small_block_size=100, chunk_size=100)
    os.remove(base + ".ec02")
    assert rebuild_ec_files(base, device="cpu") == [2]
    os.remove(base + ".ec05")
    vol = EcVolume(base, device="cpu", large_block_size=10000,
                   small_block_size=100)
    assert all(vol.read_needle(i).data == p for i, p in payloads.items())
    vol.close()
    from seaweedfs_tpu_torch.parallel.cluster_encode import batch_encode_files
    from seaweedfs_tpu_torch.parallel.cluster_rebuild import batch_rebuild_files
    from seaweedfs_tpu_torch.parallel.mesh import make_mesh
    lrc = os.path.join(d, "8")
    with DatWriter(lrc) as w:
        for i, p in payloads.items():
            w.write_needle(Needle(cookie=i, id=i, data=p))
    mesh = make_mesh(devices=[torch.device("cpu")])
    batch_encode_files([lrc], mesh, codec="lrc")
    os.remove(lrc + ".ec03")
    assert "read 5 shards" in batch_rebuild_files([lrc], mesh)[0]
    for backend in ("torch", "numpy"):
        c = new_coder(backend=backend, codec="lrc", device="cpu")
        assert host_array(c.encode(data)).shape == (4, 5000)
assert not any(sys.modules.get(n) for n in ("jax", "jaxlib", "seaweedfs_tpu"))
print("ISOLATED-OK")
"""


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_runs_with_jax_and_reference_blocked(tmp_path):
    r = _run([sys.executable, "-c", _BLOCKED_RUN], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-4000:]
    assert "ISOLATED-OK" in r.stdout


def _sources():
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                           "kernel_variants.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_module_imports_jax_or_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BANNED, f"{path}: {name}"


def test_new_coder_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_coder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_coder(backend="numpy")
    assert new_coder(backend="numpy", device="cpu").total_shards == 14
    assert new_coder(device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    from the repository and from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd in (REPO, str(alone)):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_native_crc_builds_from_source_when_the_committed_library_fails(
        tmp_path, monkeypatch):
    """A committed native/libseaweed_native.so that does not load on this
    host (built elsewhere) is replaced by a g++ build from
    native/seaweed_native.cpp in the port's build directory."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    from seaweedfs_tpu_torch.utils import native

    real_cdll = native.ctypes.CDLL
    committed = os.path.join(native.NATIVE_DIR, "libseaweed_native.so")

    def cdll(path, *a, **kw):
        if os.path.abspath(path) == committed:
            raise OSError("wrong ELF class")
        return real_cdll(path, *a, **kw)

    monkeypatch.setattr(native.ctypes, "CDLL", cdll)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    lib = native.load.__wrapped__()
    assert lib is not None
    assert os.listdir(tmp_path)
    assert native.crc32c_fn(lib)(b"123456789") == 0xE3069283
