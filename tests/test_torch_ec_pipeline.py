"""The port's EC file pipeline held against seaweedfs_tpu on one volume.

Both packages run on a `.dat` written by seaweedfs_tpu's `Volume` (as
tests/test_ec_pipeline.py builds it): every `.ec00`-`.ec13`, `.ecx`,
`.ecc` and `.vif` must be byte-identical, at the shrunken block sizes
and at the default sizes with fused CRC on and off; rebuild must be
byte-identical; degraded reads must return the payloads; each package
opens the other's shards; the port's `.dat`/`.idx` writer must produce
`Volume`'s bytes.  The port runs on the CPU (its kernels' plain
versions); seaweedfs_tpu runs its Pallas kernels in interpret mode or
the numpy oracle.
"""

from __future__ import annotations

import os
import random
import shutil
from dataclasses import astuple

import numpy as np
import pytest
import torch

from seaweedfs_tpu.core import types as ref_t
from seaweedfs_tpu.core.needle import Needle as RefNeedle
from seaweedfs_tpu.core.replica_placement import ReplicaPlacement as RefRP
from seaweedfs_tpu.core.super_block import SuperBlock as RefSuperBlock
from seaweedfs_tpu.core.ttl import TTL as RefTTL
from seaweedfs_tpu.ec import decoder as ref_decoder
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec.locate import locate_data as ref_locate_data
from seaweedfs_tpu.ec.volume import EcVolume as RefEcVolume
from seaweedfs_tpu.ops.coder_numpy import NumpyCoder as RefNumpyCoder
from seaweedfs_tpu.ops.coder_pallas import PallasCoder
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch.core import types as t
from seaweedfs_tpu_torch.core.needle import Needle
from seaweedfs_tpu_torch.core.replica_placement import ReplicaPlacement
from seaweedfs_tpu_torch.core.super_block import SuperBlock
from seaweedfs_tpu_torch.core.ttl import TTL
from seaweedfs_tpu_torch.ec import decoder, encoder, to_ext
from seaweedfs_tpu_torch.ec.integrity import ShardChecksums, file_block_crcs
from seaweedfs_tpu_torch.ec.locate import locate_data
from seaweedfs_tpu_torch.ec.volume import EcVolume
from seaweedfs_tpu_torch.ops.coder_cuda import CudaCoder
from seaweedfs_tpu_torch.ops.erasure import new_coder
from seaweedfs_tpu_torch.storage.dat_writer import DatWriter

pytestmark = pytest.mark.torch

# One intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests in other files must not lose their cores.
torch.set_num_threads(1)

LARGE, SMALL = 10000, 100  # the Go test's shrunken block sizes
MIB = 1024 * 1024
EC_EXTS = [to_ext(i) for i in range(14)] + [".ecx", ".ecc", ".vif"]


def _small_payloads():
    rng = random.Random(42)
    return {i: bytes(rng.randrange(256) for _ in range(rng.randrange(1, 800)))
            for i in range(1, 121)}


def _large_payloads():
    """~12 MiB of needles log-uniform in 1 KiB..1 MiB: two default 10 MiB
    small-block rows, many needles crossing 1 MiB block boundaries."""
    rng = np.random.default_rng(5)
    out, total, i = {}, 0, 0
    while total < 12 * MIB:
        i += 1
        size = int(np.exp(rng.uniform(np.log(1024), np.log(MIB))))
        out[i] = rng.bytes(size)
        total += size
    return out


def _write_ref_volume(root, payloads) -> str:
    os.makedirs(root, exist_ok=True)
    v = Volume(str(root), "", 1)
    for nid, data in payloads.items():
        n = RefNeedle(cookie=0x9999 + nid, id=nid, data=data)
        n.append_at_ns = nid  # deterministic
        v.write_needle(n)
    v.sync()
    base = v.file_name()
    v.close()
    return base


def _clone(base: str, root) -> str:
    os.makedirs(root, exist_ok=True)
    dst = os.path.join(str(root), os.path.basename(base))
    for ext in (".dat", ".idx"):
        shutil.copyfile(base + ext, dst + ext)
    return dst


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    root = tmp_path_factory.mktemp("vols")
    small, large = _small_payloads(), _large_payloads()
    return {"small": (_write_ref_volume(root / "small", small), small),
            "large": (_write_ref_volume(root / "large", large), large)}


def _assert_same_ec_files(a: str, b: str) -> None:
    for ext in EC_EXTS:
        assert os.path.exists(a + ext) == os.path.exists(b + ext), ext
        if os.path.exists(a + ext):
            with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
                assert fa.read() == fb.read(), ext


def _encode_pair(volumes, name, tmp_path, port_coder, ref_coder, **kw):
    base, payloads = volumes[name]
    ref, port = _clone(base, tmp_path / "ref"), _clone(base, tmp_path / "port")
    ref_encoder.write_sorted_file_from_idx(ref)
    ref_encoder.write_ec_files(ref, coder=ref_coder, **kw)
    encoder.write_sorted_file_from_idx(port)
    encoder.write_ec_files(port, coder=port_coder, **kw)
    return ref, port, payloads


@pytest.fixture(scope="module")
def encoded_large(volumes, tmp_path_factory):
    """The large volume encoded once by each package (default sizes)."""
    return _encode_pair(volumes, "large", tmp_path_factory.mktemp("enc"),
                        CudaCoder(device="cpu"), RefNumpyCoder())


def _copy_pair(pair, tmp_path):
    """A private copy of an encoded (ref, port, payloads) pair."""
    ref, port, payloads = pair
    bases = []
    for base, name in ((ref, "ref"), (port, "port")):
        dst = tmp_path / name
        shutil.copytree(os.path.dirname(base), dst)
        bases.append(os.path.join(str(dst), os.path.basename(base)))
    return bases[0], bases[1], payloads


@pytest.mark.parametrize("name", ["small", "large"])
def test_dat_writer_matches_volume(volumes, name, tmp_path):
    base, payloads = volumes[name]
    mine = str(tmp_path / "1")
    with DatWriter(mine) as w:
        for nid, data in payloads.items():
            n = Needle(cookie=0x9999 + nid, id=nid, data=data)
            n.append_at_ns = nid
            w.write_needle(n)
    for ext in (".dat", ".idx"):
        with open(base + ext, "rb") as fa, open(mine + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext


@pytest.mark.parametrize("backend", ["cuda", "numpy"])
def test_shrunken_blocks_identical(volumes, backend, tmp_path):
    """large=10000, small=100: fused CRC is off by construction."""
    ref, port, payloads = _encode_pair(
        volumes, "small", tmp_path, new_coder(backend=backend, device="cpu"),
        RefNumpyCoder(), large_block_size=LARGE, small_block_size=SMALL,
        chunk_size=SMALL)
    _assert_same_ec_files(ref, port)
    vol = EcVolume(port, coder=new_coder(device="cpu"),
                   large_block_size=LARGE, small_block_size=SMALL)
    try:
        for nid, data in payloads.items():
            assert vol.read_needle(nid).data == data
    finally:
        vol.close()


@pytest.mark.parametrize("fused", ["1", "0"])
def test_default_blocks_identical(volumes, fused, tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", fused)
    calls = []
    orig = CudaCoder.encode_with_crc
    monkeypatch.setattr(CudaCoder, "encode_with_crc",
                        lambda self, d: calls.append(d.shape) or orig(self, d))
    ref, port, _ = _encode_pair(volumes, "large", tmp_path,
                                CudaCoder(device="cpu"),
                                PallasCoder(interpret=True))
    assert bool(calls) == (fused == "1")
    _assert_same_ec_files(ref, port)
    ecc = ShardChecksums.load(port)
    for sid in range(14):
        assert ecc.get(sid) == file_block_crcs(port + to_ext(sid))


@pytest.mark.parametrize("lost", [(1, 3, 9, 12), (0, 10, 11, 13)])
def test_rebuild_identical(encoded_large, lost, tmp_path):
    ref, port, _ = _copy_pair(encoded_large, tmp_path)
    originals = {}
    for sid in lost:
        with open(port + to_ext(sid), "rb") as f:
            originals[sid] = f.read()
        os.remove(ref + to_ext(sid))
        os.remove(port + to_ext(sid))
    assert ref_encoder.rebuild_ec_files(ref, coder=RefNumpyCoder()) == \
        list(lost)
    assert encoder.rebuild_ec_files(port, device="cpu") == list(lost)
    _assert_same_ec_files(ref, port)
    for sid in lost:
        with open(port + to_ext(sid), "rb") as f:
            assert f.read() == originals[sid]


def test_degraded_reads_and_cross_open(encoded_large, tmp_path):
    """Port reads its own and seaweedfs_tpu's shards with 4 missing;
    seaweedfs_tpu reads the port's."""
    ref, port, payloads = _copy_pair(encoded_large, tmp_path)
    for base in (ref, port):
        for sid in (0, 4, 8, 13):
            os.remove(base + to_ext(sid))
    for base in (ref, port):
        vol = EcVolume(base, device="cpu")
        try:
            assert vol.version == 3
            for nid, data in payloads.items():
                assert vol.read_needle(nid).data == data
        finally:
            vol.close()
    rvol = RefEcVolume(port, coder=RefNumpyCoder())
    try:
        for nid in list(payloads)[::7]:
            assert rvol.read_needle(nid).data == payloads[nid]
    finally:
        rvol.close()


def test_decoder_equal(encoded_large, tmp_path):
    ref, port, _ = _copy_pair(encoded_large, tmp_path)
    assert decoder.read_ec_volume_version(port) == \
        ref_decoder.read_ec_volume_version(ref)
    size = decoder.find_dat_file_size(port)
    assert size == ref_decoder.find_dat_file_size(ref)
    with open(port + ".dat", "rb") as f:
        original = f.read()
    os.remove(port + ".dat")
    decoder.write_dat_file(port, size)
    with open(port + ".dat", "rb") as f:
        assert f.read() == original[:size]


def test_entry_points_default_to_the_card(volumes, tmp_path):
    """Without device=, the entry points ask for CUDA and raise on a
    host with no card — they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    base = _clone(volumes["small"][0], tmp_path)
    encoder.write_sorted_file_from_idx(base)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder.write_ec_files(base)
    encoder.write_ec_files(base, coder=new_coder(backend="numpy",
                                                 device="cpu"))
    os.remove(base + to_ext(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder.rebuild_ec_files(base)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EcVolume(base)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_needle_bytes_equal(version):
    kw = dict(cookie=0x12345678, id=0xABCDEF, data=b"hello world" * 7)
    mine, ref = Needle(**kw), RefNeedle(**kw)
    for n, ttl in ((mine, TTL.parse("3d")), (ref, RefTTL.parse("3d"))):
        n.set_name(b"f.txt")
        n.set_mime(b"text/plain")
        n.set_last_modified(1700000000)
        n.set_ttl(ttl)
        n.set_pairs(b'{"a":"b"}')
        n.append_at_ns = 99
    blob = mine.to_bytes(version)
    assert blob == ref.to_bytes(version)
    back = Needle.from_bytes(blob, version)
    assert back.data == kw["data"] and back.id == kw["id"]
    if version > 1:
        assert back.name == b"f.txt" and back.ttl == TTL.parse("3d")


def test_superblock_and_index_bytes_equal():
    sb = SuperBlock(version=3, replica_placement=ReplicaPlacement.parse("012"),
                    ttl=TTL.parse("5h"), compaction_revision=7)
    ref = RefSuperBlock(version=3, replica_placement=RefRP.parse("012"),
                        ttl=RefTTL.parse("5h"), compaction_revision=7)
    assert sb.to_bytes() == ref.to_bytes()
    assert SuperBlock.from_bytes(ref.to_bytes()) == sb
    e = t.NeedleMapEntry(0x1122334455, 8 * 12345, -1)
    assert e.to_bytes() == ref_t.NeedleMapEntry(*astuple(e)).to_bytes()
    assert t.NeedleMapEntry.from_bytes(e.to_bytes()) == e


@pytest.mark.parametrize("seed", range(3))
def test_locate_data_equal(seed):
    rng = np.random.default_rng(seed)
    large, small = 10000, 100
    dat_size = int(rng.integers(10 * large, 40 * large))
    for _ in range(50):
        off = int(rng.integers(0, dat_size - 1))
        size = int(rng.integers(1, min(5 * large, dat_size - off) + 1))
        got = [astuple(iv)
               for iv in locate_data(large, small, dat_size, off, size)]
        want = [astuple(iv)
                for iv in ref_locate_data(large, small, dat_size, off, size)]
        assert got == want
