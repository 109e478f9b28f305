"""The port's batched multi-volume encode and rebuild held against
seaweedfs_tpu's single-volume `write_ec_files` / `rebuild_ec_files`.

Three volumes of 1-3 MiB, written by seaweedfs_tpu's `Volume`, go
through `parallel.cluster_encode.batch_encode_files` in one group at the
module's own block sizes (1 GiB large, 1 MiB small, 4 MiB chunks — the
batched path has no shrunken geometry, so the volumes stay small
instead); every `.ec00`-`.ec13`, `.ecx`, `.vif` and `.ecc` must equal the
reference's per-volume output, for rs and lrc, with fused CRC forced on
and off.  The batched rebuild of a 4-loss RS group and an LRC local
group must restore the shards and give the `.ecc` entries of the
reference's `rebuild_ec_files`.  The port runs on a mesh of one CPU
device (the kernels' plain versions).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu.core.needle import Needle as RefNeedle
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch.ec import to_ext
from seaweedfs_tpu_torch.parallel import cluster_encode, cluster_rebuild
from seaweedfs_tpu_torch.parallel.mesh import make_mesh
from seaweedfs_tpu_torch.parallel.stream_pipeline import PipelineRecorder

pytestmark = pytest.mark.torch

torch.set_num_threads(1)

MIB = 1024 * 1024
EC_EXTS = [to_ext(i) for i in range(14)] + [".ecx", ".vif", ".ecc"]
SIZES_MIB = (1.5, 3.0, 1.0)


def _write_ref_volume(root, vid: int, mib: float, seed: int) -> str:
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    v = Volume(str(root), "", vid)
    nid, total = 0, 0
    while total < mib * MIB:
        nid += 1
        data = rng.bytes(int(rng.integers(1000, 300_000)))
        n = RefNeedle(cookie=0x5150 + nid, id=nid, data=data)
        n.append_at_ns = nid
        v.write_needle(n)
        total += len(data)
    v.sync()
    base = v.file_name()
    v.close()
    return base


@pytest.fixture(scope="module")
def dats(tmp_path_factory):
    root = tmp_path_factory.mktemp("dats")
    return [_write_ref_volume(root, i + 1, mib, 100 + i)
            for i, mib in enumerate(SIZES_MIB)]


def _clone(bases, root, exts=(".dat", ".idx")) -> list[str]:
    """Hard links of the files `exts` of each base under root: the
    encoders and rebuilders only read them, or replace them whole."""
    os.makedirs(root, exist_ok=True)
    out = []
    for base in bases:
        dst = os.path.join(str(root), os.path.basename(base))
        for ext in exts:
            if os.path.exists(base + ext):
                os.link(base + ext, dst + ext)
        out.append(dst)
    return out


@pytest.fixture(scope="module")
def refs(dats, tmp_path_factory):
    """seaweedfs_tpu's write_ec_files of every volume, once per codec
    (its files do not depend on SEAWEEDFS_TPU_EC_FUSED_CRC)."""
    made: dict[str, list[str]] = {}

    def get(codec: str) -> list[str]:
        if codec not in made:
            out = _clone(dats, tmp_path_factory.mktemp(f"ref_{codec}"))
            for ref in out:
                ref_encoder.write_sorted_file_from_idx(ref)
                ref_encoder.write_ec_files(ref, codec=codec)
            made[codec] = out
        return made[codec]
    return get


def _assert_same(a: str, b: str, exts=EC_EXTS) -> None:
    for ext in exts:
        assert os.path.exists(a + ext) == os.path.exists(b + ext), ext
        if os.path.exists(a + ext):
            with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
                assert fa.read() == fb.read(), ext


def _mesh():
    return make_mesh(devices=[torch.device("cpu")])


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("codec", ["rs", "lrc"])
def test_batched_encode_equals_reference(dats, refs, tmp_path, monkeypatch,
                                         codec, fused):
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", fused)
    mine = _clone(dats, tmp_path / "port")
    rec = PipelineRecorder()
    lines = cluster_encode.batch_encode_files(mine, _mesh(), codec=codec,
                                              recorder=rec)
    assert len(lines) == 3
    for a, b in zip(mine, refs(codec)):
        _assert_same(a, b)
    # one group, one step of three volumes: every stage was recorded
    assert set(rec.stage_seconds()) == {"stack", "dispatch", "device",
                                        "drain"}


def test_batched_encode_groups_by_max_batch_bytes(dats, refs, tmp_path,
                                                  monkeypatch):
    """Groups of at least max_batch_bytes of `.dat` each: with a 1-byte
    bound every volume is its own group, and the files do not change."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", "1")
    mine = _clone(dats, tmp_path / "port")
    lines = cluster_encode.batch_encode_files(mine, _mesh(),
                                              max_batch_bytes=1, depth=0)
    assert all("1 volumes per step" in line for line in lines)
    for a, b in zip(mine, refs("rs")):
        _assert_same(a, b)


def test_batched_encode_refuses_bad_chunk_size(tmp_path):
    for chunk in (MIB // 2, 3 * MIB):
        with pytest.raises(ValueError, match="chunk_size"):
            cluster_encode.batch_encode_files([], _mesh(), chunk_size=chunk)


@pytest.mark.parametrize("codec,lost", [("rs", (1, 3, 9, 12)),
                                        ("lrc", (3,))])
def test_batched_rebuild_equals_reference(refs, tmp_path, monkeypatch,
                                          codec, lost):
    """Both packages rebuild from seaweedfs_tpu's shards (hard links):
    the port's rebuilt shards and `.ecc` must equal the reference's
    rebuild_ec_files output and the original shards."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", "1")
    exts = [".dat", ".idx"] + EC_EXTS
    originals = refs(codec)
    ref = _clone(originals, tmp_path / "ref", exts)
    mine = _clone(originals, tmp_path / "port", exts)
    for r, base in zip(ref, mine):
        for sid in lost:
            os.remove(r + to_ext(sid))
            os.remove(base + to_ext(sid))
        assert ref_encoder.rebuild_ec_files(r) == list(lost)
    # 2 MiB of shards per sub-batch: the 3 volumes split into sub-batches
    rec = PipelineRecorder()
    lines = cluster_rebuild.batch_rebuild_files(
        mine, _mesh(), max_batch_bytes=2 * MIB, recorder=rec)
    assert len(lines) == 3 and all("rebuilt" in line for line in lines)
    if codec == "lrc":
        assert all("read 5 shards vs 10" in line for line in lines)
    assert len({i for _s, i, _a, _b in rec.spans()}) > 1
    for base, r, orig in zip(mine, ref, originals):
        _assert_same(base, r)
        _assert_same(base, orig, [to_ext(s) for s in lost])


def test_batched_rebuild_skips_unrecoverable_and_complete(refs, tmp_path):
    mine = _clone(refs("rs")[:2], tmp_path / "port", [".dat", ".idx"]
                  + EC_EXTS)
    for sid in range(5):
        os.remove(mine[0] + to_ext(sid))
    lines = cluster_rebuild.batch_rebuild_files(mine, _mesh())
    assert len(lines) == 1 and "SKIPPED" in lines[0]


def test_rebuild_group_takes_gather_and_placement(tmp_path):
    """rebuild_group with caller-supplied gather and placement, as the
    cluster slice plugs in its shard fetch and scatter; survivors of
    unequal length are refused as the reference refuses them."""
    from seaweedfs_tpu_torch.codecs import get_codec
    from seaweedfs_tpu_torch.ops.coder_numpy import NumpyCoder
    rng = np.random.default_rng(3)
    full = {vid: NumpyCoder().encode_all(rng.integers(
        0, 256, (10, MIB), dtype=np.uint8)) for vid in ("a", "b")}
    placed = {}
    present = tuple(range(1, 14))
    lines = cluster_rebuild.rebuild_group(
        get_codec("rs"), present, (0,), ["a", "b"],
        lambda vid, used: [full[vid][s] for s in used],
        lambda vid, missing, shards, crcs: placed.update(
            {vid: (list(missing), shards, crcs)}),
        _mesh(), depth=0)
    assert len(lines) == 2
    for vid in ("a", "b"):
        missing, shards, crcs = placed[vid]
        assert missing == [0] and np.array_equal(shards[0], full[vid][0])
    with pytest.raises(ValueError, match="survivor shards disagree on size"):
        cluster_rebuild.rebuild_group(
            get_codec("rs"), present, (0,), ["a"],
            lambda vid, used: [full[vid][s][: MIB - (s == 5)] for s in used],
            lambda *a: None, _mesh(), depth=0)


def test_plan_repair_reads_equals_reference():
    from seaweedfs_tpu import codecs as ref_codecs
    from seaweedfs_tpu.parallel.cluster_rebuild import \
        plan_repair_reads as ref_plan
    from seaweedfs_tpu_torch.codecs import get_codec
    for name, missing in (("lrc", (3,)), ("lrc", (3, 7)), ("lrc", (12,)),
                          ("rs", (1, 3, 9, 12))):
        present = tuple(s for s in range(14) if s not in missing)
        assert cluster_rebuild.plan_repair_reads(
            get_codec(name), present, missing) == \
            ref_plan(ref_codecs.get_codec(name), present, missing)


def test_batched_paths_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster_encode.batch_encode_files([str(tmp_path / "1")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster_rebuild.batch_rebuild_files([str(tmp_path / "1")])


def test_pipeline_depth_from_environment(monkeypatch):
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_PIPELINE_DEPTH", raising=False)
    assert cluster_encode.pipeline_depth() == 2
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_PIPELINE_DEPTH", "0")
    assert cluster_encode.pipeline_depth() == 0
    assert cluster_encode.pipeline_depth(3) == 3
