"""The port's batched rebuild held to its byte budget: a volume whose
survivors and rebuilt shards do not fit in `max_batch_bytes` goes to the
device in column steps, and the files it writes are those of the JAX
package's unsplit rebuild.

Three volumes of 3, 1 and 2 MiB shards (.dat of ~25, ~5 and ~15 MiB,
written by the port's `DatWriter` from a seed and encoded by its
`write_ec_files` on the CPU) lose shards 1, 3, 9 and 12 (RS 10->4) or
shard 3 (LRC's 5-read local repair).  `batch_rebuild_files`, and the
shell's wire `batch_rebuild` through a live port cluster, rebuild them
with a budget below one volume: the 3 MiB volume goes in two column
steps, the last of them ragged (2 MiB + 1 MiB), the others whole.  Every
rebuilt shard file and its `.ecc` entry must equal the reference's
`rebuild_ec_files` of the same survivors, and every step's stacked
input plus output, read from the `batch_rebuild_device` stage bytes,
must stay within the budget.  The port runs on a mesh of one CPU device
(the kernels' plain versions).
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec.integrity import ShardChecksums as RefChecksums
from seaweedfs_tpu_torch.core.needle import Needle
from seaweedfs_tpu_torch.ec import to_ext
from seaweedfs_tpu_torch.ec.encoder import (write_ec_files,
                                            write_sorted_file_from_idx)
from seaweedfs_tpu_torch.ec.integrity import ShardChecksums
from seaweedfs_tpu_torch.parallel import cluster_rebuild
from seaweedfs_tpu_torch.parallel.mesh import make_mesh
from seaweedfs_tpu_torch.storage.dat_writer import DatWriter

from _torch_cluster import (PORT, LiveCluster,  # noqa: F401
                            cluster_deadline, hermetic_port_state)

pytestmark = pytest.mark.torch

torch.set_num_threads(1)

MIB = 1024 * 1024
DAT_MIB = (25, 5, 15)  # shards of 3, 1 and 2 MiB
LOST = {"rs": (1, 3, 9, 12), "lrc": (3,)}
USED = {"rs": 10, "lrc": 5}
# Two column units of (used + missing) rows: the 3 MiB volume splits
# into 2 + 1 MiB, the 2 MiB one just fits whole, the 1 MiB one too.
BUDGET = {c: 2 * MIB * (USED[c] + len(LOST[c])) for c in LOST}


def _write_dat(base: str, mib: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    with DatWriter(base) as w:
        nid = 0
        while w.size < mib * MIB - 2 * MIB:
            nid += 1
            n = Needle(cookie=nid, id=nid,
                       data=rng.bytes(int(rng.integers(1000, 2 * MIB))))
            n.append_at_ns = nid
            w.write_needle(n)


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """Per codec, the three volumes' bases with their 14 shards."""
    out = {}
    for codec in LOST:
        root = tmp_path_factory.mktemp(f"vols_{codec}")
        bases = []
        for i, mib in enumerate(DAT_MIB):
            base = str(root / str(i + 1))
            _write_dat(base, mib, 40 + i)
            write_sorted_file_from_idx(base)
            write_ec_files(base, codec=codec, device="cpu")
            os.remove(base + ".dat")
            bases.append(base)
        out[codec] = bases
    return out


def _copy(bases, root) -> list[str]:
    os.makedirs(root, exist_ok=True)
    out = []
    for base in bases:
        dst = os.path.join(str(root), os.path.basename(base))
        for name in os.listdir(os.path.dirname(base)):
            if name.startswith(os.path.basename(base) + "."):
                shutil.copy(os.path.join(os.path.dirname(base), name),
                            os.path.join(str(root), name))
        out.append(dst)
    return out


def _reference_rebuild(bases, lost, root) -> list[str]:
    """The JAX package's unsplit `rebuild_ec_files` of copies of the
    survivors."""
    refs = _copy(bases, root)
    for ref in refs:
        for sid in lost:
            if os.path.exists(ref + to_ext(sid)):
                os.remove(ref + to_ext(sid))
        assert ref_encoder.rebuild_ec_files(ref) == list(lost)
    return refs


def _record_steps(monkeypatch) -> list[int]:
    """The stacked survivor bytes of every device step."""
    steps: list[int] = []
    real = cluster_rebuild.observe_batch_stage

    def observe(stages, stage, seconds, nbytes):
        if stage == "batch_rebuild_device":
            steps.append(nbytes)
        real(stages, stage, seconds, nbytes)
    monkeypatch.setattr(cluster_rebuild, "observe_batch_stage", observe)
    return steps


def _assert_within_budget(steps, codec) -> None:
    used, rows = USED[codec], USED[codec] + len(LOST[codec])
    # Stacked input plus the rebuilt output of each step.
    assert all(n // used * rows <= BUDGET[codec] for n in steps), steps


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("volumes", ["one", "three"])
@pytest.mark.parametrize("codec", ["rs", "lrc"])
def test_column_steps_equal_unsplit_rebuild(encoded, tmp_path, monkeypatch,
                                            codec, volumes, fused):
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", fused)
    originals = encoded[codec][:1 if volumes == "one" else 3]
    lost = LOST[codec]
    refs = _reference_rebuild(originals, lost, tmp_path / "ref")
    mine = _copy(originals, tmp_path / "port")
    for base in mine:
        for sid in lost:
            os.remove(base + to_ext(sid))
    steps = _record_steps(monkeypatch)
    lines = cluster_rebuild.batch_rebuild_files(
        mine, make_mesh(devices=[torch.device("cpu")]),
        max_batch_bytes=BUDGET[codec])
    assert len(lines) == len(mine)
    assert all("rebuilt shards" in line for line in lines)
    # The 3 MiB volume in 2 + 1 MiB, each other volume whole.
    used = USED[codec]
    assert steps == [2 * MIB * used, MIB * used, MIB * used,
                     2 * MIB * used][:len(mine) + 1]
    _assert_within_budget(steps, codec)
    for base, ref in zip(mine, refs):
        ecc, ref_ecc = ShardChecksums.load(base), RefChecksums.load(ref)
        for sid in lost:
            with open(base + to_ext(sid), "rb") as a, \
                    open(ref + to_ext(sid), "rb") as b:
                assert a.read() == b.read(), (base, sid)
            assert ecc.get(sid) == ref_ecc.get(sid), (base, sid)
        with open(base + ".ecc", "rb") as a, open(ref + ".ecc", "rb") as b:
            assert a.read() == b.read()


def test_steps_plan_the_budget():
    """Whole volumes share a step while rows x the widest fit; a volume
    that does not fit alone goes in unit-aligned column steps, the last
    ragged; one that is a single unit goes whole whatever the budget."""
    plan = list(cluster_rebuild._steps([3 * MIB, MIB, MIB, 2 * MIB], 14,
                                       MIB, 28 * MIB))
    assert plan == [([0], (0, 2 * MIB)), ([0], (2 * MIB, 3 * MIB)),
                    ([1, 2], None), ([3], None)]
    assert list(cluster_rebuild._steps([MIB, 5 * MIB], 14, MIB, 1)) == [
        ([0], None)] + [([1], (k * MIB, (k + 1) * MIB)) for k in range(5)]
    # Equal volumes group as the reference groups them: budget // per_vol.
    assert [len(i) for i, _ in cluster_rebuild._steps(
        [MIB] * 7, 14, MIB, 30 * MIB)] == [2, 2, 2, 1]


def _fill_collection(cluster, collection: str, mib: int, seed: int):
    client = cluster.client()
    cluster.rpc.call_json(f"{cluster.url()}/vol/grow?count=1&collection="
                          f"{collection}", "POST")
    rng = np.random.default_rng(seed)
    vid, total = None, 0
    while total < (mib - 2) * MIB:
        data = rng.bytes(int(rng.integers(MIB // 2, 2 * MIB)))
        fid = client.upload_data(data, collection=collection)
        vid = vid or int(fid.split(",")[0])
        assert int(fid.split(",")[0]) == vid
        total += len(data)
    return vid


SPREAD = ([0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11, 12, 13])


def _encode_and_spread(cluster, vid: int) -> None:
    rpc = cluster.rpc
    src = cluster.client().lookup(vid)[0]["url"]
    rpc.call_json(f"http://{src}/admin/ec/generate", "POST", {"volume": vid})
    for vs, shards in zip(cluster.servers, SPREAD):
        if vs.url() != src:
            rpc.call_json(f"http://{vs.url()}/admin/ec/copy_shard", "POST",
                          {"volume": vid, "source": src, "shards": shards,
                           "copy_ecx": True})
    for vs, shards in zip(cluster.servers, SPREAD):
        rpc.call_json(f"http://{vs.url()}/admin/ec/mount", "POST",
                      {"volume": vid})
        rpc.call_json(f"http://{vs.url()}/admin/ec/delete_shards", "POST",
                      {"volume": vid, "shards": [
                          s for s in range(14) if s not in shards]})
    rpc.call_json(f"http://{src}/admin/delete_volume", "POST",
                  {"volume": vid})


@pytest.mark.usefixtures("cluster_deadline")
def test_wire_column_steps_equal_unsplit_rebuild(tmp_path, monkeypatch):
    """`ec.rebuild -batch`'s `batch_rebuild` over a live port cluster:
    survivors gathered by range (`/admin/ec/shard_read`), each split
    volume's rebuilt shards pushed piece by piece at their offsets as
    each column step drains (tests/test_torch_wire_pieces.py pins the
    pieces)."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", "1")
    cluster = LiveCluster(PORT, tmp_path / "cluster")
    try:
        vids = [_fill_collection(cluster, f"c{i}", mib, 60 + i)
                for i, mib in enumerate(DAT_MIB)]
        for vid in vids:
            _encode_and_spread(cluster, vid)
        cluster.freshen()
        env = cluster.env()
        survivors = tmp_path / "survivors"
        survivors.mkdir()
        bases = []
        for vid in vids:
            locs = env.ec_shard_locations(vid)
            base = str(survivors / str(vid))
            for sid in range(14):
                cluster.rpc.call_to_file(
                    f"http://{locs[sid][0]}/admin/ec/shard_file?volume={vid}"
                    f"&shard={sid}", base + to_ext(sid))
            for ext in (".ecx", ".vif"):
                try:
                    cluster.rpc.call_to_file(
                        f"http://{locs[0][0]}/admin/ec/shard_file?"
                        f"volume={vid}&ext={ext}", base + ext)
                except cluster.rpc.RpcError:  # an RS volume has no .vif
                    if os.path.exists(base + ext):
                        os.remove(base + ext)
            for sid in LOST["rs"]:
                holder = env.ec_shard_locations(vid)[sid][0]
                cluster.rpc.call_json(
                    f"http://{holder}/admin/ec/delete_shards", "POST",
                    {"volume": vid, "shards": [sid]})
            bases.append(base)
        refs = _reference_rebuild(bases, LOST["rs"], tmp_path / "ref")
        cluster.freshen()
        steps = _record_steps(monkeypatch)
        lines = cluster_rebuild.batch_rebuild(
            env, vids, mesh=make_mesh(devices=[torch.device("cpu")]),
            max_batch_bytes=BUDGET["rs"])
        assert all("rebuilt shards" in line for line in lines), lines
        assert steps == [20 * MIB, 10 * MIB, 10 * MIB, 20 * MIB]
        _assert_within_budget(steps, "rs")
        cluster.freshen()
        for vid, ref in zip(vids, refs):
            locs = env.ec_shard_locations(vid)
            assert sorted(locs) == list(range(14))
            ref_ecc = RefChecksums.load(ref)
            for sid in LOST["rs"]:
                target = cluster.server(locs[sid][0])
                got = bytes(cluster.rpc.call(
                    f"http://{target.url()}/admin/ec/shard_file?"
                    f"volume={vid}&shard={sid}"))
                with open(ref + to_ext(sid), "rb") as f:
                    assert got == f.read(), (vid, sid)
                ecc = ShardChecksums.load(target._volume_base(vid))
                assert ecc.get(sid) == ref_ecc.get(sid), (vid, sid)
    finally:
        cluster.stop()


def test_shard_size_probe_finds_every_length(monkeypatch):
    """The wire path's size probe against stand-in holders: whole-block
    shards, a ragged one, one byte and an empty one."""
    for size in (0, 1, MIB - 1, MIB, MIB + 1, 3 * MIB, 5 * MIB + 12345):
        calls = []

        def fetch(holders, vid, sid, span=None, size=size):
            calls.append(span)
            lo, hi = span
            return b"\x01" * max(0, min(hi, size) - lo)
        monkeypatch.setattr(cluster_rebuild, "_fetch_shard", fetch)
        assert cluster_rebuild._shard_size(["h"], 1, 0) == size
        assert len(calls) <= 2 * 32
