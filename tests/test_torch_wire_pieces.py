"""The wire path of the port's batched EC verbs keeps to its step:
`ec.rebuild -batch` pushes a split volume's rebuilt shards piece by
piece at their offsets as each column step drains, `ec.encode -batch`
pushes a shard larger than a piece the same way, and the receiving
volume server streams each piece to the shard's temp file
(`/admin/ec/receive_shard?offset=&size=`), installing the shard only
when its last piece lands.

Live port clusters in this process (`_torch_cluster.LiveCluster`, the
kernels' plain versions on the CPU).  Volumes are written by the port's
`DatWriter` from a seed, into a volume server's directory before it
starts, or encoded outside the cluster and their shards spread over it.
Every shard, `.ecc` entry, `.ecx` and `.vif` either
verb installs must equal the JAX package's unsplit `write_ec_files` and
`rebuild_ec_files` of the same bytes (its native coder: its backends
agree byte for byte); every piece's width is pinned from the receiving
side; the rebuild's peak traced memory (`tracemalloc`, which sees
numpy's buffers and every bytes object, the in-process servers'
included) must stay below the lost shards' bytes of the volume; a piece
that fails fails the rebuild and installs nothing; and the reference's
whole push still installs a shard on a port server.
"""

from __future__ import annotations

import os
import shutil
import tracemalloc

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec.integrity import ShardChecksums as RefChecksums
from seaweedfs_tpu.ec.volume_info import \
    update_volume_info as ref_update_volume_info
from seaweedfs_tpu.ops.erasure import new_coder as ref_new_coder
from seaweedfs_tpu_torch import fault
from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
from seaweedfs_tpu_torch.core.needle import Needle
from seaweedfs_tpu_torch.ec import to_ext
from seaweedfs_tpu_torch.ec.encoder import (write_ec_files,
                                            write_sorted_file_from_idx)
from seaweedfs_tpu_torch.ec.integrity import ShardChecksums
from seaweedfs_tpu_torch.ops.erasure import new_coder
from seaweedfs_tpu_torch.parallel import cluster_encode, cluster_rebuild
from seaweedfs_tpu_torch.parallel.mesh import make_mesh
from seaweedfs_tpu_torch.storage.dat_writer import DatWriter

from _torch_cluster import (PORT, LiveCluster,  # noqa: F401
                            cluster_deadline, hermetic_port_state)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]

torch.set_num_threads(1)

MIB = 1024 * 1024
LOST = {"rs": (1, 3, 9, 12), "lrc": (3,)}
ROWS = {"rs": 14, "lrc": 6}  # survivors read plus shards rebuilt
# The volumes of the encode-then-rebuild case: shards of 3 MiB (split)
# and 1 MiB (whole).
SPLIT_MIB, WHOLE_MIB = 3, 1
# ec.rebuild -batch's budget: column steps of 2 MiB, so the 3 MiB
# volume goes in 2 + 1 MiB (a ragged last step) and the 1 MiB one whole.
REBUILD_BUDGET = {c: 2 * MIB * ROWS[c] for c in LOST}
# ec.encode -batch's scatter budget: pieces of 2 MiB (a quarter), so a
# 3 MiB shard goes in 2 + 1 MiB and a 1 MiB shard whole.
SCATTER_BUDGET = 8 * MIB
# The memory case: one RS volume of 10 MiB shards rebuilt in column
# steps of 1 MiB: its 4 lost shards hold 40 MiB.
MEM_MIB = 10
MEM_BUDGET = MIB * ROWS["rs"]


def _write_dat(base: str, shard_mib: int, seed: int) -> None:
    """A .dat/.idx from `seed` whose shards are `shard_mib` MiB."""
    rng = np.random.default_rng(seed)
    with DatWriter(base) as w:
        nid = 0
        while w.size < (10 * shard_mib - 1) * MIB - 64 * 1024:
            nid += 1
            room = (10 * shard_mib - 1) * MIB - w.size
            n = Needle(cookie=nid, id=nid, data=rng.bytes(
                int(min(room, rng.integers(1000, 2 * MIB)))))
            n.append_at_ns = nid
            w.write_needle(n)


def _start(tmp_path, volumes: dict, n: int = 4) -> LiveCluster:
    """A port cluster of `n` volume servers; `volumes` ({vid: (shard
    MiB, seed)}) are written into the first server's directory before
    it starts."""
    cluster = LiveCluster(PORT, tmp_path / "cluster", n=0)
    try:
        d = os.path.join(cluster.root, "vs0")
        os.makedirs(d)
        for vid, (mib, seed) in volumes.items():
            _write_dat(os.path.join(d, str(vid)), mib, seed)
        for _ in range(n):
            cluster.add_server()
        cluster.freshen()
    except BaseException:
        cluster.stop()
        raise
    return cluster


def _record_pieces(monkeypatch) -> list[tuple]:
    """(vid, sid, offset or None, size or None, body length) of every
    receive_shard the port's volume servers take, in arrival order."""
    seen: list[tuple] = []
    real = VolumeServer._ec_receive_shard

    def receive(self, query, body):
        # A streamed body has its length; a tree whose route takes the
        # body whole (before pieces) hands bytes.
        off = query.get("offset")
        seen.append((int(query["volume"]), int(query["shard"]),
                     None if off is None else int(off),
                     int(query["size"]) if "size" in query else None,
                     getattr(body, "length", None) or len(body)))
        return real(self, query, body)
    monkeypatch.setattr(VolumeServer, "_ec_receive_shard", receive)
    return seen


def _widths(seen, vid: int, sid: int) -> list[tuple]:
    return [(off, n) for v, s, off, _size, n in seen if (v, s) == (vid, sid)]


def _holder_files(cluster, vid: int) -> dict:
    """{shard id or extension: bytes} of `vid` on the live servers, each
    read from the server that holds it (the .ecx and .vif from the first
    holder), and {shard id: .ecc entry} from its holder's sidecar."""
    env = cluster.env()
    locs = env.ec_shard_locations(vid)
    files, ecc = {}, {}
    for sid, urls in locs.items():
        vs = cluster.server(urls[0])
        base = vs._volume_base(vid)
        with open(base + to_ext(sid), "rb") as f:
            files[sid] = f.read()
        ecc[sid] = ShardChecksums.load(base).get(sid)
    base = cluster.server(locs[0][0])._volume_base(vid)
    for ext in (".ecx", ".vif"):
        if os.path.exists(base + ext):
            with open(base + ext, "rb") as f:
                files[ext] = f.read()
    return files, ecc


def _reference_encode(dat_base: str, ref_base: str, codec: str) -> None:
    """The JAX package's unsplit write_ec_files of a copy of the .dat,
    then the .ecx and a fresh .vif (needle version and codec id) as its
    batched encoder writes them."""
    for ext in (".dat", ".idx"):
        shutil.copy(dat_base + ext, ref_base + ext)
    ref_encoder.write_ec_files(ref_base, coder=ref_new_coder(
        backend="native", codec=codec))
    ref_encoder.write_sorted_file_from_idx(ref_base)
    with open(ref_base + ".dat", "rb") as f:
        version = f.read(1)[0]
    if os.path.exists(ref_base + ".vif"):  # an RS encode writes none
        os.remove(ref_base + ".vif")
    ref_update_volume_info(ref_base, version=version, codec=codec)


def _assert_reference(files, ecc, ref_base: str, sids) -> None:
    ref_ecc = RefChecksums.load(ref_base)
    for sid in sids:
        with open(ref_base + to_ext(sid), "rb") as f:
            assert files[sid] == f.read(), sid
        assert ecc[sid] == ref_ecc.get(sid), sid


@pytest.mark.parametrize("codec", ["rs", "lrc"])
def test_encode_then_rebuild_in_pieces_equal_reference(
        tmp_path, monkeypatch, codec):
    """`ec.encode -batch` of a volume of 3 MiB shards (pushed in 2 + 1
    MiB pieces) and one of 1 MiB shards (pushed whole), then the lost
    shards of both rebuilt by `ec.rebuild -batch` (the 3 MiB volume in
    2 + 1 MiB column steps, each step's pieces at their offsets; the 1
    MiB one whole).  Every file equals the reference's."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SCATTER_BUDGET",
                       str(SCATTER_BUDGET))
    seen = _record_pieces(monkeypatch)
    vids = {201: (SPLIT_MIB, 70), 202: (WHOLE_MIB, 71)}
    cluster = _start(tmp_path, vids)
    try:
        mesh = make_mesh(devices=[torch.device("cpu")])
        refs = {}
        (tmp_path / "ref").mkdir()
        for vid in vids:
            refs[vid] = str(tmp_path / "ref" / str(vid))
            _reference_encode(os.path.join(cluster.root, "vs0", str(vid)),
                              refs[vid], codec)
        env = cluster.env()
        lines = cluster_encode.batch_encode(env, sorted(vids), mesh,
                                            codec=codec)
        assert len(lines) == 2 and all("ec shards on" in ln for ln in lines)
        cluster.freshen()
        total = 14
        for vid, (mib, _seed) in vids.items():
            files, ecc = _holder_files(cluster, vid)
            _assert_reference(files, ecc, refs[vid], range(total))
            for ext in (".ecx", ".vif"):
                with open(refs[vid] + ext, "rb") as f:
                    assert files[ext] == f.read(), (vid, ext)
            want = [(0, 2 * MIB), (2 * MIB, MIB)] if mib == SPLIT_MIB \
                else [(None, MIB)]
            for sid in range(total):
                assert _widths(seen, vid, sid) == want, (vid, sid)

        # Lose shards of both volumes, then ec.rebuild -batch.
        lost = LOST[codec]
        for vid in vids:
            for sid in lost:
                holder = env.ec_shard_locations(vid)[sid][0]
                cluster.rpc.call_json(
                    f"http://{holder}/admin/ec/delete_shards", "POST",
                    {"volume": vid, "shards": [sid]})
        cluster.freshen()
        for vid in vids:
            for sid in lost:
                os.remove(refs[vid] + to_ext(sid))
            assert ref_encoder.rebuild_ec_files(refs[vid]) == list(lost)
        seen.clear()
        lines = cluster_rebuild.batch_rebuild(
            env, sorted(vids), mesh, max_batch_bytes=REBUILD_BUDGET[codec])
        assert all("rebuilt shards" in ln for ln in lines), lines
        cluster.freshen()
        for vid, (mib, _seed) in vids.items():
            files, ecc = _holder_files(cluster, vid)
            assert sorted(k for k in files if isinstance(k, int)) == \
                list(range(total))
            _assert_reference(files, ecc, refs[vid], lost)
            want = [(0, 2 * MIB), (2 * MIB, MIB)] if mib == SPLIT_MIB \
                else [(None, MIB)]
            for sid in lost:
                assert _widths(seen, vid, sid) == want, (vid, sid)
            # Every piece names the shard's full length.
            assert {size for v, _s, off, size, _n in seen
                    if v == vid and off is not None} <= {mib * MIB}
    finally:
        cluster.stop()


def _place_encoded(cluster, tmp_path, vid: int, shard_mib: int,
                   seed: int) -> None:
    """A volume from `seed` encoded outside the cluster (the native
    coder, for speed: the backends agree byte for byte), its shards
    spread over the servers round robin with the .ecx, .vif and .ecc
    beside each, and mounted."""
    stage = tmp_path / "stage"
    stage.mkdir()
    base = str(stage / str(vid))
    _write_dat(base, shard_mib, seed)
    write_sorted_file_from_idx(base)
    write_ec_files(base, coder=new_coder(backend="native", device="cpu"))
    n = len(cluster.servers)
    for i, vs in enumerate(cluster.servers):
        dst = os.path.join(vs.store.locations[0].directory, str(vid))
        for sid in range(i, 14, n):
            shutil.copy(base + to_ext(sid), dst + to_ext(sid))
        for ext in (".ecx", ".vif", ".ecc"):
            if os.path.exists(base + ext):  # an RS encode writes no .vif
                shutil.copy(base + ext, dst + ext)
        cluster.rpc.call_json(f"http://{vs.url()}/admin/ec/mount", "POST",
                              {"volume": vid})
    cluster.freshen()


def _lose(cluster, vid: int, lost, ref_base: str) -> None:
    """Copy the survivors and sidecars to `ref_base`, delete `lost` on
    their holders and rebuild the copy with the reference."""
    env = cluster.env()
    locs = env.ec_shard_locations(vid)
    for sid in range(14):
        cluster.rpc.call_to_file(
            f"http://{locs[sid][0]}/admin/ec/shard_file?volume={vid}"
            f"&shard={sid}", ref_base + to_ext(sid))
    for ext in (".ecx", ".vif"):
        try:
            cluster.rpc.call_to_file(
                f"http://{locs[0][0]}/admin/ec/shard_file?volume={vid}"
                f"&ext={ext}", ref_base + ext)
        except cluster.rpc.RpcError:  # an RS volume has no .vif
            if os.path.exists(ref_base + ext):
                os.remove(ref_base + ext)
    for sid in lost:
        os.remove(ref_base + to_ext(sid))
        cluster.rpc.call_json(
            f"http://{locs[sid][0]}/admin/ec/delete_shards", "POST",
            {"volume": vid, "shards": [sid]})
    assert ref_encoder.rebuild_ec_files(ref_base) == list(lost)
    cluster.freshen()


def test_rebuild_memory_follows_the_step(tmp_path, monkeypatch):
    """One RS volume of 10 MiB shards loses 4 (40 MiB) and is rebuilt in
    column steps of 1 MiB: the process's peak traced memory over the
    rebuild stays below the 40 MiB of lost shards (a step in flight
    holds ~10 MiB of gathered survivors and their copies on the
    in-process holders' side; two steps' pieces, 4 MiB each, with
    theirs).  A rebuild that collects whole shards before it pushes
    them (the JAX package's, and the port's before pieces) holds at
    least those 40 MiB."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", "1")
    seen = _record_pieces(monkeypatch)
    vid, lost = 301, LOST["rs"]
    cluster = _start(tmp_path, {})
    try:
        _place_encoded(cluster, tmp_path, vid, MEM_MIB, 80)
        ref = str(tmp_path / "ref")
        _lose(cluster, vid, lost, ref)
        env = cluster.env()
        mesh = make_mesh(devices=[torch.device("cpu")])
        tracemalloc.start()
        try:
            tracemalloc.reset_peak()
            base_mem = tracemalloc.get_traced_memory()[0]
            lines = cluster_rebuild.batch_rebuild(
                env, [vid], mesh, max_batch_bytes=MEM_BUDGET)
            peak = tracemalloc.get_traced_memory()[1] - base_mem
        finally:
            tracemalloc.stop()
        assert all("rebuilt shards" in ln for ln in lines), lines
        lost_bytes = len(lost) * MEM_MIB * MIB
        assert peak < lost_bytes, (peak, lost_bytes)
        cluster.freshen()
        files, ecc = _holder_files(cluster, vid)
        _assert_reference(files, ecc, ref, lost)
        for sid in lost:
            assert _widths(seen, vid, sid) == [
                (k * MIB, MIB) for k in range(MEM_MIB)], sid
    finally:
        cluster.stop()


def test_failed_piece_fails_the_rebuild_and_installs_nothing(
        tmp_path, monkeypatch):
    """A volume of 3 MiB shards goes in three column steps of 1 MiB; a
    fault at a shard's second piece (`ec.scatter`, matched on its
    offset) fails `ec.rebuild -batch`: no lost shard is on any disk or
    mounted anywhere.  A second `ec.rebuild -batch` starts each shard
    again at offset 0 and installs the reference's bytes."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", "1")
    vid, lost = 401, LOST["rs"]
    cluster = _start(tmp_path, {})
    try:
        _place_encoded(cluster, tmp_path, vid, 3, 90)
        ref = str(tmp_path / "ref")
        _lose(cluster, vid, lost, ref)
        env = cluster.env()
        mesh = make_mesh(devices=[torch.device("cpu")])
        fault.registry.arm("ec.scatter", f"fail*1~{MIB}")
        with pytest.raises(cluster.rpc.RpcError, match="ec.scatter"):
            cluster_rebuild.batch_rebuild(env, [vid], mesh,
                                          max_batch_bytes=MEM_BUDGET)
        cluster.freshen()
        assert not set(env.ec_shard_locations(vid)) & set(lost)
        for vs in cluster.servers:
            base = vs._volume_base(vid)
            assert not any(os.path.exists(base + to_ext(s)) for s in lost)
            ev = vs.ec_volumes.get(vid)
            assert ev is None or not set(ev.shards) & set(lost)
        lines = cluster_rebuild.batch_rebuild(env, [vid], mesh,
                                              max_batch_bytes=MEM_BUDGET)
        assert all("rebuilt shards" in ln for ln in lines), lines
        cluster.freshen()
        files, ecc = _holder_files(cluster, vid)
        _assert_reference(files, ecc, ref, lost)
    finally:
        cluster.stop()


@pytest.mark.parametrize("client", ["rebuild", "encode"])
def test_reference_whole_push_installs_on_a_port_server(tmp_path, client):
    """The JAX package's whole-shard push (its rebuild's `_push_shard`,
    its encode's `_scatter_shard`) to a port volume server installs the
    shard and fingerprints it as before: a push without `offset=` is a
    whole push."""
    from seaweedfs_tpu.parallel import cluster_encode as ref_encode
    from seaweedfs_tpu.parallel import cluster_rebuild as ref_rebuild
    vid, sid = 501, 5
    cluster = _start(tmp_path, {}, n=2)
    try:
        _place_encoded(cluster, tmp_path, vid, 1, 95)
        target, source = cluster.servers
        base = target._volume_base(vid)
        os.remove(base + ".ecx")
        path = str(tmp_path / "stage" / str(vid)) + to_ext(sid)
        with open(path, "rb") as f:
            body = f.read()
        if client == "rebuild":
            ref_rebuild._push_shard(vid, sid, body, target.url(),
                                    [source.url()])
        else:
            ref_encode._scatter_shard(target.url(), vid, sid, path,
                                      ref_encode._ByteBudget(1 << 20))
        with open(base + to_ext(sid), "rb") as f:
            assert f.read() == body
        assert ShardChecksums.load(base).get(sid) == \
            RefChecksums.load(str(tmp_path / "stage" / str(vid))).get(sid)
        # The rebuild's push names an .ecx source, which the target
        # pulls once the shard is installed.
        assert os.path.exists(base + ".ecx") == (client == "rebuild")
        assert not os.path.exists(f"{base}.rcv{sid}.tmp")
    finally:
        cluster.stop()
