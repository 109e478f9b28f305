"""The port's EC layout at the north-star volume size, held against the
JAX package's at the real geometry: 1 GiB large blocks, 1 MiB small
blocks, a `.dat` of 12 000 MiB (one large-block row) and of 30 000 MiB
(`weed master -volumeSizeLimitMB=30000`: two large-block rows, then 952
small rows).

- `locate_data` and `Interval.to_shard_id_and_offset` for seeded
  (offset, size) pairs, across every 1 GiB large-block boundary, across
  the transition from the large rows into the small ones, and across
  small-block boundaries;
- `_chunk_reader`'s plan over a sparse `.dat` of the full size: the
  offset and length of every read, and the shape of every chunk it
  yields, taken without reading (the reads are recorded, not made);
- the `.ecx` offset codec and binary search (`EcVolume.
  find_needle_from_ecx`) for needles at offsets above 4 GiB, on a
  synthetic `.ecx`.

Besides, chip_smoke.py's phase 4 runs on the CPU at a few MiB.
"""

from __future__ import annotations

import os
import types

import numpy as np
import pytest

from seaweedfs_tpu.core import types as ref_types
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import locate as ref_locate
from seaweedfs_tpu.ec import volume as ref_volume
from seaweedfs_tpu.ops.coder_numpy import NumpyCoder as RefNumpyCoder
from seaweedfs_tpu_torch.core import types as port_types
from seaweedfs_tpu_torch.ec import encoder as port_encoder
from seaweedfs_tpu_torch.ec import locate as port_locate
from seaweedfs_tpu_torch.ec import volume as port_volume
from seaweedfs_tpu_torch.ops.coder_numpy import NumpyCoder

pytestmark = pytest.mark.torch

MIB = 1024 * 1024
LARGE = 1024 * MIB
SMALL = MIB
CHUNK = 4 * MIB
DAT_MIB = (12000, 30000)


def _shard_bytes(dat: int) -> int:
    """The Go layout's shard size: large rows while more than one full
    row remains, then small rows."""
    rows, rest = 0, dat
    while rest > 10 * LARGE:
        rows += 1
        rest -= 10 * LARGE
    return rows * LARGE + -(-rest // (10 * SMALL)) * SMALL


def _pairs(dat: int, seed: int) -> list[tuple[int, int]]:
    """(offset, size) pairs: seeded ones, and ones across every large
    block boundary (the last of them the large-to-small transition) and
    across the first and last small-block boundaries."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(400):
        size = int(np.exp(rng.uniform(0, np.log(8 * MIB))))
        out.append((int(rng.integers(0, dat - size)), size))
    n_large = dat // (10 * LARGE)
    large_end = n_large * 10 * LARGE
    bounds = [k * LARGE for k in range(1, n_large * 10 + 1)]
    bounds += [large_end + k * SMALL for k in (1, 2, 10, 11)]
    bounds += [dat - 3 * SMALL, dat - SMALL]
    for b in bounds:
        out += [(b - 1, 2), (b - 4096, 8192), (b - 3 * MIB, 4 * MIB),
                (b, 100), (b - 100, 100)]
    return out


@pytest.mark.parametrize("dat_mib", DAT_MIB)
def test_locate_equals_reference_at_real_geometry(dat_mib):
    dat = 10 * _shard_bytes(dat_mib * MIB)  # what EcVolume passes
    large_rows = 0
    for offset, size in _pairs(dat, dat_mib):
        port = port_locate.locate_data(LARGE, SMALL, dat, offset, size)
        ref = ref_locate.locate_data(LARGE, SMALL, dat, offset, size)
        assert [vars(iv) for iv in port] == [vars(iv) for iv in ref], \
            (offset, size)
        assert [iv.to_shard_id_and_offset(LARGE, SMALL) for iv in port] == \
            [iv.to_shard_id_and_offset(LARGE, SMALL) for iv in ref]
        assert sum(iv.size for iv in port) == size
        large_rows = port[0].large_block_rows_count
    assert large_rows == (1 if dat_mib == 12000 else 2)
    # The transition: the last byte of the large rows is the last byte
    # of shard 9's last large block; the next is shard 0's first small
    # block.
    end = large_rows * 10 * LARGE
    ivs = port_locate.locate_data(LARGE, SMALL, dat, end - 1, 2)
    assert [iv.is_large_block for iv in ivs] == [True, False]
    assert [iv.to_shard_id_and_offset(LARGE, SMALL) for iv in ivs] == [
        (9, large_rows * LARGE - 1), (0, large_rows * LARGE)]


def _plan(encoder_mod, path: str, dat: int, monkeypatch) -> tuple:
    """Every read `_chunk_reader` makes and every chunk's shape, with
    the reads recorded and answered empty, and the chunks' buffers
    zero-strided views."""
    reads: list = []

    def pread(fd, n, offset):
        reads.append((offset, n))
        return b""

    fake_np = types.SimpleNamespace(
        zeros=lambda shape, dtype: np.broadcast_to(
            np.zeros(1, dtype), shape),
        frombuffer=np.frombuffer, uint8=np.uint8)
    monkeypatch.setattr(encoder_mod, "os", types.SimpleNamespace(
        pread=pread))
    monkeypatch.setattr(encoder_mod, "np", fake_np)
    try:
        with open(path, "rb") as f:
            shapes = [c.shape for c in encoder_mod._chunk_reader(
                f, dat, LARGE, SMALL, CHUNK)]
    finally:
        monkeypatch.undo()
    return reads, shapes


@pytest.mark.parametrize("dat_mib", DAT_MIB)
def test_chunk_reader_plan_equals_reference(dat_mib, tmp_path, monkeypatch):
    dat = dat_mib * MIB - 4096  # filled to just below the limit
    path = str(tmp_path / "1.dat")
    with open(path, "wb") as f:
        f.truncate(dat)  # sparse: nothing is written
    port = _plan(port_encoder, path, dat, monkeypatch)
    ref = _plan(ref_encoder, path, dat, monkeypatch)
    assert port == ref
    reads, shapes = port
    n_large = 1 if dat_mib == 12000 else 2
    small_rows = -(-(dat - n_large * 10 * LARGE) // (10 * SMALL))
    assert len(shapes) == n_large * LARGE // CHUNK + -(-small_rows // 4)
    assert shapes[0] == (10, CHUNK) and shapes[-1][1] % SMALL == 0
    assert sum(s[1] for s in shapes) == _shard_bytes(dat)
    # The first chunk reads each data shard's first large block; the
    # first small-row chunk starts where the large rows end.
    assert reads[:10] == [(i * LARGE, CHUNK) for i in range(10)]
    first_small = n_large * LARGE // CHUNK * 10
    assert reads[first_small:first_small + 11] == [
        (n_large * 10 * LARGE + i * SMALL, SMALL) for i in range(11)]
    assert len(reads) == n_large * LARGE // CHUNK * 10 + small_rows * 10


def _ecx(module, n: int, dat: int, seed: int) -> tuple[bytes, list]:
    """A sorted .ecx of n needles at seeded 8-aligned offsets up to dat,
    a third of them above 4 GiB, and some deleted."""
    rng = np.random.default_rng(seed)
    ids = np.unique(rng.integers(1, 1 << 40, n))
    offsets = np.sort(rng.integers(0, dat // 8, len(ids))) * 8
    offsets[len(ids) // 3 * 2:] = np.maximum(
        offsets[len(ids) // 3 * 2:], (4 << 30) + 8)
    sizes = rng.integers(1, 4 * MIB, len(ids))
    sizes[::17] = module.TOMBSTONE_FILE_SIZE
    entries = [(int(k), int(o), int(s)) for k, o, s in
               zip(ids, offsets, sizes)]
    blob = b"".join(module.NeedleMapEntry(key=k, offset=o, size=s).to_bytes()
                    for k, o, s in entries)
    return blob, entries


@pytest.mark.parametrize("dat_mib", DAT_MIB)
def test_ecx_above_4gib_equals_reference(dat_mib, tmp_path):
    dat = dat_mib * MIB
    port_blob, entries = _ecx(port_types, 3000, dat, dat_mib)
    ref_blob, _ = _ecx(ref_types, 3000, dat, dat_mib)
    assert port_blob == ref_blob
    assert sum(o > 4 << 30 for _k, o, _s in entries) > 900
    for _k, o, _s in entries[::97]:
        assert port_types.offset_from_bytes(
            port_types.offset_to_bytes(o)) == o
        assert port_types.offset_to_bytes(o) == ref_types.offset_to_bytes(o)
    base = str(tmp_path / "1")
    with open(base + ".ecx", "wb") as f:
        f.write(port_blob)
    port = port_volume.EcVolume(base, coder=NumpyCoder(), version=3)
    ref = ref_volume.EcVolume(base, coder=RefNumpyCoder(), version=3)
    try:
        absent = [entries[0][0] - 1, entries[-1][0] + 1] + [
            (a[0] + b[0]) // 2 for a, b in zip(entries[:40], entries[1:41])
            if b[0] - a[0] > 1]
        for key in [k for k, _o, _s in entries] + absent:
            got = _outcome(port.find_needle_from_ecx, key)
            assert got == _outcome(ref.find_needle_from_ecx, key), key
        for key, offset, size in entries:
            if size != port_types.TOMBSTONE_FILE_SIZE:
                assert port.find_needle_from_ecx(key) == (offset, size)
    finally:
        port.close()
        ref.close()


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the outcome is the result
        return ("raise", type(e).__name__, str(e))


def test_chip_smoke_phase_main_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.phase_main_path on the CPU at 24 MiB (no large-block
    row: the geometry above covers those), with the batched rebuild's
    budget cut to 28 MiB so that it runs in column steps of 2 MiB, the
    last one ragged, and write_volume's blob cut to 8 MiB so that its
    payloads wrap.  The wrappers count only kernel launches, so each outermost
    plain call counts as one here (`count_plain_launches`); every check
    of the phase runs, and its windows are those phase 7 expects.  The
    hooks' per-call cost, a timing of the card, is left out."""
    import importlib.util

    import torch

    from _torch_cluster import count_plain_launches
    from seaweedfs_tpu_torch.ec import encoder
    from seaweedfs_tpu_torch.parallel import cluster_rebuild
    from seaweedfs_tpu_torch.parallel.mesh import make_mesh
    from seaweedfs_tpu_torch.stats import roofline

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_main", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "REPO", str(tmp_path))
    monkeypatch.setattr(cs, "MAIN_BATCH_BYTES", 28 * MIB)
    monkeypatch.setattr(cs, "VOLUME_BLOB", 8 * MIB)
    monkeypatch.setattr(cs, "HOOK_ROUNDS", 1)
    monkeypatch.setattr(cs, "MEM_SLACK", 0)
    monkeypatch.setattr(cs, "hooks_per_call", lambda torch, dev: {})
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cluster_rebuild, "make_mesh", lambda: make_mesh(
        devices=[torch.device("cpu")]))
    monkeypatch.setenv("SEAWEEDFS_TPU_ROOFLINE_CACHE", str(tmp_path / "pk"))
    monkeypatch.setattr(encoder, "fused_crc_enabled", lambda *a, **k: True)
    monkeypatch.setattr(cluster_rebuild, "fused_crc_enabled",
                        lambda *a, **k: True)
    count_plain_launches(monkeypatch)
    monkeypatch.setitem(roofline.PROBE_SIZES, "cpu", {
        "m": 32, "membw_bytes": 4096, "copy_bytes": 4096, "reps": 1})
    roofline.probe_peaks("cpu", force=True)
    args = types.SimpleNamespace(seed=0, main_mib=24)
    with cs.hooks("armed"):
        out = cs.phase_main_path(torch, torch.device("cpu"), args)
    assert out["layout"] == {"large_rows": 0, "small_rows": 3,
                             "shard_bytes": 3 * MIB, "encode_calls": 1}
    assert out["launches_by_step"] == {
        "encode_rs_bitmatrix_crc": 1, "rebuild_rs_bitmatrix": 1,
        "batch_rebuild_rs_bitmatrix_crc": 2,
        "reads_rs_bitmatrix": out["lost_intervals"]}
    assert out["batch_rebuild"]["steps"] == 2  # 2 + 1 MiB
    assert out["reads"] == out["needles"] and out["lost_intervals"] > 0
    assert set(out["reads_by_kind"]) == {"small"}
    assert out["reduced"] == "volume 30000 MiB -> 24 MiB"
    assert not os.path.exists(tmp_path / "_smoke_work")
    for name, w in out["obs"].items():
        key, stage_bytes, repair = cs._window_expectation(
            name, w, out["shard_bytes"], 0, 0, 0)
        assert sum(w["rows"].values()) == w["launches"] > 0, name
        assert set(w["rows"]) == {key}, name
        for stage in cs.EC_STAGES:
            assert w["stage_bytes"].get(stage, 0) == \
                stage_bytes.get(stage, 0), (name, stage)
        assert w["repair"] == repair, name
