"""The storage path end to end at a few MiB: chip_smoke.py's phase 8,
seaweedfs_tpu against the port, step by step.

One volume's life through the storage engine, as `weed volume -max=7`
with the compact needle map runs it: needles written through `Store`
(one of them bit-rotted on its way to disk by the `volume.corrupt`
fault), a torn tail truncated by the remount's recovery, the needle
scrub quarantining the rotten needle, deletes and a vacuum, the volume
server's `ec.generate` sequence (readonly, sync, `.ecx`, shards with
their `.ecc`, `.vif`), deletes through the mounted EC volume (`.ecj`),
one flipped byte in a data and in a parity shard repaired by the EC
scrub through the block-repair callback, four shards rebuilt, and
`ec.to_volume` (`.dat` from the data shards, `.idx` from `.ecx` +
`.ecj`) mounted through `Store` and scrubbed clean.  After every step
the observations, journal events and all files must be identical.

Under the 4-byte and the 5-byte offset flavor.  Then the EC pieces the
decode needs on their own (`iterate_ecj_file`,
`write_idx_file_from_ec_index`, `ShardBits`).  A last test runs
chip_smoke.py's own `phase_storage` on the CPU, with
the plain kernels counted as launches, so the phase's checks and its
phase-7 windows are exercised before a card sees them.
"""

from __future__ import annotations

import importlib.util
import math
import os
import types

import numpy as np
import pytest
import torch

from _torch_cluster import count_plain_launches
from _torch_storage import PAIR, ec_kw, ec_volume, flavor, needle, \
    outcome, repair_ec_block, twin  # noqa: F401

pytestmark = pytest.mark.torch

torch.set_num_threads(1)

MIB = 1 << 20
LIMIT = 12 * MIB          # the volume's size (two .ecc blocks per shard)
VID, COLLECTION = 1, "smoke"
CORRUPT_NID = 7
ROT = {3: 0, 12: 1}       # shard -> 1 MiB block index
LOST = (2, 5, 11, 13)


def _sha(path):
    import hashlib
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes((b[0] ^ 0xFF,)))


def _storage_path(m, root):
    rng = np.random.default_rng(30)
    store = m.store.Store([root], max_volume_counts=[7])
    v = store.add_volume(VID, COLLECTION)
    base = v.file_name()
    payloads, cookies = {}, {}
    while True:
        size = int(math.exp(rng.uniform(math.log(1024), math.log(512 * 1024))))
        room = LIMIT - v.dat_size() - m.needle.get_actual_size(0, v.version) \
            - 16
        size = min(size, room)
        if size < 1024:
            break
        nid = len(payloads) + 1
        n = needle(m, nid, rng.bytes(size), int(rng.integers(1 << 32)))
        if nid == CORRUPT_NID:
            m.fault.arm("volume.corrupt", "fail*1")
        store.write_needle(VID, n)
        m.fault.disarm_all()
        payloads[nid], cookies[nid] = n.data, n.cookie
    v.sync()
    yield "written", {"needles": len(payloads), "dat": v.dat_size()}

    torn = needle(m, len(payloads) + 1, bytes(4096)).to_bytes(v.version)
    with open(base + ".dat", "ab") as f:
        f.write(torn[:len(torn) // 2])
    store.unmount_volume(VID)
    v = store.mount_volume(VID)
    yield "remounted", {"dat": v.dat_size(),
                        "file": os.path.getsize(base + ".dat")}

    daemon = m.scrub.ScrubDaemon(store, {}, node="smoke", mbps=0, interval=0)
    report = daemon.scrub_volume(v)
    candidates = [i for i in payloads if i != CORRUPT_NID]
    deleted = sorted(int(i) for i in rng.choice(
        candidates, len(candidates) // 10, replace=False))
    freed = [store.delete_needle(VID, nid) for nid in deleted]
    before = v.dat_size()
    m.vacuum.vacuum(v)
    yield "vacuumed", {"scrub": report, "tickets": sorted(v.repair_tickets),
                       "deleted": deleted, "freed": freed,
                       "reclaimed": before - v.dat_size()}

    store.mark_volume_readonly(VID, True)
    v.sync()
    m.encoder.write_sorted_file_from_idx(base)
    m.encoder.write_ec_files(base, **ec_kw(m))
    m.volume_info.save_volume_info(base, v.version, codec="rs")
    ev = ec_volume(m, base, vid=VID)
    store.delete_volume(VID)
    live = [i for i in payloads if i not in set(deleted) and i != CORRUPT_NID]
    ec_deleted = sorted(int(i) for i in rng.choice(live, 5, replace=False))
    for nid in ec_deleted:
        ev.delete_needle(nid)
    yield "encoded", {"shard": ev.shards[0].size, "ec_deleted": ec_deleted,
                      "ecj": os.path.getsize(base + ".ecj")}

    digests = {sid: _sha(base + m.ec.to_ext(sid)) for sid in range(14)}
    for sid, block in ROT.items():
        _flip(base + m.ec.to_ext(sid), block * MIB + 4321)
    ec_scrub = m.scrub.ScrubDaemon(store, {VID: ev}, node="smoke", mbps=0,
                                   interval=0,
                                   repair_ec_block=repair_ec_block(m))
    ec_report = ec_scrub.scrub_ec_volume(ev, repair=True)
    ev.close()
    yield "ec-scrubbed", {"report": ec_report, "restored": [
        _sha(base + m.ec.to_ext(sid)) == digests[sid] for sid in range(14)]}

    for sid in LOST:
        os.remove(base + m.ec.to_ext(sid))
    rebuilt = m.encoder.rebuild_ec_files(base, **ec_kw(m))
    yield "rebuilt", {"rebuilt": rebuilt, "restored": [
        _sha(base + m.ec.to_ext(sid)) == digests[sid] for sid in LOST]}

    size = m.decoder.find_dat_file_size(base)
    m.decoder.write_dat_file(base, size)
    m.decoder.write_idx_file_from_ec_index(base)
    v = store.mount_volume(VID)
    final = [i for i in live if i not in set(ec_deleted)]
    reads = [store.read_needle(VID, nid, cookies[nid]).data == payloads[nid]
             for nid in final]
    gone = [outcome(store.read_needle, VID, nid)[:2]
            for nid in deleted + ec_deleted + [CORRUPT_NID]]
    final_report = m.scrub.ScrubDaemon(store, {}, node="smoke", mbps=0,
                                       interval=0).scrub_volume(v)
    yield "decoded", {"size": size, "reads": reads, "gone": gone,
                      "scrub": final_report, "count": v.file_count()}
    store.close()


def test_storage_path_step_by_step(flavor, tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _storage_path))
    assert steps["written"]["needles"] > CORRUPT_NID
    assert steps["remounted"]["dat"] == steps["remounted"]["file"] == \
        steps["written"]["dat"]
    vac = steps["vacuumed"]
    assert (vac["scrub"]["corrupt"], vac["scrub"]["quarantined"]) == (1, 1)
    assert vac["tickets"] == [CORRUPT_NID] and vac["reclaimed"] > 0
    assert steps["encoded"]["shard"] >= 2 * MIB
    assert steps["encoded"]["ecj"] == 8 * 5
    rep = steps["ec-scrubbed"]["report"]
    assert (rep["corrupt"], rep["repaired"], rep["unrepaired"]) == (2, 2, 0)
    assert all(steps["ec-scrubbed"]["restored"])
    assert steps["rebuilt"]["rebuilt"] == list(LOST)
    assert all(steps["rebuilt"]["restored"])
    dec = steps["decoded"]
    assert dec["reads"] and all(dec["reads"])
    assert dec["gone"] == [("raise", "NotFoundError")] * len(dec["gone"])
    assert dec["scrub"]["corrupt"] == 0
    assert dec["scrub"]["checked"] == dec["count"] == len(dec["reads"])


def _ecj_decode(m, root):
    v = m.volume.Volume(root, "", 4, use_worker=False)
    payloads = {i: bytes([i]) * (37 * i) for i in range(1, 60)}
    for nid, data in payloads.items():
        n = needle(m, nid, data, nid)
        n.append_at_ns = nid
        v.write_needle(n)
    v.delete_needle(9)
    v.close()
    base = os.path.join(root, "4")
    m.encoder.write_sorted_file_from_idx(base)
    m.encoder.write_ec_files(base, large_block_size=10000,
                             small_block_size=100, chunk_size=100,
                             **ec_kw(m))
    yield "encoded", {"ecj": list(m.decoder.iterate_ecj_file(base))}
    ev = m.ec_volume.EcVolume(base, vid=4, large_block_size=10000,
                              small_block_size=100, **ec_kw(m))
    for nid in (3, 41, 3, 58):
        ev.delete_needle(nid)
    ev.close()
    yield "deleted", {"ecj": list(m.decoder.iterate_ecj_file(base))}
    os.remove(base + ".idx")
    m.decoder.write_idx_file_from_ec_index(base)
    os.remove(base + ".dat")
    m.decoder.write_dat_file(base, m.decoder.find_dat_file_size(base),
                             large_block_size=10000, small_block_size=100)
    v = m.volume.Volume(root, "", 4, create=False, use_worker=False)
    yield "decoded", {"reads": [outcome(lambda i=i: v.read_needle(i).data ==
                                        payloads[i]) for i in payloads],
                      "count": v.file_count()}
    v.close()


def test_ecj_journal_and_idx_from_ec_index(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _ecj_decode))
    assert steps["encoded"]["ecj"] == []
    assert steps["deleted"]["ecj"][:2] == [3, 41]
    reads = steps["decoded"]["reads"]
    assert [i + 1 for i, r in enumerate(reads) if r[0] == "raise"] == \
        [3, 9, 41, 58]
    assert steps["decoded"]["count"] == 55


def test_shard_bits_equal():
    out = []
    for m in PAIR:
        sb = m.shard_bits.ShardBits(0)
        for sid in (0, 3, 9, 10, 13):
            sb = sb.add_shard_id(sid)
        other = m.shard_bits.ShardBits(0).add_shard_id(3).add_shard_id(12)
        out.append((int(sb), sb.shard_ids(), sb.shard_id_count(),
                    sb.has_shard_id(9), sb.has_shard_id(1),
                    int(sb.remove_shard_id(3)), int(sb.plus(other)),
                    int(sb.minus(other)), sb.minus_parity_shards().shard_ids(),
                    m.shard_bits.ShardBits(1 << 15).shard_ids(16)))
    assert out[1] == out[0]
    assert out[1][1] == [0, 3, 9, 10, 13]


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_cpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phase_storage_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.phase_storage at 12 MiB on the CPU.  The wrappers count
    only kernel launches, so each OUTERMOST plain call is counted as one
    here; fused CRC is forced so ec.generate takes K2 as on the card."""
    from seaweedfs_tpu_torch.ec import encoder
    from seaweedfs_tpu_torch.stats import roofline

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "REPO", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setenv("SEAWEEDFS_TPU_ROOFLINE_CACHE", str(tmp_path / "pk"))
    monkeypatch.setattr(encoder, "fused_crc_enabled", lambda *a, **k: True)
    count_plain_launches(monkeypatch)
    monkeypatch.setitem(roofline.PROBE_SIZES, "cpu", {
        "m": 32, "membw_bytes": 4096, "copy_bytes": 4096, "reps": 1})
    roofline.probe_peaks("cpu", force=True)
    args = types.SimpleNamespace(seed=0, dat_mib=12, batch_div=32)
    with cs.hooks("armed"):
        st = cs.phase_storage(torch, torch.device("cpu"), args)
    assert st["ec_scrub_report"]["repaired"] == 2
    assert st["needles_quarantined"] == 1
    assert st["needles_read_back"] > 0
    for name, w in st["obs"].items():
        key, stage_bytes, repair = cs._window_expectation(
            name, w, 0, 0, 0, st["shard_bytes"])
        assert sum(w["rows"].values()) == w["launches"] > 0, name
        assert set(w["rows"]) == {key}, name
        for stage in cs.EC_STAGES:
            assert w["stage_bytes"].get(stage, 0) == \
                stage_bytes.get(stage, 0), (name, stage)
        assert w["repair"] == repair, name
