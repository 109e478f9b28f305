"""The port's crash-safe mount, needle scrub, quarantine and EC shard
scrub held against seaweedfs_tpu.

Mirrors the storage cases of tests/test_scrub.py: the recovery units
(torn `.dat` tail, lost or torn `.idx` entries, a missing or lying
`.idx`, an idempotent remount after a delete), repair tickets across a
restart, the needle scrub's detection, quarantine and repair through a
callback, the `.ecc` sidecar's verification (`limiter=`, `set_block`,
`drop_shard`, `verify_file`), and the EC scrub with the block-repair
callback: the reference's `_repair_ec_block` contract over its numpy
coder against the port's `repair_ec_block_locally` over the plain K1.
Reports, return values, journal events and every file (`.dat`, `.idx`,
`.qrt`, `.ecc`, shards) must be identical step by step.  The cases that
need a live cluster (replica repair over HTTP, healthz, shell commands,
kill -9 of a server process) wait for the volume-server slice.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from _torch_storage import (PAIR, PORT, REF, ec_kw, ec_volume, needle,
                            outcome, repair_ec_block, twin)

pytestmark = pytest.mark.torch

torch.set_num_threads(1)

MIB = 1 << 20


def _mk_volume(m, root, n=5, vid=7):
    v = m.volume.Volume(root, "", vid, use_worker=False)
    fids = []
    for i in range(n):
        nd = needle(m, 100 + i, f"needle payload {i} ".encode() * 8,
                    0x1234 + i)
        v.write_needle(nd)
        fids.append((nd.id, nd.cookie, nd.data))
    v.sync()
    return v, fids


def _reads(v, fids):
    return [outcome(lambda k=k, c=c: v.read_needle(k, c).data == d)
            for k, c, d in fids]


# -- crash-safe mount --------------------------------------------------------


def _recovery(case):
    def scenario(m, root):
        v, fids = _mk_volume(m, root)
        base = v.file_name()
        if case == "missing_idx":
            v.delete_needle(fids[1][0])  # a tombstone survives the regen
        if case == "remount_after_delete":
            v.delete_needle(fids[-1][0])
        v.close()
        entry = m.idx.ENTRY_SIZE
        if case == "torn_tail":
            with open(base + ".dat", "ab") as f:
                f.write(b"\xde\xad\xbe\xef" * 3)
        elif case == "lost_idx_tail":
            size = os.path.getsize(base + ".idx")
            with open(base + ".idx", "r+b") as f:
                f.truncate(size - 2 * entry)
        elif case == "missing_idx":
            os.remove(base + ".idx")
        elif case == "stale_idx_beyond_eof":
            size = os.path.getsize(base + ".dat")
            with open(base + ".dat", "r+b") as f:
                f.truncate(size - 10)
        elif case == "partial_idx_entry":
            with open(base + ".idx", "ab") as f:
                f.write(b"\x01\x02\x03")
        yield "damaged", {}
        for mount in range(3 if case == "remount_after_delete" else 1):
            v = m.volume.Volume(root, "", 7, create=False, use_worker=False)
            obs = {"reads": _reads(v, fids), "count": v.file_count(),
                   "dat": (v.dat_size(), os.path.getsize(base + ".dat")),
                   "idx": os.path.getsize(base + ".idx") % entry}
            if mount == 0:
                obs["write"] = v.write_needle(
                    needle(m, 999, b"post-recovery write", 1))
                obs["read"] = outcome(lambda: v.read_needle(999, 1).data)
            v.close()
            yield f"mount{mount}", obs
        report = m.scrub.recover_volume_files(base + ".dat", base + ".idx",
                                              vid=7)
        yield "again", {"report": report}
    return scenario


@pytest.mark.parametrize("case", [
    "torn_tail", "lost_idx_tail", "missing_idx", "stale_idx_beyond_eof",
    "remount_after_delete", "partial_idx_entry"])
def test_recovery_units(case, tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _recovery(case)))
    first = steps["mount0"]
    assert first["dat"][0] == first["dat"][1]
    assert first["idx"] == 0
    assert first["read"] == ("ok", b"post-recovery write")
    assert steps["again"]["report"] == {"dat_truncated": 0,
                                        "idx_appended": 0,
                                        "idx_regenerated": False}


def test_recovery_events(tmp_path, monkeypatch):
    """The torn tail's recovery emits one volume.recovered in each
    package (twin holds their attributes equal)."""
    seen = []

    def scenario(m, root):
        seq = m.events.JOURNAL._seq
        yield from _recovery("torn_tail")(m, root)
        seen.append([e["attrs"] for e in m.events.JOURNAL.snapshot(
            type_="volume.recovered") if e["seq"] > seq])

    twin(tmp_path, monkeypatch, scenario)
    assert seen[0] == seen[1] == [{"vid": 7, "dat_truncated": 12,
                                   "idx_appended": 0,
                                   "idx_regenerated": False}]


def _tickets(m, root):
    v, fids = _mk_volume(m, root)
    key, cookie, data = fids[0]
    obs = {"first": v.quarantine_needle(key),
           "again": v.quarantine_needle(key),
           "absent": v.quarantine_needle(12345),
           "count": v.corrupt_count(), "read": _reads(v, fids[:1])}
    v.close()
    yield "quarantined", obs
    v = m.volume.Volume(root, "", 7, create=False, use_worker=False)
    obs = {"count": v.corrupt_count(), "tickets": sorted(v.repair_tickets)}
    v.repair_needle(needle(m, key, data, cookie))
    obs.update(after=v.corrupt_count(), read=_reads(v, fids[:1]))
    v.close()
    yield "repaired", obs
    v = m.volume.Volume(root, "", 7, create=False, use_worker=False)
    yield "closed", {"count": v.corrupt_count()}
    v.close()


def test_repair_tickets_survive_restart(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _tickets))
    assert steps["quarantined"]["first"] and \
        not steps["quarantined"]["again"]
    assert steps["repaired"]["count"] == 1
    assert steps["closed"]["count"] == 0


# -- the needle scrub --------------------------------------------------------


def _needle_scrub(m, root):
    store = m.store.Store([root])
    v = store.add_volume(3, "scrub")
    payloads = {}
    for i in range(1, 13):
        nd = needle(m, i, bytes([i]) * (300 * i), 0x500 + i)
        if i in (4, 9):
            m.fault.arm("volume.corrupt", "fail*1")
        store.write_needle(3, nd)
        m.fault.disarm_all()
        payloads[i] = (nd.cookie, nd.data)
    v.sync()
    calls = []

    def heal(vol, key):
        calls.append(key)
        if key == 9:
            return False  # no healthy replica for this one
        cookie, data = payloads[key]
        vol.repair_needle(needle(m, key, data, cookie))
        return True

    daemon = m.scrub.ScrubDaemon(store, {}, node="n1", mbps=0, interval=0)
    obs = {"report": daemon.scrub_volume(v),
           "tickets": sorted(v.repair_tickets),
           "reads": [outcome(lambda k=k: v.read_needle(k).data)
                     for k in (3, 4, 9)]}
    yield "detected", obs
    daemon = m.scrub.ScrubDaemon(store, {}, node="n1", mbps=0, interval=0,
                                 repair_needle=heal)
    obs = {"sweep": daemon.scrub_all(repair=True), "calls": calls,
           "tickets": sorted(v.repair_tickets),
           "reads": [outcome(lambda k=k: v.read_needle(k).data ==
                             payloads[k][1]) for k in (3, 4, 9)]}
    yield "repaired", obs
    store.close()


def test_needle_scrub_quarantine_and_repair(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _needle_scrub))
    rep = steps["detected"]["report"]
    assert (rep["checked"], rep["corrupt"], rep["quarantined"]) == (12, 2, 2)
    assert steps["detected"]["tickets"] == [4, 9]
    assert steps["repaired"]["tickets"] == [9]
    assert steps["repaired"]["reads"][1] == ("ok", True)


def test_rate_limiter_throttles_and_disables():
    for m in PAIR:
        off = m.scrub.RateLimiter(0)
        off.take(1 << 30)  # disabled: returns at once
        lim = m.scrub.RateLimiter(mbps=100.0)  # 100 MB/s
        t0 = m.scrub.time.monotonic()
        for _ in range(3):
            lim.take(1_000_000)
        assert m.scrub.time.monotonic() - t0 >= 0.015


# -- EC: the .ecc sidecar and the shard scrub --------------------------------


def _payloads(total=11 * MIB):
    """Needles log-uniform in 1 KiB..256 KiB, enough for two 1 MiB .ecc
    blocks per shard (10 MiB small-block rows)."""
    rng = np.random.default_rng(11)
    out, used, i = {}, 0, 0
    while used < total:
        i += 1
        size = int(np.exp(rng.uniform(np.log(1024), np.log(256 * 1024))))
        out[i] = rng.bytes(size)
        used += size + 64
    return out


PAYLOADS = _payloads()


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes((b[0] ^ 0xFF,)))


def _ec_base(m, root, vid=5):
    v = m.volume.Volume(root, "", vid, use_worker=False)
    for nid, data in PAYLOADS.items():
        nd = needle(m, nid, data, 0x7000 + nid)
        nd.append_at_ns = nid
        v.write_needle(nd)
    v.set_readonly(True)
    v.sync()
    base = v.file_name()
    v.close()
    m.encoder.write_sorted_file_from_idx(base)
    m.encoder.write_ec_files(base, **ec_kw(m))
    m.volume_info.save_volume_info(base, 3, codec="rs")
    return base


def _ecc_sidecar(m, root):
    base = _ec_base(m, root)
    shard = lambda sid: base + m.ec.to_ext(sid)  # noqa: E731
    ecc = m.integrity.ShardChecksums.load(base)
    limiter = m.scrub.RateLimiter(0)
    obs = {"block": ecc.block,
           "match": [ecc.get(s) == m.integrity.file_block_crcs(
               shard(s), limiter=limiter) for s in range(14)],
           "clean": [ecc.verify_file(s, shard(s), limiter=limiter)
                     for s in range(14)]}
    yield "encoded", obs
    _flip(shard(12), 100)
    _flip(shard(0), MIB + 7)
    obs = {"bad12": ecc.verify_file(12, shard(12)),
           "bad0": ecc.verify_file(0, shard(0)),
           "none": ecc.verify_file(1, shard(1))}
    ecc.set_block(12, 0, m.integrity.file_block_crcs(shard(12))[0])
    ecc.drop_shard(3)
    ecc.save()
    again = m.integrity.ShardChecksums.load(base)
    obs.update(after=again.verify_file(12, shard(12)), dropped=again.get(3),
               unknown=outcome(again.verify_file, 3, shard(3)))
    yield "edited", obs


def test_ecc_sidecar(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _ecc_sidecar))
    assert all(steps["encoded"]["match"])
    assert steps["encoded"]["clean"] == [[]] * 14
    assert steps["edited"]["bad12"] == [0] and steps["edited"]["bad0"] == [1]
    assert steps["edited"]["after"] == [] and steps["edited"]["dropped"] is None


def _ec_scrub(m, root):
    base = _ec_base(m, root)
    shard = lambda sid: base + m.ec.to_ext(sid)  # noqa: E731
    ev = ec_volume(m, base, vid=5)
    for nid in (2, 3, 40):
        ev.delete_needle(nid)
    store = m.store.Store([os.path.join(root, "empty")])
    yield "mounted", {"shards": sorted(ev.shards),
                      "size": ev.shards[0].size}
    with open(shard(3), "rb") as f:
        d3 = f.read()
    with open(shard(12), "rb") as f:
        d12 = f.read()
    _flip(shard(3), 4321)            # data shard, block 0
    _flip(shard(12), MIB + 1234)     # parity shard, block 1
    detect = m.scrub.ScrubDaemon(store, {5: ev}, node="n1", mbps=0,
                                 interval=0)
    obs = {"report": detect.scrub_ec_volume(ev, repair=True),
           "corrupt": detect.ec_corrupt_snapshot()}
    yield "detected", obs
    daemon = m.scrub.ScrubDaemon(store, {5: ev}, node="n1", mbps=0,
                                 interval=0, repair_ec_block=repair_ec_block(m))
    obs = {"sweep": daemon.scrub_all(repair=True),
           "corrupt": daemon.ec_corrupt_counts()}
    with open(shard(3), "rb") as f:
        obs["restored3"] = f.read() == d3
    with open(shard(12), "rb") as f:
        obs["restored12"] = f.read() == d12
    yield "repaired", obs
    ecc = m.integrity.ShardChecksums.load(base)
    ecc.drop_shard(6)
    ecc.save()
    obs = {"first": daemon.scrub_ec_volume(ev),  # trust on first scrub
           "recorded": m.integrity.ShardChecksums.load(base).get(6) ==
           m.integrity.file_block_crcs(shard(6)),
           "reads": [outcome(lambda n=n: ev.read_needle(n).data ==
                             PAYLOADS[n]) for n in (1, 2, 41, 99)]}
    yield "tofu", obs
    ev.close()
    store.close()


def test_ec_scrub_repairs_through_the_decode(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _ec_scrub))
    assert steps["mounted"]["size"] > MIB
    rep = steps["detected"]["report"]
    assert (rep["corrupt"], rep["repaired"], rep["unrepaired"]) == (2, 0, 2)
    sweep = steps["repaired"]["sweep"]
    assert (sweep["corrupt"], sweep["repaired"]) == (2, 2)
    assert steps["repaired"]["restored3"] and steps["repaired"]["restored12"]
    assert steps["repaired"]["corrupt"] == {}
    assert steps["tofu"]["recorded"]
    assert steps["tofu"]["reads"][1][:2] == ("raise", "NeedleNotFound")


def test_port_repair_callback_refuses_a_wrong_solve(tmp_path):
    """With a second corrupt source shard the reconstruction misses the
    recorded CRC: the port's callback leaves the shard untouched."""
    base = _ec_base(PORT, str(tmp_path))
    ev = ec_volume(PORT, base, vid=5)
    shard = lambda sid: base + PORT.ec.to_ext(sid)  # noqa: E731
    crcs = PORT.integrity.ShardChecksums.load(base).get(1)
    _flip(shard(1), 10)
    _flip(shard(0), 10)   # a source the 10-survivor solve reads
    with open(shard(1), "rb") as f:
        before = f.read()
    assert not PORT.scrub.repair_ec_block_locally(ev, 1, 0, MIB, 0, crcs[0])
    with open(shard(1), "rb") as f:
        assert f.read() == before
    ev.close()
    assert REF.integrity.ShardChecksums.load(base).get(1) == crcs
