"""The port's volume engine (Volume, Store, vacuum, scanner, backup,
change log, fault points, zero-copy reads) held against seaweedfs_tpu.

Mirrors the storage cases of tests/test_volume.py,
tests/test_offset_5bytes.py, tests/test_backup.py and
tests/test_sendfile_read.py.  Each scenario runs once per package in the
same directory (tests/_torch_storage.py `twin`): the values it observes,
the journal events and every file (`.dat`, `.idx`, `.qrt`, `.rlog`,
`.cpd`/`.cpx`) must be identical step by step.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import threading

import pytest
import torch

from _torch_storage import PAIR, PORT, flavor, needle, outcome, twin  # noqa: F401

pytestmark = pytest.mark.torch

torch.set_num_threads(1)


def _data(m, v, nid, cookie=None):
    return outcome(lambda: v.read_needle(nid, cookie).data)


def _vi(info) -> dict:
    d = dataclasses.asdict(info)
    d.pop("modified_at")  # a remount seeds it from the .dat's mtime
    return d


# -- Volume ------------------------------------------------------------------


def _volume_basics(m, root):
    v = m.volume.Volume(root, "", 1)
    obs = {"write": v.write_needle(needle(m, 101, b"hello volume engine",
                                          0xCAFE)),
           "read": _data(m, v, 101), "cookie_ok": _data(m, v, 101, 0xCAFE),
           "cookie_bad": _data(m, v, 101, 0xBEEF),
           "missing": _data(m, v, 999)}
    yield "write-read", obs
    v.write_needle(needle(m, 5, b"to be deleted", 1))
    obs = {"freed": v.delete_needle(5), "again": v.delete_needle(5),
           "read": _data(m, v, 5), "deleted_size": v.deleted_size()}
    yield "delete", obs
    v.write_needle(needle(m, 9, b"v1", 1))
    v.write_needle(needle(m, 9, b"v2-new", 2))
    yield "overwrite", {"read": _data(m, v, 9),
                        "deletions": v.nm.metrics.deletion_count}
    for i in range(20):  # the batch worker: one fsync per batch
        v.write_needle(needle(m, 1000 + i, bytes([i]) * (37 * i + 1), i),
                       fsync=True)
    yield "fsync-writes", {"count": v.file_count(),
                           "read": _data(m, v, 1013)}
    v.set_readonly(True)
    obs = {"ro_write": outcome(v.write_needle, needle(m, 1, b"x")),
           "ro_delete": outcome(v.delete_needle, 101)}
    v.set_readonly(False)
    obs["rw_write"] = v.write_needle(needle(m, 1, b"x"))
    yield "readonly", obs
    v.close()
    v2 = m.volume.Volume(root, "", 1, create=False)
    obs = {"count": v2.file_count(), "read": _data(m, v2, 1013),
           "deleted": _data(m, v2, 5), "content": v2.content_size(),
           "max_key": v2.max_file_key(), "garbage": v2.garbage_ratio(),
           "closed_write": None}
    v2.close()
    obs["closed_write"] = outcome(v2.write_needle, needle(m, 2, b"y"))
    obs["absent"] = outcome(m.volume.Volume, root, "", 2, create=False)
    yield "reload", obs


def test_volume_basics(flavor, tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _volume_basics))
    assert steps["write-read"]["cookie_bad"][:2] == ("raise", "VolumeError")
    assert steps["delete"]["read"][:2] == ("raise", "NotFoundError")
    assert steps["reload"]["count"] == 23


def test_concurrent_writes_batched(tmp_path):
    """Writers racing through the batch worker: the order differs run to
    run, so each package is held to the same readable set."""
    got = []
    for m in PAIR:
        (tmp_path / m.short).mkdir()
        v = m.volume.Volume(str(tmp_path / m.short), "", 1)

        def writer(base):
            for i in range(50):
                v.write_needle(needle(m, base * 1000 + i, bytes([base]) * 100,
                                      base), fsync=True)

        ths = [threading.Thread(target=writer, args=(k,)) for k in range(1, 5)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        got.append((v.file_count(), sorted(
            (k * 1000 + i, v.read_needle(k * 1000 + i).data)
            for k in range(1, 5) for i in range(50))))
        v.close()
    assert got[1] == got[0]
    assert got[1][0] == 200


def _scanner_and_vacuum(m, root):
    v = m.volume.Volume(root, "c1", 4, use_worker=False)
    for i in range(30):
        v.write_needle(needle(m, i, b"z" * (100 + i * 7)))
    for i in range(0, 30, 2):
        v.delete_needle(i)
    v.sync()
    base = v.file_name()
    recs = [(n.id, n.size, off) for n, off, *_ in
            m.scanner.scan_volume_file(base + ".dat")]
    regen = os.path.join(root, "regen.idx")
    yield "scan", {"records": recs, "super": m.scanner.read_super_block(
        base + ".dat").to_bytes(),
        "regen": m.scanner.generate_idx_from_dat(base + ".dat", regen)}
    os.remove(regen)
    obs = {"commit_unstaged": outcome(m.vacuum.commit_compact, v)}
    m.vacuum.compact(v)
    obs["staged"] = v.vacuum_staged
    yield "compacted", obs
    m.vacuum.cleanup_compact(v)
    obs = {"staged": v.vacuum_staged,
           "commit_abandoned": outcome(m.vacuum.commit_compact, v)}
    yield "cleanup", obs
    before = v.dat_size()
    m.vacuum.vacuum(v)
    obs = {"before": before, "after": v.dat_size(),
           "revision": v.super_block.compaction_revision,
           "count": v.file_count(), "garbage": v.garbage_ratio(),
           "live": [_data(m, v, i) for i in range(30)]}
    yield "vacuum", obs
    errs = []

    def worker():
        try:
            m.vacuum.vacuum(v)
        except Exception as e:  # noqa: BLE001 — collected for the observation
            errs.append(repr(e))

    ths = [threading.Thread(target=worker) for _ in range(4)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    v.write_needle(needle(m, 100, b"post-vacuum"))
    yield "vacuum-again", {"errors": errs, "read": _data(m, v, 100),
                           "revision": v.super_block.compaction_revision}
    v.close()


def test_scanner_and_vacuum(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _scanner_and_vacuum))
    assert len(steps["scan"]["records"]) == 45  # 30 writes + 15 markers
    assert steps["compacted"]["commit_unstaged"][1] == "VacuumError"
    assert steps["vacuum"]["after"] < steps["vacuum"]["before"]
    assert steps["vacuum-again"]["errors"] == []


@pytest.mark.parametrize("kind", ["compact", "memory", "sorted_file"])
def test_needle_map_kinds_under_volume(kind, tmp_path, monkeypatch):
    def scenario(m, root):
        v = m.volume.Volume(root, "", 3, use_worker=False)
        for i in range(1, 40):
            v.write_needle(needle(m, i, os.urandom(0) + bytes([i]) * i))
        v.delete_needle(7)
        v.close()
        v = m.volume.Volume(root, "", 3, create=False, use_worker=False,
                            needle_map_kind=kind)
        yield "reopened", {"readonly": v.readonly, "count": v.file_count(),
                           "reads": [_data(m, v, i) for i in (1, 7, 39)],
                           "write": outcome(v.write_needle,
                                            needle(m, 50, b"new"))}
        v.close()

    steps = dict(twin(tmp_path, monkeypatch, scenario))
    assert steps["reopened"]["readonly"] == (kind == "sorted_file")


# -- Store -------------------------------------------------------------------


def _store(m, root):
    d1, d2 = os.path.join(root, "a"), os.path.join(root, "b")
    s = m.store.Store([d1, d2], ip="127.0.0.1", port=8080)
    s.add_volume(1)
    s.add_volume(2, collection="pics", replica_placement="001")
    s.write_needle(1, needle(m, 10, b"one"))
    s.write_needle(2, needle(m, 20, b"two"))
    hb = s.collect_heartbeat()
    hb["volumes"] = sorted((_vi(v) for v in hb["volumes"]),
                           key=lambda d: d["id"])
    new, deleted = s.drain_deltas()
    yield "added", {"read": s.read_needle(2, 20).data, "hb": hb,
                    "new": sorted(v.id for v in new),
                    "deleted": [v.id for v in deleted],
                    "dup": outcome(s.add_volume, 1),
                    "missing": outcome(s.read_needle, 9, 1)}
    s.mark_volume_readonly(2, True)
    obs = {"ro": outcome(s.write_needle, 2, needle(m, 21, b"x")),
           "del": outcome(s.delete_needle, 1, 10),
           "del_absent": outcome(s.delete_needle, 1, 10)}
    s.mark_volume_readonly(2, False)
    s.configure_volume(2, "010")
    s.unmount_volume(1)
    obs["unmounted"] = s.has_volume(1)
    s.mount_volume(1)
    obs["remounted"] = (s.has_volume(1), outcome(s.read_needle, 1, 10))
    obs["reserve"] = s.check_disk_reserve()
    yield "ops", obs
    s.delete_volume(1)
    _, deleted = s.drain_deltas()
    yield "deleted", {"deleted": [v.id for v in deleted],
                      "dat": os.path.exists(os.path.join(d1, "1.dat"))}
    s.close()
    s = m.store.Store([d1, d2], disk_reserve_bytes=1 << 62)
    obs = {"found": s.has_volume(2), "read": s.read_needle(2, 20).data,
           "rp": str(s.find_volume(2).super_block.replica_placement),
           "flipped": s.check_disk_reserve(),
           "readonly": s.find_volume(2).readonly,
           "low": sorted(os.path.relpath(p, root) for p in s.low_disk_dirs)}
    yield "rediscovered", obs
    s.close()


def test_store(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _store))
    assert steps["added"]["new"] == [1, 2]
    assert steps["added"]["dup"][1] == "VolumeError"
    assert steps["rediscovered"]["flipped"] == [2]


# -- the 5-byte flavor past 32 GB --------------------------------------------


def _past_32gb(m, root):
    v = m.volume.Volume(root, "", 1, use_worker=False)
    v.write_needle(needle(m, 1, b"low", 5))
    with v._lock:  # a sparse .dat: push the append cursor past 32 GB
        v._dat.truncate(33 << 30)
        v._append_at = 33 << 30
    obs = {"write": outcome(v.write_needle, needle(m, 2, b"high" * 100, 5))}
    obs["reads"] = [_data(m, v, 1), _data(m, v, 2)]
    v.close()
    yield "written", obs
    if os.path.getsize(os.path.join(root, "1.dat")) > 33 << 30:
        v = m.volume.Volume(root, "", 1, create=False, use_worker=False)
        yield "reopened", {"reads": [_data(m, v, 1), _data(m, v, 2)]}
        v.close()


def test_needle_past_32gb(flavor, tmp_path, monkeypatch):
    """5 bytes: the record lands past 32 GB and reopens; 4 bytes: the
    write is refused at the cap."""
    steps = dict(twin(tmp_path, monkeypatch, _past_32gb))
    if flavor == 5:
        assert steps["written"]["write"][0] == "ok"
        assert steps["reopened"]["reads"][1] == ("ok", b"high" * 100)
    else:
        assert steps["written"]["write"][1] == "VolumeError"


# -- fault points, change log, expiry ----------------------------------------


def _faults(m, root):
    v = m.volume.Volume(root, "", 6, use_worker=False)
    v.write_needle(needle(m, 1, b"clean needle"))
    m.fault.arm("volume.corrupt", "fail*1")
    obs = {"write": v.write_needle(needle(m, 2, b"soon to be rotten " * 32))}
    m.fault.disarm_all()
    obs["read"] = outcome(lambda: v.read_needle(2).data)
    obs["blob"] = outcome(v.read_needle_blob, 2)
    obs["clean"] = _data(m, v, 1)
    yield "corrupt", obs
    size = v.dat_size()
    m.fault.arm("disk.full", "fail*1")
    obs = {"write": outcome(v.write_needle, needle(m, 3, b"x" * 4000))}
    m.fault.disarm_all()
    obs.update(readonly=v.readonly, size=(size, v.dat_size()),
               next=outcome(v.write_needle, needle(m, 4, b"y")))
    yield "disk-full", obs
    v.close()


def test_fault_points(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _faults))
    assert steps["corrupt"]["read"][1] == "CorruptNeedleError"
    assert steps["disk-full"]["write"][1] == "DiskFullError"
    assert steps["disk-full"]["readonly"]
    assert len(set(steps["disk-full"]["size"])) == 1


def _change_log(m, root):
    v = m.volume.Volume(root, "", 8, use_worker=False)
    v.write_needle(needle(m, 1, b"before the log"))
    log = v.enable_rlog()
    for i in range(2, 6):
        v.write_needle(needle(m, i, bytes([i]) * 50, cookie=i))
    v.write_needle(needle(m, 6, b"durable"), fsync=True)
    v.delete_needle(3)
    v.quarantine_needle(4)  # journal=False: not a user delete
    v.repair_needle(needle(m, 4, bytes([4]) * 50, cookie=4))
    yield "logged", {"records": [dataclasses.astuple(r) for r in log.read_from(0)],
                     "tickets": v.corrupt_count()}
    v.close()
    v = m.volume.Volume(root, "", 8, create=False, use_worker=False)
    v.write_needle(needle(m, 7, b"after the restart"))
    yield "reopened", {"reopened": v.rlog is not None,
                       "records": [dataclasses.astuple(r) for r in v.rlog.read_from(5)]}
    v.close()


def test_change_log_follows_commits(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _change_log))
    assert steps["reopened"]["reopened"]


def test_expiry_checks_equal(monkeypatch):
    for m in PAIR:
        m.expiry.set_clock(lambda: 1_000_000.0)
    try:
        out = []
        for m in PAIR:
            ttl = m.ttl.TTL.parse("3m")
            n = needle(m, 1, b"x")
            n.set_ttl(ttl)
            n.set_last_modified(1_000_000 - 120)
            old = needle(m, 2, b"y")
            old.set_ttl(ttl)
            old.set_last_modified(1_000_000 - 181)
            out.append((m.expiry.needle_ttl_sec(n, None),
                        m.expiry.needle_expired(n),
                        m.expiry.needle_expired(old),
                        m.expiry.volume_expired(ttl, 1_000_000 - 100),
                        m.expiry.volume_expired(ttl, 1_000_000 - 1000),
                        m.expiry.volume_near_expiry(ttl, 1_000_000 - 170)))
        assert out[1] == out[0]
        assert out[1][1:3] == (False, True)
    finally:
        for m in PAIR:
            m.expiry.reset_clock()


# -- incremental backup ------------------------------------------------------


def _backup(m, root):
    import shutil
    src, dst = os.path.join(root, "src"), os.path.join(root, "dst")
    os.makedirs(src)
    os.makedirs(dst)
    v = m.volume.Volume(src, "", 3, use_worker=False)
    stamps = []
    for i in range(5):
        v.write_needle(needle(m, i + 1, f"first-{i}".encode(), 0x99))
        stamps.append(v.read_needle(i + 1).append_at_ns)
    v.sync()
    obs = {"cut_mid": m.backup.binary_search_by_append_at_ns(v, stamps[2]),
           "cut_end": m.backup.binary_search_by_append_at_ns(v, stamps[-1]),
           "cut_all": m.backup.binary_search_by_append_at_ns(v, 0)}
    for ext in (".dat", ".idx"):
        shutil.copyfile(v.file_name() + ext, os.path.join(dst, "3" + ext))
    since = m.backup.last_append_at_ns(os.path.join(dst, "3.dat"))
    obs["since"] = since
    yield "seeded", obs
    for i in range(5, 8):
        v.write_needle(needle(m, i + 1, f"second-{i}".encode(), 0x99))
    v.delete_needle(2)   # a tombstone before a later live write
    v.write_needle(needle(m, 20, b"later-live", 0x99))
    delta = m.backup.read_incremental(v, since)
    applied = m.backup.apply_incremental(
        os.path.join(dst, "3.dat"), os.path.join(dst, "3.idx"), delta,
        v.version)
    yield "applied", {"delta": delta, "applied": applied}
    b = m.volume.Volume(dst, "", 3, create=False, use_worker=False)
    reads = [_data(m, b, i) for i in (1, 2, 3, 6, 8, 20)]
    b.close()
    v.delete_needle(1)   # a window of tombstones only
    v.delete_needle(3)
    since = m.backup.last_append_at_ns(os.path.join(dst, "3.dat"))
    delta = m.backup.read_incremental(v, since)
    m.backup.apply_incremental(os.path.join(dst, "3.dat"),
                               os.path.join(dst, "3.idx"), delta, v.version)
    since = m.backup.last_append_at_ns(os.path.join(dst, "3.dat"))
    yield "deletes-only", {"reads": reads, "delta": delta,
                           "empty_next": m.backup.read_incremental(v, since)}
    v.close()


def test_incremental_backup(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _backup))
    assert steps["applied"]["applied"] >= 5
    assert steps["deletes-only"]["reads"][1][1] == "NotFoundError"
    assert steps["deletes-only"]["delta"]
    assert steps["deletes-only"]["empty_next"] == b""


# -- zero-copy reads ---------------------------------------------------------


def _sendfile(slice_, want, sock_pair):
    a, b = sock_pair
    got = bytearray()

    def drain():
        while len(got) < want:
            chunk = b.recv(1 << 20)
            if not chunk:
                return
            got.extend(chunk)

    th = threading.Thread(target=drain)
    th.start()
    noted = []
    slice_.sendfile_to(a, note=noted.append)
    th.join(timeout=30)
    assert not th.is_alive(), "the reader never got the whole payload"
    return bytes(got), sum(noted)


def _slices(m, root):
    big = bytes(range(256)) * 2048  # 512 KiB
    v = m.volume.Volume(root, "", 1)
    off, _ = v.write_needle(needle(m, 7, big, 0xABC))
    v.write_needle(needle(m, 8, b"tiny", 1))
    sl = v.read_needle_slice(7, 0xABC, min_size=1024)
    with sl:
        head = sl.read(100_000)
        pair = socket.socketpair()
        try:
            sent, noted = _sendfile(sl, sl.size - len(head), pair)
        finally:
            for s in pair:
                s.close()
    obs = {"size": sl.size, "whole": head + sent == big, "noted": noted,
           "small": v.read_needle_slice(8, 1, min_size=1024),
           "bad_cookie": outcome(v.read_needle_slice, 7, 0xDEF, 1024),
           "absent": outcome(v.read_needle_slice, 999, None, 1024),
           "pread": v.pread(16, off)}
    yield "served", obs
    with open(os.path.join(root, "1.dat"), "r+b") as f:
        f.seek(off + 16 + 4 + 1000)
        byte = f.read(1)
        f.seek(off + 16 + 4 + 1000)
        f.write(bytes((byte[0] ^ 0xFF,)))
    yield "rotten", {"slice": outcome(v.read_needle_slice, 7, 0xABC, 1024)}
    v.close()


def test_read_needle_slice_and_sendfile(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _slices))
    assert steps["served"]["whole"]
    assert steps["served"]["noted"] == 512 * 1024 - 100_000
    assert steps["served"]["small"] is None
    assert steps["rotten"]["slice"][1] == "CorruptNeedleError" or \
        "CRC" in steps["rotten"]["slice"][2]


def test_port_volume_sync_fsyncs_idx_too(tmp_path, monkeypatch):
    v = PORT.volume.Volume(str(tmp_path), "", 7, use_worker=False)
    v.write_needle(needle(PORT, 1, b"x"))
    synced = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: synced.append(fd) or real(fd))
    v.sync()
    assert v._dat.fileno() in synced
    assert v.nm._idx_file.fileno() in synced
    v.close()
