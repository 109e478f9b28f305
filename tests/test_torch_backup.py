"""The port's incremental volume backup (`storage/volume_backup.py` and
`weed backup`) held against the JAX package's.

Mirrors the five cases of tests/test_backup.py.  The four storage cases
run through `_torch_storage.twin` (same directory, pinned clocks): equal
observations and byte-identical source and backup files at every step.
The end-to-end case runs `weed backup` (full, then incremental) against
each package's live cluster fed the same writes on pinned clocks, and
the port's backup files must equal the reference's backup of the same
volume byte for byte.
"""

from __future__ import annotations

import random
import shutil

import pytest

from _torch_cluster import (PACKAGES, LiveCluster,  # noqa: F401
                            hermetic_port_state, mod, pin_clocks)
from _torch_storage import outcome, snapshot, twin

pytestmark = pytest.mark.torch


def _vol(m, d, vid=3):
    return m.volume.Volume(str(d), "", vid, use_worker=False)


def _write(m, v, nid, data):
    v.write_needle(m.needle.Needle(id=nid, cookie=0x99, data=data))
    return v.nm.get(nid)


def _seed_backup(v, dst, vid=3):
    v.sync()
    shutil.copyfile(v.file_name() + ".dat", f"{dst}/{vid}.dat")
    shutil.copyfile(v.file_name() + ".idx", f"{dst}/{vid}.idx")


def _apply(m, v, dst, since):
    delta = m.backup.read_incremental(v, since)
    applied = m.backup.apply_incremental(f"{dst}/3.dat", f"{dst}/3.idx",
                                         delta, v.version)
    return delta, applied


def _reads(m, d, nids):
    b = m.volume.Volume(str(d), "", 3, create=False, use_worker=False)
    try:
        return {nid: outcome(lambda n=nid: b.read_needle(n).data)
                for nid in nids}
    finally:
        b.close()


def _binary_search(m, root):
    v = _vol(m, root)
    stamps = []
    for i in range(10):
        _write(m, v, i + 1, f"rec-{i}".encode())
        stamps.append(v.read_needle(i + 1).append_at_ns)
    search = m.backup.binary_search_by_append_at_ns
    yield "searched", {"mid": search(v, stamps[4]), "off6": v.nm.get(6)[0],
                       "newest": search(v, stamps[-1]),
                       "end": v.dat_size(), "all": search(v, 0),
                       "off1": v.nm.get(1)[0]}
    v.close()


def _roundtrip_with_deletes(m, root):
    src, dst = f"{root}/src", f"{root}/dst"
    import os
    os.makedirs(src)
    os.makedirs(dst)
    v = _vol(m, src)
    for i in range(5):
        _write(m, v, i + 1, f"first-{i}".encode())
    _seed_backup(v, dst)
    since = m.backup.last_append_at_ns(f"{dst}/3.dat")
    for i in range(5, 8):
        _write(m, v, i + 1, f"second-{i}".encode())
    v.delete_needle(2)
    delta, applied = _apply(m, v, dst, since)
    yield "applied", {"since": since, "delta": delta, "applied": applied}
    yield "backup", {"reads": _reads(m, dst, range(1, 9)),
                     "empty_next": m.backup.read_incremental(
                         v, m.backup.last_append_at_ns(f"{dst}/3.dat"))}
    v.close()


def _delete_before_later_write(m, root):
    src, dst = f"{root}/s", f"{root}/d"
    import os
    os.makedirs(src)
    os.makedirs(dst)
    v = _vol(m, src)
    for i in range(4):
        _write(m, v, i + 1, f"x-{i}".encode())
    _seed_backup(v, dst)
    since = m.backup.last_append_at_ns(f"{dst}/3.dat")
    v.delete_needle(2)
    _write(m, v, 9, b"later-live")
    delta, applied = _apply(m, v, dst, since)
    yield "applied", {"delta": delta, "applied": applied,
                      "reads": _reads(m, dst, (1, 2, 9))}
    v.close()


def _delete_only_interval(m, root):
    src, dst = f"{root}/s2", f"{root}/d2"
    import os
    os.makedirs(src)
    os.makedirs(dst)
    v = _vol(m, src)
    for i in range(3):
        _write(m, v, i + 1, f"y-{i}".encode())
    _seed_backup(v, dst)
    since = m.backup.last_append_at_ns(f"{dst}/3.dat")
    v.delete_needle(1)
    v.delete_needle(3)
    delta, applied = _apply(m, v, dst, since)
    yield "applied", {"delta": delta, "applied": applied,
                      "reads": _reads(m, dst, (1, 2, 3)),
                      "empty_next": m.backup.read_incremental(
                          v, m.backup.last_append_at_ns(f"{dst}/3.dat"))}
    v.close()


def test_binary_search_cut_offset(tmp_path, monkeypatch):
    obs = dict(twin(tmp_path, monkeypatch, _binary_search))["searched"]
    assert obs["mid"] == obs["off6"] and obs["newest"] == obs["end"]
    assert obs["all"] == obs["off1"]


def test_incremental_roundtrip_with_deletes(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _roundtrip_with_deletes))
    assert steps["applied"]["delta"] and steps["applied"]["applied"] >= 4
    reads = steps["backup"]["reads"]
    assert reads[2][:2] == ("raise", "NotFoundError")
    assert all(reads[n][0] == "ok" for n in (1, 3, 4, 5, 6, 7, 8))
    assert steps["backup"]["empty_next"] == b""


def test_delete_before_later_write_replays(tmp_path, monkeypatch):
    obs = dict(twin(tmp_path, monkeypatch, _delete_before_later_write))
    reads = obs["applied"]["reads"]
    assert reads[2][:2] == ("raise", "NotFoundError")
    assert reads[9] == ("ok", b"later-live")


def test_delete_only_interval_replays(tmp_path, monkeypatch):
    obs = dict(twin(tmp_path, monkeypatch, _delete_only_interval))
    reads = obs["applied"]["reads"]
    assert obs["applied"]["delta"]
    assert reads[1][:2] == reads[3][:2] == ("raise", "NotFoundError")
    assert reads[2] == ("ok", b"y-1")
    assert obs["applied"]["empty_next"] == b""


# -- weed backup against a live cluster, both packages ---------------------------


def _backup_run(pkg, root, clock):
    """One package's master and volume server; `weed backup` of the
    first volume (full), more writes, a delete, `weed backup` again
    (incremental).  Returns the backup files and what they serve."""
    cmd = mod(pkg, "command")
    cmd._load_all()
    cluster = LiveCluster(pkg, root, n=1)
    try:
        client = cluster.client()
        rng = random.Random(9)
        # One volume in the collection, so that every write lands on it.
        cluster.rpc.call(f"{cluster.url()}/vol/grow?count=1&collection=bk",
                         "POST")
        fid1 = client.upload_data(rng.randbytes(3000), collection="bk")
        vid = int(fid1.split(",")[0])
        host = cluster.url().replace("http://", "")
        bdir = str(root / "backup")
        flags, rest = cmd.parse_flags([f"-master={host}", f"-volumeId={vid}",
                                       f"-dir={bdir}"])
        rc_full = cmd.COMMANDS["backup"].run(flags, rest)
        full = snapshot(bdir)
        fids = [fid1]
        for _ in range(8):
            clock.now += 1
            fids.append(client.upload_data(
                rng.randbytes(rng.randrange(1, 5000)), collection="bk"))
        clock.now += 1
        client.delete(fids[1])
        rc_incr = cmd.COMMANDS["backup"].run(flags, rest)
        t = mod(pkg, "core.types")
        b = mod(pkg, "storage.volume").Volume(bdir, "", vid, create=False,
                                              use_worker=False)
        try:
            reads = {}
            for fid in fids:
                _vid, key, cookie = t.parse_file_id(fid)
                reads[fid] = outcome(lambda: b.read_needle(key, cookie).data)
        finally:
            b.close()
        src = {k: v for k, v in snapshot(str(root / "vs0")).items()
               if k.startswith(f"bk_{vid}.") and k[-4:] in (".dat", ".idx")}
    finally:
        cluster.stop()
    return {"rc": (rc_full, rc_incr), "fids": fids, "full": full,
            "incremental": snapshot(bdir), "reads": reads, "source": src}


def test_backup_command_end_to_end(tmp_path, monkeypatch):
    """weed backup, full then incremental over the VolumeTail routes:
    the port's backup files equal the reference's backup of the same
    volume byte for byte, and serve every needle that landed there."""
    clock = pin_clocks(monkeypatch)
    out = []
    for pkg in PACKAGES:
        random.seed(0)
        clock.now = 1_700_000_000.0
        d = tmp_path / pkg
        d.mkdir()
        out.append(_backup_run(pkg, d, clock))
    assert out[1] == out[0]
    state = out[1]
    assert state["rc"] == (0, 0)
    assert len({f.split(",")[0] for f in state["fids"]}) == 1
    # The incremental backup is the volume: same .dat bytes.
    vid = state["fids"][0].split(",")[0]
    assert state["incremental"][f"{vid}.dat"] == \
        state["source"][f"bk_{vid}.dat"]
    deleted = state["fids"][1]
    assert state["reads"][deleted][:2] == ("raise", "NotFoundError")
    assert all(r[0] == "ok" for f, r in state["reads"].items()
               if f != deleted)
    assert state["incremental"] != state["full"]


# -- a full copy of a live volume -----------------------------------------------


def _served(m, d):
    """The needle ids a backup copy serves through its .idx."""
    v = m.volume.Volume(str(d), "", 3, create=False, use_worker=False)
    try:
        keys: list = []
        v.nm.ascending_visit(lambda e: keys.append(e.key)
                             if e.size > 0 else None)
        return sorted(keys)
    finally:
        v.close()


def _scanned(m, d):
    return sorted(n.id for n, _o, _t in m.scanner.scan_volume_file(
        f"{d}/3.dat") if n.size > 0)


def _idx_then_dat_gap(m, root):
    """`weed backup`'s first run copies the .idx, then the .dat: a record
    appended in between is in the copy's .dat, not its .idx, and the
    resume point (last_append_at_ns walks the .dat to EOF) already counts
    it, so no incremental run brings its index entry."""
    import os
    src, dst = f"{root}/s3", f"{root}/d3"
    os.makedirs(src)
    os.makedirs(dst)
    v = _vol(m, src)
    for i in range(5):
        _write(m, v, i + 1, f"idx-{i}".encode())
    v.sync()
    shutil.copyfile(v.file_name() + ".idx", f"{dst}/3.idx")
    for i in range(5, 7):
        _write(m, v, i + 1, f"gap-{i}".encode())
    v.sync()
    shutil.copyfile(v.file_name() + ".dat", f"{dst}/3.dat")
    _write(m, v, 8, b"after")
    _apply(m, v, dst, m.backup.last_append_at_ns(f"{dst}/3.dat"))
    yield "backed-up", {"served": _served(m, dst),
                        "scanned": _scanned(m, dst)}
    m.scanner.generate_idx_from_dat(f"{dst}/3.dat", f"{dst}/3.idx")
    yield "fixed", {"served": _served(m, dst)}
    v.close()


def _torn_full_copy(m, root):
    """A .dat copied while a record lands can end inside it (the
    reference's route sends the size it sees first; the port's stops at
    the last whole record): the incremental run appends after the
    partial bytes, so the index serves every needle while a scan (`weed
    fix`, `weed export`) stops or goes astray at the partial record."""
    import os
    src, dst = f"{root}/s4", f"{root}/d4"
    os.makedirs(src)
    os.makedirs(dst)
    v = _vol(m, src)
    for i in range(4):
        _write(m, v, i + 1, f"whole-{i}".encode() * 20)
    v.sync()
    shutil.copyfile(v.file_name() + ".idx", f"{dst}/3.idx")
    offset, _size = _write(m, v, 5, b"landing" * 50)
    v.sync()
    with open(v.file_name() + ".dat", "rb") as f:
        head = f.read(offset + 40)  # ends inside needle 5
    with open(f"{dst}/3.dat", "wb") as f:
        f.write(head)
    _write(m, v, 6, b"later")
    delta, applied = _apply(m, v, dst,
                            m.backup.last_append_at_ns(f"{dst}/3.dat"))
    yield "backed-up", {"applied": applied, "served": _served(m, dst),
                        "scanned": _scanned(m, dst)}
    v.close()


def test_full_copy_of_live_volume_misses_idx_gap_until_fix(tmp_path,
                                                           monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _idx_then_dat_gap))
    assert steps["backed-up"]["served"] == [1, 2, 3, 4, 5, 8]
    assert steps["backed-up"]["scanned"] == list(range(1, 9))
    assert steps["fixed"]["served"] == list(range(1, 9))


def test_torn_full_copy_keeps_index_but_breaks_scan(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _torn_full_copy))
    obs = steps["backed-up"]
    assert obs["applied"] == 2
    assert obs["served"] == [1, 2, 3, 4, 5, 6]
    assert obs["scanned"] != obs["served"]


class _Growing:
    """A file served while it grows: its fstat size is what the server
    announces as Content-Length, its reads run on past it."""

    def __init__(self, path: str, more: bytes):
        self.f = open(path, "rb")
        self.more = more

    def fileno(self):
        return self.f.fileno()

    def read(self, n=-1):
        chunk = self.f.read(n)
        if not chunk and self.more:
            chunk, self.more = self.more, b""
        return chunk

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.f.close()


def test_growing_file_sends_announced_length_in_the_port(tmp_path):
    """A file response whose file grows while it streams: the reference
    sends it to EOF under the Content-Length it read first, so the
    client's pooled connection holds the rest and its next call reads
    them as a status line; the port sends the announced bytes only."""
    src = tmp_path / "grow.dat"
    src.write_bytes(b"d" * 5000)
    out = {}
    for pkg in PACKAGES:
        rpc = mod(pkg, "cluster.rpc")
        server = rpc.JsonHttpServer()
        server.route("GET", "/grow",
                     lambda q, b: _Growing(str(src), b"grown\nmore"))
        server.route("GET", "/ok", lambda q, b: {"ok": 1})
        server.start()
        try:
            n = rpc.call_to_file(server.url() + "/grow",
                                 str(tmp_path / f"{pkg}.dl"))
            nxt = outcome(rpc.call, server.url() + "/ok")
        finally:
            server.stop()
        out[pkg] = (n, nxt[:2])
    ref, port = out["seaweedfs_tpu"], out["seaweedfs_tpu_torch"]
    assert ref[0] == port[0] == 5000
    assert ref[1][0] == "raise"
    assert port[1] == ("ok", {"ok": 1})


def test_volume_file_of_live_volume_ends_at_record_boundary(tmp_path):
    """`/admin/volume_file` of a mounted volume while a record is landing
    (its first bytes already in the .dat): the reference copies them and
    the copy ends inside a record; the port copies up to the last whole
    record, and the copy is the volume as it was before the write."""
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        root.mkdir()
        cluster = LiveCluster(pkg, root, n=1)
        try:
            client = cluster.client()
            cluster.rpc.call(f"{cluster.url()}/vol/grow?count=1"
                             f"&collection=bk", "POST")
            fid = client.upload_data(b"whole" * 100, collection="bk")
            vid = int(fid.split(",")[0])
            vs = cluster.servers[0]
            path = vs.store.find_volume(vid).file_name() + ".dat"
            with open(path, "rb") as f:
                before = f.read()
            with open(path, "ab") as f:
                f.write(b"\x00\x00\x00\x01landing")  # a record's head
            copy = str(root / "copy.dat")
            n = cluster.rpc.call_to_file(
                f"http://{vs.url()}/admin/volume_file?volume={vid}&ext=.dat",
                copy)
            with open(copy, "rb") as f:
                out[pkg] = (n, f.read() == before)
        finally:
            cluster.stop()
    assert out["seaweedfs_tpu"][1] is False
    assert out["seaweedfs_tpu_torch"] == (len(before), True)
