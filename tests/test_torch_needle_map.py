"""The port's needle maps and on-disk formats held against seaweedfs_tpu.

Mirrors tests/test_needle_map.py, the format cases of
tests/test_core_formats.py and tests/test_offset_5bytes.py: the same
operations on `MemoryNeedleMap`, `CompactNeedleMap` and
`SortedFileNeedleMap` in both packages must return the same values,
keep the same counters and leave byte-identical `.idx`/`.sdx` files,
under the 4-byte and the 5-byte offset flavor.  Also the port's repairs
of this slice: `idx.ENTRY_SIZE` and `iter_index` follow the flavor per
call, `set_offset_flavor`/`format_file_id`/`parse_file_id`/
`offset_is_zero` exist, and `ReplicaPlacement.parse` memoizes.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

from _torch_storage import PAIR, PORT, REF, flavor, outcome  # noqa: F401

pytestmark = pytest.mark.torch

torch.set_num_threads(1)

TOMB = REF.types.TOMBSTONE_FILE_SIZE
KINDS = ("compact", "memory", "sorted_file")


def _write_idx(m, path, entries):
    with open(path, "wb") as f:
        for key, off, size in entries:
            m.idx.append_entry(f, key, off, size)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _state(nm, keys) -> dict:
    seen = []
    nm.ascending_visit(lambda e: seen.append((e.key, e.offset, e.size)))
    mt = nm.metrics
    return {"get": [nm.get(k) for k in keys], "len": len(nm),
            "metrics": (mt.file_count, mt.deletion_count,
                        mt.file_byte_count, mt.deletion_byte_count,
                        mt.maximum_file_key),
            "ordered": [int(x) for x in nm.ordered_offsets()],
            "visit": seen, "content": nm.content_size(),
            "deleted": nm.deleted_size()}


def _pair_paths(tmp_path, name):
    out = []
    for m in PAIR:
        d = tmp_path / m.short
        d.mkdir(exist_ok=True)
        out.append(str(d / name))
    return out


# -- formats -----------------------------------------------------------------


def test_offset_flavor_sizes_and_codecs(flavor):
    """Sizes, offset bytes and the 0-offset test agree per flavor; the
    port's idx.ENTRY_SIZE follows the flavor (it was frozen at 16)."""
    for m in PAIR:
        assert m.types.OFFSET_SIZE == flavor
        assert m.idx.ENTRY_SIZE == m.types.NEEDLE_MAP_ENTRY_SIZE == \
            12 + flavor
    assert PORT.types.MAX_POSSIBLE_VOLUME_SIZE == \
        REF.types.MAX_POSSIBLE_VOLUME_SIZE
    top = REF.types.MAX_POSSIBLE_VOLUME_SIZE - 8
    for actual in (0, 8, 1 << 20, (32 << 30) - 8, top):
        b = PORT.types.offset_to_bytes(actual)
        assert b == REF.types.offset_to_bytes(actual)
        assert len(b) == flavor
        assert PORT.types.offset_from_bytes(b) == actual
        assert PORT.types.offset_is_zero(actual) == \
            REF.types.offset_is_zero(actual) == (actual == 0)
    e = PORT.types.NeedleMapEntry(key=0xDEADBEEF01, offset=top, size=1234)
    assert e.to_bytes() == REF.types.NeedleMapEntry(
        key=0xDEADBEEF01, offset=top, size=1234).to_bytes()


def test_set_offset_flavor_rejects_other_widths():
    for m in PAIR:
        with pytest.raises(ValueError):
            m.types.set_offset_flavor(6)
        assert m.types.OFFSET_SIZE == 4


@pytest.mark.parametrize("fid", ["3,01637037d6000000", "1,012345678",
                                 "7,ab00000001", "nocomma", "x,12", "2,"])
def test_file_id_format_parse(fid):
    assert outcome(PORT.types.parse_file_id, fid) == \
        outcome(REF.types.parse_file_id, fid)
    got = outcome(PORT.types.parse_file_id, fid)
    if got[0] == "ok":
        assert PORT.types.format_file_id(*got[1]) == \
            REF.types.format_file_id(*got[1])


def test_idx_walk_and_append(flavor, tmp_path):
    entries = [(i, i * 8, i % 100) for i in range(2500)]  # > ROWS_TO_READ
    entries.append((7, (40 << 30) if flavor == 5 else 4096, TOMB))
    paths = _pair_paths(tmp_path, "v.idx")
    for m, p in zip(PAIR, paths):
        _write_idx(m, p, entries)
        with open(p, "ab") as f:
            f.write(b"\x01\x02\x03")  # a torn trailing entry
    assert _read(paths[0]) == _read(paths[1])
    got = []
    for m, p in zip(PAIR, paths):
        with open(p, "rb") as f:
            rows = [(e.key, e.offset, e.size) for e in m.idx.iter_index(f)]
        assert [(e.key, e.offset, e.size)
                for e in m.idx.iter_index(_read(p))] == rows
        got.append(rows)
    assert got[0] == got[1] == entries


def test_ttl_and_replica_placement_codecs():
    for s in ("3m", "4h", "5d", "6w", "7M", "100", ""):
        ref, port = REF.ttl.TTL.parse(s), PORT.ttl.TTL.parse(s)
        assert port.to_bytes() == ref.to_bytes()
        assert port.to_uint32() == ref.to_uint32()
        assert PORT.ttl.TTL.from_uint32(port.to_uint32()) == port
    for s in ("000", "001", "012", "200"):
        ref, port = REF.rp.ReplicaPlacement.parse(s), \
            PORT.rp.ReplicaPlacement.parse(s)
        assert port.to_byte() == ref.to_byte()
        assert port.copy_count() == ref.copy_count()
        # Memoized like the reference: one frozen instance per string.
        assert PORT.rp.ReplicaPlacement.parse(s) is port
    with pytest.raises(ValueError):
        PORT.rp.ReplicaPlacement.parse("900")


# -- map operations ----------------------------------------------------------


OPS = ([("put", k * 13 % 103, (k + 1) * 8, 10 + k) for k in range(103)]
       + [("delete", k, 0, 0) for k in range(0, 103, 5)]
       + [("put", k, (200 + k) * 8, 500 + k) for k in range(0, 103, 7)]
       + [("delete", 999, 0, 0), ("delete", 5, 0, 0)])


@pytest.mark.parametrize("kind", ["compact", "memory"])
@pytest.mark.parametrize("merge", [None, 16])
def test_map_operations_identical(flavor, kind, merge, tmp_path, monkeypatch):
    """put/get/delete through the overflow-merge boundary: equal returns,
    counters, visits, and byte-identical write-through .idx files; a
    reload of each .idx rebuilds the same state."""
    keys = list(range(0, 110)) + [999]
    states = []
    for m, p in zip(PAIR, _pair_paths(tmp_path, "1.idx")):
        if merge is not None:
            monkeypatch.setattr(m.needle_map.CompactNeedleMap,
                                "OVERFLOW_MERGE", merge)
        open(p, "wb").close()
        nm = m.needle_map.new_needle_map(kind, p)
        freed = []
        for op, k, off, size in OPS:
            if op == "put":
                nm.put(k, off, size)
            else:
                freed.append(nm.delete(k))
        st = _state(nm, keys)
        nm.close()
        re = m.needle_map.new_needle_map(kind, p)
        st["reloaded"] = _state(re, keys)
        re.close()
        st["freed"] = freed
        st["idx"] = _read(p)
        states.append(st)
    assert states[1] == states[0]
    assert states[1]["reloaded"]["visit"] == states[1]["visit"]


@pytest.mark.parametrize("kind", KINDS)
def test_load_dedup_tombstones(flavor, kind, tmp_path):
    big = (100 << 30) + 4096 if flavor == 5 else 4096 * 1000
    entries = [(1, 8, 100), (2, 16, 200), (1, 24, 110), (3, 32, 300),
               (2, 0, TOMB), (4, 40, 400), (4, 48, 410), (9, 0, TOMB),
               (5, big, 60), (6, big + 4096, 70), (6, 0, TOMB)]
    states = []
    for m, p in zip(PAIR, _pair_paths(tmp_path, "k.idx")):
        _write_idx(m, p, entries)
        nm = m.needle_map.new_needle_map(kind, p)
        states.append(_state(nm, range(0, 11)))
        nm.close()
    assert states[1] == states[0]
    assert states[1]["get"][5] == (big, 60) and states[1]["get"][6] is None


def test_compact_bulk_load_bounded_memory(tmp_path):
    n = 200_000
    rec = np.empty(n, dtype=[("k", ">u8"), ("o", ">u4"), ("s", ">i4")])
    rec["k"] = np.arange(1, n + 1)
    rec["o"] = np.arange(1, n + 1)
    rec["s"] = 100
    p = str(tmp_path / "big.idx")
    with open(p, "wb") as f:
        f.write(rec.tobytes())
    got = []
    for m in PAIR:
        nm = m.needle_map.CompactNeedleMap.load(p)
        got.append((len(nm), nm.metrics.file_count,
                    nm.index_memory_bytes(), nm.get(1), nm.get(n),
                    nm.get(n + 1)))
        nm.close()
    assert got[1] == got[0] == (n, n, n * 16, (8, 100), (n * 8, 100), None)


def test_compact_concurrent_mutation_and_reads(tmp_path, monkeypatch):
    monkeypatch.setattr(PORT.needle_map.CompactNeedleMap, "OVERFLOW_MERGE",
                        64)
    p = str(tmp_path / "1.idx")
    open(p, "wb").close()
    nm = PORT.needle_map.CompactNeedleMap.load(p)
    n, errors = 4000, []

    def writer():
        try:
            for k in range(1, n + 1):
                nm.put(k, k * 8, 100)
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    def reader(seed):
        try:
            for i in range(300):
                k = 1 + (seed * 2654435761 + i) % n
                got = nm.get(k)
                assert got is None or got == (k * 8, 100)
                nm.ordered_offsets()  # merges under the lock
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ths = [threading.Thread(target=writer)] + \
        [threading.Thread(target=reader, args=(s,)) for s in range(3)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    assert not errors
    assert len(nm) == n
    nm.close()
    ref = REF.needle_map.CompactNeedleMap.load(p)  # the same journal
    assert len(ref) == n and ref.get(n // 2) == (n // 2 * 8, 100)
    ref.close()


# -- the sorted file (.sdx) --------------------------------------------------


def test_sorted_file_generate_and_lookups(flavor, tmp_path):
    entries = [(k, k * 8, 50 + k) for k in range(1000, 0, -1)]
    entries += [(k, 0, TOMB) for k in range(1, 1000, 7)]
    entries += [(k, k * 16, 500) for k in range(1, 1000, 13)]
    states = []
    for m, p in zip(PAIR, _pair_paths(tmp_path, "3.idx")):
        _write_idx(m, p, entries)
        nm = m.needle_map.SortedFileNeedleMap.load(p)
        st = _state(nm, [0, 1, 2, 8, 14, 999, 1000, 1001])
        st["put"] = outcome(nm.put, 1, 8, 1)
        st["delete"] = outcome(nm.delete, 10)
        nm.close()
        st["sdx"] = _read(p[:-4] + ".sdx")
        st["src"] = _read(p[:-4] + ".sdx.src")
        with open(p, "rb") as f:
            st["memdb"] = m.needle_map.MemDb.from_idx(f).to_sorted_bytes()
        states.append(st)
    assert states[1] == states[0]
    assert states[1]["sdx"] == states[1]["memdb"]
    assert states[1]["put"][:2] == ("raise", "RuntimeError")


def test_sorted_file_regenerates_on_append(tmp_path):
    """An .idx append within mtime granularity still regenerates the
    .sdx (the recorded source length is the staleness signal)."""
    out = []
    for m, p in zip(PAIR, _pair_paths(tmp_path, "4.idx")):
        _write_idx(m, p, [(1, 8, 100)])
        m.needle_map.SortedFileNeedleMap.load(p).close()
        sdx = p[:-4] + ".sdx"
        ino = os.stat(sdx).st_ino
        m.needle_map.SortedFileNeedleMap.load(p).close()
        fresh_kept = os.stat(sdx).st_ino == ino
        mtime = os.path.getmtime(sdx)
        with open(p, "ab") as f:
            m.idx.append_entry(f, 2, 16, 200)
        os.utime(p, (mtime, mtime))
        os.utime(sdx, (mtime, mtime))
        nm = m.needle_map.SortedFileNeedleMap.load(p)
        out.append((fresh_kept, nm.get(1), nm.get(2), _read(sdx)))
        nm.close()
    assert out[1] == out[0]
    assert out[1][:3] == (True, (8, 100), (16, 200))


# -- crash state -------------------------------------------------------------


@pytest.mark.parametrize("case", ["clean", "torn_entry", "beyond_eof",
                                  "empty", "missing"])
def test_idx_crash_state_and_verify(flavor, case, tmp_path):
    """idx_crash_state's furthest write and dead keys, and
    verify_idx_against_dat's repair of the .idx, agree on the same
    volume files."""
    results = []
    for m in PAIR:
        d = tmp_path / m.short
        d.mkdir()
        v = m.volume.Volume(str(d), "", 1, use_worker=False)
        for i in range(1, 6):
            n = m.needle.Needle(cookie=i, id=i, data=bytes([i]) * (40 * i))
            n.append_at_ns = i
            v.write_needle(n)
        v.close()
        base = str(d / "1")
        # The tombstone is written by hand: delete_needle would stamp
        # the wall clock into the marker.
        with open(base + ".idx", "ab") as f:
            m.idx.append_entry(f, 3, 0, TOMB)
        if case == "torn_entry":
            with open(base + ".idx", "ab") as f:
                f.write(b"\x00" * 5)
        elif case == "beyond_eof":
            size = os.path.getsize(base + ".dat")
            with open(base + ".dat", "r+b") as f:
                f.truncate(size - 10)
        elif case == "empty":
            open(base + ".idx", "wb").close()
        elif case == "missing":
            os.remove(base + ".idx")
        state = m.needle_map.idx_crash_state(base + ".idx")
        m.needle_map.verify_idx_against_dat(base + ".idx", base + ".dat")
        idx = _read(base + ".idx") if os.path.exists(base + ".idx") \
            else None
        results.append((state[0], sorted(state[1]), idx,
                        _read(base + ".dat")))
    assert results[1] == results[0]
