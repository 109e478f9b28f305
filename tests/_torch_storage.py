"""Both packages' storage engines side by side, for the port's storage
tests (tests/test_torch_needle_map.py, _storage_volume.py, _scrub.py,
_tier.py, _storage_path.py).

A scenario is a generator function `scenario(m, root)`: `m` is one
package's namespace of modules (`REF` for seaweedfs_tpu, `PORT` for
seaweedfs_tpu_torch) and `root` a working directory.  It yields
`(label, observation)` at each checkpoint.  `twin` runs the scenario
for seaweedfs_tpu, then again for the port in the SAME directory (so
paths that land in files, such as a `.vif`'s backend spec, agree), and
holds the two step by step: equal labels, equal observations, equal
journal events since the previous checkpoint (types, severities and
attributes without durations or free disk space), and every file under `root`
byte-identical (compared by sha256).

Wall-clock fields are pinned: `time` in the modules that stamp files
(needle `append_at_ns`, tombstones, `.qrt` tickets, `.rlog` records,
`.vif` times, sig v4 dates) is a FixedClock whose `time_ns` counts up
by one from a fixed start, and both packages' `storage.expiry` clocks
are set to a constant.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import shutil
import threading
import time
from types import SimpleNamespace

import pytest

MODULES = {
    "types": "core.types", "idx": "core.idx", "needle": "core.needle",
    "crc": "core.crc", "ttl": "core.ttl", "rp": "core.replica_placement",
    "super_block": "core.super_block",
    "needle_map": "storage.needle_map", "volume": "storage.volume",
    "store": "storage.store", "vacuum": "storage.vacuum",
    "scrub": "storage.scrub", "scanner": "storage.volume_scanner",
    "backup": "storage.volume_backup", "tier": "storage.tier",
    "backend": "storage.backend", "expiry": "storage.expiry",
    "remote_cache": "storage.remote_cache",
    "chunk_cache": "storage.chunk_cache", "rlog": "replication.rlog",
    "sigv4": "s3api.sigv4", "ec": "ec", "encoder": "ec.encoder",
    "decoder": "ec.decoder", "ec_volume": "ec.volume",
    "integrity": "ec.integrity", "volume_info": "ec.volume_info",
    "shard_bits": "ec.shard_bits", "fault": "fault", "events": "events",
}
# Modules whose wall-clock reads reach bytes on disk or in a signature.
# The change log imports `time` inside its functions, so `time.time_ns`
# itself is pinned for the length of a run too.
CLOCKED = ("volume", "tier", "scrub", "sigv4")
EPOCH_S = 1_700_000_000.0
# Event attributes that vary run to run: durations, and the disk's live
# free space (`disk.low`).
VOLATILE_ATTRS = ("seconds", "free_bytes")


def _load(pkg: str, short: str) -> SimpleNamespace:
    mods = {k: importlib.import_module(f"{pkg}.{v}")
            for k, v in MODULES.items()}
    return SimpleNamespace(name=pkg, short=short, **mods)


REF = _load("seaweedfs_tpu", "ref")
PORT = _load("seaweedfs_tpu_torch", "port")
PAIR = (REF, PORT)


def _ref_coder():
    from seaweedfs_tpu.ops.coder_numpy import NumpyCoder
    return NumpyCoder()


def ec_kw(m) -> dict:
    """The EC entry points' coder choice: the reference's numpy oracle,
    the port's plain K1/K2 on the CPU."""
    return {"coder": _ref_coder()} if m is REF else {"device": "cpu"}


def ec_volume(m, base: str, vid: int = 0):
    return m.ec_volume.EcVolume(base, vid=vid, **ec_kw(m))


def ref_repair_ec_block(ev, sid, offset, size, block_index, want_crc):
    """seaweedfs_tpu's `VolumeServer._repair_ec_block` contract over the
    volume's local shards (the cluster layer gathers remote intervals):
    reconstruct the block, CRC-gate it, pwrite and fsync it."""
    try:
        data = ev._reconstruct_interval(sid, offset, size)
    except Exception:  # noqa: BLE001 — not enough healthy shards
        return False
    shard = ev.shards.get(sid)
    if shard is None or len(data) != size or \
            REF.crc.crc32c(data) != want_crc:
        return False
    with open(shard.path, "r+b") as f:
        os.pwrite(f.fileno(), data, offset)
        os.fsync(f.fileno())
    REF.events.emit("needle.repaired", node="", vid=ev.vid, shard=sid,
                    block=block_index, source="ec", bytes=size)
    return True


def repair_ec_block(m):
    return ref_repair_ec_block if m is REF else \
        PORT.scrub.repair_ec_block_locally


class FixedClock:
    """Stands in for the `time` module: `time_ns` counts up by one from
    a fixed start, `time` and `gmtime` are constant, everything else is
    the real module."""

    def __init__(self):
        self._ns = int(EPOCH_S) * 10**9
        self._lock = threading.Lock()

    def time_ns(self) -> int:
        with self._lock:
            self._ns += 1
            return self._ns

    def time(self) -> float:
        return EPOCH_S

    def gmtime(self, secs=None):
        return time.gmtime(EPOCH_S if secs is None else secs)

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture(params=[4, 5], ids=["offset4", "offset5"])
def flavor(request):
    """Both packages under the 4-byte (32 GB) and the 5-byte (8 TB)
    offset flavor; reset to 4 after."""
    for m in PAIR:
        m.types.set_offset_flavor(request.param)
    yield request.param
    for m in PAIR:
        m.types.set_offset_flavor(4)


def outcome(fn, *args, **kw):
    """("ok", value) or ("raise", exception class name, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the outcome is the result
        return ("raise", type(e).__name__, str(e))


def needle(m, nid: int, data: bytes, cookie: int = 0x1234):
    return m.needle.Needle(cookie=cookie, id=nid, data=data)


def snapshot(root: str) -> dict:
    """relpath -> (size, sha256); files over 256 MiB (sparse volumes)
    hash their first and last MiB."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            size = os.path.getsize(p)
            h = hashlib.sha256()
            with open(p, "rb") as fh:
                if size > 256 << 20:
                    h.update(fh.read(1 << 20))
                    fh.seek(size - (1 << 20))
                    h.update(fh.read())
                else:
                    for chunk in iter(lambda: fh.read(1 << 22), b""):
                        h.update(chunk)
            out[os.path.relpath(p, root)] = (size, h.hexdigest())
    return out


# The event families the storage engine and the EC path emit; a server
# an earlier test file left winding down in the same worker process
# must not leak its own events into the comparison.
ENGINE_EVENTS = ("volume.", "needle.", "scrub.", "disk.", "fault.", "ec.",
                 "tier.")


def _events_since(m, seq: int) -> list:
    return [(e["type"], e["severity"],
             {k: v for k, v in e["attrs"].items()
              if k not in VOLATILE_ATTRS})
            for e in m.events.JOURNAL.snapshot()
            if e["seq"] > seq and e["type"].startswith(ENGINE_EVENTS)]


def _run(m, scenario, root: str, monkeypatch) -> list:
    for name in CLOCKED:
        monkeypatch.setattr(getattr(m, name), "time", FixedClock())
    monkeypatch.setattr(time, "time_ns", FixedClock().time_ns)
    m.expiry.set_clock(lambda: EPOCH_S)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    steps = []
    seq = m.events.JOURNAL._seq
    try:
        for label, obs in scenario(m, root):
            events = _events_since(m, seq)
            seq = m.events.JOURNAL._seq
            steps.append((label, obs, events, snapshot(root)))
    finally:
        m.fault.disarm_all()
        m.expiry.reset_clock()
    return steps


def twin(tmp_path, monkeypatch, scenario) -> list:
    """Run `scenario` for both packages and hold them step by step;
    returns the port's [(label, observation)]."""
    root = str(tmp_path / "work")
    ref = _run(REF, scenario, root, monkeypatch)
    port = _run(PORT, scenario, root, monkeypatch)
    assert [s[0] for s in port] == [s[0] for s in ref]
    for (label, r_obs, r_ev, r_files), (_, p_obs, p_ev, p_files) in \
            zip(ref, port):
        assert p_obs == r_obs, f"step {label}: observations differ"
        assert p_ev == r_ev, f"step {label}: journal events differ"
        assert sorted(p_files) == sorted(r_files), \
            f"step {label}: file sets differ"
        for name in r_files:
            assert p_files[name] == r_files[name], \
                f"step {label}: {name} differs"
    return [(s[0], s[1]) for s in port]
