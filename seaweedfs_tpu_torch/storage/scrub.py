"""Data integrity: crash-safe volume recovery + background scrub.

Three layers, mirroring SeaweedFS's volume_checking.go /
command_volume_check_disk.go direction but wired into this repo's
events/healthz/fault surfaces:

1. `recover_volume_files` — crash-safe mount.  Run before a volume's
   needle map is opened: validates the superblock, truncates a torn
   trailing record left by a `kill -9` mid-write, appends idx entries
   for complete records the index never learned about (crash between
   the .dat fsync and the .idx append), and regenerates the .idx from
   the .dat when it is missing or references bytes past EOF.  A crash
   can lose unacknowledged in-flight writes, never acknowledged ones,
   and never leaves a volume unmountable or lying.

2. `ScrubDaemon` — rate-limited (`-scrub.mbps`) background sweep on
   the volume server: CRC-verifies every live needle of every normal
   volume and every block of every local EC shard file (against the
   `.ecc` sidecar, ec/integrity.py).  Detection emits
   `needle.corrupt`, bumps `SeaweedFS_scrub_corrupt_total`, and — for
   needles — quarantines (tombstone + repair ticket) so corrupt bytes
   are never served while the volume reports degraded on
   `/cluster/healthz`.

3. Self-healing — the daemon takes repair callbacks from the server:
   a corrupt/unreadable needle is re-fetched from a healthy replica,
   a corrupt shard block is reconstructed through the EC decode
   path (coder.reconstruct over >=10 sibling shard intervals), both
   rewritten in place with `needle.repaired` +
   `SeaweedFS_needle_repairs_total{source=}` emitted.  The port has no
   volume server yet: `repair_ec_block_locally` is the block-repair
   callback over an EcVolume's local shards.

Facebook's warehouse study (arxiv 1309.0186) puts repair traffic, not
encode, at the center of EC operating cost; routing block repair
through the same batched decode kernel the rebuild pipeline uses keeps
that path cheap (arxiv 1611.09968's efficient-repair direction).
"""

from __future__ import annotations

import os
import threading
import time

from ..core import idx as idx_mod
from ..core import types as t
from ..core.needle import Needle, get_actual_size
from ..events import emit as emit_event
from ..stats.metrics import (needle_repairs_total, scrub_bytes_total,
                             scrub_checked_total, scrub_corrupt_total,
                             scrub_sweeps_total)
from ..trace import root_span
from ..utils import glog
from .volume_scanner import read_super_block, scan_data_tail


# -- crash-safe mount --------------------------------------------------------

def _write_idx_entries(out, entries) -> None:
    for key, offset, size in entries:
        if size > 0:
            idx_mod.append_entry(out, key, offset, size)
        else:
            idx_mod.append_entry(out, key, 0, t.TOMBSTONE_FILE_SIZE)
    out.flush()
    os.fsync(out.fileno())


def recover_volume_files(dat_path: str, idx_path: str, vid: int = 0,
                         node: str = "") -> dict:
    """Crash-safe mount pass (see module docstring).  Returns a report
    dict; raises whatever read_super_block raises for an unmountable
    .dat (0-byte crashed create, garbage superblock) so the store can
    skip it like before.  Emits `volume.recovered` when it changed
    anything on disk."""
    from .needle_map import idx_crash_state
    report = {"dat_truncated": 0, "idx_appended": 0,
              "idx_regenerated": False}
    sb = read_super_block(dat_path)  # validates; raises if unmountable
    version = sb.version
    dat_size = os.path.getsize(dat_path)
    last, dead_keys = idx_crash_state(idx_path)
    idx_missing = not os.path.exists(idx_path) or \
        os.path.getsize(idx_path) == 0

    stale = last is not None and \
        last[0] + get_actual_size(last[1], version) > dat_size
    if stale:
        # The index vouches for bytes the .dat no longer has: it is
        # lying — rebuild it from what the data actually says.
        start = None
    elif last is not None:
        # Index tail is sound: only the region past its furthest entry
        # needs scanning — O(tail), not O(volume), per mount.
        start = last[0] + get_actual_size(last[1], version)
    else:
        start = None
    entries, data_end = scan_data_tail(dat_path, start_offset=start)
    if stale or (idx_missing and entries):
        with open(idx_path, "wb") as out:
            _write_idx_entries(out, entries)
        report["idx_regenerated"] = True
    else:
        # Complete records the index never learned about (crash
        # between the .dat write and the .idx append): journal them.
        # Tombstone MARKERS past the furthest write entry are normal
        # (their idx entries carry offset 0, so they sit beyond `start`
        # on every mount) — only journal ones the index doesn't
        # already record as deleted, or every restart after a delete
        # would append a duplicate and report a phantom recovery.
        fresh = [(key, off, size) for key, off, size in entries
                 if size > 0 or key not in dead_keys]
        if fresh:
            with open(idx_path, "ab") as out:
                _write_idx_entries(out, fresh)
            report["idx_appended"] = len(fresh)

    if data_end < dat_size:
        # Torn trailing record from a crash mid-write: truncate so the
        # append grid stays clean and the next write lands aligned.
        with open(dat_path, "r+b") as f:
            f.truncate(data_end)
        report["dat_truncated"] = dat_size - data_end

    if report["dat_truncated"] or report["idx_appended"] or \
            report["idx_regenerated"]:
        glog.warningf("volume %d recovered: %s", vid, report)
        emit_event("volume.recovered", node=node, severity="warn",
                   vid=vid, **report)
    return report


# -- rate limiting -----------------------------------------------------------

class RateLimiter:
    """Token-bucket byte throttle for the scrub's disk reads
    (`-scrub.mbps`): a background sweep must never starve foreground
    traffic of disk bandwidth.  mbps <= 0 disables."""

    def __init__(self, mbps: float = 32.0):
        self.rate = mbps * 1e6
        self._allow_at = time.monotonic()
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> None:
        if self.rate <= 0 or nbytes <= 0:
            return
        with self._lock:
            now = time.monotonic()
            self._allow_at = max(self._allow_at, now) + nbytes / self.rate
            wait = self._allow_at - now
        if wait > 0:
            time.sleep(min(wait, 5.0))


# -- the scrub daemon --------------------------------------------------------

class ScrubDaemon:
    """Per-volume-server integrity sweep + self-healing dispatcher.

    `repair_needle(volume, key) -> truthy` and
    `repair_ec_block(ev, sid, offset, size, block_index, want_crc)
    -> bool` come from the cluster layer (they need master lookups /
    shard fan-out); without them the daemon detects and quarantines
    but cannot heal.
    """

    def __init__(self, store, ec_volumes: dict, node: str = "",
                 mbps: float = 32.0, interval: float = 3600.0,
                 repair_needle=None, repair_ec_block=None,
                 on_change=None):
        self.store = store
        self.ec_volumes = ec_volumes
        self.node = node
        self.limiter = RateLimiter(mbps)
        self.interval = interval
        self.repair_needle = repair_needle
        self.repair_ec_block = repair_ec_block
        self.on_change = on_change
        # vid -> {(shard_id, block_index), ...} of detected-but-
        # unrepaired EC corruption; feeds the heartbeat so the master's
        # healthz reports the volume degraded until healed.  Guarded by
        # _ec_corrupt_lock: the heartbeat and /admin/scrub/status
        # threads iterate it while a sweep mutates it.
        self.ec_corrupt: dict[int, set[tuple[int, int]]] = {}
        self._ec_corrupt_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._sweep_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.interval <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="scrub")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.scrub_all(repair=True)
            except Exception as e:  # noqa: BLE001 — sweep must survive
                glog.warningf("scrub sweep failed: %s", e)

    # -- sweeps --------------------------------------------------------------

    def ec_corrupt_counts(self) -> dict[int, int]:
        with self._ec_corrupt_lock:
            return {vid: len(blocks)
                    for vid, blocks in self.ec_corrupt.items()
                    if blocks}

    def ec_corrupt_snapshot(self) -> dict[int, list[tuple[int, int]]]:
        with self._ec_corrupt_lock:
            return {vid: sorted(blocks)
                    for vid, blocks in self.ec_corrupt.items()
                    if blocks}

    def _ec_mark(self, vid: int, sid: int, block: int,
                 corrupt: bool) -> None:
        with self._ec_corrupt_lock:
            blocks = self.ec_corrupt.setdefault(vid, set())
            if corrupt:
                blocks.add((sid, block))
            else:
                blocks.discard((sid, block))

    def scrub_all(self, repair: bool = False,
                  vid: int | None = None) -> dict:
        """One sweep over every (or one) volume and EC volume.  Safe to
        call concurrently with traffic; serialized against itself."""
        with self._sweep_lock, root_span("scrub.sweep", "scrub",
                                         repair=repair):
            reports = []
            for loc in self.store.locations:
                for v in list(loc.volumes.values()):
                    if vid is not None and v.vid != vid:
                        continue
                    if v.remote_file is not None:
                        continue  # tiered: the backend owns integrity
                    reports.append(self.scrub_volume(v, repair=repair))
            for evid, ev in sorted(self.ec_volumes.items()):
                if vid is not None and evid != vid:
                    continue
                reports.append(self.scrub_ec_volume(ev, repair=repair))
            scrub_sweeps_total.inc()
            out = {"volumes": reports,
                   "corrupt": sum(r["corrupt"] for r in reports),
                   "repaired": sum(r["repaired"] for r in reports),
                   "quarantined": sum(r.get("quarantined", 0)
                                      for r in reports)}
            if self.on_change is not None and \
                    (out["corrupt"] or out["repaired"]):
                try:
                    self.on_change()
                except Exception:  # noqa: BLE001 — advisory only
                    pass
            return out

    # -- normal volumes ------------------------------------------------------

    def _verify_needle(self, v, entry) -> str | None:
        """CRC-verify one live needle record in place.  Returns an
        error string, or None when the bytes are sound.  Re-validates
        the map entry after a failure so a concurrent overwrite or
        vacuum swap is never misread as bit-rot."""
        total = get_actual_size(entry.size, v.version)
        err = None
        try:
            blob = v.pread(total, entry.offset)
            if len(blob) < total:
                err = "short read (record truncated)"
            else:
                n = Needle.parse_header(blob)
                if n.id != entry.key or n.size != entry.size:
                    err = (f"header mismatch: disk has "
                           f"{n.id:x}/{n.size}, index says "
                           f"{entry.key:x}/{entry.size}")
                else:
                    Needle.from_bytes(blob, v.version, check_crc=True)
        except OSError as e:
            err = f"read error: {e}"
        except ValueError as e:
            err = str(e)
        if err is not None:
            cur = v.nm.get(entry.key)
            if cur is None or cur != (entry.offset, entry.size):
                return None  # raced a delete/overwrite/vacuum: skip
        return err

    def scrub_volume(self, v, repair: bool = False) -> dict:
        emit_event("scrub.start", node=self.node, vid=v.vid,
                   kind="volume")
        t0 = time.perf_counter()
        entries: list = []
        v.nm.ascending_visit(
            lambda e: entries.append(e) if t.size_is_valid(e.size)
            else None)
        checked = corrupt = repaired = quarantined = 0
        nbytes = 0
        for entry in entries:
            total = get_actual_size(entry.size, v.version)
            self.limiter.take(total)
            err = self._verify_needle(v, entry)
            checked += 1
            nbytes += total
            scrub_checked_total.inc(kind="needle")
            scrub_bytes_total.inc(total)
            if err is None:
                continue
            corrupt += 1
            scrub_corrupt_total.inc(kind="needle")
            emit_event("needle.corrupt", node=self.node,
                       severity="error", vid=v.vid,
                       key=f"{entry.key:x}", kind="needle", error=err)
            fixed = False
            if repair and self.repair_needle is not None:
                try:
                    fixed = bool(self.repair_needle(v, entry.key))
                except Exception:  # noqa: BLE001 — repair must not
                    fixed = False  # kill the sweep
            if fixed:
                repaired += 1
            elif "read error" not in err:
                # CRC-proven corruption: stop serving the bad bytes.
                # A pure read error may be transient — never tombstone
                # a needle whose bytes might be fine.
                if v.quarantine_needle(entry.key, node=self.node):
                    quarantined += 1
        if repair and self.repair_needle is not None:
            # Second chance for previously-quarantined needles: the
            # repair ticket survives the tombstone precisely so a
            # replica that was down last sweep can heal us now.
            for key in list(v.repair_tickets):
                try:
                    if self.repair_needle(v, key):
                        repaired += 1
                except Exception:  # noqa: BLE001
                    pass
        v.last_scrub = time.time()
        report = {"id": v.vid, "kind": "volume", "checked": checked,
                  "corrupt": corrupt, "repaired": repaired,
                  "quarantined": quarantined,
                  "tickets": len(v.repair_tickets), "bytes": nbytes}
        emit_event("scrub.finish", node=self.node, vid=v.vid,
                   kind="volume",
                   severity="warn" if corrupt > repaired else "info",
                   seconds=round(time.perf_counter() - t0, 6), **{
                       k: report[k] for k in
                       ("checked", "corrupt", "repaired", "bytes")})
        return report

    # -- EC volumes ----------------------------------------------------------

    def scrub_ec_volume(self, ev, repair: bool = False) -> dict:
        from ..ec.integrity import (ShardChecksums, ecc_lock,
                                    file_block_crcs)
        emit_event("scrub.start", node=self.node, vid=ev.vid, kind="ec")
        t0 = time.perf_counter()
        ecc = ShardChecksums.load(ev.base_file_name)
        checked = corrupt = repaired = 0
        nbytes = 0
        tofu: dict[int, list[int]] = {}
        for sid in sorted(ev.shards):
            shard = ev.shards[sid]
            crcs = ecc.get(sid)
            if crcs is None:
                # Trust-on-first-scrub: a shard that arrived without a
                # checksum record (copied/received) is fingerprinted
                # now; divergence is detectable from the next sweep on.
                tofu[sid] = file_block_crcs(
                    shard.path, block=ecc.block, limiter=self.limiter)
                continue
            bad = ecc.verify_file(sid, shard.path,
                                  limiter=self.limiter)
            checked += len(crcs)
            nbytes += os.path.getsize(shard.path)
            scrub_checked_total.inc(len(crcs), kind="shard_block")
            scrub_bytes_total.inc(os.path.getsize(shard.path))
            for b in bad:
                corrupt += 1
                scrub_corrupt_total.inc(kind="shard_block")
                emit_event("needle.corrupt", node=self.node,
                           severity="error", vid=ev.vid,
                           kind="shard_block", shard=sid, block=b)
                fixed = False
                if repair and self.repair_ec_block is not None and \
                        b < len(crcs):
                    off = b * ecc.block
                    size = min(ecc.block, shard.size - off)
                    try:
                        # The callback rewrites the block ONLY when
                        # the reconstruction reproduces the recorded
                        # checksum — anything else (a second corrupt
                        # source shard) is a failed repair that must
                        # not touch the original bytes.
                        fixed = bool(self.repair_ec_block(
                            ev, sid, off, size, b, crcs[b]))
                    except Exception:  # noqa: BLE001
                        fixed = False
                if fixed:
                    repaired += 1
                self._ec_mark(ev.vid, sid, b, corrupt=not fixed)
        if tofu:
            # Re-load under the sidecar lock: a shard received mid-
            # sweep must not have its fresh record clobbered by this
            # sweep's stale view.
            with ecc_lock(ev.base_file_name):
                cur = ShardChecksums.load(ev.base_file_name)
                changed = False
                for sid, crcs in tofu.items():
                    if cur.get(sid) is None:
                        cur.set_shard(sid, crcs)
                        changed = True
                if changed:
                    cur.save()
        unrepaired = len(self.ec_corrupt_snapshot().get(ev.vid, []))
        report = {"id": ev.vid, "kind": "ec", "checked": checked,
                  "corrupt": corrupt, "repaired": repaired,
                  "unrepaired": unrepaired, "bytes": nbytes}
        emit_event("scrub.finish", node=self.node, vid=ev.vid,
                   kind="ec",
                   severity="warn" if unrepaired else "info",
                   seconds=round(time.perf_counter() - t0, 6), **{
                       k: report[k] for k in
                       ("checked", "corrupt", "repaired", "bytes")})
        return report


# -- local EC block repair ---------------------------------------------------

def repair_ec_block_locally(ev, sid: int, offset: int, size: int,
                            block_index: int, want_crc: int,
                            node: str = "") -> bool:
    """A `repair_ec_block` callback over the shards an EcVolume holds
    locally, with the volume server's contract: reconstruct the block
    from sibling shard intervals (`EcVolume._reconstruct_interval`, one
    bit-matrix kernel launch; bringing the bytes to the host is the
    fence), and pwrite + fsync it in place ONLY if the result reproduces
    the recorded checksum.  A wrong solve (a second, still-undetected
    corrupt source shard) leaves the original bytes untouched.  Until
    the volume server is ported, this is how a `ScrubDaemon` heals EC
    shard blocks."""
    from ..core.crc import crc32c
    try:
        data = ev._reconstruct_interval(sid, offset, size)
    except Exception:  # noqa: BLE001 — not enough healthy shards
        return False
    shard = ev.shards.get(sid)
    if shard is None or len(data) != size or crc32c(data) != want_crc:
        return False
    with open(shard.path, "r+b") as f:
        os.pwrite(f.fileno(), data, offset)
        os.fsync(f.fileno())
    needle_repairs_total.inc(source="ec")
    emit_event("needle.repaired", node=node, vid=ev.vid, shard=sid,
               block=block_index, source="ec", bytes=size)
    return True
