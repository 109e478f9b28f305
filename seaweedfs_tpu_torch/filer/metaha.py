"""Sharded, replicated filer metadata plane (metadata HA).

The namespace is split into shards by the FIRST path component
(`/a/b/c` shards on "a"), so a rename inside one top-level tree is
single-shard by construction — the same reason the reference shards
its filer store by directory.  The shard map — which filer is primary
for each shard, at which fencing epoch, with which followers — is
owned by the MASTER (filers register and heartbeat like volume
servers); this module is the filer-side half:

- **Shard journals.**  Every acked namespace mutation on a shard
  primary is framed into a per-shard `.mlog` (replication/rlog.py
  FramedLog: CRC-framed records, torn-tail truncation at open, a
  Watermark sidecar for the applied seq) and fsync'd BEFORE the ack.
  Records are logical ops (set / del / ren / kv), not state diffs —
  a directory rename replays as one rename on the follower instead of
  an unreconstructible delete+create pair.

- **Semi-sync replication.**  After the local fsync the primary pushes
  the record to its in-sync followers (`/.meta/shard/apply`) and acks
  only once at least one follower persisted it (when the shard has
  followers at all) — the zero-acked-op-loss bar: an acked mutation
  exists on at least two disks before the client hears 200.  A
  follower that misses a push falls out of the in-sync set and
  catches back up through its tailer (below), rejoining once level.

- **Epoch fencing** (replication/lease.py semantics).  Each shard
  carries a monotonically-fenced epoch; a push or an acquire at a
  stale epoch is refused with 409, a contested shard (mid-move, no
  primary, or a primary that lost master contact) fails CLOSED with
  503.  A partition can therefore never produce two filers acking
  writes for one shard: the side that cannot reach the master stops
  acking when its lease TTL runs out, and its pushes are fenced by
  epoch everywhere else.

- **Rejoin repair.**  A deposed primary that comes back tails the new
  primary; if its journal runs PAST the new primary's (records it
  framed but never replicated — by the ack rule those were never
  acked), the divergent suffix is truncated and reverse-applied
  (set→restore-old, del→re-insert, ren→rename-back) before tailing
  resumes.  The promoted history is the truth; unacked writes unwind.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time

from ..cluster import rpc
from ..core.crc import crc32c
from ..events import emit as emit_event
from ..fault import registry as _fault
from ..replication.rlog import FramedLog
from ..stats import metrics as _metrics
from ..utils import glog


def shard_key(path: str) -> str:
    """First path component; "" for the root itself."""
    p = path.strip("/")
    return p.split("/", 1)[0] if p else ""


def shard_of(path: str, num_shards: int) -> int:
    return crc32c(shard_key(path).encode()) % num_shards


class ShardWriteError(Exception):
    """A mutation refused by the shard plane; carries the HTTP verdict
    (409 wrong-shard / stale-epoch, 503 contested / no in-sync)."""

    def __init__(self, status: int, doc: dict):
        super().__init__(doc.get("error", "shard write refused"))
        self.status = status
        self.doc = doc


class ShardPlane:
    """Filer-side shard engine: per-shard journals, primary fan-out,
    follower tailers, and the epoch fence.  Disarmed (num_shards == 0,
    the default) every hook is a no-op — a standalone filer behaves
    exactly as before this plane existed."""

    def __init__(self, filer, directory: str, self_url: str,
                 pulse_seconds: float = 5.0):
        self.filer = filer
        self.dir = directory
        self.self_url = self_url
        self.pulse_seconds = pulse_seconds
        self.num_shards = 0
        self.map: dict[int, dict] = {}
        self.map_version = 0
        self._epochs: dict[int, int] = {}   # monotonic fence per shard
        self._insync: dict[int, set] = {}   # primary-side sync set
        self._demoted: set[int] = set()     # fail closed until new map
        self._logs: dict[int, FramedLog] = {}
        self._conds: dict[int, threading.Condition] = {}
        self._locks: dict[int, threading.RLock] = {}
        self._lock = threading.RLock()
        self._tailers: dict[int, threading.Thread] = {}
        self._stop = threading.Event()
        # Primary lease TTL: a primary that cannot reach the master
        # stops acking when this runs out (the partition half of the
        # no-dual-primary guarantee; the epoch fence is the other).
        self._master_ok_until = 0.0
        os.makedirs(directory, exist_ok=True)
        self._load_epochs()

    # -- fence persistence ---------------------------------------------------

    def _epochs_path(self) -> str:
        return os.path.join(self.dir, "shard_epochs.json")

    def _load_epochs(self) -> None:
        try:
            with open(self._epochs_path()) as f:
                self._epochs = {int(k): int(v)
                                for k, v in json.load(f).items()}
        except (OSError, ValueError):
            self._epochs = {}

    def _store_epochs(self) -> None:
        tmp = f"{self._epochs_path()}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in self._epochs.items()},
                          f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._epochs_path())
        except OSError:
            pass

    def _fence(self, shard: int, epoch: int) -> bool:
        """Adopt `epoch` for `shard` if it does not regress; a raise
        is durable before any record at that epoch is accepted."""
        with self._lock:
            cur = self._epochs.get(shard, 0)
            if epoch < cur:
                return False
            if epoch > cur:
                self._epochs[shard] = epoch
                self._store_epochs()
                emit_event("shard.fence", node=self.self_url,
                           shard=shard, epoch=epoch)
            return True

    # -- per-shard plumbing --------------------------------------------------

    def log_for(self, shard: int) -> FramedLog:
        with self._lock:
            log = self._logs.get(shard)
            if log is None:
                log = FramedLog(os.path.join(self.dir,
                                             f"shard_{shard:04d}.mlog"))
                self._logs[shard] = log
            return log

    def _shard_lock(self, shard: int) -> threading.RLock:
        with self._lock:
            return self._locks.setdefault(shard, threading.RLock())

    def _cond(self, shard: int) -> threading.Condition:
        with self._lock:
            return self._conds.setdefault(shard, threading.Condition())

    def note_master_contact(self) -> None:
        self._master_ok_until = time.monotonic() + \
            3 * self.pulse_seconds

    @property
    def armed(self) -> bool:
        return self.num_shards > 0

    def role(self, shard: int) -> str:
        row = self.map.get(shard)
        if row is None:
            return "none"
        if row.get("primary") == self.self_url:
            return "primary"
        if self.self_url in row.get("followers", []):
            return "follower"
        return "none"

    # -- map adoption --------------------------------------------------------

    def arm(self, doc: dict) -> None:
        """Adopt a master-pushed shard map (heartbeat response or a
        direct acquire).  Epochs only move forward; a row whose epoch
        regresses our durable fence is ignored (stale master read)."""
        shards = doc.get("shards") or {}
        version = int(doc.get("version", 0))
        with self._lock:
            if version and version < self.map_version:
                return
            self.map_version = version or self.map_version
            self.num_shards = int(doc.get("num_shards",
                                          len(shards) or 0))
            new_map: dict[int, dict] = {}
            for k, row in shards.items():
                k = int(k)
                if not self._fence(k, int(row.get("epoch", 0))):
                    continue  # stale row: keep the old one
                new_map[k] = {"primary": row.get("primary"),
                              "epoch": int(row.get("epoch", 0)),
                              "followers": list(row.get("followers",
                                                        []))}
            for k, row in new_map.items():
                prev = self.map.get(k)
                self.map[k] = row
                if row["primary"] == self.self_url:
                    self._demoted.discard(k)
                    if prev is None or prev.get("primary") != \
                            self.self_url or \
                            prev.get("epoch") != row["epoch"]:
                        self._insync[k] = set(row["followers"])
                        self._replay_unapplied(k)
                else:
                    self._insync.pop(k, None)
                    self._demoted.discard(k)
                    if self.self_url in row["followers"]:
                        self._ensure_tailer(k)

    def _replay_unapplied(self, shard: int) -> None:
        """WAL self-heal at (re)acquire: records framed before a crash
        but never applied (watermark behind the log) replay into the
        store — idempotent, at-least-once."""
        log = self.log_for(shard)
        start = log.watermark.value + 1
        if start > log.last_seq:
            return
        for seq, _epoch, rec in log.read_from(start):
            self._apply_to_store(rec)
            log.watermark.set(seq)

    # -- the write path (primary) --------------------------------------------

    def gate(self, path: str) -> tuple[int, dict] | None:
        """Pre-mutation admission check for a write at `path`: None to
        admit, else the (status, body) to refuse with.  409 carries the
        primary hint so shard-map-aware clients re-fetch and retry."""
        if not self.armed:
            return None
        shard = shard_of(path, self.num_shards)
        return self._check_primary(shard)

    def gate_rename(self, src: str, dst: str) -> tuple[int, dict] | None:
        if not self.armed:
            return None
        s1 = shard_of(src, self.num_shards)
        s2 = shard_of(dst, self.num_shards)
        if s1 != s2:
            return (400, {"error": "cross-shard rename",
                          "src_shard": s1, "dst_shard": s2})
        return self._check_primary(s1)

    def _check_primary(self, shard: int) -> tuple[int, dict] | None:
        row = self.map.get(shard)
        if row is None or not row.get("primary"):
            return (503, {"error": f"shard {shard} has no primary",
                          "shard": shard})
        if shard in self._demoted:
            return (503, {"error": f"shard {shard} is moving",
                          "shard": shard})
        if row["primary"] != self.self_url:
            return (409, {"error": "wrong shard",
                          "shard": shard, "primary": row["primary"],
                          "epoch": row["epoch"]})
        if time.monotonic() > self._master_ok_until:
            # Lease TTL expired: we may have been failed over behind
            # a partition.  Fail closed — never ack in the dark.
            return (503, {"error": f"shard {shard} lease stale "
                                   "(no master contact)",
                          "shard": shard})
        return None

    def on_op(self, op: dict, path: str) -> None:
        """The Filer's shard_sink: journal + replicate one committed
        logical op.  Raises ShardWriteError when the op cannot be
        acked (the HTTP layer turns that into the 409/503 verdict)."""
        if not self.armed:
            return
        shard = shard_of(path, self.num_shards)
        with self._shard_lock(shard):
            verdict = self._check_primary(shard)
            if verdict is not None:
                raise ShardWriteError(*verdict)
            row = self.map[shard]
            epoch = row["epoch"]
            log = self.log_for(shard)
            seq = log.append(epoch, op)
            log.sync()  # durable locally before any ack
            log.watermark.set(seq)  # primary applied it pre-journal
            _metrics.filer_shard_journal_records_total.inc(
                shard=str(shard))
            # Followers = the map row's list UNION whoever reinsync'd
            # in: a freshly-joined follower reaches the primary (its
            # tailer offers in) BEFORE the next heartbeat delivers the
            # updated row — acking primary-only through that window
            # would let a later promotion of that follower lose acked
            # ops.
            followers = sorted(
                (set(row.get("followers", [])) |
                 self._insync.get(shard, set())) - {self.self_url})
            acked = self._fan_out(shard, epoch, seq, op, followers)
            if followers and not acked:
                raise ShardWriteError(
                    503, {"error": f"shard {shard}: no in-sync "
                                   "follower acked", "shard": shard})
        cond = self._cond(shard)
        with cond:
            cond.notify_all()

    def _fan_out(self, shard: int, epoch: int, seq: int, op: dict,
                 followers: list) -> int:
        """Semi-sync push: returns how many followers persisted the
        record.  A failed push demotes the follower to catch-up (its
        tailer re-levels it); a fenced push (409) means WE are stale —
        surface that as a refusal, not an ack."""
        insync = self._insync.setdefault(shard, set(followers))
        acked = 0
        payload = {"shard": shard, "epoch": epoch, "seq": seq,
                   "record": op, "primary": self.self_url}
        for f in sorted(insync & set(followers)):
            try:
                if _fault.ARMED:
                    _fault.hit("wan.partition", peer=f, shard=shard)
                rpc.call_json(f + "/.meta/shard/apply",
                              payload=payload, timeout=10.0)
                acked += 1
            except rpc.RpcError as e:
                if e.status == 409:
                    # The follower fenced us: a newer epoch exists.
                    insync.discard(f)
                    _metrics.filer_shard_fences_total.inc(
                        shard=str(shard))
                    raise ShardWriteError(
                        409, {"error": "fenced by follower",
                              "shard": shard, "epoch": epoch})
                insync.discard(f)
            except Exception:  # noqa: BLE001 — dead follower
                insync.discard(f)
        return acked

    # -- the apply path (follower) -------------------------------------------

    def apply_record(self, shard: int, epoch: int, seq: int,
                     rec: dict) -> tuple[int, dict]:
        """Persist + apply one replicated record.  Idempotent by
        (shard, epoch, seq): the applied watermark no-ops replays, the
        epoch fence 409s stale primaries, and a seq gap is refused so
        in-order re-delivery (the tailer) converges with nothing
        skipped."""
        with self._shard_lock(shard):
            if not self._fence(shard, epoch):
                _metrics.filer_shard_fences_total.inc(shard=str(shard))
                return (409, {"error": "stale epoch",
                              "shard": shard, "epoch": epoch,
                              "current": self._epochs.get(shard, 0)})
            log = self.log_for(shard)
            if seq <= log.watermark.value:
                _metrics.filer_shard_apply_total.inc(
                    shard=str(shard), result="duplicate")
                return (200, {"applied": False, "dup": True,
                              "seq": seq})
            if seq > log.last_seq + 1:
                # A gap would silently skip history on a fresh or
                # lagging follower — refuse it unacked; the tailer
                # re-delivers in order from the applied watermark.
                return (409, {"error": "seq gap", "shard": shard,
                              "have": log.last_seq, "got": seq})
            if seq == log.last_seq + 1:
                log.append(epoch, rec, seq=seq)
                log.sync()  # durable before the ack back to primary
            self._apply_to_store(rec)
            log.watermark.set(seq)
            _metrics.filer_shard_apply_total.inc(
                shard=str(shard), result="applied")
        cond = self._cond(shard)
        with cond:
            cond.notify_all()
        return (200, {"applied": True, "seq": seq})

    def _apply_to_store(self, rec: dict) -> None:
        """Replay one logical op through the local Filer.  High-level
        methods keep the replay deterministic (parents materialize,
        subtrees move) and feed local subscribers; the applying flag
        suppresses re-journaling and chunk GC (the primary already
        queued the blob deletes — a second queueing would double-free)."""
        from .entry import Entry
        from .filer import FilerError
        from .filerstore import NotFound
        f = self.filer
        f._applying_remote.flag = True
        try:
            # Local events emitted by the replay carry the origin
            # signature chain — the active-active sync loop-breaker
            # keeps working across the shard hop.
            with f.with_signatures(rec.get("sigs", [])):
                op = rec.get("op")
                if op == "set":
                    f.create_entry(Entry.from_dict(rec["entry"]),
                                   o_excl=False)
                elif op == "del":
                    try:
                        f.delete_entry(rec["path"], recursive=True,
                                       delete_chunks=False)
                    except (FilerError, NotFound):
                        pass  # replayed delete: already gone
                elif op == "ren":
                    try:
                        f.rename(rec["src"], rec["dst"])
                    except (FilerError, NotFound):
                        pass  # replayed rename: src already moved
                elif op == "kv":
                    if rec.get("val") is None:
                        f.store.kv_delete(rec["key"])
                    else:
                        f.store.kv_put(rec["key"],
                                       base64.b64decode(rec["val"]))
        except Exception as e:  # noqa: BLE001 — one bad record must
            glog.warningf("shard apply failed: %s (%s)",
                          e, rec.get("op"))  # not wedge the chain
        finally:
            f._applying_remote.flag = False

    # -- demote / acquire (move + failover RPCs) -----------------------------

    def demote(self, shard: int, epoch: int) -> tuple[int, dict]:
        """Demote-first half of a move: stop acking NOW, before the
        new primary exists anywhere (lease.py begin_move semantics —
        mid-move the shard is contested and fails closed)."""
        with self._shard_lock(shard):
            if epoch < self._epochs.get(shard, 0):
                return (409, {"error": "stale epoch",
                              "current": self._epochs.get(shard, 0)})
            self._demoted.add(shard)
            self._insync.pop(shard, None)
            log = self.log_for(shard)
            return (200, {"demoted": True, "shard": shard,
                          "last_seq": log.last_seq})

    def acquire(self, shard: int, epoch: int, followers: list,
                version: int = 0) -> tuple[int, dict]:
        """Become primary for `shard` at `epoch` (master push after a
        promote/move; the next heartbeat map is the backstop)."""
        with self._shard_lock(shard):
            if not self._fence(shard, epoch):
                return (409, {"error": "stale epoch",
                              "current": self._epochs.get(shard, 0)})
            self.map[shard] = {"primary": self.self_url,
                               "epoch": epoch,
                               "followers": list(followers)}
            if version:
                self.map_version = max(self.map_version, version)
            self._demoted.discard(shard)
            self._insync[shard] = set(followers)
            self._replay_unapplied(shard)
            log = self.log_for(shard)
            return (200, {"acquired": True, "shard": shard,
                          "epoch": epoch, "last_seq": log.last_seq})

    # -- follower tailers (catch-up + rejoin repair) -------------------------

    def _ensure_tailer(self, shard: int) -> None:
        t = self._tailers.get(shard)
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=self._tail_shard, args=(shard,),
                             daemon=True,
                             name=f"shard-tail:{shard}")
        self._tailers[shard] = t
        t.start()

    def _tail_shard(self, shard: int) -> None:
        # Two cadences: FAST while catching up or unsettled (the
        # tailer is the recovery path — reinsync latency bounds how
        # long a primary can be left with no ackable follower), IDLE
        # once level (semi-sync pushes feed an in-sync follower; the
        # poll is then only a liveness re-offer, and N shards x N
        # followers of 20Hz status chatter would starve the very
        # primaries the bench prices).
        fast = max(0.05, min(0.25, self.pulse_seconds / 20))
        idle = max(fast, min(2.0, self.pulse_seconds))
        while not self._stop.is_set():
            row = self.map.get(shard)
            if row is None or self.role(shard) != "follower" or \
                    not row.get("primary"):
                if self.role(shard) == "primary":
                    return  # promoted: the tailer's job is done
                self._stop.wait(fast)
                continue
            primary = row["primary"]
            try:
                level = self._tail_once(shard, primary)
            except Exception:  # noqa: BLE001 — primary down/moving:
                self._stop.wait(fast)  # re-resolve and retry
                continue
            self._stop.wait(idle if level else fast)

    def _tail_once(self, shard: int, primary: str) -> bool:
        """One catch-up round; returns True when level with the
        primary (caller may relax to the idle cadence)."""
        log = self.log_for(shard)
        st = rpc.call(
            f"{primary}/.meta/shard/status?shard={shard}",
            timeout=5.0)
        if log.last_seq > int(st.get("last_seq", 0)):
            self._repair_divergence(shard, int(st.get("last_seq", 0)))
        applied = log.watermark.value
        if applied >= int(st.get("last_seq", 0)):
            # Level with the primary: offer to rejoin the sync set.
            try:
                rpc.call_json(primary + "/.meta/shard/insync",
                              payload={"shard": shard,
                                       "follower": self.self_url,
                                       "seq": applied}, timeout=5.0)
            except Exception:  # noqa: BLE001 — next round retries
                pass
            return True
        recs = rpc.call(
            f"{primary}/.meta/shard/tail?shard={shard}"
            f"&since_seq={applied}&limit=500", timeout=10.0)
        for seq, epoch, rec in recs.get("records", []):
            self.apply_record(shard, int(epoch), int(seq), rec)
        return False

    def _repair_divergence(self, shard: int, primary_last: int) -> None:
        """Our journal runs past the promoted primary's: those records
        were framed here but never replicated, so (by the semi-sync ack
        rule) never acked — unwind them, newest first, and fall back in
        line behind the new history."""
        log = self.log_for(shard)
        dropped = log.truncate_from(primary_last + 1)
        f = self.filer
        from .entry import Entry
        from .filerstore import NotFound
        f._applying_remote.flag = True
        try:
            for _seq, _epoch, rec in dropped:  # newest first
                try:
                    op = rec.get("op")
                    if op == "set":
                        if rec.get("old"):
                            f.store.insert_entry(
                                Entry.from_dict(rec["old"]))
                        else:
                            try:
                                f.store.delete_entry(
                                    rec["entry"]["path"])
                            except NotFound:
                                pass
                    elif op == "del" and rec.get("entry"):
                        f.store.insert_entry(
                            Entry.from_dict(rec["entry"]))
                    elif op == "ren":
                        try:
                            f.rename(rec["dst"], rec["src"])
                        except Exception:  # noqa: BLE001
                            pass
                except Exception:  # noqa: BLE001 — keep unwinding
                    pass
        finally:
            f._applying_remote.flag = False
        wm = log.watermark
        wm.remove()
        wm.set(primary_last)
        glog.warningf("shard %d: unwound %d divergent records "
                      "(rejoin behind promoted primary)",
                      shard, len(dropped))

    def reinsync(self, shard: int, follower: str,
                 seq: int) -> tuple[int, dict]:
        """A leveled follower asks back into the sync set."""
        with self._shard_lock(shard):
            if self.role(shard) != "primary":
                return (409, {"error": "not primary"})
            log = self.log_for(shard)
            if seq < log.last_seq:
                return (200, {"insync": False, "behind": True,
                              "last_seq": log.last_seq})
            self._insync.setdefault(shard, set()).add(follower)
            return (200, {"insync": True})

    # -- introspection -------------------------------------------------------

    def heartbeat_rows(self) -> dict:
        out = {}
        for k in sorted(set(self.map) | set(self._logs)):
            log = self._logs.get(k)
            out[str(k)] = {
                "role": self.role(k),
                "epoch": self._epochs.get(k, 0),
                "last_seq": log.last_seq if log else 0,
                "applied_seq": log.watermark.value if log else 0,
            }
        return out

    def status(self) -> dict:
        rows = []
        for k in sorted(self.map):
            row = self.map[k]
            log = self._logs.get(k)
            rows.append({
                "shard": k, "role": self.role(k),
                "primary": row.get("primary"),
                "epoch": row.get("epoch", 0),
                "followers": row.get("followers", []),
                "insync": sorted(self._insync.get(k, set())),
                "moving": k in self._demoted,
                "last_seq": log.last_seq if log else 0,
                "applied_seq": log.watermark.value if log else 0,
            })
        return {"armed": self.armed, "num_shards": self.num_shards,
                "map_version": self.map_version,
                "node": self.self_url, "shards": rows}

    def wait_for_seq(self, shard: int, seq: int,
                     timeout: float) -> bool:
        """Block until the shard journal reaches `seq` (tail streams)."""
        cond = self._cond(shard)
        deadline = time.monotonic() + timeout
        with cond:
            while self.log_for(shard).last_seq < seq:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                cond.wait(min(left, 0.5))
        return True

    def stop(self) -> None:
        self._stop.set()
        for t in list(self._tailers.values()):
            t.join(timeout=2.0)
        with self._lock:
            for log in self._logs.values():
                log.close()
            self._logs.clear()
