"""Raft consensus for master HA.

Reference: the master embeds a raft node (weed/server/raft_server.go,
github.com/chrislusf/raft) whose single state-machine command is
MaxVolumeId (weed/topology/cluster_commands.go) — the leader owns volume
id assignment, followers proxy mutating requests to the leader
(master_server.go:155).

This is a from-scratch Raft (election + log replication + persistence +
snapshot/compaction + single-server membership change), not a port:
RPCs ride the same JSON/HTTP plane as the rest of the cluster (mounted
on the master's own server), and the state machine is a callback so the
master wires MaxVolumeId (or anything else) in.

Snapshotting: when the applied log grows past `compact_threshold`
entries, the node asks the state machine for a snapshot (snapshot_fn),
persists it (tmp+fsync+rename next to the log), and truncates the
journal — the log is bounded on a long-lived cluster.  A follower so
far behind that the needed entries were compacted away receives the
snapshot over /raft/install_snapshot (InstallSnapshot, Raft §7).

Membership: one server at a time via add_server()/remove_server()
(Raft thesis §4.1 single-server changes — no joint consensus needed
when changes don't overlap).  The configuration is a log entry applied
on APPEND (latest-config-in-log rule) and included in snapshots.

The port's copy of `seaweedfs_tpu/cluster/raft.py`.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Callable

from . import rpc

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class NotLeader(Exception):
    def __init__(self, leader: str | None):
        super().__init__(f"not the leader (leader={leader})")
        self.leader = leader


class RaftNode:
    """One consensus participant.

    `node_id` / `peers` are base URLs (http://host:port) whose HTTP
    servers route /raft/* to this node via `mount()`.  `apply_fn(cmd)`
    is invoked exactly once per committed entry, in log order, on every
    node.
    """

    def __init__(self, node_id: str, peers: list[str],
                 apply_fn: Callable[[dict], None],
                 state_path: str | None = None,
                 election_timeout: tuple[float, float] = (0.6, 1.2),
                 heartbeat_interval: float = 0.15,
                 snapshot_fn: Callable[[], dict] | None = None,
                 restore_fn: Callable[[dict], None] | None = None,
                 compact_threshold: int = 1000):
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        # The construction-time membership: the config baseline when no
        # snapshot and no raft_config log entry says otherwise.
        self._initial_peers = sorted(set(peers) | {node_id})
        self._config_lock = threading.Lock()
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.compact_threshold = compact_threshold
        self.state_path = state_path
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval

        # Volatile state first — snapshot loading touches it.
        self.state = FOLLOWER
        self.leader_id: str | None = None
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self._wake_events: dict[str, threading.Event] = {}
        # Peers removed from the config but still owed the removal
        # entry: peer -> log index after which replication stops.  A
        # removed server must SEE its removal or it never learns to
        # stop campaigning.
        self._parting: dict[str, int] = {}
        # Membership: a node removed from the configuration stops
        # electing itself (it keeps serving reads/redirects).
        self.in_config = True

        # Persistent state (term, vote, log, snapshot).
        self.current_term = 0
        self.voted_for: str | None = None
        self.log: list[dict] = []  # {"term": int, "cmd": dict}
        # Compaction base: entries 1..log_base live in the snapshot;
        # self.log[0] is entry log_base+1.
        self.log_base = 0
        self.log_base_term = 0
        self._snap_state: dict = {}
        self._snap_peers: list[str] = []
        # Journal lines written since the last rewrite — rewrites are
        # amortized (see _maybe_compact_locked).
        self._journal_lines = 0
        self._load_state()

        # Everything at or below log_base lives in the snapshot and is
        # committed+applied by definition.
        self.commit_index = self.log_base
        self.last_applied = self.log_base

        self._lock = threading.RLock()
        self._commit_cv = threading.Condition(self._lock)
        # Serializes state-machine mutations (apply_fn batches vs
        # restore_fn on InstallSnapshot).  Without it a snapshot can be
        # restored between an apply batch's last_applied bump and the
        # apply_fn calls, and the stale commands then land ON TOP of
        # the newer snapshot state.  Ordering: _sm_lock before _lock,
        # never the reverse.
        self._sm_lock = threading.Lock()
        self._last_heartbeat = time.monotonic()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # Outbound RPC transport — injectable so fault-injection tests
        # can partition nodes (raise on blocked links) without touching
        # the network stack.  Production uses the pooled JSON client.
        self.transport: Callable = rpc.call_json

    # -- persistence ---------------------------------------------------------
    # Meta (term/vote) is a tiny JSON rewritten on change; the log is an
    # append-only JSONL journal — appending an entry is O(1), not a
    # rewrite of history.  Conflict truncation (rare) rewrites the
    # journal.

    def _log_path(self) -> str | None:
        return self.state_path + ".log" if self.state_path else None

    def _snap_path(self) -> str | None:
        return self.state_path + ".snap" if self.state_path else None

    @staticmethod
    def _fsync_dir(path: str) -> None:
        """fsync the parent directory so a rename/create survives power
        loss — without this the fsynced file's directory entry may
        still be lost, forgetting a granted vote."""
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _load_state(self) -> None:
        if not self.state_path:
            return
        embedded = False
        try:
            with open(self.state_path) as f:
                d = json.load(f)
            self.current_term = d.get("term", 0)
            self.voted_for = d.get("voted_for")
            # Migration: early versions embedded the log in the meta file.
            self.log = d.get("log", [])
            embedded = bool(self.log)
        except (OSError, json.JSONDecodeError):
            pass
        try:
            with open(self._snap_path()) as f:
                snap = json.load(f)
            self._install_snapshot_locked(snap, persist=False)
        except (OSError, json.JSONDecodeError):
            pass
        try:
            with open(self._log_path()) as f:
                for line in f:
                    if not line.strip():
                        continue
                    e = json.loads(line)
                    # Journal entries carry their global index so a
                    # crash between snapshot write and journal rewrite
                    # cannot graft stale pre-compaction entries after
                    # the new log_base (Log Matching would break).
                    i = e.pop("i", None)
                    if i is None:  # legacy journal: sequential from 1
                        i = self.log_base + len(self.log) + 1
                    if i <= self.log_base:
                        continue  # already inside the snapshot
                    if i != self.log_base + len(self.log) + 1:
                        break  # gap/stale tail: discard the rest
                    self.log.append(e)
                    self._maybe_apply_config(e)
        except (OSError, json.JSONDecodeError):
            pass
        if embedded:  # move embedded entries into the journal once
            self._rewrite_log()
            self._save_meta()

    def _save_meta(self) -> None:
        if not self.state_path:
            return
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": self.current_term,
                       "voted_for": self.voted_for}, f)
            f.flush()
            os.fsync(f.fileno())  # a granted vote must survive power loss
        os.replace(tmp, self.state_path)
        self._fsync_dir(self.state_path)

    def _append_log(self, entries: list[dict],
                    first_index: int) -> None:
        """Journal a suffix; each line records its global index."""
        path = self._log_path()
        if not path or not entries:
            return
        created = not os.path.exists(path)
        with open(path, "a") as f:
            for off, e in enumerate(entries):
                rec = dict(e, i=first_index + off)
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            # An acked log suffix is a durability promise to the leader.
            os.fsync(f.fileno())
        self._journal_lines += len(entries)
        if created:
            self._fsync_dir(path)

    def _rewrite_log(self) -> None:
        path = self._log_path()
        if not path:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for off, e in enumerate(self.log):
                rec = dict(e, i=self.log_base + 1 + off)
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._fsync_dir(path)
        self._journal_lines = len(self.log)

    def _save_state(self) -> None:  # kept for vote/term call sites
        self._save_meta()

    # -- snapshot / compaction (Raft §7) -------------------------------------

    def _write_snapshot_file(self, snap: dict) -> None:
        path = self._snap_path()
        if not path:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._fsync_dir(path)

    def _current_snapshot(self) -> dict:
        return {"last_index": self.log_base,
                "last_term": self.log_base_term,
                "state": self._snap_state,
                "peers": list(self._snap_peers
                              or self._initial_peers)}

    def _install_snapshot_locked(self, snap: dict,
                                 persist: bool = True) -> None:
        """Replace log prefix (or everything) with a snapshot."""
        self.log_base = snap["last_index"]
        self.log_base_term = snap.get("last_term", 0)
        self._snap_state = snap.get("state", {})
        self._snap_peers = list(snap.get("peers", []))
        if self.restore_fn is not None:
            try:
                self.restore_fn(self._snap_state)
            except Exception:  # noqa: BLE001 — state machine bug must
                pass           # not kill consensus
        if snap.get("peers"):
            self._set_peers(snap["peers"])
        self.log = []
        if persist:
            self._write_snapshot_file(snap)
            self._rewrite_log()

    def _maybe_compact_locked(self) -> None:
        """Snapshot + truncate once the applied portion of the log
        exceeds the threshold — bounds the journal on long-lived
        clusters."""
        if self.last_applied - self.log_base < self.compact_threshold:
            return
        state = self.snapshot_fn() if self.snapshot_fn else {}
        last = self.last_applied
        last_term = self._term_at(last)
        # The snapshot's membership is the config AS OF its last
        # entry — an uncommitted config later in the log must not be
        # baked into the baseline (conflict truncation could revert it).
        self._snap_peers = self._config_at(last)
        del self.log[: last - self.log_base]
        self.log_base = last
        self.log_base_term = last_term
        self._snap_state = state
        self._write_snapshot_file(self._current_snapshot())
        # The journal rewrite is AMORTIZED: every line carries its
        # global index, so the loader already skips entries at or below
        # log_base — correctness never needs the rewrite, only disk
        # bounding does.  Rewriting on every compaction would hold the
        # raft lock across a multi-fsync pass and (on a slow disk)
        # starve heartbeats into spurious elections.
        if self._journal_lines > 4 * self.compact_threshold:
            self._rewrite_log()

    # -- membership (thesis §4.1 single-server changes) ----------------------

    def _set_peers(self, peer_ids: list[str]) -> None:
        new = [p for p in peer_ids if p != self.id]
        self.in_config = self.id in peer_ids
        added = [p for p in new if p not in self.peers]
        removed = [p for p in self.peers if p not in new]
        self.peers = new
        for p in removed:
            if self.state == LEADER and p in self.match_index:
                # Keep replicating until the peer HAS its removal entry
                # (it must learn to stop campaigning), then its loop
                # tears the structures down.
                self._parting[p] = self._last_log_index()
                ev = self._wake_events.get(p)
                if ev is not None:
                    ev.set()
            else:
                self.next_index.pop(p, None)
                self.match_index.pop(p, None)
                ev = self._wake_events.pop(p, None)
                if ev is not None:
                    ev.set()  # its loop exits on the config check
        if self.state == LEADER:
            nxt = self._last_log_index() + 1
            for p in added:
                self._parting.pop(p, None)  # re-added mid-parting
                if p in self.match_index:
                    continue  # replicator already alive
                self.next_index.setdefault(p, nxt)
                self.match_index.setdefault(p, 0)
                self._wake_events[p] = threading.Event()
                threading.Thread(
                    target=self._peer_loop, args=(p, self.current_term),
                    daemon=True, name=f"raft-repl-{p}").start()

    def _maybe_apply_config(self, entry: dict) -> None:
        """Configuration entries take effect as soon as they are in the
        log (latest-config-in-log rule), commit or not."""
        cmd = entry.get("cmd", {})
        if cmd.get("op") == "raft_config":
            self._set_peers(cmd["peers"])

    def _config_at(self, index: int) -> list[str]:
        """Membership as of a log index: the persisted snapshot
        baseline plus every config entry at or below `index`."""
        peers = list(self._snap_peers or self._initial_peers)
        for off, e in enumerate(self.log):
            if self.log_base + 1 + off > index:
                break
            if e.get("cmd", {}).get("op") == "raft_config":
                peers = e["cmd"]["peers"]
        return peers

    def _recompute_config(self) -> None:
        """After a conflict truncation, the live config is the latest
        one still in snapshot+log — NOT the possibly-truncated config
        this node had applied."""
        self._set_peers(self._config_at(self._last_log_index()))

    def _config_change(self, peers: list[str], timeout: float) -> None:
        # _config_lock serializes concurrent add/remove end to end:
        # without it two changes could both pass the in-flight scan and
        # the later one would silently erase the earlier (the
        # single-server-change safety argument needs them ordered).
        with self._config_lock:
            with self._lock:
                if self.state != LEADER:
                    raise NotLeader(self.leader_id)
                for i in range(self.commit_index + 1,
                               self._last_log_index() + 1):
                    if self.log[i - self.log_base - 1]["cmd"].get("op") \
                            == "raft_config":
                        raise RuntimeError(
                            "a membership change is already in flight")
            self.propose({"op": "raft_config",
                          "peers": sorted(set(peers))},
                         timeout=timeout)

    def add_server(self, peer: str, timeout: float = 10.0) -> None:
        """Grow the cluster by one voter (leader only)."""
        with self._lock:
            members = set(self.peers) | {self.id, peer}
        self._config_change(sorted(members), timeout)

    def remove_server(self, peer: str, timeout: float = 10.0) -> None:
        """Shrink the cluster by one voter (leader only; a leader does
        not remove itself — transfer leadership first)."""
        if peer == self.id:
            raise ValueError("leader cannot remove itself; demote a "
                             "follower or stop this node instead")
        with self._lock:
            members = (set(self.peers) | {self.id}) - {peer}
        self._config_change(sorted(members), timeout)

    # -- lifecycle -----------------------------------------------------------

    def mount(self, server: rpc.JsonHttpServer) -> None:
        server.route("POST", "/raft/request_vote", self._h_request_vote)
        server.route("POST", "/raft/append_entries",
                     self._h_append_entries)
        server.route("POST", "/raft/install_snapshot",
                     self._h_install_snapshot)
        server.route("GET", "/raft/status", self._h_status)

    def start(self) -> None:
        for target, name in ((self._election_loop, "raft-election"),
                             (self._apply_loop, "raft-apply")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        with self._commit_cv:
            self._commit_cv.notify_all()
        for t in self._threads:
            t.join(timeout=2)

    # -- log helpers (1-based global indices; log_base = snapshot) -----------

    def _last_log_index(self) -> int:
        return self.log_base + len(self.log)

    def _term_at(self, index: int) -> int:
        if index == self.log_base:
            return self.log_base_term
        i = index - self.log_base
        return self.log[i - 1]["term"] if 1 <= i <= len(self.log) else 0

    # -- RPC handlers --------------------------------------------------------

    def _h_request_vote(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        with self._lock:
            if req["term"] > self.current_term:
                self._become_follower(req["term"], None)
            granted = False
            if req["term"] == self.current_term and \
                    self.voted_for in (None, req["candidate_id"]):
                # §5.4.1: candidate's log must be at least as up-to-date.
                my_last_term = self._term_at(self._last_log_index())
                up_to_date = (
                    req["last_log_term"] > my_last_term
                    or (req["last_log_term"] == my_last_term
                        and req["last_log_index"] >=
                        self._last_log_index()))
                if up_to_date:
                    granted = True
                    self.voted_for = req["candidate_id"]
                    self._last_heartbeat = time.monotonic()
                    self._save_state()
            return {"term": self.current_term, "vote_granted": granted}

    def _h_append_entries(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        with self._lock:
            if req["term"] > self.current_term or \
                    (req["term"] == self.current_term
                     and self.state != FOLLOWER):
                self._become_follower(req["term"], req["leader_id"])
            if req["term"] < self.current_term:
                return {"term": self.current_term, "success": False}
            self.leader_id = req["leader_id"]
            self._last_heartbeat = time.monotonic()
            prev_idx = req["prev_log_index"]
            prev_term = req["prev_log_term"]
            entries = req.get("entries", [])
            if prev_idx < self.log_base:
                # Everything at or below log_base is snapshotted and
                # committed; skip the already-incorporated prefix.  The
                # effective prev entry is the batch's own entry at
                # log_base — comparing the ORIGINAL prev term against
                # the snapshot term would spuriously reject forever.
                skip = self.log_base - prev_idx
                if skip >= len(entries):
                    return {"term": self.current_term, "success": True,
                            "match_index": max(prev_idx + len(entries),
                                               self.log_base)}
                entries = entries[skip:]
                prev_idx = self.log_base
                # A committed prefix matches the snapshot by Log
                # Matching; trust it rather than the leader's term
                # for an entry we compacted away.
                prev_term = self.log_base_term
            if prev_idx > self._last_log_index() or \
                    self._term_at(prev_idx) != prev_term:
                return {"term": self.current_term, "success": False,
                        "hint_index": min(prev_idx,
                                          self._last_log_index())}
            # Append/overwrite conflicting suffix.
            idx = prev_idx
            truncated = False
            appended: list[dict] = []
            appended_at = 0
            for e in entries:
                idx += 1
                if idx <= self._last_log_index():
                    if self._term_at(idx) != e["term"]:
                        del self.log[idx - self.log_base - 1:]
                        truncated = True
                        self.log.append(e)
                        if not appended:
                            appended_at = idx
                        appended.append(e)
                else:
                    self.log.append(e)
                    if not appended:
                        appended_at = idx
                    appended.append(e)
            if truncated:
                self._rewrite_log()
                self._recompute_config()
            elif appended:
                self._append_log(appended, appended_at)
            for e in appended:
                self._maybe_apply_config(e)
            if req["leader_commit"] > self.commit_index:
                self.commit_index = min(req["leader_commit"],
                                        self._last_log_index())
                self._commit_cv.notify_all()
            return {"term": self.current_term, "success": True,
                    "match_index": req["prev_log_index"]
                    + len(req.get("entries", []))}

    def _h_install_snapshot(self, query: dict, body: bytes) -> dict:
        """InstallSnapshot (Raft §7): the leader ships its snapshot to
        a follower whose needed entries were compacted away."""
        req = json.loads(body)
        # _sm_lock first (same order as the apply loop): restore_fn
        # must not run while an apply batch is mid-flight, or stale
        # pre-snapshot commands would mutate the restored state.
        with self._sm_lock, self._lock:
            if req["term"] < self.current_term:
                return {"term": self.current_term, "success": False}
            if req["term"] > self.current_term or self.state != FOLLOWER:
                self._become_follower(req["term"], req["leader_id"])
            self.leader_id = req["leader_id"]
            self._last_heartbeat = time.monotonic()
            snap = req["snapshot"]
            if snap["last_index"] > max(self.log_base,
                                        self.last_applied,
                                        self.commit_index):
                self._install_snapshot_locked(snap)
                self.commit_index = snap["last_index"]
                self.last_applied = snap["last_index"]
                self._commit_cv.notify_all()
            # An older snapshot than our applied state would REWIND the
            # state machine while last_applied stayed high (the gap
            # would never re-apply): refuse it but report our matching
            # prefix so the leader resumes AppendEntries from there.
            return {"term": self.current_term, "success": True,
                    "match_index": self.log_base}

    def _h_status(self, query: dict, body: bytes) -> dict:
        with self._lock:
            return {"id": self.id, "state": self.state,
                    "term": self.current_term, "leader": self.leader_id,
                    "commit_index": self.commit_index,
                    "log_base": self.log_base,
                    "log_length": len(self.log),
                    "peers": sorted(self.peers),
                    "in_config": self.in_config}

    # -- state transitions ---------------------------------------------------

    def _become_follower(self, term: int, leader: str | None) -> None:
        # Election safety: a vote binds to a term — only forget it when
        # the term actually advances.  The same-term step-down path
        # (leader discovery) must keep voted_for or a node could grant
        # two votes in one term (two leaders possible).
        was_leader = self.state == LEADER
        if term > self.current_term:
            self.voted_for = None
        self.current_term = term
        self.state = FOLLOWER
        if leader is not None:
            self.leader_id = leader
        self._save_state()
        if was_leader:
            from ..events import emit as emit_event
            from ..trace import root_span
            with root_span("raft.stepdown", "master", node=self.id):
                emit_event("leader.stepdown", node=self.id,
                           severity="warn", term=term,
                           new_leader=leader or "")

    def _become_leader(self) -> None:
        self.state = LEADER
        self.leader_id = self.id
        from ..events import emit as emit_event
        from ..trace import root_span
        with root_span("raft.elect", "master", node=self.id):
            emit_event("leader.elect", node=self.id,
                       term=self.current_term,
                       peers=sorted(self.peers))
        # Barrier no-op (§8): entries inherited from prior terms can't
        # be count-committed; committing a current-term entry commits
        # them transitively, so the new leader's state machine catches
        # up before it serves any read-modify-write (id issuance).
        entry = {"term": self.current_term, "cmd": {"op": "noop"}}
        self.log.append(entry)
        self._append_log([entry], self._last_log_index())
        nxt = self._last_log_index() + 1
        self.next_index = {p: nxt for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        if not self.peers:
            self.commit_index = self._last_log_index()
            self._commit_cv.notify_all()
        # One long-lived replicator per peer for this term; each paces
        # itself at heartbeat_interval and is woken early by propose().
        term = self.current_term
        self._wake_events = {p: threading.Event() for p in self.peers}
        for peer in self.peers:
            threading.Thread(target=self._peer_loop, args=(peer, term),
                             daemon=True,
                             name=f"raft-repl-{peer}").start()

    def barrier(self, timeout: float = 5.0) -> None:
        """Wait until this node has applied every entry currently in its
        log — the leader's read-your-own-writes fence."""
        with self._lock:
            target = self._last_log_index()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self.last_applied >= target:
                    return
                if self.state != LEADER:
                    raise NotLeader(self.leader_id)
            time.sleep(0.01)
        raise TimeoutError(f"barrier at index {target} not reached")

    # -- election ------------------------------------------------------------

    def _election_loop(self) -> None:
        while not self._stop.is_set():
            timeout = random.uniform(*self.election_timeout)
            self._stop.wait(self.heartbeat_interval / 2)
            with self._lock:
                if self.state == LEADER or not self.in_config:
                    continue  # removed nodes never campaign
                elapsed = time.monotonic() - self._last_heartbeat
                if elapsed < timeout:
                    continue
                # Start an election.
                self.state = CANDIDATE
                self.current_term += 1
                self.voted_for = self.id
                self._save_state()
                term = self.current_term
                last_idx = self._last_log_index()
                last_term = self._term_at(last_idx)
                self._last_heartbeat = time.monotonic()
            if not self.peers:  # single-node cluster
                with self._lock:
                    if self.state == CANDIDATE and \
                            self.current_term == term:
                        self._become_leader()
                continue
            votes = [1]  # self-vote
            votes_lock = threading.Lock()

            def ask(peer: str) -> None:
                try:
                    out = self.transport(
                        peer + "/raft/request_vote",
                        payload={"term": term, "candidate_id": self.id,
                                 "last_log_index": last_idx,
                                 "last_log_term": last_term},
                        timeout=0.5)
                except Exception:  # noqa: BLE001 — unreachable peer
                    return
                with self._lock:
                    if out["term"] > self.current_term:
                        self._become_follower(out["term"], None)
                        return
                if out.get("vote_granted"):
                    with votes_lock:
                        votes[0] += 1

            threads = [threading.Thread(target=ask, args=(p,),
                                        daemon=True) for p in self.peers]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=0.6)
            with self._lock:
                if self.state == CANDIDATE and \
                        self.current_term == term and \
                        votes[0] * 2 > len(self.peers) + 1:
                    self._become_leader()

    # -- leader replication --------------------------------------------------

    def _peer_loop(self, peer: str, term: int) -> None:
        """Replicate to one peer until this term's leadership ends: one
        in-flight AppendEntries at a time, paced at heartbeat_interval,
        woken early when propose() appends."""
        ev = self._wake_events.get(peer)
        while not self._stop.is_set():
            with self._lock:
                if self.state != LEADER or self.current_term != term:
                    return
                if peer not in self.match_index:
                    return  # removed from the configuration
                part = self._parting.get(peer)
                if part is not None and \
                        self.match_index.get(peer, 0) >= part:
                    # The removed peer has its removal entry: done.
                    self._parting.pop(peer, None)
                    self.next_index.pop(peer, None)
                    self.match_index.pop(peer, None)
                    self._wake_events.pop(peer, None)
                    return
            self._replicate_to(peer, term)
            if ev is not None:
                ev.wait(self.heartbeat_interval)
                ev.clear()
            else:
                self._stop.wait(self.heartbeat_interval)

    def _replicate_to(self, peer: str, term: int) -> None:
        with self._lock:
            if self.state != LEADER or self.current_term != term:
                return
            if peer not in self.match_index:
                return  # removed from the configuration
            nxt = self.next_index.get(peer, self._last_log_index() + 1)
            if nxt <= self.log_base:
                # The entries this follower needs were compacted away:
                # ship the snapshot instead (InstallSnapshot, §7).
                snap = self._current_snapshot()
            else:
                snap = None
                prev_idx = nxt - 1
                prev_term = self._term_at(prev_idx)
                entries = self.log[nxt - self.log_base - 1:]
                commit = self.commit_index
        if snap is not None:
            try:
                out = self.transport(
                    peer + "/raft/install_snapshot",
                    payload={"term": term, "leader_id": self.id,
                             "snapshot": snap},
                    timeout=2.0)
            except Exception:  # noqa: BLE001 — retried next beat
                return
            with self._lock:
                if out["term"] > self.current_term:
                    self._become_follower(out["term"], None)
                    return
                if self.state != LEADER or self.current_term != term:
                    return
                if out.get("success"):
                    self.match_index[peer] = out.get("match_index",
                                                     snap["last_index"])
                    self.next_index[peer] = self.match_index[peer] + 1
            return
        try:
            out = self.transport(
                peer + "/raft/append_entries",
                payload={"term": term, "leader_id": self.id,
                         "prev_log_index": prev_idx,
                         "prev_log_term": prev_term,
                         "entries": entries, "leader_commit": commit},
                timeout=0.5)
        except Exception:  # noqa: BLE001 — peer down; retried next beat
            return
        with self._lock:
            if out["term"] > self.current_term:
                self._become_follower(out["term"], None)
                return
            if self.state != LEADER or self.current_term != term:
                return
            if out.get("success"):
                self.match_index[peer] = out.get("match_index", prev_idx)
                self.next_index[peer] = self.match_index[peer] + 1
            else:
                # Back off (use follower's hint when present).
                self.next_index[peer] = max(
                    1, out.get("hint_index", nxt - 1))
        self._maybe_advance_commit()

    def _maybe_advance_commit(self) -> None:
        with self._lock:
            if self.state != LEADER:
                return
            for n in range(self._last_log_index(), self.commit_index, -1):
                # §5.4.2: only commit entries from the current term by
                # counting; older ones commit transitively.
                if self._term_at(n) != self.current_term:
                    break
                replicas = 1 + sum(
                    1 for p in self.peers if self.match_index.get(p, 0)
                    >= n)
                if replicas * 2 > len(self.peers) + 1:
                    self.commit_index = n
                    self._commit_cv.notify_all()
                    break

    # -- apply ---------------------------------------------------------------

    def _apply_loop(self) -> None:
        while not self._stop.is_set():
            with self._commit_cv:
                while self.last_applied >= self.commit_index and \
                        not self._stop.is_set():
                    self._commit_cv.wait(timeout=0.5)
                if self._stop.is_set():
                    return
                start = self.last_applied + 1
                end = self.commit_index
                entries = self.log[start - self.log_base - 1:
                                   end - self.log_base]
            applied = False
            with self._sm_lock:
                with self._lock:
                    # Re-check under the mutation lock: an
                    # InstallSnapshot may have restored a newer state
                    # while we were between locks — our batch is then
                    # stale and must be dropped, not applied on top.
                    if self.last_applied == start - 1:
                        self.last_applied = end
                        applied = True
                if applied:
                    for e in entries:
                        if e["cmd"].get("op") in ("noop", "raft_config"):
                            continue  # consensus bookkeeping only
                        try:
                            self.apply_fn(e["cmd"])
                        except Exception:  # noqa: BLE001 — state
                            pass           # machine bug must not kill
                            #                consensus
            with self._lock:
                try:
                    self._maybe_compact_locked()
                except Exception:  # noqa: BLE001 — a failed snapshot
                    pass           # write must not kill consensus

    # -- client API ----------------------------------------------------------

    def is_leader(self) -> bool:
        with self._lock:
            return self.state == LEADER

    def leader(self) -> str | None:
        with self._lock:
            return self.leader_id

    def propose(self, cmd: dict, timeout: float = 5.0) -> int:
        """Append a command, wait for commit; returns its log index.
        Raises NotLeader on followers (caller proxies to .leader())."""
        with self._lock:
            if self.state != LEADER:
                raise NotLeader(self.leader_id)
            entry = {"term": self.current_term, "cmd": cmd}
            self.log.append(entry)
            index = self._last_log_index()
            self._append_log([entry], index)
            self._maybe_apply_config(entry)
        if not self.peers:
            with self._lock:
                self.commit_index = max(self.commit_index, index)
                self._commit_cv.notify_all()
        else:
            with self._lock:  # the dict mutates during membership
                events = list(self._wake_events.values())
            for ev in events:
                ev.set()  # wake the replicators now, not next beat
        deadline = time.monotonic() + timeout
        with self._commit_cv:
            while self.commit_index < index:
                if self._stop.is_set() or \
                        time.monotonic() > deadline:
                    raise TimeoutError(
                        f"entry {index} not committed in {timeout}s")
                if self.state != LEADER:
                    raise NotLeader(self.leader_id)
                self._commit_cv.wait(timeout=0.1)
        # Wait until locally applied so the caller observes the effect.
        deadline2 = time.monotonic() + timeout
        while time.monotonic() < deadline2:
            with self._lock:
                if self.last_applied >= index:
                    return index
            time.sleep(0.005)
        return index
