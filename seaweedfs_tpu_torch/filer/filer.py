"""Filer core: namespace CRUD over a FilerStore + chunk GC + event log.

Reference: weed/filer/filer.go (CreateEntry with recursive parent
creation :129-235, FindEntry with TTL expiry :250-311, DeleteEntryMetaAndData),
filer_deletion.go (async chunk deletion pump to volume servers),
filer_notify.go (NotifyUpdateEvent meta log), meta_aggregator.go
(subscription fan-out — here a simple in-process pub/sub + ring buffer).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Iterable

from .entry import Attributes, Entry, FileChunk
from .filechunks import minus_chunks
from .filerstore import FilerStore, MemoryStore, NotFound, _norm
from .meta_log import MetaLog

ROOT = Entry(path="/", is_directory=True,
             attributes=Attributes(mode=0o755))


class FilerError(Exception):
    pass


class MetaEvent:
    """One namespace mutation (filer.proto EventNotification).

    ``signatures`` lists the filer signatures that have already seen or
    applied this mutation — the active-active sync loop-breaker
    (filer.proto EventNotification.signatures; command/filer_sync.go
    skips events already carrying the target's signature)."""

    __slots__ = ("ts_ns", "directory", "old_entry", "new_entry",
                 "signatures")

    def __init__(self, directory: str, old_entry: Entry | None,
                 new_entry: Entry | None, ts_ns: int | None = None,
                 signatures: list[int] | None = None):
        self.ts_ns = ts_ns if ts_ns is not None else time.time_ns()
        self.directory = directory
        self.old_entry = old_entry
        self.new_entry = new_entry
        self.signatures = signatures or []

    def to_dict(self) -> dict:
        return {"ts_ns": self.ts_ns, "directory": self.directory,
                "old_entry": self.old_entry.to_dict()
                if self.old_entry else None,
                "new_entry": self.new_entry.to_dict()
                if self.new_entry else None,
                "signatures": self.signatures}

    @classmethod
    def from_dict(cls, d: dict) -> "MetaEvent":
        return cls(
            directory=d["directory"],
            old_entry=Entry.from_dict(d["old_entry"])
            if d.get("old_entry") else None,
            new_entry=Entry.from_dict(d["new_entry"])
            if d.get("new_entry") else None,
            ts_ns=d["ts_ns"], signatures=list(d.get("signatures", [])))


class Filer:
    def __init__(self, store: FilerStore | None = None,
                 delete_file_id_fn: Callable[[list[str]], None]
                 | None = None,
                 log_capacity: int = 4096,
                 meta_log_dir: str | None = None,
                 signature: int | None = None,
                 fetch_chunk_fn: Callable[..., bytes] | None = None):
        self.store = store or MemoryStore()
        # Serializes every hardlink-doc read-modify-write: the HTTP
        # server is thread-per-connection, and a lost counter update
        # either leaks content forever or frees shared chunks while
        # links remain.  RLock because find_entry (expiry release) can
        # re-enter from inside a guarded section.
        self._hl_lock = threading.RLock()
        # Fetches a stored blob by file id — needed to expand chunk
        # manifests when freeing a deleted file's chunks (the manifest
        # AND its inner chunks must both go; filer_deletion.go resolves
        # manifests before deleting).  Without it, manifest chunks are
        # deleted but their inner chunks leak to vacuum.
        self._fetch_chunk = fetch_chunk_fn
        # Filer signature: random id stamped on every locally-originated
        # event — the cross-cluster sync loop-breaker (filer.go filer
        # Signature field).
        self.signature = signature if signature is not None \
            else random.getrandbits(31)
        # Chunk GC: file ids queued here are batch-deleted from the blob
        # store by the deletion pump (filer_deletion.go).
        self._delete_fn = delete_file_id_fn
        self._pending_deletions: list[str] = []
        self._del_lock = threading.Lock()
        # Meta log: persistent journal + live subscribers (filer_notify
        # + log_buffer).  RLock: delivery happens under the lock so one
        # subscriber sees events strictly in order; replay during
        # subscribe() holds it.
        self.meta_log = MetaLog(meta_log_dir, capacity=log_capacity)
        self._log_lock = threading.RLock()
        self._subscribers: list[Callable[[MetaEvent], None]] = []
        # Metadata-HA shard sink (filer/metaha.py ShardPlane.on_op):
        # when set, every committed mutation is journaled into its
        # shard's durable log + replicated to followers BEFORE the
        # caller can ack.  A raise from the sink fails the request —
        # an op the shard plane refused was never acked.  None (the
        # default) keeps a standalone filer on the pre-HA path.
        self.shard_sink: Callable[[dict, str], None] | None = None
        # Set while replaying a replicated record through the
        # high-level mutators: suppresses re-journaling (no loops) and
        # chunk GC (the origin primary already queued the deletes).
        self._applying_remote = threading.local()
        # Signatures to attach to the next mutation on this thread
        # (set by the server when a sync/replication client replays a
        # remote event carrying prior signatures).
        self._extra_signatures = threading.local()
        # Optional notification queue: every event is also published for
        # `filer.replicate` consumers (weed/notification/configuration.go;
        # the reference publishes from filer_notify.go:18).
        self.notification_queue = None
        self._stop = threading.Event()
        self._pump = threading.Thread(target=self._deletion_pump,
                                      daemon=True, name="filer-gc")
        self._pump.start()

    # -- hardlinks (filerstore_hardlink.go) -----------------------------------
    #
    # A hardlinked file's content lives ONCE in the store's KV plane
    # under its hard_link_id; every path entry in the link group is a
    # pointer carrying that id.  Reads overlay the KV blob
    # (maybeReadHardLink), writes through any path update the blob
    # (setHardLink), and deletes decrement the shared counter, freeing
    # the chunks only when the last link goes (DeleteHardLink).

    _HL_PREFIX = "hardlink/"

    def _hl_read(self, hid: str) -> dict | None:
        import json
        blob = self.store.kv_get(self._HL_PREFIX + hid)
        return None if blob is None else json.loads(blob)

    def _hl_write(self, hid: str, doc: dict) -> None:
        import json
        self.store.kv_put(self._HL_PREFIX + hid, json.dumps(doc).encode())

    def _hl_doc(self, entry: Entry, counter: int) -> dict:
        return {"attributes": entry.attributes.to_dict(),
                "chunks": [c.to_dict() for c in entry.chunks],
                "hard_link_counter": counter}

    def _maybe_read_hardlink(self, e: Entry) -> Entry:
        if not e.hard_link_id:
            return e
        doc = self._hl_read(e.hard_link_id)
        if doc is not None:
            e.attributes = Attributes.from_dict(doc["attributes"])
            e.chunks = [FileChunk.from_dict(c) for c in doc["chunks"]]
            e.hard_link_counter = doc["hard_link_counter"]
        return e

    def _hl_store_content(self, entry: Entry) -> None:
        """Write entry content through to the shared doc.  The counter
        ALWAYS comes from the store side: a client replaying a cached
        entry (stale counter) must never clobber the live link count —
        that would free shared chunks while links still exist."""
        with self._hl_lock:
            doc = self._hl_read(entry.hard_link_id)
            counter = doc["hard_link_counter"] if doc \
                else max(1, entry.hard_link_counter)
            entry.hard_link_counter = counter
            self._hl_write(entry.hard_link_id,
                           self._hl_doc(entry, counter))

    def _release_hardlink(self, e: Entry, delete_chunks: bool) -> None:
        """One path in the link group is going away: decrement the
        shared counter; the last release frees the content.  Chunk
        deletion (which may resolve manifests over the network) happens
        AFTER the lock is dropped so unrelated hardlink traffic never
        stalls behind volume-server fetches."""
        to_free: list[FileChunk] | None = None
        with self._hl_lock:
            doc = self._hl_read(e.hard_link_id)
            if doc is None:
                to_free = e.chunks
            else:
                doc["hard_link_counter"] -= 1
                if doc["hard_link_counter"] <= 0:
                    self.store.kv_delete(self._HL_PREFIX + e.hard_link_id)
                    to_free = [FileChunk.from_dict(c)
                               for c in doc["chunks"]]
                else:
                    self._hl_write(e.hard_link_id, doc)
        if delete_chunks and to_free:
            self._queue_chunk_deletion(to_free)

    def create_hardlink(self, src: str, dst: str) -> Entry:
        """`ln src dst`: dst becomes another name for src's content.
        The first link converts src into the KV-backed form."""
        import secrets
        src, dst = _norm(src), _norm(dst)
        with self._hl_lock:
            # Everything that can fail — dst collision, src checks,
            # parent creation — runs BEFORE the counter bump, and the
            # dst check sits inside the lock, so a failed or racing
            # link can never leak a reference (which would pin the
            # content forever).
            if self.exists(dst):
                raise FilerError(f"{dst} already exists")
            e = self._maybe_read_hardlink(self.store.find_entry(src))
            if e.is_directory:
                raise FilerError(f"cannot hardlink directory {src}")
            self._ensure_parents(dst.rsplit("/", 1)[0] or "/",
                                 e.attributes)
            if not e.hard_link_id:
                before = e.clone()
                e.hard_link_id = secrets.token_hex(8)
                e.hard_link_counter = 1
                self._hl_write(e.hard_link_id, self._hl_doc(e, 1))
                self.store.update_entry(e)
                # The conversion is a mutation of src — subscribers
                # (filer.sync, mount meta caches) must see the entry
                # gain its hard_link_id or replicas would later free
                # shared chunks on src's deletion.
                self._notify(e.dir, before, e)
            doc = self._hl_read(e.hard_link_id)
            if doc is None:
                # Entry row survived but the doc is gone (lost KV
                # plane): repair by re-seeding from the entry.
                doc = self._hl_doc(e, max(1, e.hard_link_counter))
            doc["hard_link_counter"] += 1
            self._hl_write(e.hard_link_id, doc)
            link = Entry(path=dst, attributes=e.attributes,
                         chunks=[c for c in e.chunks],
                         hard_link_id=e.hard_link_id,
                         hard_link_counter=doc["hard_link_counter"])
            self.store.insert_entry(link)
        self._notify(link.dir, None, link)
        return link

    # -- namespace CRUD ------------------------------------------------------

    def find_entry(self, path: str) -> Entry:
        path = _norm(path)
        if path == "/":
            return ROOT.clone()
        e = self._maybe_read_hardlink(self.store.find_entry(path))
        if e.is_expired():
            if e.hard_link_id:
                self._release_hardlink(e, delete_chunks=True)
            else:
                self._queue_chunk_deletion(e.chunks)
            self.store.delete_entry(path)
            self._notify(e.dir, e, None)
            raise NotFound(path)
        return e

    def exists(self, path: str) -> bool:
        try:
            self.find_entry(path)
            return True
        except NotFound:
            return False

    def create_entry(self, entry: Entry,
                     o_excl: bool = False) -> Entry:
        """Insert/overwrite an entry, creating parent directories
        (CreateEntry, filer.go:129).  Overwriting a file queues its
        replaced chunks for deletion."""
        entry.path = _norm(entry.path)
        if entry.path == "/":
            return entry
        self._ensure_parents(entry.dir, entry.attributes)
        old: Entry | None
        try:
            old = self.store.find_entry(entry.path)
        except NotFound:
            old = None
        if old is not None:
            if o_excl:
                raise FilerError(f"{entry.path} already exists")
            if old.is_directory != entry.is_directory:
                raise FilerError(
                    f"{entry.path} exists as a "
                    f"{'directory' if old.is_directory else 'file'}")
            if old.is_directory:
                # mkdir on an existing directory is a no-op and emits NO
                # event (filer.go:163-176) — otherwise two synced filers
                # ping-pong directory updates forever.
                return old
            old = self._maybe_read_hardlink(old)
            if old.hard_link_id and not entry.hard_link_id:
                # Overwriting one name of a link group rewrites the
                # shared content — every other link sees it (POSIX
                # open(O_TRUNC) on a hardlinked file).
                entry.hard_link_id = old.hard_link_id
                entry.hard_link_counter = old.hard_link_counter
            garbage = minus_chunks(old.chunks, entry.chunks)
            self._queue_chunk_deletion(garbage)
        if not entry.attributes.crtime:
            entry.attributes.crtime = time.time()
        if not entry.attributes.mtime:
            entry.attributes.mtime = time.time()
        if entry.hard_link_id:
            self._hl_store_content(entry)
        self.store.insert_entry(entry)
        self._notify(entry.dir, old, entry)
        self._sink({"op": "set", "entry": entry.to_dict(),
                    "old": old.to_dict() if old else None},
                   entry.path)
        return entry

    def update_entry(self, entry: Entry) -> Entry:
        entry.path = _norm(entry.path)
        old = self._maybe_read_hardlink(
            self.store.find_entry(entry.path))  # must exist
        if old.hard_link_id and not entry.hard_link_id:
            entry.hard_link_id = old.hard_link_id
            entry.hard_link_counter = old.hard_link_counter
        garbage = minus_chunks(old.chunks, entry.chunks)
        self._queue_chunk_deletion(garbage)
        entry.attributes.mtime = time.time()
        if entry.hard_link_id:
            self._hl_store_content(entry)
        self.store.update_entry(entry)
        self._notify(entry.dir, old, entry)
        self._sink({"op": "set", "entry": entry.to_dict(),
                    "old": old.to_dict()}, entry.path)
        return entry

    def _ensure_parents(self, dir_path: str, attr: Attributes) -> None:
        if dir_path == "/":
            return
        try:
            e = self.store.find_entry(dir_path)
            if not e.is_directory:
                raise FilerError(f"{dir_path} is a file, not a directory")
            return
        except NotFound:
            pass
        parent = dir_path.rsplit("/", 1)[0] or "/"
        self._ensure_parents(parent, attr)
        d = Entry(path=dir_path, is_directory=True,
                  attributes=Attributes(
                      mtime=time.time(), crtime=time.time(), mode=0o775,
                      uid=attr.uid, gid=attr.gid,
                      collection=attr.collection,
                      replication=attr.replication))
        self.store.insert_entry(d)
        self._notify(d.dir, None, d)
        self._sink({"op": "set", "entry": d.to_dict(), "old": None},
                   d.path)

    def delete_entry(self, path: str, recursive: bool = False,
                     delete_chunks: bool = True) -> None:
        """Delete an entry; directories need recursive=True when non-empty.
        Referenced chunks are queued for blob deletion unless
        delete_chunks=False (metadata-only delete — used when the chunks
        are shared, e.g. S3 multipart parts after completion)."""
        path = _norm(path)
        if path == "/":
            raise FilerError("cannot delete root")
        e = self.store.find_entry(path)
        if e.is_directory:
            children = self.store.list_directory_entries(path, "", True, 2)
            if children and not recursive:
                raise FilerError(f"{path} is not empty")
            for child in list(self._walk(path)):
                if child.path == path:
                    continue
                if child.hard_link_id:
                    self._release_hardlink(child, delete_chunks)
                elif delete_chunks:
                    self._queue_chunk_deletion(child.chunks)
            self.store.delete_folder_children(path)
        if e.hard_link_id:
            self._release_hardlink(e, delete_chunks)
        elif delete_chunks:
            self._queue_chunk_deletion(e.chunks)
        self.store.delete_entry(path)
        self._notify(e.dir, e, None)
        # The record carries the top entry only: a recursive delete
        # replays as one recursive delete on the follower (the
        # reference's event stream elides per-child tombstones too).
        self._sink({"op": "del", "path": path,
                    "entry": e.to_dict(), "recursive": recursive},
                   path)

    def _walk(self, root: str) -> Iterable[Entry]:
        from .filerstore import iterate_tree
        return iterate_tree(self.store, root)

    def list_entries(self, dir_path: str, start_file_name: str = "",
                     include_start: bool = False,
                     limit: int = 1024) -> list[Entry]:
        out: list[Entry] = []
        start, include = start_file_name, include_start
        # Refill after expiry filtering: a short page must mean
        # end-of-directory, or callers stop paginating too early.
        while len(out) < limit:
            page = self.store.list_directory_entries(
                dir_path, start, include, limit - len(out))
            if not page:
                break
            for e in page:
                e = self._maybe_read_hardlink(e)
                if e.is_expired():
                    if e.hard_link_id:
                        self._release_hardlink(e, delete_chunks=True)
                    else:
                        self._queue_chunk_deletion(e.chunks)
                    self.store.delete_entry(e.path)
                    self._notify(e.dir, e, None)
                    continue
                out.append(e)
            start, include = page[-1].name, False
        return out

    def rename(self, old_path: str, new_path: str) -> Entry:
        """AtomicRenameEntry: move an entry (and any subtree) without
        touching chunk data (filer_grpc_server_rename.go)."""
        old_path, new_path = _norm(old_path), _norm(new_path)
        if new_path == old_path or new_path.startswith(old_path + "/"):
            # Moving a directory under itself would delete the subtree's
            # parent and orphan the moved entries.
            raise FilerError(f"cannot move {old_path} under itself")
        e = self.store.find_entry(old_path)
        if self.exists(new_path):
            raise FilerError(f"{new_path} already exists")
        moves = [(old_path, new_path, e)]
        if e.is_directory:
            for child in self._walk(old_path):
                if child.path == old_path:
                    continue
                moves.append((child.path,
                              new_path + child.path[len(old_path):],
                              child))
        self._ensure_parents(
            new_path.rsplit("/", 1)[0] or "/", e.attributes)
        for src, dst, entry in moves:
            entry = entry.clone()
            entry.path = dst
            self.store.insert_entry(entry)
        for src, _dst, entry in reversed(moves):
            self.store.delete_entry(src)
        moved = self.store.find_entry(new_path)
        self._notify(e.dir, e, None)
        self._notify(moved.dir, None, moved)
        # One logical record for the whole (possibly subtree) move:
        # the follower replays it as a rename against its own store —
        # a delete+create pair could never reconstruct the subtree.
        self._sink({"op": "ren", "src": old_path, "dst": new_path},
                   old_path)
        return moved

    # -- chunk GC ------------------------------------------------------------

    def _queue_chunk_deletion(self, chunks: list[FileChunk]) -> None:
        if not chunks:
            return
        if getattr(self._applying_remote, "flag", False):
            # Replicated replay: the origin primary already queued
            # these blob deletes — queueing again would double-free.
            return
        from .filechunk_manifest import (has_chunk_manifest,
                                         resolve_chunk_manifest)
        if has_chunk_manifest(chunks) and self._fetch_chunk is not None:
            try:
                data, manifests = resolve_chunk_manifest(
                    self._fetch_chunk, chunks)
                chunks = data + manifests
            except Exception:  # noqa: BLE001 — an unreadable manifest
                pass  # still frees the chunks we can see
        # The pump thread that actually issues the blob deletes has no
        # request context, so the deleting principal is captured HERE —
        # the volume-side tenant ledger decrements the same tenant the
        # delete request named.
        from ..tenancy import context as _tenant_ctx
        tenant = _tenant_ctx.current_tenant()
        with self._del_lock:
            # Packed chunks (filer/packing.py) share their needle with
            # sibling files: deleting one file must never free the
            # pack.  The pack's bytes come back via TTL expiry /
            # collection drop, which reclaim the needle as a whole.
            self._pending_deletions.extend(
                (c.file_id, tenant) for c in chunks
                if not getattr(c, "packed", False))

    def _deletion_pump(self) -> None:
        """Batch-delete queued file ids (loopProcessingDeletion)."""
        while not self._stop.wait(1.0):
            self.flush_deletions()

    def flush_deletions(self) -> None:
        from ..tenancy import context as _tenant_ctx
        with self._del_lock:
            batch, self._pending_deletions = self._pending_deletions, []
        if batch and self._delete_fn is not None:
            by_tenant: dict[str, list[str]] = {}
            for fid, tenant in batch:
                by_tenant.setdefault(tenant, []).append(fid)
            try:
                for tenant, fids in by_tenant.items():
                    _tenant_ctx.set_principal(tenant)
                    try:
                        self._delete_fn(fids)
                    finally:
                        _tenant_ctx.clear_principal()
            except Exception:  # noqa: BLE001 — blob servers may be down;
                with self._del_lock:  # retry next tick
                    self._pending_deletions = batch + \
                        self._pending_deletions

    # -- meta log / subscriptions -------------------------------------------

    def with_signatures(self, signatures: list[int]):
        """Context manager: mutations inside carry these extra
        signatures (sync replay attaching the origin chain)."""
        filer = self

        class _Ctx:
            def __enter__(self):
                filer._extra_signatures.value = list(signatures)

            def __exit__(self, *exc):
                filer._extra_signatures.value = []
        return _Ctx()

    def _sink(self, op: dict, path: str) -> None:
        """Hand one committed logical op to the shard plane (journal +
        fan-out before ack).  No-op standalone, and while replaying a
        replicated record (the follower's apply must not re-journal).
        Raises ShardWriteError when the plane refuses the ack."""
        sink = self.shard_sink
        if sink is None or getattr(self._applying_remote, "flag",
                                   False):
            return
        sigs = [self.signature]
        for s in getattr(self._extra_signatures, "value", []):
            if s not in sigs:
                sigs.append(s)
        op["sigs"] = sigs
        sink(op, path)

    def _notify(self, directory: str, old: Entry | None,
                new: Entry | None) -> None:
        sigs = [self.signature]
        for s in getattr(self._extra_signatures, "value", []):
            if s not in sigs:
                sigs.append(s)
        ev = MetaEvent(directory, old, new, signatures=sigs)
        with self._log_lock:
            # Append first: MetaLog may bump ts_ns to keep timestamps
            # strictly increasing; the queue and live subscribers must
            # see the same final timestamp as the journal.
            d = ev.to_dict()
            ev.ts_ns = self.meta_log.append(d)
            # Queue publish rides under the log lock so queue order can
            # never diverge from meta-log order.
            if self.notification_queue is not None:
                try:
                    self.notification_queue.publish(
                        (new or old).path if (new or old) else directory,
                        d)
                except Exception:  # noqa: BLE001 — a dead queue must
                    pass           # not block namespace mutations
            # Deliver under the lock: a subscriber mid-replay in
            # subscribe() must not observe newer events first.
            for fn in list(self._subscribers):
                try:
                    fn(ev)
                except Exception:  # noqa: BLE001 — one bad subscriber
                    pass           # must not break mutations

    def read_meta_events(self, since_ns: int = 0,
                         limit: int = 10000) -> list[MetaEvent]:
        """Events newer than since_ns from the persistent journal."""
        return [MetaEvent.from_dict(d)
                for d in self.meta_log.read_since(since_ns, limit)]

    def subscribe(self, fn: Callable[[MetaEvent], None],
                  since_ns: int = 0) -> Callable[[], None]:
        """Replay events newer than since_ns, then deliver live events
        (SubscribeMetadata: replay-from-log then tail).  Returns an
        unsubscribe function."""
        with self._log_lock:
            # Page until the journal is exhausted — a fixed-limit read
            # would silently gap the replay on large journals.
            page_size = 10000
            while True:
                page = self.read_meta_events(since_ns, page_size)
                for ev in page:
                    fn(ev)
                if len(page) < page_size:
                    break
                since_ns = page[-1].ts_ns
            self._subscribers.append(fn)

        def unsubscribe():
            with self._log_lock:
                if fn in self._subscribers:
                    self._subscribers.remove(fn)
        return unsubscribe

    def close(self) -> None:
        self._stop.set()
        self.flush_deletions()
        self.meta_log.close()
        self.store.close()
