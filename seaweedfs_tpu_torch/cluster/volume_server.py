"""Volume server: needle CRUD over HTTP + admin/EC RPCs + heartbeats.

Surface mirrors the reference volume server
(weed/server/volume_server_handlers_*.go, volume_grpc_*.go):

  public:  GET/POST/DELETE /{fid}   (?type=replicate suppresses fan-out)
  admin:   POST /admin/assign_volume | delete_volume | readonly | vacuum
           POST /admin/ec/generate | mount | rebuild | delete_shards
           GET  /admin/status
           GET  /admin/ec/shard_read?volume=&shard=&offset=&size=

Replicated writes fan out to sibling replicas looked up at the master
(topology/store_replicate.go) — all-or-fail like the reference.

Every EC coder this server builds (generate, mount, rebuild, startup
discovery) runs on `device` ("cuda" by default; "cpu" runs the kernels'
plain versions), resolved before any socket is bound, so a server asked
for a card that is not there refuses to start.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import random
import re
import threading
import time
import urllib.parse

import numpy as np
import torch

from ..core import types as t
from ..core.needle import CURRENT_VERSION, Needle
from ..ec import TOTAL_SHARDS, to_ext
from ..ec.encoder import rebuild_ec_files, write_ec_files, \
    write_sorted_file_from_idx
from ..ec.shard_bits import ShardBits
from ..ec.volume import EcVolume, NeedleNotFound
from ..events import emit as emit_event
from ..fault import registry as _fault
from ..codecs import get_codec
from ..ops.erasure import host_array, resolve_device
from ..stats import flows as _flows
from ..stats import roofline as _roofline
from ..stats.metrics import (ec_repair_read_bytes_total,
                             needle_repairs_total, observe_ec_stage)
from ..storage.scrub import ScrubDaemon
from ..storage.store import Store
from ..storage.vacuum import vacuum as vacuum_volume
from ..storage.volume import (CorruptNeedleError, DiskFullError,
                              NotFoundError, TierReadError, VolumeError)
from ..trace import span as trace_span
from . import rpc

# receive_shard writes a pushed body to its temp file in reads of this
# many bytes: a target holds one read buffer, whatever the shard size.
_RECEIVE_READ = 4 << 20

# How long a receive_ecc fragment may wait for its receive_shard before
# it stops being trusted (see VolumeServer._ec_pending_ecc).  Scatter
# pushes follow their fragment within seconds; minutes-old entries mean
# the push failed and a LATER encode generation must not inherit them.
_PENDING_ECC_TTL = 600.0


class VolumeServer:
    def __init__(self, master_url: str | list[str],
                 directories: list[str],
                 host: str = "127.0.0.1", port: int = 0,
                 max_volume_counts: list[int] | None = None,
                 data_center: str = "DefaultDataCenter",
                 rack: str = "DefaultRack",
                 pulse_seconds: int = 2,
                 jwt_signing_key: str = "",
                 ssl_context=None,
                 read_redirect: bool = True,
                 scrub_mbps: float = 32.0,
                 scrub_interval: float = 3600.0,
                 fsync: bool = False,
                 max_concurrent: int = 0,
                 queue_depth: int | None = None,
                 shutdown_grace: float = 30.0,
                 disk_reserve_mb: float = 0.0,
                 idle_timeout: float = 120.0,
                 ec_codec: str = "rs",
                 slo_read_p99: float | None = None,
                 slo_availability: float | None = None,
                 replicate_peer: str | None = None,
                 replicate_collections: str = "",
                 replicate_interval: float = 0.5,
                 tier_cache_mb: float = 64.0,
                 tier_promote_hits: int = 0,
                 tier_promote_window: float = 60.0,
                 transport: str | None = None,
                 sendfile_min: int | None = None,
                 tenant_rules: str = "",
                 geo_cluster_id: str = "",
                 replicate_compress: bool = False,
                 device="cuda"):
        # The card (or the CPU) every EC coder of this server runs on:
        # resolved first, so a missing card refuses the start.
        self.device = resolve_device(device)
        # Seed master list; heartbeats follow leader hints and rotate
        # seeds on failure (volume_grpc_client_to_master.go:60-85).
        self.masters = list(master_url) if isinstance(master_url, list) \
            else [master_url]
        self.master_url = self.masters[0]
        self._master_idx = 0
        # Write-path guard (security/guard.go): when a signing key is
        # configured, needle writes/deletes require a master-minted JWT.
        from ..utils.security import Guard
        self.guard = Guard(signing_key=jwt_signing_key)
        self._hb_seq = 0
        # Process generation: lets the master distinguish a restarted
        # volume server (seq starts over) from out-of-order arrivals.
        self._hb_epoch = random.getrandbits(63)
        self._hb_lock = threading.Lock()
        self.data_center = data_center
        self.rack = rack
        self.pulse_seconds = pulse_seconds
        # -read.redirect (volume.go:79, default true): GETs of volumes
        # not hosted here 301 to a current holder instead of 404ing.
        self.read_redirect = read_redirect
        # Tenancy & QoS (-tenant.rules): quota rules feed per-tenant
        # token buckets + DRR weights in the admission plane, and the
        # usage ledger below reports per-(tenant, collection) stored
        # bytes/objects to the master on every heartbeat.
        from ..tenancy import TenantUsage, load_rules
        self.tenant_policy = load_rules(tenant_rules) \
            if tenant_rules else None
        self.usage = TenantUsage()
        # Overload protection (-max.concurrent): bounded read/write
        # lanes + the lower-priority internal lane; 0 = no shedding
        # (in-flight is still tracked for graceful drain).
        self.server = rpc.JsonHttpServer(
            host, port, ssl_context=ssl_context,
            idle_timeout=idle_timeout,
            transport=transport,
            admission=rpc.AdmissionControl(
                max_concurrent, queue_depth=queue_depth,
                tenant_policy=self.tenant_policy))
        # -read.sendfile.min: smallest whole-needle GET served via the
        # zero-copy slice path (0 disables, None = class default).
        self.sendfile_min = self.SENDFILE_MIN if sendfile_min is None \
            else int(sendfile_min)
        self.store = Store(directories, max_volume_counts,
                           ip=host, port=self.server.port,
                           disk_reserve_bytes=int(disk_reserve_mb
                                                  * 1024 * 1024))
        # Graceful lifecycle (-shutdown.grace): draining mode refuses
        # new writes, finishes in-flight work, then says goodbye so the
        # master unregisters without a dead-sweep window.
        self.shutdown_grace = shutdown_grace
        self.draining = False
        self._drain_lock = threading.Lock()
        # -ec.codec: default erasure codec for /admin/ec/generate
        # ("rs" wire-compatible default; "lrc" for 5-read repair).
        # Validated now so a typo fails at startup, not mid-encode.
        self.ec_codec = get_codec(ec_codec).name
        self.ec_volumes: dict[int, EcVolume] = {}
        self._ec_recv_lock = threading.Lock()
        self._ec_recv_vlocks: dict[int, threading.Lock] = {}
        # (vid, sid) -> the lock a shard's pieces take while they write
        # its temp file.
        self._ec_recv_slocks: dict[tuple[int, int], threading.Lock] = {}
        # vid -> {sid: (shipped_at, crcs)} entries that arrived via
        # receive_ecc and have not yet been claimed by their
        # receive_shard.  Kept SEPARATE from the on-disk .ecc sidecar:
        # a sidecar entry might be a stale leftover from a prior encode
        # generation (same shard size, so the block count matches), and
        # trusting it for a fresh push would make the first scrub
        # quarantine a healthy shard.  Only an entry the encoder
        # shipped THIS time may stand in for fingerprinting the pushed
        # body; entries expire after _PENDING_ECC_TTL (a fragment whose
        # shard push failed must not haunt a later re-encode that
        # happens to match its block count), and a restart in between
        # just loses the map — receive_shard falls back safely.
        self._ec_pending_ecc: \
            dict[int, dict[int, tuple[float, list[int]]]] = {}
        # vid -> (fetched_at, ttl, shard->urls).  TTL is tiered by how
        # complete the last lookup was (store_ec.go:221-229): a lookup
        # that can't even serve reads retries quickly, a full set is
        # trusted for a long time.
        self._ec_loc_cache: dict[
            int, tuple[float, float, dict[int, list[str]]]] = {}
        # vid -> (fetched_at, /dir/lookup response): the volume-location
        # cache every misdirected read and replication fan-out shares
        # (operation/lookup.go keeps the same cache for ~10 minutes;
        # 60s here keeps rebalance staleness short on this plane).
        self._vol_loc_cache: dict[int, tuple[float, dict]] = {}
        self._ec_read_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._ec_pool_lock = threading.Lock()
        self._reap_partial_files()
        self._load_ec_volumes()
        # -fsync: force per-write durability (every POST behaves like
        # ?fsync=true — zero-loss acks for users who want them).
        self.fsync_writes = fsync
        # Background integrity sweep + self-healing (storage/scrub.py):
        # repairs route through this server because they need master
        # lookups (replica fetch) and the EC shard fan-out (decode).
        self.scrub = ScrubDaemon(
            self.store, self.ec_volumes, node=self.url(),
            mbps=scrub_mbps, interval=scrub_interval,
            repair_needle=self._repair_needle_from_replica,
            repair_ec_block=self._repair_ec_block,
            on_change=lambda: self._send_heartbeat(full=True))
        # Cross-cluster mirroring (-replicate.peer names the STANDBY
        # cluster's master): a background shipper tails every local
        # volume's durable change log and streams batches to the peer;
        # the receive side (the standby's _replication_apply) applies
        # idempotently against per-volume applied-seq watermarks.
        # Geo active/active (-geo.cluster.id): names THIS cluster in
        # the lease plane.  Per-volume `.lease` sidecars make exactly
        # one cluster the write home; non-holders forward writes and
        # the apply path fences stale epochs (replication/lease.py).
        self.geo_cluster_id = geo_cluster_id
        self.leases = None
        if geo_cluster_id:
            from ..replication.lease import LeaseTable
            self.leases = LeaseTable(self.store, geo_cluster_id)
        self.shipper = None
        if replicate_peer:
            from ..replication.shipper import ReplicationShipper
            self.shipper = ReplicationShipper(
                self.store, replicate_peer, node=self.url(),
                collections=replicate_collections,
                interval=replicate_interval,
                cluster_id=geo_cluster_id,
                compress=replicate_compress, leases=self.leases)
        self._replication_applied: dict[int, object] = {}
        self._replication_apply_lock = threading.Lock()
        s = self.server
        s.route("GET", "/admin/status", self._admin_status)
        s.route("POST", "/admin/status", self._admin_status)
        s.route("GET", "/ui", self._ui)
        from ..utils.pprof import enable_pprof_routes
        enable_pprof_routes(s)
        from ..trace import setup_server_tracing
        setup_server_tracing(s, "volumeServer")
        from ..fault.routes import setup_fault_routes
        setup_fault_routes(s)
        from ..events import setup_event_routes
        setup_event_routes(s)
        s.route("POST", "/admin/assign_volume", self._admin_assign_volume)
        s.route("POST", "/admin/delete_volume", self._admin_delete_volume)
        s.route("POST", "/admin/readonly", self._admin_readonly)
        s.route("POST", "/admin/configure_replication",
                self._admin_configure_replication)
        s.route("POST", "/admin/vacuum", self._admin_vacuum)
        s.route("POST", "/admin/scrub", self._admin_scrub)
        s.route("GET", "/admin/scrub/status", self._admin_scrub_status)
        s.route("POST", "/admin/scrub/repair", self._admin_scrub_repair)
        s.route("GET", "/admin/needle_raw", self._admin_needle_raw)
        s.route("POST", "/admin/ec/generate", self._ec_generate)
        s.route("POST", "/admin/ec/mount", self._ec_mount)
        s.route("POST", "/admin/ec/unmount", self._ec_unmount)
        s.route("POST", "/admin/ec/rebuild", self._ec_rebuild)
        s.route("POST", "/admin/ec/delete_shards", self._ec_delete_shards)
        s.route("GET", "/admin/ec/shard_read", self._ec_shard_read)
        s.route("GET", "/admin/ec/shard_file", self._ec_shard_file)
        s.route("POST", "/admin/ec/copy_shard", self._ec_copy_shard)
        s.route("POST", "/admin/ec/receive_shard", self._ec_receive_shard,
                stream_body=True)
        s.route("POST", "/admin/ec/receive_file", self._ec_receive_file)
        s.route("POST", "/admin/ec/receive_ecc", self._ec_receive_ecc)
        s.route("POST", "/admin/ec/to_volume", self._ec_to_volume)
        s.route("POST", "/query", self._query)
        s.route("GET", "/admin/volume_tail", self._volume_tail)
        s.route("POST", "/admin/leave", self._admin_leave)
        s.route("POST", "/admin/drain", self._admin_drain)
        s.route("POST", "/admin/replication/apply",
                self._replication_apply)
        s.route("POST", "/admin/replication/pause",
                self._replication_pause)
        s.route("POST", "/admin/replication/resume",
                self._replication_resume)
        s.route("GET", "/debug/replication", self._debug_replication)
        s.route("GET", "/admin/lease/status", self._lease_status)
        s.route("POST", "/admin/lease/acquire", self._lease_acquire)
        s.route("POST", "/admin/lease/move", self._lease_move)
        s.route("POST", "/admin/tier_upload", self._tier_upload)
        s.route("POST", "/admin/tier_download", self._tier_download)
        s.route("GET", "/debug/tier", self._debug_tier)
        # Tier plane (-tier.cache.mb / -tier.promote.*): the shared
        # remote block cache budget, and the auto-promotion policy —
        # `hits` tiered reads inside `window` seconds schedule a
        # tier_download back to local disk (0 hits = disabled).
        from ..storage.remote_cache import CACHE as _tier_cache
        _tier_cache.configure(int(tier_cache_mb * (1 << 20)))
        self.tier_promote_hits = tier_promote_hits
        self.tier_promote_window = tier_promote_window
        self._promoting: set[int] = set()
        self._promote_lock = threading.Lock()
        self._setup_metrics()
        # SLO plane: /debug/slow exemplars + /debug/slo state, declared
        # objectives (-slo.read.p99 / -slo.availability) feeding the
        # burn engine; heartbeats carry heartbeat_view() so the master
        # folds this node into /cluster/healthz.
        from ..stats.slo import setup_slo_routes
        setup_slo_routes(s)
        self.server.slo.set_objectives(slo_read_p99, slo_availability)
        # Lock-contention surface: /debug/locks — the volume write
        # lock, ecc sidecar lock, and admission-lane locks all report
        # here with their current holders/waiters.
        from ..stats.contention import setup_contention_routes
        setup_contention_routes(s)
        # Heavy hitters (stats/hotkeys.py): hot volumes / needles /
        # client IPs on the read+write data paths, for /debug/hot and
        # the shell's cluster.hot — the cache/packing target list.
        from ..stats.hotkeys import HotKeyTracker
        self.hot = HotKeyTracker()
        s.route("GET", "/debug/hot", self._debug_hot)
        s.route("GET", "/debug/tenants", self._debug_tenants)
        # Device roofline plane (stats/roofline.py): per-kernel
        # achieved-fraction table, pipeline occupancy gantts, probed
        # peaks and device memory stats.
        s.route("GET", "/debug/device", self._debug_device)
        s.route("GET", "/admin/volume_file", self._volume_file)
        s.route("POST", "/admin/copy_volume", self._copy_volume)
        s.route("GET", "/admin/volume/checksums", self._volume_checksums)
        s.route("POST", "/admin/volume/receive", self._volume_receive)
        s.route("POST", "/admin/mount", self._admin_mount)
        s.route("POST", "/admin/unmount", self._admin_unmount)
        s.prefix_route("GET", "/", self._get_needle)
        s.prefix_route("HEAD", "/", self._head_needle)
        s.prefix_route("POST", "/", self._post_needle)
        s.prefix_route("PUT", "/", self._post_needle)
        s.prefix_route("DELETE", "/", self._delete_needle)
        self._stop = threading.Event()
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True,
                                           name=f"hb:{self.server.port}")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.server.start()
        self._send_heartbeat(full=True)
        self._hb_thread.start()
        self.scrub.start()
        if self.shipper is not None:
            self.shipper.start()

    def stop(self) -> None:
        self._stop.set()
        if self.shipper is not None:
            self.shipper.stop()
        self.scrub.stop()
        self.server.stop()
        with self._ec_pool_lock:
            if self._ec_read_pool is not None:
                self._ec_read_pool.shutdown(wait=False)
                self._ec_read_pool = None
        for ev in self.ec_volumes.values():
            ev.close()
        self.store.close()

    def url(self) -> str:
        return f"{self.server.host}:{self.server.port}"

    # -- metrics (stats/metrics.go volume-server vectors) --------------------

    def _setup_metrics(self) -> None:
        from ..stats.sysstats import disk_status, memory_status
        reg = self.server.enable_metrics("volumeServer")

        def _iter_volumes():
            for loc in self.store.locations:
                yield from list(loc.volumes.values())

        def volumes_by_collection() -> dict:
            out: dict[tuple, float] = {}
            for v in _iter_volumes():
                k = (v.collection or "default", "volume")
                out[k] = out.get(k, 0) + 1
            if self.ec_volumes:
                out[("default", "ec_shard_volume")] = \
                    float(len(self.ec_volumes))
            return out

        def disk_sizes() -> dict:
            out: dict[tuple, float] = {}
            for v in _iter_volumes():
                k = (v.collection or "default", "normal")
                out[k] = out.get(k, 0) + v.content_size()
            return out

        reg.gauge("SeaweedFS_volumeServer_volumes",
                  "volumes managed by this server",
                  ("collection", "type"), callback=volumes_by_collection)
        reg.gauge("SeaweedFS_volumeServer_max_volumes",
                  "maximum volume slots",
                  callback=lambda: float(sum(
                      l.max_volume_count for l in self.store.locations)))
        reg.gauge("SeaweedFS_volumeServer_total_disk_size",
                  "stored bytes by collection",
                  ("collection", "type"), callback=disk_sizes)
        reg.gauge("SeaweedFS_disk_free_bytes", "free disk bytes",
                  ("dir",), callback=lambda: {
                      (l.directory,): disk_status(l.directory)["free"]
                      for l in self.store.locations})
        # The rest of the reference DiskStatus fields (disk.go): total
        # capacity, used bytes, and fill percentage per directory — the
        # same numbers the heartbeat feeds the master's health rollup.
        reg.gauge("SeaweedFS_disk_all_bytes", "total disk bytes",
                  ("dir",), callback=lambda: {
                      (l.directory,): disk_status(l.directory)["all"]
                      for l in self.store.locations})
        reg.gauge("SeaweedFS_disk_used_bytes", "used disk bytes",
                  ("dir",), callback=lambda: {
                      (l.directory,): disk_status(l.directory)["used"]
                      for l in self.store.locations})
        reg.gauge("SeaweedFS_disk_percent_used",
                  "disk fill percentage", ("dir",), callback=lambda: {
                      (l.directory,):
                      disk_status(l.directory)["percent_used"]
                      for l in self.store.locations})
        reg.gauge("SeaweedFS_memory_rss_bytes", "resident set size",
                  callback=lambda: float(memory_status()["rss"]))
        # Free-space reserve breaches (-disk.reserve): 1 while the
        # directory's free bytes sit below the reserve (its volumes are
        # readonly), 0 otherwise.
        reg.gauge("SeaweedFS_disk_reserve_breached",
                  "1 while the dir's free space is below -disk.reserve",
                  ("dir",), callback=lambda: {
                      (l.directory,):
                      1.0 if l.directory in self.store.low_disk_dirs
                      else 0.0
                      for l in self.store.locations})
        # EC pipeline stage instruments are process-global singletons
        # (every coder/reconstruction path observes into them); exposing
        # them here puts kernel/staging/fan-out time on this server's
        # /metrics scrape.
        from ..stats.metrics import ec_stage_bytes, ec_stage_seconds
        # register_once, not register: process-global singletons must
        # never land twice in one registry (an in-process re-init would
        # emit a duplicate exposition family and fail promcheck — the
        # regression in tests/test_slo.py).
        reg.register_once(ec_stage_seconds)
        reg.register_once(ec_stage_bytes)
        # Device roofline instruments (stats/roofline.py): per-kernel
        # fenced seconds / analytic bytes / GF(2) work, plus the
        # streamed-pipeline occupancy gauge — process-global
        # singletons, register_once for the same promcheck reason.
        for m in (_roofline.kernel_seconds_total,
                  _roofline.kernel_bytes_total,
                  _roofline.kernel_work_total,
                  _roofline.device_occupancy):
            reg.register_once(m)
        # Scrub + self-healing instruments (process-global singletons,
        # storage/scrub.py) on this server's scrape.
        from ..stats.metrics import (scrub_bytes_total,
                                     scrub_checked_total,
                                     scrub_corrupt_total,
                                     scrub_sweeps_total)
        for m in (scrub_checked_total, scrub_bytes_total,
                  scrub_corrupt_total, scrub_sweeps_total,
                  needle_repairs_total, ec_repair_read_bytes_total):
            reg.register_once(m)
        # Cross-cluster replication instruments (process-global
        # singletons the shipper observes into, replication/shipper.py).
        from ..stats.metrics import (replication_lag_seconds,
                                     replication_lag_seconds_total,
                                     replication_resends_total,
                                     replication_shipped_bytes_total)
        for m in (replication_shipped_bytes_total,
                  replication_resends_total,
                  replication_lag_seconds_total,
                  replication_lag_seconds):
            reg.register_once(m)
        # Tiering instruments: the shared remote block cache's
        # served-byte counters + mover/expiry totals (process-global
        # singletons), plus live gauges over the cache itself —
        # occupancy against the -tier.cache.mb budget and the remote
        # fetch latency quantiles (a WindowedSketch, so the gauges
        # track the last five minutes, not process lifetime).
        from ..stats.metrics import (lifecycle_actions_total,
                                     tier_cache_hit_bytes_total,
                                     tier_cache_miss_bytes_total,
                                     tier_moved_bytes_total,
                                     ttl_expired_bytes_total)
        for m in (tier_cache_hit_bytes_total,
                  tier_cache_miss_bytes_total, tier_moved_bytes_total,
                  ttl_expired_bytes_total, lifecycle_actions_total):
            reg.register_once(m)
        from ..storage.remote_cache import CACHE as _tier_cache
        reg.gauge("SeaweedFS_tier_cache_used_bytes",
                  "remote block cache occupancy",
                  callback=lambda: float(_tier_cache.used_bytes()))
        reg.gauge("SeaweedFS_tier_cache_max_bytes",
                  "remote block cache budget (-tier.cache.mb)",
                  callback=lambda: float(_tier_cache.max_bytes))

        def tier_fetch_quantiles() -> dict:
            out = {}
            for q, lbl in ((0.5, "0.5"), (0.99, "0.99")):
                v = _tier_cache.fetch_latency.quantile(q)
                out[(lbl,)] = v if v is not None else 0.0
            return out

        reg.gauge("SeaweedFS_tier_read_seconds",
                  "remote backend block-fetch latency quantiles "
                  "(5-minute window)", ("quantile",),
                  callback=tier_fetch_quantiles)
        # Tenancy plane: live per-tenant stored usage on this node —
        # the same numbers the heartbeat reports into the master's
        # rollup, scrapeable without a /debug/tenants hit.
        reg.gauge("SeaweedFS_tenant_stored_bytes",
                  "stored bytes by tenant on this server", ("tenant",),
                  callback=lambda: {
                      (t,): float(e["bytes"])
                      for t, e in self.usage.stored_totals().items()})
        reg.gauge("SeaweedFS_tenant_stored_objects",
                  "stored objects by tenant on this server",
                  ("tenant",), callback=lambda: {
                      (t,): float(e["objects"])
                      for t, e in self.usage.stored_totals().items()})

    # -- heartbeats ---------------------------------------------------------

    def _disk_statuses(self) -> list[dict]:
        """Per-directory DiskStatus for the heartbeat: the master's
        health rollup watches percent_used without a per-node scrape."""
        from ..stats.sysstats import disk_status
        out = []
        for loc in self.store.locations:
            try:
                out.append(disk_status(loc.directory))
            except OSError:
                continue
        return out

    def _ec_shard_infos(self) -> list[dict]:
        out = []
        # Snapshots: /admin/ec/mount and unmount change both maps from
        # request threads while the pulse thread builds its beat.
        for vid, ev in list(self.ec_volumes.items()):
            bits = ShardBits(0)
            for sid in list(ev.shards):
                bits = bits.add_shard_id(sid)
            # The codec id rides every heartbeat so the master (and
            # through it the rebuild planner) knows each EC volume's
            # shard scheme without touching a .vif.
            out.append({"id": vid, "collection": "",
                        "shard_bits": int(bits),
                        "codec": ev.codec.name})
        return out

    def _send_heartbeat(self, full: bool = False,
                        _hops: int = 0) -> None:
        from .master import vinfo_to_dict
        # A master we haven't registered with yet (leader switch / seed
        # rotation) needs the full picture, not a delta.
        full = full or getattr(self, "_need_full", False)
        # Free-space reserve enforcement rides the heartbeat cadence:
        # volumes on a breached location flip readonly here, BEFORE the
        # snapshot below reports them, so the master learns the
        # readonly state and the low-disk flag in the same beat.
        if self.store.check_disk_reserve():
            full = True  # readonly flips must reach the master now
        # Heartbeats are POSTed from two threads (pulse loop + the
        # post-allocate beat); the sequence number lets the master drop
        # any snapshot that arrives after a newer one, or a stale full
        # sync would erase a just-allocated volume from the topology.
        # Snapshot collection rides under the same lock so seq order
        # matches content order (the reference gets this for free from
        # its single bidi heartbeat stream, volume_grpc_client_to_master).
        with self._hb_lock:
            self._hb_seq += 1
            hb: dict = {
                "ip": self.server.host, "port": self.server.port,
                "public_url": self.store.public_url,
                "data_center": self.data_center, "rack": self.rack,
                "seq": self._hb_seq, "seq_epoch": self._hb_epoch,
                "max_volume_count": sum(l.max_volume_count
                                        for l in self.store.locations),
                "ec_shards": self._ec_shard_infos(),
                "disks": self._disk_statuses(),
                # Detected-but-unrepaired EC shard corruption (scrub):
                # the master's healthz reports these volumes degraded.
                "ec_corrupt": self.scrub.ec_corrupt_counts(),
                # Lifecycle + capacity flags: the master's _assign
                # steers away from draining/low-disk nodes and healthz
                # reports them without a per-node scrape.
                "draining": self.draining,
                "low_disk": bool(self.store.low_disk_dirs),
                # SLO state (stats/slo.py): burn verdict + mergeable
                # aggregate read/write quantile sketches — the master
                # folds every node into one cluster-wide tail on
                # /cluster/healthz and degrades on fast burn.
                "slo": self.server.slo.heartbeat_view(),
                # Per-(tenant, collection) stored usage, ABSOLUTE
                # values (idempotent): the master's UsageRollup
                # replaces this node's rows wholesale each beat, so a
                # dropped beat or failover never double-counts.
                "tenants": self.usage.heartbeat_view(),
                # Wire-flow ledger rows for THIS server (absolute
                # totals, idempotent like the tenant rollup): the
                # master replaces this node's cells wholesale each
                # beat and derives rates from successive samples.
                "flows": {
                    "rows": _flows.LEDGER.snapshot(local=self.url()),
                    "budgets":
                        _flows.LEDGER.budget_status(local=self.url()),
                },
                # Device roofline rollup (stats/roofline.py): absolute
                # per-kernel rows + pipeline occupancy summary — the
                # master's /cluster/device and its occupancy-collapse
                # healthz warning.
                "device": _roofline.LEDGER.heartbeat_view(),
            }
            if self.shipper is not None:
                # Per-volume replication lag (seq delta + seconds) +
                # pairing config: the master folds this into
                # /cluster/healthz and its lag-SLO verdict.
                hb["replication"] = self.shipper.lag_view()
            if self.leases is not None:
                # Geo lease rows (holder cluster + fencing epoch per
                # mirrored volume): the master's /cluster/mirror
                # rollup and healthz geo section.
                hb["leases"] = {"cluster_id": self.geo_cluster_id,
                                "volumes": self.leases.snapshot()}
            if full:
                hb["volumes"] = [
                    vinfo_to_dict(v) for v in
                    self.store.collect_heartbeat()["volumes"]]
            else:
                new, deleted = self.store.drain_deltas()
                if not new and not deleted:
                    hb["new_volumes"], hb["deleted_volumes"] = [], []
                else:
                    hb["new_volumes"] = [vinfo_to_dict(v) for v in new]
                    hb["deleted_volumes"] = [vinfo_to_dict(v)
                                             for v in deleted]
        try:
            if _fault.ARMED:
                _fault.hit("master.heartbeat", master=self.master_url,
                           server=self.url())
            out = rpc.call(f"{self.master_url}/heartbeat", "POST",
                           json.dumps(hb).encode())
            if isinstance(out, dict) and out.get("is_leader") is False:
                hint = out.get("leader")
                self._need_full = True
                if hint and hint != self.master_url:
                    # Redial the leader and re-register there.
                    self.master_url = hint
                    if _hops < 2:  # election churn: retry next tick
                        self._send_heartbeat(_hops=_hops + 1)
                else:
                    # Leaderless (or self-referential) answer: this
                    # master may be partitioned from the quorum — try
                    # the next seed rather than spinning here.
                    self._rotate_master()
            elif full:
                self._need_full = False
        except Exception:  # noqa: BLE001 — master down: rotate to the
            # next seed and re-register on the next tick.
            self._need_full = True
            self._rotate_master()

    def _rotate_master(self) -> None:
        if len(self.masters) > 1:
            self._master_idx = (self._master_idx + 1) % \
                len(self.masters)
            self.master_url = self.masters[self._master_idx]

    def _heartbeat_loop(self) -> None:
        # Flow identity for this daemon thread: several servers can
        # share one process (tests), so the process-wide default is
        # not enough — outbound beats must attribute to THIS node.
        _flows.bind_thread(self.url(), "volume")
        ticks = 0
        while not self._stop.wait(self.pulse_seconds):
            ticks += 1
            # Periodic full sync like the reference's EC beat (17x pulse).
            try:
                self._send_heartbeat(full=(ticks % 17 == 0))
            except Exception as e:  # noqa: BLE001 — one bad beat (a
                # shard map mutated mid-snapshot) must not end the
                # pulse: the master would sweep this node for good.
                # The reference's loop dies here; the next full beat
                # resends everything.
                from ..utils import glog
                glog.warningf("heartbeat to %s failed: %r",
                              self.master_url, e)
                self._need_full = True
            try:
                self._lifecycle_tick()
            except Exception:  # noqa: BLE001 — never kill the heartbeat
                pass

    # -- holder-side lifecycle (TTL retirement + auto-promotion) -------------

    def _lifecycle_tick(self) -> None:
        """Piggybacks on the heartbeat cadence: retire TTL volumes whose
        newest write is past expiry (every needle inside is already a
        404 — the files are pure garbage), and promote tiered volumes
        the block cache says turned hot again."""
        from ..storage import expiry as _expiry
        from ..storage.remote_cache import CACHE
        for loc in self.store.locations:
            for v in list(loc.volumes.values()):
                ttl = v.super_block.ttl
                if ttl.minutes() > 0 and _expiry.volume_expired(
                        ttl, getattr(v, "modified_at", 0),
                        # Grace past nominal expiry: clock skew between
                        # writers plus a couple of pulses so the master
                        # steers away first.
                        grace=max(0.1 * ttl.minutes() * 60,
                                  2.0 * self.pulse_seconds)):
                    self._retire_expired_volume(v)
                    continue
                if v.remote_file is not None and \
                        self.tier_promote_hits > 0:
                    hits = CACHE.hits_in_window(
                        v.remote_file.backend.spec, v.remote_file.key,
                        self.tier_promote_window)
                    if hits >= self.tier_promote_hits:
                        self._schedule_promotion(v.vid)

    def _retire_expired_volume(self, v) -> None:
        """Whole-volume TTL retirement (the reference's volume-level
        TTL vacuum): drop the remote object if tiered, delete the local
        files, tell the master via a full heartbeat."""
        size = v.dat_size()
        tiered = v.remote_file is not None
        if tiered:
            # Best-effort remote delete BEFORE the local unmount: the
            # .vif (removed by delete_volume) is the only pointer to
            # the object, and a leaked remote .dat is paid-for garbage.
            from ..storage.tier import _tier_credentials, load_vif
            info = load_vif(v.file_name())
            if info and info.get("files"):
                fdesc = info["files"][0]
                try:
                    from ..storage.backend import backend_for_spec
                    ak, sk = _tier_credentials()
                    backend_for_spec(fdesc["backend_spec"], ak,
                                     sk).delete(fdesc["key"])
                except Exception:  # noqa: BLE001 — retirement proceeds
                    pass
        try:
            self.store.delete_volume(v.vid)
        except VolumeError:
            return
        from ..stats.metrics import ttl_expired_bytes_total
        ttl_expired_bytes_total.inc(size, via="volume_retire")
        self.usage.drop_volume(v.vid)
        emit_event("volume.expired", node=self.url(), vid=v.vid,
                   collection=v.collection, bytes=size, tiered=tiered,
                   ttl=str(v.super_block.ttl))
        try:
            self._send_heartbeat(full=True)
        except Exception:  # noqa: BLE001
            pass

    def _schedule_promotion(self, vid: int) -> None:
        """Sustained cache hits inside the window: bring the .dat back
        local in the background (one promotion per volume at a time)."""
        with self._promote_lock:
            if vid in self._promoting:
                return
            self._promoting.add(vid)
        threading.Thread(target=self._promote_volume, args=(vid,),
                         name=f"promote:{vid}", daemon=True).start()

    def _promote_volume(self, vid: int) -> None:
        from ..stats.metrics import lifecycle_actions_total
        from ..storage.tier import _tier_credentials, \
            move_dat_from_remote
        try:
            v = self.store.find_volume(vid)
            if v is None or v.remote_file is None:
                return
            ak, sk = _tier_credentials()
            try:
                move_dat_from_remote(v, access_key=ak, secret_key=sk)
            except Exception:  # noqa: BLE001 — retried next window
                lifecycle_actions_total.inc(action="promote",
                                            outcome="error")
                return
            lifecycle_actions_total.inc(action="promote", outcome="ok")
            emit_event("lifecycle.promote", node=self.url(), vid=vid,
                       collection=v.collection, bytes=v.dat_size())
            try:
                self._send_heartbeat(full=True)
            except Exception:  # noqa: BLE001
                pass
        finally:
            with self._promote_lock:
                self._promoting.discard(vid)

    def _debug_tier(self, query: dict, body: bytes) -> dict:
        """Tier state of every volume here + the shared cache's live
        numbers — the data behind `volume.tier.status`."""
        from ..storage.remote_cache import CACHE
        from ..storage.tier import load_vif
        vols = []
        for loc in self.store.locations:
            for v in list(loc.volumes.values()):
                ent = {"volume": v.vid, "collection": v.collection,
                       "tiered": v.remote_file is not None,
                       "ttl": str(v.super_block.ttl),
                       "modified_at": getattr(v, "modified_at", 0)}
                if v.remote_file is not None:
                    info = load_vif(v.file_name()) or {}
                    files = info.get("files") or [{}]
                    ent["remote"] = {
                        "backend_spec": files[0].get("backend_spec"),
                        "key": files[0].get("key"),
                        "file_size": files[0].get("file_size")}
                    ent["hits_in_window"] = CACHE.hits_in_window(
                        v.remote_file.backend.spec, v.remote_file.key,
                        self.tier_promote_window)
                vols.append(ent)
        return {"volumes": vols, "cache": CACHE.stats(),
                "promote": {"hits": self.tier_promote_hits,
                            "window": self.tier_promote_window}}

    # -- public needle handlers ---------------------------------------------

    def _parse_fid_path(self, path: str) -> tuple[int, int, int]:
        fid = urllib.parse.unquote(path.lstrip("/"))
        return t.parse_file_id(fid)

    _VOL_LOOKUP_TTL = 60.0
    _VOL_LOOKUP_NEG_TTL = 5.0

    def _lookup_volume(self, vid: int) -> dict:
        """Cached master /dir/lookup (operation/lookup.go's vid cache)
        shared by the misdirected-read redirect and the replication
        fan-out — neither may hammer the master per request.  A
        definitive negative answer (the master does not know the
        volume) is negative-cached briefly, so clients hammering stale
        fids don't turn every local 404 into a master round-trip."""
        now = time.time()
        hit = self._vol_loc_cache.get(vid)
        if hit and now < hit[0]:
            return hit[1]
        # Cache miss = one master round-trip; on a trace this is where
        # read-redirect / replication fan-out latency hides.
        with trace_span("volume.loc_lookup", vid=vid):
            try:
                resp = rpc.call(
                    f"{self.master_url}/dir/lookup?volumeId={vid}")
            except rpc.RpcError:
                self._vol_loc_cache[vid] = (
                    now + self._VOL_LOOKUP_NEG_TTL, {})
                raise
        self._vol_loc_cache[vid] = (now + self._VOL_LOOKUP_TTL, resp)
        return resp

    def _read_redirect_or_404(self, vid: int, path: str, query: dict):
        """Non-local volume on the read path: 301 to a current holder
        when -read.redirect is on (GetOrHeadHandler,
        volume_server_handlers_read.go:62-83; default true,
        volume.go:79), else 404 like a redirect-less server.  EC-only
        volumes redirect to a shard holder (any holder serves reads by
        distributed reconstruction), like the reference's topology
        lookup falling back to EC locations."""
        if self.read_redirect:
            urls: list[str] = []
            try:
                out = self._lookup_volume(vid)
                for loc in out.get("locations", []):
                    urls.append(loc.get("publicUrl") or loc.get("url"))
                for dns in out.get("ecShards", {}).values():
                    for d in dns:
                        urls.append(d.get("publicUrl") or d.get("url"))
            except Exception:  # noqa: BLE001 — master down: plain 404
                pass
            scheme = "https" if self.server.ssl_context else "http"
            for url in urls:
                if url and url != self.url():
                    target = f"{scheme}://{url}{path}"
                    if query.get("collection"):
                        target += "?collection=" + urllib.parse.quote(
                            query["collection"])
                    return (301, b"", {"Location": target})
        raise rpc.RpcError(404, f"volume {vid} not on this server")

    def _head_needle(self, path: str, query: dict, body: bytes):
        """Existence/size probe without the body (fsck, clients)."""
        vid, key, cookie = self._parse_fid_path(path)
        v = self.store.find_volume(vid)
        if v is None and vid not in self.ec_volumes:
            return self._read_redirect_or_404(vid, path, query)
        if v is not None:
            try:
                n = self.store.read_needle(vid, key, cookie)
            except NotFoundError as e:
                raise rpc.RpcError(404, str(e)) from None
            except TierReadError as e:
                raise rpc.RpcError(503, str(e),
                                   headers={"Retry-After": "1"}) \
                    from None
            except CorruptNeedleError as e:
                # A probe must answer what IS here: 503 flags a rotten
                # local copy so fsck/replica-repair treat this holder
                # as unhealthy without transferring a body.
                raise rpc.RpcError(503, str(e)) from None
            except VolumeError as e:
                raise rpc.RpcError(403, str(e)) from None
            size = len(n.data)
            # HEAD shares GET's handler in the reference
            # (GetOrHeadHandler): same ETag/Last-Modified/Content-Type/
            # Content-Disposition and the same 304 short-circuits, so a
            # cache-validation flow can start from a HEAD.
            hdrs, not_modified = self._conditional_headers(
                query, f"{n.checksum:08x}",
                n.name if n.has_name() else b"",
                n.mime if n.has_mime() else b"",
                int(n.last_modified) if n.has_last_modified_date()
                else 0)
            if not_modified:
                return (304, b"", hdrs)
            hdrs["Accept-Ranges"] = "bytes"
            if n.is_compressed() and size >= 4:
                # HEAD must mirror GET's negotiation: a gzip-accepting
                # client would receive the stored bytes (report that
                # length + encoding), anyone else the inflated body —
                # sized by the gzip ISIZE trailer (last 4 bytes, LE)
                # without actually inflating the needle.
                if "gzip" in query.get("_accept_encoding", ""):
                    hdrs["Content-Encoding"] = "gzip"
                else:
                    size = int.from_bytes(n.data[-4:], "little")
            hdrs["Content-Length"] = str(size)
            return (200, b"", hdrs)
        # EC probe: locate-only (.ecx binary search + .ecj check) —
        # reports 404 for absent/deleted needles without reconstructing
        # any data.
        ev = self.ec_volumes[vid]
        self._ensure_ec_version(ev)
        try:
            ev.locate_needle(key)
        except NeedleNotFound as e:
            raise rpc.RpcError(404, str(e)) from None
        return (200, b"", {})

    # Payloads at least this large go out via the zero-copy sendfile
    # path (CRC-checked preads + os.sendfile) — the DEFAULT whole-
    # needle GET path, not a large-object special case: one page is
    # the break-even where the extra metadata preads cost less than
    # the userspace copy they avoid.  Records needing the parse path
    # (compressed, TTL'd, tiered, v1 layout, resize) decline the slice
    # and fall through unchanged; tune/disable with -read.sendfile.min.
    SENDFILE_MIN = 4096

    @staticmethod
    def _principal(query: dict) -> tuple[str, str]:
        """(tenant, originating client) the rpc middleware resolved —
        `_client` carries the X-Weed-Client a proxying filer forwarded,
        so hot-key attribution names the real caller, not the proxy."""
        return (query.get("_tenant", ""),
                query.get("_client", "") or
                query.get("_remote_addr", ""))

    def _get_needle(self, path: str, query: dict, body: bytes):
        vid, key, cookie = self._parse_fid_path(path)
        tenant, client = self._principal(query)
        self.hot.read(vid, key, client, tenant)
        if _fault.ARMED:
            _fault.hit("volume.read", vid=vid, server=self.url())
        v = self.store.find_volume(vid)
        if v is None:
            ev = self.ec_volumes.get(vid)
            if ev is None:
                return self._read_redirect_or_404(vid, path, query)
            n = self._ec_read(ev, key, cookie)
        else:
            # Lock-free size peek decides the path so the dominant
            # small-read case pays zero extra lookups (a stale peek
            # only mis-routes to the other path, which re-validates).
            ent = v.nm.get(key)
            if ent is not None and self.sendfile_min > 0 and \
                    ent[1] >= self.sendfile_min and \
                    "width" not in query and "height" not in query:
                # Zero-copy fast path for large plain needles: CRC is
                # verified by streaming preads, then the responder
                # os.sendfile's the payload straight from the .dat
                # (VERDICT r4 #1; the reference serves the same bytes
                # after its own CRC check,
                # volume_server_handlers_read.go:28).
                try:
                    sl = v.read_needle_slice(key, cookie,
                                             min_size=self.sendfile_min)
                except NotFoundError as e:
                    raise rpc.RpcError(404, str(e)) from None
                except (CorruptNeedleError, OSError) as e:
                    # Degraded read: heal in line and serve the
                    # repaired bytes rather than erroring.
                    n = self._degraded_read(v, vid, key, cookie, e)
                    return self._serve_needle(n, query)
                except VolumeError as e:
                    raise rpc.RpcError(403, str(e)) from None
                if sl is not None:
                    cond, not_modified = self._conditional_headers(
                        query, sl.etag, sl.name, sl.mime,
                        sl.last_modified)
                    if not_modified:
                        sl.close()
                        return (304, b"", cond)
                    cond.setdefault("Content-Type",
                                    "application/octet-stream")
                    cond["Accept-Ranges"] = "bytes"
                    try:
                        rng = rpc.parse_byte_range(
                            query.get("_range_header", ""), sl.size)
                    except rpc.RpcError:  # 416: the slice owns an fd
                        sl.close()
                        raise
                    if rng is not None:
                        # CRC was verified over the whole payload;
                        # sendfile just the requested window
                        # (processRangeRequest single-range path).
                        lo, hi = rng
                        total = sl.size
                        sl.offset += lo
                        sl.size = hi - lo + 1
                        self.usage.note_request(tenant,
                                                read_bytes=sl.size)
                        return (206, sl, {
                            **cond,
                            "Content-Length": str(sl.size),
                            "Content-Range":
                            f"bytes {lo}-{hi}/{total}"})
                    self.usage.note_request(tenant, read_bytes=sl.size)
                    return (200, sl,
                            {**cond,
                             "Content-Length": str(sl.size)})
            try:
                n = self.store.read_needle(vid, key, cookie)
            except NotFoundError as e:
                if key in v.repair_tickets:
                    # Quarantined (tombstoned) corrupt needle: a
                    # replica may still hold it — degraded read.
                    n = self._degraded_read(v, vid, key, cookie, e)
                else:
                    raise rpc.RpcError(404, str(e)) from None
            except TierReadError as e:
                # Remote tier unreachable (WAN partition / backend
                # down): the local bytes are gone BY DESIGN, so
                # degraded-read repair has nothing to heal — answer a
                # bounded, retryable 503 with a pacing hint.
                raise rpc.RpcError(503, str(e),
                                   headers={"Retry-After": "1"}) \
                    from None
            except (CorruptNeedleError, OSError) as e:
                # CRC failure or a dying sector on the read path: the
                # same self-healing repair the scrub uses, in line —
                # the client gets the repaired bytes, not an error.
                n = self._degraded_read(v, vid, key, cookie, e)
            except VolumeError as e:
                raise rpc.RpcError(403, str(e)) from None
        return self._serve_needle(n, query)

    def _serve_needle(self, n: Needle, query: dict):
        """Post-read pipeline shared by the replicated and EC paths:
        gzip negotiation, optional image resize, then Range shaping on
        the outgoing representation (processRangeRequest,
        weed/server/common.go:233 via
        volume_server_handlers_read.go:255-264) — storage layout must
        never change read behavior."""
        self.usage.note_request(query.get("_tenant", ""),
                                read_bytes=len(n.data))
        cond, not_modified = self._conditional_headers(
            query, f"{n.checksum:08x}", n.name if n.has_name() else b"",
            n.mime if n.has_mime() else b"",
            int(n.last_modified) if n.has_last_modified_date() else 0)
        if not_modified:
            return (304, b"", cond)
        if n.is_compressed():
            # Stored gzipped (volume_server_handlers_read.go): hand the
            # raw bytes to readers that accept gzip, decompress for the
            # rest.  Resize always needs the plain image bytes.
            from ..utils.compression import ungzip_data
            if "gzip" in query.get("_accept_encoding", "") and \
                    "width" not in query and "height" not in query:
                return self._maybe_range(
                    query, n.data,
                    {**cond, "Content-Encoding": "gzip"})
            n.data = ungzip_data(n.data)
        if "width" in query or "height" in query:
            # On-the-fly resize for image reads
            # (volume_server_handlers_read.go:219-243).  Malformed
            # dimensions degrade to 0 = unresized, like the reference's
            # atoi — never a 500 on a valid needle read.
            from ..images import resized

            def _dim(name: str) -> int:
                try:
                    return max(0, int(query.get(name, 0) or 0))
                except ValueError:
                    return 0
            data, mime = resized(n.data, _dim("width"), _dim("height"),
                                 query.get("mode", ""))
            if mime:
                cond = {**cond, "Content-Type": mime}
            return self._maybe_range(query, data, cond)
        return self._maybe_range(query, n.data, cond)

    @staticmethod
    def _conditional_headers(query: dict, etag: str, name: bytes,
                             mime: bytes, last_modified: int):
        """Caching/content headers for a needle GET + the 304
        short-circuit (volume_server_handlers_read.go:113-129 and
        adjustHeaderContentDisposition, common.go:221): ETag is the
        quoted 8-hex checksum, Last-Modified honors If-Modified-Since,
        If-None-Match matches the quoted etag, needle mime wins unless
        it is octet-stream, and a named needle gets inline/attachment
        disposition (?dl=true).  Returns (headers, not_modified)."""
        from email.utils import formatdate, parsedate_to_datetime
        # The stored CRC as an explicit header on HEAD and GET alike:
        # volume.fsck -crc and replica repair compare content identity
        # across holders without bodies (and without unquoting ETags).
        hdrs = {"ETag": f'"{etag}"', "X-Needle-Checksum": etag}
        if last_modified:
            hdrs["Last-Modified"] = formatdate(last_modified,
                                               usegmt=True)
            ims = query.get("_if_modified_since", "")
            if ims:
                try:
                    dt = parsedate_to_datetime(ims)
                    if dt.tzinfo is None:
                        # Zone-less dates (obsolete asctime form) are
                        # GMT per RFC 7231; naive .timestamp() would
                        # apply the server's local offset.
                        from datetime import timezone
                        dt = dt.replace(tzinfo=timezone.utc)
                    t_ims = dt.timestamp()
                except (TypeError, ValueError):
                    t_ims = None
                if t_ims is not None and t_ims >= last_modified:
                    return hdrs, True
        if query.get("_if_none_match", "") == f'"{etag}"':
            return hdrs, True
        if mime and not mime.startswith(b"application/octet-stream"):
            hdrs["Content-Type"] = mime.decode("utf-8", "replace")
        if name:
            disp = "inline"
            if query.get("dl", "").lower() in ("true", "1"):
                disp = "attachment"
            fname = (name.decode("utf-8", "replace")
                     .replace("\\", "\\\\").replace('"', '\\"'))
            hdrs["Content-Disposition"] = \
                f'{disp}; filename="{fname}"'
        return hdrs, False

    @staticmethod
    def _maybe_range(query: dict, data: bytes, hdrs: dict):
        """Range applies to the response representation (what's being
        sent after gzip/resize decisions), like the reference where
        processRangeRequest wraps the final writeFn."""
        hdrs = {"Accept-Ranges": "bytes", **hdrs}
        rng = rpc.parse_byte_range(query.get("_range_header", ""),
                                   len(data))
        if rng is None:
            return (200, data, hdrs)
        lo, hi = rng
        hdrs["Content-Range"] = f"bytes {lo}-{hi}/{len(data)}"
        return (206, data[lo:hi + 1], hdrs)

    def _ec_read(self, ev: EcVolume, key: int, cookie: int) -> Needle:
        """EC read path with the full distributed ladder (store_ec.go):
        local shard -> remote shard via peers -> on-the-fly reconstruction
        gathering >=10 shard intervals from the cluster.  Returns the
        parsed needle; response shaping lives in _serve_needle."""
        self._ensure_ec_version(ev)
        try:
            _offset, _size, intervals = ev.locate_needle(key)
        except NeedleNotFound as e:
            raise rpc.RpcError(404, str(e)) from None
        try:
            blob = b"".join(self._read_ec_interval(ev, iv)
                            for iv in intervals)
        except Exception as e:  # noqa: BLE001
            raise rpc.RpcError(500, f"{type(e).__name__}: {e}") from None
        n = Needle.from_bytes(blob, ev.version)
        if n.cookie != cookie:
            raise rpc.RpcError(403, "cookie mismatch")
        return n

    def _ensure_ec_version(self, ev: EcVolume) -> None:
        """Resolve the volume version over the cluster when local detection
        can't (no .vif, no local .ec00, <10 local shards): read the
        superblock head of shard 0 from a peer."""
        if ev._version is not None:
            return
        try:
            ev._version = ev._detect_version()
            return
        except Exception:  # noqa: BLE001 — fall through to remote
            pass
        from ..core.super_block import SuperBlock
        for url in self._ec_shard_locations(ev.vid).get(0, []):
            if url == self.url():
                continue
            try:
                head = rpc.call(
                    f"http://{url}/admin/ec/shard_read?volume={ev.vid}"
                    f"&shard=0&offset=0&size=64",
                    headers={**rpc.PRIORITY_LOW,
                             **_flows.tag("ec.gather")})
                ev._version = SuperBlock.from_bytes(bytes(head)).version
                return
            except Exception:  # noqa: BLE001
                continue
        raise rpc.RpcError(
            500, f"cannot determine version of ec volume {ev.vid}")

    @staticmethod
    def _loc_ttl(locs: dict[int, list[str]]) -> float:
        """Freshness tier for a shard-location lookup result, mirroring
        the reference's cachedLookupEcShardLocations tiers
        (store_ec.go:221-229): a set too small to serve reads (<10
        shards) is retried after 11s, an incomplete set after 7m, and a
        full 14-shard map is trusted for 37m."""
        n = len(locs)
        if n < 10:
            return 11.0
        if n < TOTAL_SHARDS:
            return 7 * 60.0
        return 37 * 60.0

    def _ec_shard_locations(self, vid: int,
                            refresh: bool = False) -> dict[int, list[str]]:
        """Shard id -> server urls, cached with tiered freshness."""
        now = time.time()
        hit = self._ec_loc_cache.get(vid)
        if hit and not refresh and now - hit[0] < hit[1]:
            return hit[2]
        locs: dict[int, list[str]] = {}
        try:
            resp = rpc.call(f"{self.master_url}/dir/lookup?volumeId={vid}")
            for sid_str, dns in resp.get("ecShards", {}).items():
                locs[int(sid_str)] = [d["url"] for d in dns]
        except Exception:  # noqa: BLE001 — stale cache beats failing
            if hit:
                return hit[2]
        self._ec_loc_cache[vid] = (now, self._loc_ttl(locs), locs)
        return locs

    def _ec_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        """Shared fan-out pool for degraded EC reads.  Tasks never submit
        nested work, so a bounded pool cannot deadlock."""
        with self._ec_pool_lock:
            if self._ec_read_pool is None:
                self._ec_read_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=32, thread_name_prefix="ec-read")
            return self._ec_read_pool

    def _read_ec_interval(self, ev: EcVolume, interval) -> bytes:
        sid, off = interval.to_shard_id_and_offset(
            ev.large_block_size, ev.small_block_size)
        size = interval.size
        # 1. local shard
        shard = ev.shards.get(sid)
        if shard is not None:
            buf = shard.read_at(off, size)
            if len(buf) == size:
                return buf
        # 2. remote shard holders (failover across every holder, like
        #    readRemoteEcShardInterval walking sourceDataNodes)
        locations = self._ec_shard_locations(ev.vid)
        with trace_span("ec.shard_fetch", vid=ev.vid, shard=sid,
                        size=size):
            data = self._fetch_shard_interval(ev, locations, sid, off,
                                              size)
        if data is not None:
            return data
        # 3. reconstruct from >=10 other shard intervals.
        try:
            return self._reconstruct_shard_interval(ev, sid, off, size)
        except rpc.RpcError:
            # The cached shard map can predate a rebuild or a move (a
            # full map is trusted for 37 min, a partial one for 7): read
            # the master's map now, and the interval once more from
            # where it places the shards.
            fresh = self._ec_shard_locations(ev.vid, refresh=True)
            if fresh == locations:
                # As the failed solve left it: no map, so the next read
                # asks the master at once.
                self._ec_loc_cache.pop(ev.vid, None)
                raise
        data = self._fetch_shard_interval(ev, fresh, sid, off, size)
        if data is not None:
            return data
        return self._reconstruct_shard_interval(ev, sid, off, size)

    def _reconstruct_shard_interval(self, ev: EcVolume, sid: int,
                                    off: int, size: int) -> bytes:
        """One shard interval through the decode path, codec-aware:
        gather the SAME byte range from the codec's planned MINIMAL
        survivor set — the local group for an in-group LRC loss (5
        reads), the first data_shards survivors for RS — widening to
        more siblings only when a planned read fails, and stopping the
        widened fan-out as soon as the erasure pattern solves (the old
        "any >=10" ladder, generalized to pick the cheapest survivor
        set).  Reads fan out in parallel (store_ec.go:322-376 launches
        one goroutine per shard); every gathered byte lands in
        SeaweedFS_ec_repair_read_bytes_total{codec=}.  Shared by the
        degraded read ladder and the scrub's corrupt-block repair."""
        locations = self._ec_shard_locations(ev.vid)
        codec = ev.codec
        with trace_span("ec.reconstruct", vid=ev.vid, shard=sid,
                        size=size, codec=codec.name) as rspan:
            # Pool threads have no thread-local trace context — hand
            # them this span's context explicitly.
            tp = rspan.traceparent() or None
            pool = self._ec_pool()
            t_gather = time.perf_counter()
            candidates = [s for s in range(codec.total_shards)
                          if s != sid]
            have: dict[int, bytes] = {}

            def solvable() -> bool:
                try:
                    codec.decode_matrix(tuple(have), (sid,))
                    return True
                except ValueError:
                    return False

            try:
                plan = codec.repair_plan(tuple(candidates), [sid])[0]
            except ValueError:
                raise rpc.RpcError(
                    500, f"shard {sid} of ec volume {ev.vid} is "
                         f"unrecoverable under codec {codec.name}"
                ) from None
            futs = {
                pool.submit(
                    self._fetch_shard_interval, ev, locations, other,
                    off, size, tp):
                other for other in plan.reads
            }
            for f in concurrent.futures.as_completed(futs):
                buf = f.result()
                if buf is not None:
                    have[futs[f]] = buf
            plan_ok = len(have) == len(plan.reads)
            if not plan_ok and not solvable():
                # A planned read failed: widen to every remaining
                # sibling, stopping as soon as the pattern solves.
                futs = {
                    pool.submit(
                        self._fetch_shard_interval, ev, locations,
                        other, off, size, tp):
                    other for other in candidates
                    if other not in plan.reads
                }
                for f in concurrent.futures.as_completed(futs):
                    buf = f.result()
                    if buf is not None:
                        have[futs[f]] = buf
                        if solvable():
                            break
                for f in futs:
                    f.cancel()
            # Network fan-out cost, separate from the GF solve below.
            gathered_bytes = sum(len(b) for b in have.values())
            observe_ec_stage("shard_gather",
                             time.perf_counter() - t_gather,
                             gathered_bytes)
            ec_repair_read_bytes_total.inc(gathered_bytes,
                                           codec=codec.name)
            if not solvable():
                # The location map let us down — drop it so the next
                # read refreshes immediately instead of waiting out the
                # TTL.
                self._ec_loc_cache.pop(ev.vid, None)
                raise rpc.RpcError(
                    500, f"cannot reconstruct shard {sid}: only "
                         f"{len(have)} shard intervals reachable")
            if plan_ok and plan.local:
                # Degraded read / repair served entirely from the
                # shard's locality group — the LRC payoff.
                emit_event("ec.repair.local", node=self.url(),
                           vid=ev.vid, shard=sid, codec=codec.name,
                           reads=len(have), bytes=gathered_bytes)
            arrs = {k: np.frombuffer(v, dtype=np.uint8)
                    for k, v in have.items()}
            # Execution-fenced device time: a CUDA result is waited for
            # on the stream the coder launched on, a host array needs
            # no fence, so the histogram records real solve time, not
            # launch time.
            t_dev = time.perf_counter()
            rec = ev.coder.reconstruct(arrs, wanted=[sid])
            _fence(rec[sid])
            observe_ec_stage("reconstruct_device",
                             time.perf_counter() - t_dev, size)
            t_stage = time.perf_counter()
            out = host_array(rec[sid]).tobytes()
            observe_ec_stage("host_staging",
                             time.perf_counter() - t_stage, size)
            rspan.set(gathered=len(have))
            return out

    def _fetch_shard_interval(self, ev: EcVolume,
                              locations: dict[int, list[str]],
                              sid: int, off: int, size: int,
                              traceparent: str | None = None
                              ) -> bytes | None:
        """One shard's interval: local file first, then every remote
        holder in turn.  Returns None when no source can serve it.
        `traceparent` carries the caller's trace context across the
        fan-out pool's thread boundary."""
        # Fan-out pool threads carry no flow identity of their own:
        # bind to this server so the gather's out-bytes attribute here
        # (idempotent; handler threads rebind per request anyway).
        _flows.bind_thread(self.url(), "volume")
        local = ev.shards.get(sid)
        if local is not None:
            buf = local.read_at(off, size)
            if len(buf) == size:
                return buf
        me = self.url()
        # Shard gathers are internal traffic (low-priority lane at the
        # holder): a rebuild/degraded-read storm must not starve the
        # holder's user reads.  Flow-attributed as ec.gather — pool
        # worker threads carry no purpose context, so the header rides
        # explicitly.
        hdrs = {**rpc.PRIORITY_LOW, **_flows.tag("ec.gather")}
        if traceparent:
            hdrs["traceparent"] = traceparent
        for url in locations.get(sid, []):
            if url == me:
                continue
            try:
                if _fault.ARMED:
                    _fault.hit("ec.fetch_shard", holder=url,
                               vid=ev.vid, shard=sid)
                data = rpc.call(
                    f"http://{url}/admin/ec/shard_read?volume={ev.vid}"
                    f"&shard={sid}&offset={off}&size={size}",
                    headers=hdrs)
                if len(data) == size:
                    return bytes(data)
            except Exception:  # noqa: BLE001 — try next holder
                continue
        return None

    # -- self-healing repair (the scrub daemon calls back here) --------------

    def _degraded_read(self, v, vid: int, key: int,
                       cookie: int | None, err: Exception) -> Needle:
        """Read-path fallback: a CRC-failing (or unreadable, or
        quarantined) needle triggers the same repair the scrub uses,
        inline, and the request is served the repaired bytes — a
        degraded read, not an error (store_ec.go's degraded ladder
        applied to replication)."""
        emit_event("needle.corrupt", node=self.url(), severity="error",
                   vid=vid, key=f"{key:x}", kind="needle", path="read",
                   error=str(err)[:200])
        n = self._repair_needle_from_replica(v, key)
        if n is None:
            if isinstance(err, CorruptNeedleError):
                # Proven rot with no healthy source: quarantine so the
                # bad bytes are never served, and report degraded.
                if v.quarantine_needle(key, node=self.url()):
                    self._send_heartbeat(full=True)
            raise rpc.RpcError(
                500, f"needle {key:x} corrupt/unreadable and no "
                     f"replica could repair it: {err}")
        if cookie is not None and n.cookie != cookie:
            raise rpc.RpcError(403,
                               f"cookie mismatch for needle {key:x}")
        return n

    def _repair_needle_from_replica(self, v, key: int) -> Needle | None:
        """Fetch the raw CRC-verified record of one needle from a
        healthy sibling replica (/admin/needle_raw — which never
        serves rotten bytes) and rewrite it in place, closing the
        repair ticket.  Returns the healed Needle, or None when no
        replica could supply a sound copy."""
        vid = v.vid
        # May run on the scrub daemon's thread: bind the flow identity.
        _flows.bind_thread(self.url(), "volume")
        try:
            lookup = self._lookup_volume(vid)
        except Exception:  # noqa: BLE001 — master down: cannot locate
            return None
        me = self.url()
        for loc in lookup.get("locations", []):
            url = loc.get("url")
            if not url or url == me:
                continue
            try:
                blob = rpc.call(f"http://{url}/admin/needle_raw?"
                                f"volume={vid}&key={key}",
                                headers={**rpc.PRIORITY_LOW,
                                         **_flows.tag("repair.fetch")})
                n = Needle.from_bytes(bytes(blob), v.version)
            except Exception:  # noqa: BLE001 — next replica
                continue
            if n.id != key:
                continue
            v.repair_needle(n)
            needle_repairs_total.inc(source="replica")
            emit_event("needle.repaired", node=me, vid=vid,
                       key=f"{key:x}", source="replica", replica=url)
            return n
        return None

    def _repair_ec_block(self, ev: EcVolume, sid: int, offset: int,
                         size: int, block_index: int,
                         want_crc: int) -> bool:
        """Reconstruct one corrupt shard block through the EC decode
        path (>=10 sibling shard intervals -> one GF solve on the
        device coder) and pwrite it back in place — ONLY if the
        reconstruction reproduces the recorded checksum.  A wrong
        solve (a second, still-undetected corrupt source shard) must
        leave the original bytes untouched: overwriting a 1-bit flip
        with fresh garbage would destroy evidence a later repair
        round could still use."""
        from ..core.crc import crc32c
        try:
            data = self._reconstruct_shard_interval(ev, sid, offset,
                                                    size)
        except Exception:  # noqa: BLE001 — not enough healthy shards
            return False
        shard = ev.shards.get(sid)
        if shard is None or len(data) != size or \
                crc32c(data) != want_crc:
            return False
        with open(shard.path, "r+b") as f:
            os.pwrite(f.fileno(), data, offset)
            os.fsync(f.fileno())
        needle_repairs_total.inc(source="ec")
        emit_event("needle.repaired", node=self.url(), vid=ev.vid,
                   shard=sid, block=block_index, source="ec",
                   bytes=size)
        return True

    def _admin_scrub(self, query: dict, body: bytes) -> dict:
        """POST /admin/scrub {volume?, repair?}: run one integrity
        sweep now (volume.scrub shell command, tests).  The follow-up
        full heartbeat republishes corrupt counts so /cluster/healthz
        reflects the sweep immediately."""
        req = json.loads(body) if body else {}
        out = self.scrub.scrub_all(repair=bool(req.get("repair")),
                                   vid=req.get("volume"))
        self._send_heartbeat(full=True)
        return out

    def _admin_scrub_status(self, query: dict, body: bytes) -> dict:
        volumes = []
        for loc in self.store.locations:
            for v in loc.volumes.values():
                volumes.append({
                    "id": v.vid, "last_scrub": v.last_scrub,
                    "corrupt_count": v.corrupt_count(),
                    "tickets": sorted(f"{k:x}"
                                      for k in v.repair_tickets)})
        return {"volumes": volumes,
                "ec_corrupt": {str(vid): [list(b) for b in blocks]
                               for vid, blocks in
                               self.scrub.ec_corrupt_snapshot().items()}}

    def _admin_scrub_repair(self, query: dict, body: bytes) -> dict:
        """POST /admin/scrub/repair {volume, key}: targeted repair of
        one needle from a replica — volume.check.disk drives this to
        sync a replica that diverged (missing/rotten needle)."""
        req = json.loads(body)
        v = self.store.find_volume(req["volume"])
        if v is None:
            raise rpc.RpcError(404,
                               f"volume {req['volume']} not here")
        key = int(req["key"])
        n = self._repair_needle_from_replica(v, key)
        if n is None:
            raise rpc.RpcError(
                500, f"needle {key:x}: no replica could supply a "
                     f"healthy copy")
        self._send_heartbeat(full=True)
        return {"volume": v.vid, "key": f"{key:x}",
                "size": len(n.data)}

    def _admin_needle_raw(self, query: dict, body: bytes):
        """GET /admin/needle_raw?volume=&key=: the raw CRC-verified
        record bytes of one live needle — what a sibling pulls to heal
        its copy.  Never serves rotten bytes: a local CRC failure is a
        503, so replica repair cannot propagate corruption."""
        vid = int(query["volume"])
        v = self.store.find_volume(vid)
        if v is None:
            raise rpc.RpcError(404, f"volume {vid} not on this server")
        try:
            blob = v.read_needle_blob(int(query["key"]))
        except NotFoundError as e:
            raise rpc.RpcError(404, str(e)) from None
        except (CorruptNeedleError, OSError) as e:
            raise rpc.RpcError(503, str(e)) from None
        return (200, blob,
                {"Content-Type": "application/octet-stream",
                 "X-Volume-Version": str(v.version)})

    # -- cross-cluster replication (standby receive + surfaces) --------------

    def _replication_watermark(self, v):
        """The volume's durable applied-seq watermark (standby side)."""
        from ..replication.rlog import Watermark
        with self._replication_apply_lock:
            wm = self._replication_applied.get(v.vid)
            if wm is None:
                wm = Watermark(v.file_name() + ".rap")
                self._replication_applied[v.vid] = wm
        return wm

    def _replication_apply(self, query: dict, body: bytes) -> dict:
        """POST /admin/replication/apply — one shipped change-log
        batch from the primary.  Idempotent by (needle id, cookie,
        seq): records at or below the durable applied watermark are
        skipped, so duplicated delivery and replayed batches are
        no-ops; records apply in seq order, so a WRITE followed by its
        DELETE converges to the tombstone (a delete never resurrects).
        The ack `{"acked_seq": N}` goes out only after the watermark
        is persisted — the primary advancing on it can never skip a
        record this side might not remember applying.

        Accepted while draining: like ?type=replicate traffic, an
        inbound mirror batch is the tail of writes the PRIMARY already
        committed and acked.

        Geo active/active adds three gates (all 4xx — the sender must
        not treat them as a WAN failure): a zlib `codec` batch is
        inflated first and its raw/wire sizes ride the ack; a batch
        stamped `(cluster_id, epoch)` is fenced against the local
        `.lease` (stale epochs are the old holder talking — 409); and
        a batch whose first NEW seq leaves a gap above the applied
        watermark is refused UNACKED (409), because acking it would
        let reordered delivery skip the missing records forever."""
        import base64
        import zlib
        req = json.loads(body)
        vid = int(req["volume"])
        records = req.get("records", [])
        raw_bytes = wire_bytes = 0
        if req.get("codec") == "zlib":
            comp = base64.b64decode(req.get("records_z") or "")
            wire_bytes = len(comp)
            try:
                raw = zlib.decompress(comp)
            except zlib.error as e:
                raise rpc.RpcError(
                    400, f"volume {vid}: bad zlib batch: {e}") \
                    from None
            raw_bytes = len(raw)
            records = json.loads(raw)
        v = self.store.find_volume(vid)
        if v is None:
            # First batch for a volume the standby doesn't host yet:
            # create it (the assign_volume path) and heartbeat so the
            # peer master's /dir/lookup resolves it from now on.  No
            # rlog here — standby mutations arrive FROM a mirror and
            # must not ship back.
            try:
                v = self.store.add_volume(
                    vid, req.get("collection", ""),
                    req.get("replication", "000"), req.get("ttl", ""),
                    version=int(req.get("version", CURRENT_VERSION)))
            except VolumeError:
                v = self.store.find_volume(vid)
                if v is None:
                    raise rpc.RpcError(
                        500, f"cannot host mirrored volume {vid}") \
                        from None
            try:
                self._send_heartbeat(full=True)
            except Exception:  # noqa: BLE001 — master down: lookup
                pass           # resolves after the next pulse
        sender = str(req.get("cluster_id") or "")
        if sender and self.leases is not None:
            # Epoch fence: the geo safety invariant's receive half.
            # A stale-epoch batch is a partitioned old holder still
            # talking — refuse it so two clusters can never both
            # commit a write for this volume.
            reason = self.leases.check_batch(
                vid, sender, int(req.get("epoch", 0)))
            if reason is not None:
                emit_event("lease.fence", node=self.url(),
                           severity="warn", vid=vid, sender=sender,
                           epoch=int(req.get("epoch", 0)),
                           reason=reason)
                raise rpc.RpcError(409, f"volume {vid}: {reason}")
        wm = self._replication_watermark(v)
        applied = skipped = 0
        last = wm.value
        recs_sorted = sorted(records, key=lambda r: r["seq"])
        fresh = [r for r in recs_sorted if int(r["seq"]) > last]
        if fresh and int(fresh[0]["seq"]) > last + 1:
            # Gap above the watermark: batch n+1 arrived before batch
            # n (wan.reorder, or a lost prefix).  Refuse WITHOUT
            # acking — the sender's watermark holds and it re-ships
            # in order.
            raise rpc.RpcError(
                409, f"volume {vid}: gap — first new seq "
                     f"{fresh[0]['seq']} > applied {last} + 1 "
                     f"(reordered batch refused unacked)")
        for rec in recs_sorted:
            seq = int(rec["seq"])
            if seq <= last:
                skipped += 1
                continue
            op = int(rec["op"])
            if op == 1 and rec.get("blob"):  # OP_WRITE
                blob = base64.b64decode(rec["blob"])
                try:
                    n = Needle.from_bytes(blob, v.version)  # CRC gate
                except ValueError as e:
                    raise rpc.RpcError(
                        400, f"volume {vid} seq {seq}: {e}") from None
                v.write_needle(n, journal=False)
            elif op == 2:  # OP_DELETE — tombstones ALWAYS apply
                v.delete_needle(int(rec["needle_id"]), journal=False)
            # OP_VACUUM and blobless WRITEs advance the watermark only.
            last = seq
            applied += 1
        wm.set(last)
        out = {"acked_seq": last, "applied": applied,
               "skipped": skipped}
        if req.get("codec") == "zlib":
            # Per-batch compression accounting rides the ack: the
            # sender's shipped{raw,wire} totals and the geo bench's
            # compressed-vs-raw WAN spend both come from here.
            out["raw_bytes"] = raw_bytes
            out["wire_bytes"] = wire_bytes
        return out

    def _replication_pause(self, query: dict, body: bytes) -> dict:
        if self.shipper is None:
            raise rpc.RpcError(400, "no -replicate.peer configured")
        self.shipper.paused = True
        return {"paused": True}

    def _replication_resume(self, query: dict, body: bytes) -> dict:
        if self.shipper is None:
            raise rpc.RpcError(400, "no -replicate.peer configured")
        self.shipper.paused = False
        self.shipper.kick()
        return {"paused": False}

    def _debug_replication(self, query: dict, body: bytes) -> dict:
        """GET /debug/replication — both sides of the mirror on one
        surface: the shipper's per-volume watermarks/lag (primary
        role) and the per-volume applied seqs (standby role)."""
        doc: dict = {"node": self.url(), "role": []}
        if self.shipper is not None:
            doc["role"].append("primary")
            doc["shipper"] = self.shipper.status()
            doc["rlog"] = {}
            for loc in self.store.locations:
                for v in list(loc.volumes.values()):
                    if v.rlog is not None:
                        doc["rlog"][str(v.vid)] = v.rlog.status()
        with self._replication_apply_lock:
            applied = {str(vid): wm.value for vid, wm in
                       self._replication_applied.items()}
        if applied:
            doc["role"].append("standby")
        doc["applied"] = applied
        if self.leases is not None:
            doc["cluster_id"] = self.geo_cluster_id
            doc["leases"] = self.leases.snapshot()
        return doc

    def _lease_status(self, query: dict, body: bytes) -> dict:
        """GET /admin/lease/status[?volume=V] — this node's lease
        table: per-volume `{cluster_id, epoch, acquired_ts,
        holder_is_local, moving}` rows.  The peer's shipper reads this
        on a 409 fence to adopt the authoritative epoch."""
        if self.leases is None:
            return {"node": self.url(), "cluster_id": None,
                    "leases": {}}
        rows = self.leases.snapshot()
        if query.get("volume"):
            want = str(int(query["volume"]))
            rows = {k: v for k, v in rows.items() if k == want}
        return {"node": self.url(),
                "cluster_id": self.geo_cluster_id, "leases": rows}

    def _lease_acquire(self, query: dict, body: bytes) -> dict:
        """POST /admin/lease/acquire {volume, cluster_id?, epoch?} —
        fence `cluster_id` (default: this cluster) as the volume's
        holder.  Epoch defaults to one past what this node knows, so a
        bare acquire always fences prior holders; an explicit epoch is
        the transfer protocol's second half (the new holder adopting
        the epoch the old holder demoted at).  Monotonic: a stale
        epoch is a no-op returning the current lease."""
        if self.leases is None:
            raise rpc.RpcError(
                400, "no -geo.cluster.id configured on this node")
        req = json.loads(body) if body else {}
        vid = int(req.get("volume", query.get("volume", 0)) or 0)
        v = self.store.find_volume(vid)
        if v is None:
            raise rpc.RpcError(404, f"volume {vid} not on this server")
        v.enable_rlog()  # geo volumes always journal
        cluster = str(req.get("cluster_id") or self.geo_cluster_id)
        epoch = int(req["epoch"]) if "epoch" in req \
            else self.leases.epoch(vid) + 1
        lease = self.leases.fence(vid, cluster, epoch)
        emit_event("lease.acquire", node=self.url(), vid=vid,
                   cluster_id=lease.cluster_id, epoch=lease.epoch)
        try:
            self._send_heartbeat(full=True)
        except Exception:  # noqa: BLE001 — master down: the rollup
            pass           # catches up on the next pulse
        out = lease.to_doc()
        out["volume"] = vid
        out["holder_is_local"] = \
            lease.cluster_id == self.geo_cluster_id
        return out

    def _lease_move(self, query: dict, body: bytes) -> dict:
        """POST /admin/lease/move {volume, to, timeout?} — transfer
        the write lease to cluster `to`.  The order IS the safety
        argument: (1) refuse new local writes (`begin_move`), (2)
        drain — kick the shipper until the rlog has nothing pending,
        (3) DEMOTE FIRST: fence ourselves out by writing `to` at
        epoch+1 into our own sidecar, (4) best-effort tell the peer to
        acquire at that exact epoch.  A partition between (3) and (4)
        leaves NO holder — writes 503 everywhere until heal (the peer
        also learns the new epoch from the next shipped batch) —
        fail-closed, never split-brained.  A drain timeout aborts
        BEFORE step 3: the lease did not move."""
        if self.leases is None:
            raise rpc.RpcError(
                400, "no -geo.cluster.id configured on this node")
        if self.shipper is None:
            raise rpc.RpcError(
                400, "no -replicate.peer configured (cannot drain or "
                     "reach the target cluster)")
        req = json.loads(body) if body else {}
        vid = int(req.get("volume", 0) or 0)
        to = str(req.get("to") or "")
        if not to or to == self.geo_cluster_id:
            raise rpc.RpcError(
                400, f"bad target cluster {to!r} (want the peer's "
                     f"-geo.cluster.id, not our own)")
        v = self.store.find_volume(vid)
        if v is None:
            raise rpc.RpcError(404, f"volume {vid} not on this server")
        if not self.leases.is_holder(vid):
            raise rpc.RpcError(
                409, f"volume {vid}: lease held by "
                     f"{self.leases.holder(vid)} at epoch "
                     f"{self.leases.epoch(vid)} — not ours to move")
        v.enable_rlog()
        old_epoch = self.leases.epoch(vid)
        timeout = float(req.get("timeout", 10.0) or 10.0)
        deadline = time.monotonic() + timeout
        self.leases.begin_move(vid)
        try:
            # Drain: every committed write must reach the new holder
            # BEFORE it takes over, or the epoch fence would orphan
            # the tail.  begin_move already refuses new writes, so
            # pending() is strictly decreasing from here.
            while v.rlog is not None and v.rlog.pending() > 0:
                if time.monotonic() > deadline:
                    raise rpc.RpcError(
                        503, f"volume {vid}: drain timed out with "
                             f"{v.rlog.pending()} records pending — "
                             f"lease NOT moved",
                        headers={"Retry-After": "1"})
                self.shipper.kick()
                time.sleep(0.02)
        except rpc.RpcError:
            self.leases.abort_move(vid)
            raise
        target = self.shipper._resolve_target(vid)
        new_epoch = old_epoch + 1
        # DEMOTE FIRST (fence() also clears the moving flag): from
        # this instant we forward writes instead of committing them.
        self.leases.fence(vid, to, new_epoch)
        peer_acquired = False
        if target is not None:
            try:
                rpc.call_json(
                    f"http://{target}/admin/lease/acquire",
                    payload={"volume": vid, "cluster_id": to,
                             "epoch": new_epoch})
                peer_acquired = True
            except (rpc.RpcError, OSError, ConnectionError):
                pass  # the peer adopts the epoch from the data path
        emit_event("lease.move", node=self.url(), vid=vid,
                   to=to, epoch=new_epoch,
                   peer_acquired=peer_acquired)
        try:
            self._send_heartbeat(full=True)
        except Exception:  # noqa: BLE001
            pass
        out = {"volume": vid, "to": to, "epoch": new_epoch,
               "peer_acquired": peer_acquired}
        if not peer_acquired:
            out["warning"] = (
                "target cluster not reachable for the explicit "
                "acquire; it adopts the new epoch from the next "
                "shipped batch (writes 503 there until then)")
        return out

    def _debug_hot(self, query: dict, body: bytes) -> dict:
        """GET /debug/hot — heavy-hitter snapshot: top-k hot volumes,
        needles, and client IPs by read/write (stats/hotkeys.py).
        ?k=N sizes the lists; ?reset=1 clears the counters (a new
        observation window starts)."""
        try:
            k = int(query.get("k", 16) or 16)
        except ValueError:
            raise rpc.RpcError(400, "k must be a number") from None
        if query.get("reset") == "1":
            self.hot.clear()
        out = self.hot.snapshot(k=k)
        out["node"] = self.url()
        return out

    def _debug_tenants(self, query: dict, body: bytes) -> dict:
        """GET /debug/tenants — this node's live per-tenant ledger:
        stored bytes/objects by (tenant, collection) plus the sliding
        req/s and read/write bytes/s meters."""
        out = self.usage.snapshot()
        out["node"] = self.url()
        out["admission"] = self.server.admission.snapshot()
        return out

    def _debug_device(self, query: dict, body: bytes) -> dict:
        """GET /debug/device — the device roofline plane: probed
        peaks, per-kernel achieved-fraction table, recent invocations,
        pipeline occupancy gantts with bubble attribution, the
        analytic-vs-measured byte conservation verdict, and the
        devices' memory stats."""
        return _roofline.debug_doc(self.url(), "volume")

    def _ui(self, query: dict, body: bytes):
        """Status page (the reference's volume UI, server/volume_ui)."""
        from html import escape as esc
        rows = []
        for loc in self.store.locations:
            for v in list(loc.volumes.values()):
                rows.append(
                    f"<tr><td>{v.vid}</td>"
                    f"<td>{esc(v.collection) or '-'}</td>"
                    f"<td>{v.content_size() / 1e6:.1f}MB</td>"
                    f"<td>{v.file_count()}</td>"
                    f"<td>{'ro' if v.readonly else 'rw'}</td></tr>")
        ec_rows = "".join(
            f"<tr><td>{vid}</td><td>{sorted(ev.shards)}</td></tr>"
            for vid, ev in sorted(self.ec_volumes.items()))
        html = (
            "<!doctype html><title>seaweedfs-tpu volume</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
            "padding:4px 8px}</style>"
            f"<h1>Volume server {self.url()}</h1>"
            f"<p>master: {esc(self.master_url)} &middot; "
            f"rack: {esc(self.rack)} &middot; "
            f"dc: {esc(self.data_center)}</p>"
            "<h2>Volumes</h2><table><tr><th>id</th><th>collection</th>"
            "<th>size</th><th>files</th><th>mode</th></tr>"
            + "".join(rows) + "</table>"
            + ("<h2>EC volumes</h2><table><tr><th>id</th>"
               "<th>local shards</th></tr>" + ec_rows + "</table>"
               if ec_rows else "")
            + "<p><a href='/admin/status'>JSON status</a> &middot; "
              "<a href='/metrics'>metrics</a></p>")
        return (200, html.encode(),
                {"Content-Type": "text/html; charset=utf-8"})

    def _check_write_jwt(self, path: str, query: dict) -> None:
        """JWT gate on the write path (volume_server_handlers.go
        maybeCheckJwtAuthorization).  Replicated writes are NOT exempt:
        the fan-out forwards the original client's jwt query param and
        each replica re-verifies it, matching store_replicate.go which
        forwards the JWT and still runs the auth check on replicas."""
        if not self.guard.signing_key:
            return
        from ..utils.security import JwtError
        fid = urllib.parse.unquote(path.lstrip("/"))
        try:
            self.guard.check_jwt(query.get("jwt", ""), fid)
        except JwtError as e:
            raise rpc.RpcError(401, f"jwt: {e}") from None

    def _refuse_if_draining(self, query: dict) -> None:
        """Draining servers take no NEW writes: 503 + Retry-After
        rides the client's RetryPolicy/re-assign machinery, and the
        master is already steering assignments away.  Replica fan-outs
        (?type=replicate) stay accepted — they are the tail of an
        operation a sibling already committed, and refusing a
        tombstone's propagation would leave this node resurrecting the
        needle after its restart.  Reads keep flowing until the
        process exits."""
        if self.draining and query.get("type") != "replicate":
            raise rpc.RpcError(
                503, f"volume server {self.url()} is draining",
                headers={"Retry-After": "1"})

    def _forward_if_not_holder(self, path: str, query: dict,
                               body: bytes, method: str,
                               vid: int) -> dict | None:
        """Geo write fencing at the door: a write landing at a
        non-holder cluster NEVER commits locally — it forwards to the
        lease holder's volume server (resolved through the peer
        master, like a shipped batch) and relays the holder's answer.
        Intra-cluster replica fan-outs (?type=replicate) are exempt:
        they are the tail of a write the local holder-check already
        admitted.  A forward that cannot reach a writable holder
        fails CLOSED with 503 + Retry-After — during a partition or a
        mid-move window the volume is unavailable for writes, never
        split-brained."""
        if self.leases is None or query.get("type") == "replicate" \
                or self.leases.is_holder(vid):
            return None
        holder = self.leases.holder(vid)
        if query.get("geo") == "fwd":
            # Already a forward (both sides think the other holds —
            # a contested or mid-move lease): refuse instead of
            # bouncing the write between clusters forever.
            raise rpc.RpcError(
                503, f"volume {vid}: no writable lease holder "
                     f"(lease contested or mid-move, epoch "
                     f"{self.leases.epoch(vid)})",
                headers={"Retry-After": "1"})
        target = self.shipper._resolve_target(vid) \
            if self.shipper is not None else None
        if target is None:
            raise rpc.RpcError(
                503, f"volume {vid}: lease held by cluster "
                     f"{holder}, no route to it from here",
                headers={"Retry-After": "1"})
        fwd = {k: v for k, v in query.items()
               if not k.startswith("_")}
        fwd["geo"] = "fwd"
        qs = urllib.parse.urlencode(fwd)
        hdrs = dict(_flows.tag("replicate.fanout"))
        if "gzip" in query.get("_content_encoding", ""):
            hdrs["Content-Encoding"] = "gzip"
        try:
            out = rpc.call(f"http://{target}{path}?{qs}", method,
                           body, headers=hdrs)
        except rpc.RpcError as e:
            if e.status < 500:
                raise  # the holder's own verdict (quota, jwt, 404…)
            raise rpc.RpcError(
                503, f"volume {vid}: lease holder {holder} "
                     f"unreachable ({e.message})",
                headers={"Retry-After": "1"}) from None
        return out if isinstance(out, dict) else {}

    def _post_needle(self, path: str, query: dict, body: bytes) -> dict:
        self._check_write_jwt(path, query)
        self._refuse_if_draining(query)
        vid, key, cookie = self._parse_fid_path(path)
        tenant, client = self._principal(query)
        self.hot.write(vid, key, client, tenant)
        if _fault.ARMED:
            _fault.hit("volume.write", vid=vid, server=self.url())
        v = self.store.find_volume(vid)
        if v is None:
            raise rpc.RpcError(404, f"volume {vid} not on this server")
        fwd = self._forward_if_not_holder(path, query, body, "POST",
                                          vid)
        if fwd is not None:
            return fwd
        mime = query.get("mime", query.get("_content_type", ""))
        gzipped = "gzip" in query.get("_content_encoding", "")
        if mime == "image/jpeg" and not gzipped and \
                query.get("type") != "replicate":
            # EXIF auto-orientation on JPEG upload (needle.go:100-105);
            # replicas receive the already-fixed bytes.
            from ..images import fix_jpeg_orientation
            body = fix_jpeg_orientation(body)
        n = Needle(cookie=cookie, id=key, data=body)
        if gzipped:
            # Pre-compressed upload (needle_parse_upload.go): store the
            # gzip bytes as-is and remember it in the needle flags so
            # reads can negotiate.
            n.set_is_compressed()
        if "name" in query:
            n.set_name(query["name"].encode())
        if "mime" in query:
            n.set_mime(query["mime"].encode())
        if query.get("ttl"):
            # Stamp the assign-time ?ttl on the needle itself
            # (needle_parse_upload.go): expiry then survives a copy
            # into a volume whose superblock says something else.
            from ..core.ttl import TTL as _TTL
            try:
                n.set_ttl(_TTL.parse(query["ttl"]))
            except ValueError:
                pass
        n.set_last_modified(int(time.time()))
        # Rollback applies only to a BRAND-NEW needle: for an overwrite
        # of an existing fid, deleting would tombstone the prior
        # committed version everywhere — turning a failed update into
        # data loss.  (Lock-free peek, same as the read path's.)
        existed = v.nm.get(key) is not None
        # Like store_replicate.go:37-44: writes hit the OS page cache
        # only, unless the request opts into durability with
        # ?fsync=true (the flag is forwarded to replicas in _replicate
        # so every copy honors it).
        try:
            _offset, size = self.store.write_needle(
                vid, n, fsync=self.fsync_writes or
                query.get("fsync") == "true")
        except DiskFullError as e:
            # ENOSPC: the volume rolled the partial record back and
            # flipped readonly.  Flip the rest of the breached
            # location's volumes too (the reserve check sees free==0)
            # and heartbeat so the master re-steers immediately; the
            # client re-assigns on the 500.
            self.store.check_disk_reserve()
            try:
                self._send_heartbeat(full=True)
            except Exception:  # noqa: BLE001
                pass
            raise rpc.RpcError(500, str(e)) from None
        if query.get("type") != "replicate":
            try:
                self._replicate(path, query, body, "POST", vid=vid,
                                v=v, undo_new=not existed)
            except Exception:
                # All-or-fail means ALL-or-fail: a partial fan-out must
                # not leak the locally-committed copy (the client was
                # told the write failed and will re-assign; an orphan
                # here would survive as an unowned needle).  _replicate
                # already undid the siblings that succeeded.
                if not existed:
                    try:
                        self.store.delete_needle(vid, key)
                    except Exception:  # noqa: BLE001 — best effort
                        pass
                raise
        # Usage accounting: replica copies account on their own server
        # (the ?type=replicate leg lands here too), so the master's
        # rollup counts bytes the way the disks do — per copy.  An
        # overwrite keeps the object count; the superseded bytes are
        # reclaimed by the delete/vacuum decrement path.
        self.usage.add(tenant, v.collection, len(body),
                       nobjects=0 if existed else 1, vid=vid)
        self.usage.note_request(tenant, written_bytes=len(body))
        return {"size": len(body), "eTag": f"{n.checksum:08x}"}

    def _delete_needle(self, path: str, query: dict, body: bytes) -> dict:
        self._check_write_jwt(path, query)
        self._refuse_if_draining(query)
        vid, key, _cookie = self._parse_fid_path(path)
        tenant, client = self._principal(query)
        self.hot.write(vid, key, client, tenant)
        v = self.store.find_volume(vid)
        if v is None:
            if vid in self.ec_volumes:
                return self._delete_ec_needle(vid, key, path, query)
            raise rpc.RpcError(404, f"volume {vid} not on this server")
        fwd = self._forward_if_not_holder(path, query, b"", "DELETE",
                                          vid)
        if fwd is not None:
            return fwd
        freed = self.store.delete_needle(vid, key)
        if freed > 0:
            # Deletes decrement at tombstone time (not vacuum time):
            # quota headroom comes back the moment the user deletes,
            # even though the disk bytes wait for compaction.
            self.usage.remove(tenant, v.collection, freed, 1, vid=vid)
        self.usage.note_request(tenant)
        if query.get("type") != "replicate":
            self._replicate(path, query, b"", "DELETE")
        return {"size": freed}

    def _delete_ec_needle(self, vid: int, key: int, path: str,
                          query: dict) -> dict:
        """DELETE of a needle on an erasure-coded volume (the port's;
        the reference answers 404, so a deleted file's chunks on an EC
        volume stay live): tombstone it in this holder's .ecx (and
        .ecj), then in every other shard holder's, each of which keeps
        its own .ecx.  A holder that does not answer keeps its copy
        until it is rebuilt from a live one.  Answers the needle's
        stored size, 0 when it was already gone."""
        ev = self.ec_volumes[vid]
        ev.refresh_index()
        try:
            _off, freed, _intervals = ev.locate_needle(key)
        except NeedleNotFound:
            freed = 0
        ev.delete_needle(key)
        if query.get("type") != "replicate":
            me = self.url()
            holders = {u for urls in self._ec_shard_locations(
                vid, refresh=True).values() for u in urls} - {me}
            for url in sorted(holders):
                try:
                    rpc.call(f"http://{url}{path}?type=replicate", "DELETE",
                             headers=rpc.PRIORITY_LOW)
                except Exception:  # noqa: BLE001 — dead holder, above
                    pass
        return {"size": freed}

    def _replicate(self, path: str, query: dict, body: bytes,
                   method: str, vid: int | None = None, v=None,
                   undo_new: bool = False) -> None:
        """Fan out to sibling replicas (all-or-fail, store_replicate.go).
        Callers that already resolved the fid/volume pass them in so the
        single-copy fast path costs no extra parse or lookup.
        undo_new=True (a POST of a needle that did not exist before)
        deletes the copies that DID land when the fan-out partially
        fails, so a failed write leaves zero orphans."""
        if vid is None:
            vid = self._parse_fid_path(path)[0]
            v = self.store.find_volume(vid)
        if v is not None and \
                v.super_block.replica_placement.copy_count() == 1:
            # Single-copy volumes have no siblings; skip the master
            # lookup entirely (store_replicate.go consults the volume's
            # own replica placement the same way) — this is one master
            # RPC saved per write on the hot path.
            return
        try:
            lookup = self._lookup_volume(vid)
        except Exception:  # noqa: BLE001 — master unreachable: the local
            return         # write stands; repair catches divergence later
        errors = []
        ok_urls = []
        threads = []
        me = self.url()
        # Preserve the original query (name/mime/...) so replica needle
        # bytes are identical to the primary's.  Reserved _keys carry
        # request headers, not client parameters — strip them.
        fwd = {k: v for k, v in query.items() if not k.startswith("_")}
        fwd["type"] = "replicate"
        qs = urllib.parse.urlencode(fwd)
        # A pre-compressed body must reach replicas with the same
        # Content-Encoding so their needle flags match the primary's.
        hdrs = {"Content-Encoding": "gzip"} \
            if "gzip" in query.get("_content_encoding", "") else None

        with trace_span("volume.replicate", vid=vid,
                        method=method) as rspan:
            # Sends run on fresh threads where the thread-local trace
            # context is empty: capture the fan-out span's context here
            # and pass it explicitly so each replica's server span
            # parents under it.
            tp = rspan.traceparent()
            # Replication fan-out is internal traffic: the sibling's
            # admission control routes it through the low-priority
            # lane so a replication surge can't starve its user reads.
            send_hdrs = dict(hdrs or {}, **rpc.PRIORITY_LOW,
                             **_flows.tag("replicate.fanout"))
            if tp:
                send_hdrs["traceparent"] = tp

            def send(url):
                # Fresh thread: no flow identity — bind so the
                # fan-out bytes attribute to this server.
                _flows.bind_thread(me, "volume")
                try:
                    if _fault.ARMED:
                        _fault.hit("volume.replicate", replica=url,
                                   vid=vid)
                    rpc.call(f"http://{url}{path}?{qs}", method, body,
                             headers=send_hdrs or None)
                    ok_urls.append(url)
                except Exception as e:  # noqa: BLE001
                    errors.append(f"{url}: {e}")

            for loc in lookup.get("locations", []):
                if loc["url"] == me:
                    continue
                th = threading.Thread(target=send, args=(loc["url"],))
                th.start()
                threads.append(th)
            for th in threads:
                th.join()
            rspan.set(replicas=len(threads), errors=len(errors))
            if errors:
                # A cached location just failed: evict so the next write
                # re-resolves immediately instead of failing for the TTL.
                self._vol_loc_cache.pop(vid, None)
                if method == "POST" and undo_new:
                    # The failed NEW write is being undone everywhere —
                    # siblings below, the local copy by the caller.
                    emit_event("replication.rollback", node=me,
                               severity="warn", vid=vid,
                               committed_siblings=len(ok_urls),
                               failed=len(errors))
                if method == "POST" and ok_urls and undo_new:
                    # Partial fan-out of a NEW needle: undo the sibling
                    # copies that DID land, so an all-or-fail failure
                    # leaves zero orphaned needles anywhere (the caller
                    # undoes the local copy).  Best effort — a sibling
                    # that just took the write is alive enough to take
                    # the delete.  Overwrites are never undone: a
                    # delete would tombstone the prior version.
                    for url in ok_urls:
                        try:
                            rpc.call(f"http://{url}{path}?{qs}",
                                     "DELETE",
                                     headers=_flows.tag(
                                         "replicate.fanout"))
                        except Exception:  # noqa: BLE001
                            pass
                raise rpc.RpcError(500, "replication failed: " +
                                   "; ".join(errors))

    # -- admin handlers ------------------------------------------------------

    def _admin_status(self, query: dict, body: bytes) -> dict:
        volumes = []
        for loc in self.store.locations:
            for v in loc.volumes.values():
                volumes.append({
                    "id": v.vid, "collection": v.collection,
                    "size": v.dat_size(), "file_count": v.file_count(),
                    "garbage_ratio": v.garbage_ratio(),
                    "read_only": v.readonly,
                })
        from ..stats.sysstats import proc_cpu_seconds
        return {"volumes": volumes,
                "ec_volumes": [
                    {"id": vid, "shards": sorted(ev.shards)}
                    for vid, ev in self.ec_volumes.items()],
                "cpu_seconds": proc_cpu_seconds(),
                "pid": os.getpid()}

    def _admin_assign_volume(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        self.store.add_volume(
            req["volume"], req.get("collection", ""),
            req.get("replication", "000"), req.get("ttl", ""))
        self._send_heartbeat()
        return {}

    def _admin_delete_volume(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        self.store.delete_volume(req["volume"])
        # Whole-volume teardown: subtract everything the volume still
        # held from the tenant ledger (the per-needle decrement path
        # never saw these).
        self.usage.drop_volume(req["volume"])
        self._send_heartbeat()
        return {}

    def _admin_leave(self, query: dict, body: bytes) -> dict:
        """VolumeServerLeave: stop heartbeating so the master's dead-node
        sweep drains this server (reads keep being served until the
        process actually stops)."""
        self._stop.set()
        return {"leaving": True}

    # -- graceful lifecycle ---------------------------------------------------

    def _admin_drain(self, query: dict, body: bytes) -> dict:
        """POST /admin/drain [{grace}]: enter draining mode and block
        until in-flight requests finish (or grace expires), then say
        goodbye to the master.  The route is admission-exempt, so the
        drain request itself never deadlocks the in-flight wait."""
        req = json.loads(body) if body else {}
        grace = float(req.get("grace", self.shutdown_grace))
        return self.drain(grace)

    def drain(self, grace: float | None = None) -> dict:
        """Graceful shutdown, phase one (SIGTERM / /admin/drain /
        cluster.drain): refuse new writes with 503 + Retry-After (the
        client's RetryPolicy fails over / re-assigns), finish in-flight
        requests up to `grace` seconds, then send a goodbye heartbeat
        so the master unregisters this node IMMEDIATELY — no heartbeat
        blackout, no dead-sweep window.  Reads keep being served until
        the process actually exits (stop())."""
        grace = self.shutdown_grace if grace is None else grace
        with self._drain_lock:
            if self.draining:
                return {"draining": True, "already": True}
            self.draining = True
        emit_event("node.draining", node=self.url(), severity="warn",
                   grace=grace)
        try:
            # Publish the draining flag right away: the master stops
            # assigning writes here while we wait out the in-flight.
            self._send_heartbeat(full=True)
        except Exception:  # noqa: BLE001 — master down: drain anyway
            pass
        adm = self.server.admission
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            if adm.inflight_total() == 0:
                break
            time.sleep(0.02)
        # Stop the pulse loop BEFORE the goodbye so a periodic beat
        # can't race it and re-register this node post-goodbye (the
        # master also ignores stale beats from a goodbyed epoch).
        self._stop.set()
        self._send_goodbye()
        return {"draining": True,
                "inflight": adm.inflight_total()}

    def _send_goodbye(self) -> None:
        """Final heartbeat: the master unregisters this node now
        instead of waiting for the dead-node sweep to notice the
        heartbeat blackout."""
        hb = {"ip": self.server.host, "port": self.server.port,
              "goodbye": True, "seq_epoch": self._hb_epoch}
        try:
            rpc.call(f"{self.master_url}/heartbeat", "POST",
                     json.dumps(hb).encode(), timeout=5.0)
        except Exception:  # noqa: BLE001 — master down: its dead-node
            pass           # sweep remains the fallback

    def _admin_readonly(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        self.store.mark_volume_readonly(req["volume"],
                                        req.get("readonly", True))
        emit_event("volume.readonly", node=self.url(),
                   vid=req["volume"],
                   readonly=req.get("readonly", True))
        self._send_heartbeat(full=True)
        return {}

    def _admin_configure_replication(self, query: dict,
                                     body: bytes) -> dict:
        """VolumeConfigure (volume_grpc_admin.go:104): rewrite the
        superblock's replica placement; the follow-up full heartbeat
        re-registers the volume under its new layout."""
        req = json.loads(body)
        try:
            self.store.configure_volume(req["volume"],
                                        req["replication"])
        except (VolumeError, ValueError) as e:
            raise rpc.RpcError(400, str(e)) from None
        self._send_heartbeat(full=True)
        return {}

    def _admin_vacuum(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        v = self.store.find_volume(req["volume"])
        if v is None:
            raise rpc.RpcError(404, f"volume {req['volume']} not here")
        before = v.garbage_ratio()
        vacuum_volume(v)
        return {"garbage_ratio_before": before,
                "garbage_ratio_after": v.garbage_ratio()}

    # -- EC admin ------------------------------------------------------------

    _VOLUME_EXT = re.compile(r"\.(ec\d\d|ecx|ecj|vif|dat)$")

    def _volume_base(self, vid: int) -> str:
        v = self.store.find_volume(vid)
        if v is not None:
            return v.file_name()
        # Look for loose files (shards without a mounted volume),
        # accepting only well-formed volume extensions — a glob like
        # `1.ec*` also matches in-flight temp files (`1.ec01.part`),
        # and deriving the base from one corrupts every later write.
        for loc in self.store.locations:
            for name in (str(vid), f"*_{vid}"):
                import glob as _glob
                hits = _glob.glob(os.path.join(loc.directory,
                                               name + ".ec*")) + \
                    _glob.glob(os.path.join(loc.directory, name + ".ecx")) \
                    + _glob.glob(os.path.join(loc.directory, name + ".dat"))
                for hit in hits:
                    m = self._VOLUME_EXT.search(hit)
                    if m:
                        return hit[:m.start()]
        return os.path.join(self.store.locations[0].directory, str(vid))

    def _ec_total_shards(self, vid: int, base: str | None = None) -> int:
        """Shard-file count of an EC volume, codec-derived (mounted
        EcVolume first, then the on-disk .vif) — a mixed-codec cluster
        must not assume RS(10,4)'s 14 everywhere."""
        ev = self.ec_volumes.get(vid)
        if ev is not None:
            return ev.codec.total_shards
        from ..ec.volume_info import ec_codec_name
        try:
            return get_codec(
                ec_codec_name(base or self._volume_base(vid))).total_shards
        except ValueError:
            return TOTAL_SHARDS

    def _ec_generate(self, query: dict, body: bytes) -> dict:
        """VolumeEcShardsGenerate: .dat -> shard files + .ecx + .vif.
        The codec comes from the request ("codec": "lrc"), else the
        server's -ec.codec default; it is persisted in the .vif so
        every later mount/rebuild picks the matching matrices."""
        req = json.loads(body)
        vid = req["volume"]
        codec = get_codec(req.get("codec") or self.ec_codec)
        v = self.store.find_volume(vid)
        if v is None:
            raise rpc.RpcError(404, f"volume {vid} not here")
        v.set_readonly(True)
        emit_event("volume.readonly", node=self.url(), vid=vid,
                   readonly=True, reason="ec.generate")
        v.sync()
        base = v.file_name()
        dat_bytes = v.dat_size()
        emit_event("ec.encode.start", node=self.url(), vid=vid,
                   dat_bytes=dat_bytes, codec=codec.name)
        t0 = time.perf_counter()
        try:
            write_sorted_file_from_idx(base)
            write_ec_files(base, codec=codec.name, device=self.device)
        except Exception as e:
            emit_event("ec.encode.finish", node=self.url(),
                       severity="error", vid=vid,
                       seconds=round(time.perf_counter() - t0, 6),
                       error=f"{type(e).__name__}: {e}")
            raise
        from ..ec.volume_info import save_volume_info
        save_volume_info(base, v.version, codec=codec.name)
        emit_event("ec.encode.finish", node=self.url(), vid=vid,
                   seconds=round(time.perf_counter() - t0, 6),
                   dat_bytes=dat_bytes, shards=codec.total_shards,
                   codec=codec.name)
        return {"shards": list(range(codec.total_shards)),
                "codec": codec.name}

    def _ec_mount(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        vid = req["volume"]
        base = self._volume_base(vid)
        ev = self.ec_volumes.get(vid)
        if ev is None:
            ev = EcVolume(base, vid=vid, device=self.device)
            self.ec_volumes[vid] = ev
        else:
            ev.load_local_shards()
        self._send_heartbeat()
        return {"shards": sorted(ev.shards)}

    def _ec_unmount(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        ev = self.ec_volumes.pop(req["volume"], None)
        if ev is not None:
            ev.close()
        self._send_heartbeat()
        return {}

    def _ec_rebuild(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        vid = req["volume"]
        base = self._volume_base(vid)
        emit_event("ec.rebuild.start", node=self.url(), vid=vid)
        t0 = time.perf_counter()
        try:
            generated = rebuild_ec_files(base, device=self.device)
        except Exception as e:
            emit_event("ec.rebuild.finish", node=self.url(),
                       severity="error", vid=vid,
                       seconds=round(time.perf_counter() - t0, 6),
                       error=f"{type(e).__name__}: {e}")
            raise
        emit_event("ec.rebuild.finish", node=self.url(), vid=vid,
                   seconds=round(time.perf_counter() - t0, 6),
                   rebuilt=generated)
        return {"rebuilt_shards": generated}

    def _ec_delete_shards(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        vid, shard_ids = req["volume"], req["shards"]
        base = self._volume_base(vid)
        ev = self.ec_volumes.get(vid)
        from ..ec.integrity import ShardChecksums, ecc_lock
        with ecc_lock(base):
            ecc = ShardChecksums.load(base)
            for sid in shard_ids:
                ecc.drop_shard(sid)
            ecc.save()
        for sid in shard_ids:
            if ev is not None and sid in ev.shards:
                ev.shards.pop(sid).close()
            try:
                os.remove(base + to_ext(sid))
            except FileNotFoundError:
                pass
        # Last shard gone: unmount and drop the index sidecars too, else a
        # restart re-registers a phantom zero-shard EC volume from the
        # stale .ecx (VolumeEcShardsDelete does the same cleanup).
        if not any(os.path.exists(base + to_ext(s))
                   for s in range(self._ec_total_shards(vid, base))):
            ev = self.ec_volumes.pop(vid, None)
            if ev is not None:
                ev.close()
            for ext in (".ecx", ".ecj", ".vif", ".ecc"):
                try:
                    os.remove(base + ext)
                except FileNotFoundError:
                    pass
        self._send_heartbeat()
        return {}

    def _ec_shard_read(self, query: dict, body: bytes):
        """VolumeEcShardRead: raw bytes from one local shard."""
        vid = int(query["volume"])
        sid = int(query["shard"])
        offset = int(query.get("offset", 0))
        size = int(query.get("size", 0))
        ev = self.ec_volumes.get(vid)
        if ev is None or sid not in ev.shards:
            raise rpc.RpcError(404, f"shard {vid}.{sid} not here")
        return ev.shards[sid].read_at(offset, size)

    def _ec_shard_file(self, query: dict, body: bytes):
        """Stream a whole shard (or .ecx/.ecj) file — the CopyFile RPC."""
        vid = int(query["volume"])
        base = self._volume_base(vid)
        ext = query.get("ext") or to_ext(int(query["shard"]))
        if ext not in (".ecx", ".ecj", ".vif") and not ext.startswith(".ec"):
            raise rpc.RpcError(400, f"bad ext {ext}")
        path = base + ext
        if not os.path.exists(path):
            raise rpc.RpcError(404, f"{os.path.basename(path)} not here")
        return open(path, "rb")  # streamed by the server in 1MB chunks

    def _ec_copy_shard(self, query: dict, body: bytes) -> dict:
        """VolumeEcShardsCopy: pull shard files from a source server."""
        req = json.loads(body)
        vid = req["volume"]
        source = req["source"]  # host:port
        shard_ids = req["shards"]
        base = self._volume_base(vid)
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        from ..ec.integrity import ShardChecksums, ecc_lock
        for sid in shard_ids:
            rpc.call_to_file(f"http://{source}/admin/ec/shard_file?"
                             f"volume={vid}&shard={sid}",
                             base + to_ext(sid),
                             headers={**rpc.PRIORITY_LOW,
                                      **_flows.tag("ec.gather")})
        with ecc_lock(base):
            ecc = ShardChecksums.load(base)
            for sid in shard_ids:
                # The pull replaced the shard bytes: any recorded
                # checksum is stale — drop it so the next scrub
                # fingerprints the fresh copy (trust-on-first-scrub).
                ecc.drop_shard(sid)
            ecc.save()
        if req.get("copy_ecx", False):
            for ext in (".ecx", ".ecj", ".vif"):
                try:
                    rpc.call_to_file(
                        f"http://{source}/admin/ec/shard_file?"
                        f"volume={vid}&ext={ext}", base + ext,
                        headers=_flows.tag("ec.gather"))
                except rpc.RpcError:
                    try:
                        os.remove(base + ext)  # don't leave a 0-byte file
                    except FileNotFoundError:
                        pass
        return {}

    def _ec_receive_shard(self, query: dict, body) -> dict:
        """Push-mode shard install: the batched mesh rebuild
        (parallel/cluster_rebuild.py) decodes centrally and scatters
        rebuilt shards here — the inverse of copy_shard's pull — and the
        batched encode (parallel/cluster_encode.py) scatters its shards
        the same way.

        A push carries the whole shard, or one piece of it: `offset=`
        is where the body lands in the shard and `size=`, on every
        piece, the shard's full length.  Pieces come in order: the first
        (offset 0) starts the temp file afresh, a later one may repeat
        an earlier offset (a retried piece) but never leave a gap.  The
        body streams to the temp file in bounded reads and is never held
        whole.  The push that completes the shard (a whole push at once)
        installs it: fsync, rename to `.ecNN`, its `.ecc` entries, then
        the .ecx/.vif/.ecj sidecars pulled from ?ecx_source= when absent
        so the shard is servable once mounted.  Until then the shard is
        neither visible nor mountable."""
        vid = int(query["volume"])
        sid = int(query["shard"])
        base = self._volume_base(vid)
        if not 0 <= sid < self._ec_total_shards(vid, base):
            raise rpc.RpcError(400, f"bad shard id {sid}")
        whole = "offset" not in query
        try:
            offset = 0 if whole else int(query["offset"])
            size = None if whole else int(query["size"])
        except (KeyError, ValueError):
            raise rpc.RpcError(
                400, "a shard piece needs integer offset= and size=") \
                from None
        if not whole and (offset < 0 or offset > size or (
                body.length is not None and offset + body.length > size)):
            raise rpc.RpcError(
                400, f"piece [{offset}, +{body.length}) outside a shard of "
                     f"{size} bytes")
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        # Temp names must not collide with _volume_base's discovery
        # globs (`<vid>.ec*`) or concurrent receives would mis-derive
        # the base path from a half-written sibling.
        tmp = f"{base}.rcv{sid}.tmp"
        with self._ec_recv_lock:
            slock = self._ec_recv_slocks.setdefault(
                (vid, sid), threading.Lock())
        with slock:
            if offset:
                held = os.path.getsize(tmp) if os.path.exists(tmp) else 0
                if offset > held:
                    raise rpc.RpcError(
                        409, f"piece at {offset} of shard {vid}.{sid}: "
                             f"only {held} bytes received")
            with open(tmp, "r+b" if offset else "wb") as f:
                f.truncate(offset)
                f.seek(offset)
                n = 0
                while True:
                    buf = body.read(_RECEIVE_READ)
                    if not buf:
                        break
                    f.write(buf)
                    n += len(buf)
                if whole:
                    size = n
                if offset + n > size:
                    raise rpc.RpcError(
                        400, f"piece [{offset}, +{n}) outside a shard of "
                             f"{size} bytes")
                if offset + n < size:
                    return {"volume": vid, "shard": sid, "bytes": n,
                            "offset": offset, "size": size,
                            "complete": False}
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, base + to_ext(sid))
        # Per-volume serialization: the shared .ecc sidecar update is
        # load-modify-save, and concurrent receives for the same
        # volume must not lose each other's entries (receives for
        # OTHER volumes shouldn't stall behind this).
        with self._ec_recv_lock:
            vlock = self._ec_recv_vlocks.setdefault(
                vid, threading.Lock())
        from ..ec.integrity import (ShardChecksums, ecc_lock,
                                    file_block_crcs)
        with self._ec_recv_lock:
            pend = self._ec_pending_ecc.get(vid, {}).pop(sid, None)
            if not self._ec_pending_ecc.get(vid):
                self._ec_pending_ecc.pop(vid, None)
        if pend is not None:
            shipped_at, crcs = pend
            pend = crcs if (time.monotonic() - shipped_at
                            < _PENDING_ECC_TTL) else None
        with vlock, ecc_lock(base):
            ecc = ShardChecksums.load(base)
            nblocks = -(-size // ecc.block)
            if pend is not None and len(pend) == nblocks:
                # The encoder shipped this shard's kernel-computed CRCs
                # for THIS push (receive_ecc) — strictly better than
                # fingerprinting the pushed bytes here: they describe
                # the INTENDED bytes, so even wire corruption on the
                # push itself is detectable by the first scrub.  Skip
                # the CPU pass over the shard.  (receive_ecc already
                # merged them into the sidecar; re-assert in case a
                # concurrent writer dropped them.)
                if ecc.get(sid) != pend:
                    ecc.set_shard(sid, pend)
                    ecc.save()
            else:
                # Fingerprint the installed file so the scrub can
                # verify this shard from its first sweep (the pushed
                # bytes ARE the intended content; ec/integrity.py).
                # This also OVERWRITES any stale sidecar entry a prior
                # encode generation left behind.
                ecc.set_shard(sid, file_block_crcs(base + to_ext(sid),
                                                   ecc.block))
                ecc.save()
        source = query.get("ecx_source", "")
        if source:
            with vlock:
                if not os.path.exists(base + ".ecx"):
                    for ext in (".ecx", ".vif", ".ecj"):
                        try:
                            # Sidecars are best-effort: the shard itself
                            # is already durably installed, and a missing
                            # .vif/.ecj is normal.  call_to_file is
                            # atomic (tmp + rename), so failures leave
                            # nothing behind.
                            rpc.call_to_file(
                                f"http://{source}/admin/ec/shard_file?"
                                f"volume={vid}&ext={ext}", base + ext,
                                headers=_flows.tag("ec.gather"))
                        except (rpc.RpcError, OSError):
                            pass
        if whole:
            return {"volume": vid, "shard": sid, "bytes": size}
        return {"volume": vid, "shard": sid, "bytes": n, "offset": offset,
                "size": size, "complete": True}

    def _ec_receive_file(self, query: dict, body: bytes) -> dict:
        """Push-mode sidecar install (.ecx/.vif): the batched mesh
        encode (parallel/cluster_encode.py) builds the sorted index
        centrally and pushes it to every shard holder — for a fresh
        encode there is no existing holder a receive_shard ecx_source
        pull could reach."""
        vid = int(query["volume"])
        ext = query.get("ext", ".ecx")
        if ext not in (".ecx", ".vif"):
            raise rpc.RpcError(400, f"bad ext {ext}")
        base = self._volume_base(vid)
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        # Unique temp per request (cf. receive_shard's per-shard temp
        # names): concurrent .ecx/.vif pushes — or a push racing its
        # own retry — must never interleave in one staging file.
        tmp = (f"{base}.rcvx{ext.lstrip('.')}"
               f".{threading.get_ident()}.tmp")
        try:
            with open(tmp, "wb") as f:
                f.write(body)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, base + ext)
        finally:
            try:
                os.remove(tmp)
            except FileNotFoundError:
                pass
        return {"volume": vid, "ext": ext, "bytes": len(body)}

    def _ec_receive_ecc(self, query: dict, body: bytes) -> dict:
        """Merge kernel-computed `.ecc` entries pushed by the batched
        mesh encode/rebuild BEFORE the shards arrive: the CRCs come
        from the encode kernel's fused CRC32-C output (ops/crc_fold.py)
        — the *intended* bytes — so receive_shard can skip its CPU
        re-read of each pushed payload and divergence anywhere past the
        device (wire, disk) is detectable by the first scrub."""
        vid = int(query["volume"])
        try:
            doc = json.loads(body)
            block = int(doc.get("block", 0))
            raw = doc["shards"]
            if not isinstance(raw, dict):
                raise ValueError("shards must be an object")
            shards = {}
            for sid, crcs in raw.items():
                if not isinstance(crcs, list):
                    # A bare hex string would char-iterate into eight
                    # bogus one-digit CRCs — refuse, don't mangle.
                    raise ValueError(f"shard {sid}: crcs must be a list")
                vals = [int(c, 16) for c in crcs]
                if any(not 0 <= v <= 0xFFFFFFFF for v in vals):
                    # A >32-bit value can never equal a recomputed
                    # crc32c: merged into the sidecar it would make the
                    # first scrub quarantine a healthy shard.
                    raise ValueError(f"shard {sid}: crc out of range")
                shards[int(sid)] = vals
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            raise rpc.RpcError(400, f"bad .ecc fragment: {e}")
        base = self._volume_base(vid)
        total = self._ec_total_shards(vid, base)
        bad = [sid for sid in shards if not 0 <= sid < total]
        if bad:
            raise rpc.RpcError(400, f"bad shard ids {bad}")
        from ..ec.integrity import ShardChecksums, ecc_lock
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        with ecc_lock(base):
            ecc = ShardChecksums.load(base)
            if block and ecc.shards and block != ecc.block:
                raise rpc.RpcError(
                    409, f"block {block} != existing {ecc.block}")
            if block and not ecc.shards:
                ecc.block = block
            for sid, crcs in shards.items():
                ecc.set_shard(sid, crcs)
            ecc.save()
        # Mark the entries claimable by this generation's receive_shard
        # (see _ec_pending_ecc) — a shard push with no pending entry
        # fingerprints its body instead of trusting the sidecar.  Prune
        # expired leftovers (failed pushes) while we hold the lock so
        # the map stays bounded.
        now = time.monotonic()
        with self._ec_recv_lock:
            for v in list(self._ec_pending_ecc):
                entries = self._ec_pending_ecc[v]
                for s in [s for s, (ts, _c) in entries.items()
                          if now - ts >= _PENDING_ECC_TTL]:
                    del entries[s]
                if not entries:
                    del self._ec_pending_ecc[v]
            self._ec_pending_ecc.setdefault(vid, {}).update(
                {sid: (now, crcs) for sid, crcs in shards.items()})
        return {"volume": vid, "shards": sorted(shards), "merged": True}

    def _ec_to_volume(self, query: dict, body: bytes) -> dict:
        """VolumeEcShardsToVolume: local data shards (.ec00-.ec09) + .ecx
        back into a normal .dat/.idx volume, then mount it
        (server/volume_grpc_erasure_coding.go:330)."""
        req = json.loads(body)
        vid = req["volume"]
        ev = self.ec_volumes.get(vid)
        base = (ev.base_file_name if ev is not None
                else self._volume_base(vid))
        missing = [s for s in range(10)
                   if not os.path.exists(base + to_ext(s))]
        if missing:
            raise rpc.RpcError(
                409, f"data shards {missing} not on this server; "
                     "copy them here first")
        from ..ec.decoder import (find_dat_file_size, write_dat_file,
                                  write_idx_file_from_ec_index)
        if ev is not None:
            self.ec_volumes.pop(vid).close()
        dat_size = find_dat_file_size(base)
        write_dat_file(base, dat_size)
        write_idx_file_from_ec_index(base)
        v = self.store.mount_volume(vid)
        self._send_heartbeat(full=True)
        return {"volume": vid, "size": v.dat_size()}

    def _volume_tail(self, query: dict, body: bytes):
        """VolumeTailSender (volume_server.proto, volume_backup.go): raw
        .dat bytes of records appended after ?since_ns=, capped at
        ?max_bytes=.  The X-Last-Append-Ns header carries the newest
        timestamp in the returned window for resuming."""
        from ..storage.volume_backup import (last_append_in_blob,
                                             read_incremental)
        vid = int(query["volume"])
        since = int(query.get("since_ns", 0))
        max_bytes = int(query.get("max_bytes", 64 * 1024 * 1024))
        v = self.store.find_volume(vid)
        if v is None:
            raise rpc.RpcError(404, f"volume {vid} not on this server")
        delta = read_incremental(v, since, max_bytes)
        last = last_append_in_blob(delta, v.version) if delta else since
        return (200, delta, {"Content-Type": "application/octet-stream",
                             "X-Volume-Version": str(v.version),
                             "X-Last-Append-Ns": str(last)})

    def _tier_upload(self, query: dict, body: bytes) -> dict:
        """VolumeTierMoveDatToRemote (volume_grpc_tier_upload.go): the
        volume must be readonly; its .dat moves to the backend spec."""
        from ..storage.tier import move_dat_to_remote
        req = json.loads(body)
        vid = int(req["volume"])
        v = self.store.find_volume(vid)
        if v is None:
            raise rpc.RpcError(404, f"volume {vid} not on this server")
        try:
            info = move_dat_to_remote(
                v, req["dest"], keep_local=req.get("keep_local", False),
                access_key=req.get("access_key", ""),
                secret_key=req.get("secret_key", ""))
        except VolumeError as e:
            raise rpc.RpcError(400, str(e)) from None
        return {"volume": vid, "remote": info["files"][0]}

    def _tier_download(self, query: dict, body: bytes) -> dict:
        """VolumeTierMoveDatFromRemote: bring the .dat back local."""
        from ..storage.tier import move_dat_from_remote
        req = json.loads(body)
        vid = int(req["volume"])
        v = self.store.find_volume(vid)
        if v is None:
            raise rpc.RpcError(404, f"volume {vid} not on this server")
        try:
            move_dat_from_remote(
                v, keep_remote=req.get("keep_remote", False),
                access_key=req.get("access_key", ""),
                secret_key=req.get("secret_key", ""))
        except VolumeError as e:
            raise rpc.RpcError(400, str(e)) from None
        return {"volume": vid, "local": True}

    def _query(self, query: dict, body: bytes):
        """The volume Query RPC (pb/volume_server.proto:92,
        server/volume_grpc_query.go): run a SELECT over one stored
        object's bytes.  Body: {fid, query, input_format, csv_header,
        csv_delimiter, output_format}.  A needle of an erasure-coded
        volume is read through the EC ladder (local shard, remote
        shard, reconstruction), as a GET of it is; the JAX package
        looks only at plain volumes and answers 404 there."""
        from ..query import run_query
        from ..query.sql import SqlError
        req = json.loads(body)
        vid, key, cookie = t.parse_file_id(req["fid"])
        v = self.store.find_volume(vid)
        if v is None:
            ev = self.ec_volumes.get(vid)
            if ev is None:
                raise rpc.RpcError(404, f"volume {vid} not on this server")
            n = self._ec_read(ev, key, cookie)
        else:
            try:
                n = self.store.read_needle(vid, key, cookie)
            except NotFoundError as e:
                raise rpc.RpcError(404, str(e)) from None
        try:
            out = run_query(
                n.data, req["query"],
                input_format=req.get("input_format", "json"),
                csv_header=req.get("csv_header", True),
                csv_delimiter=req.get("csv_delimiter", ","),
                output_format=req.get("output_format", "json"))
        except (SqlError, ValueError) as e:
            raise rpc.RpcError(400, str(e)) from None
        return (200, out, {"Content-Type": "application/octet-stream"})

    def _volume_file(self, query: dict, body: bytes):
        """Stream a whole .dat/.idx/.vif file — the VolumeCopy/CopyFile RPC
        for normal volumes (server/volume_grpc_copy.go)."""
        vid = int(query["volume"])
        ext = query.get("ext", ".dat")
        if ext not in (".dat", ".idx", ".vif"):
            raise rpc.RpcError(400, f"bad ext {ext}")
        v = self.store.find_volume(vid)
        base = v.file_name() if v is not None else self._volume_base(vid)
        path = base + ext
        if not os.path.exists(path):
            raise rpc.RpcError(404, f"{os.path.basename(path)} not here")
        f = open(path, "rb")  # streamed by the server in 1MB chunks
        if v is None or ext == ".vif":
            return f
        # A mounted volume may be taking writes: send the sizes of one
        # record boundary, not whatever the file holds when it is read.
        dat, idx = v.copy_sizes()
        return (200, f, {"Content-Length": str(dat if ext == ".dat"
                                               else idx)})

    def _copy_volume(self, query: dict, body: bytes) -> dict:
        """VolumeCopy: pull .idx then .dat from a source server, then
        mount.  The shell freezes the source first; .idx-before-.dat
        ordering additionally guarantees the copied index never references
        bytes beyond the copied data snapshot."""
        req = json.loads(body)
        vid, source = req["volume"], req["source"]
        if self.store.has_volume(vid):
            raise rpc.RpcError(409, f"volume {vid} already here")
        loc = self.store.free_location()
        if loc is None:
            raise rpc.RpcError(507, "no free disk location on this server")
        collection = req.get("collection", "")
        name = f"{collection}_{vid}" if collection else str(vid)
        base = os.path.join(loc.directory, name)
        # A volume copy restores replication — wire-accounted as
        # repair.fetch (healthy-copy bytes pulled to heal placement).
        for ext in (".idx", ".dat"):
            rpc.call_to_file(f"http://{source}/admin/volume_file?"
                             f"volume={vid}&ext={ext}", base + ext,
                             headers={**rpc.PRIORITY_LOW,
                                      **_flows.tag("repair.fetch")})
        v = self.store.mount_volume(vid)
        self._send_heartbeat()
        return {"volume": vid, "size": v.dat_size()}

    def _volume_checksums(self, query: dict, body: bytes) -> dict:
        """GET /admin/volume/checksums?volume=N — the fsck-style
        needle -> CRC map for one local volume (live needles only,
        CRC-verified while scanning).  The durability autopilot's
        receive path compares the source's map against the copied
        files before registering the new replica."""
        vid = int(query["volume"])
        v = self.store.find_volume(vid)
        if v is None:
            raise rpc.RpcError(404, f"volume {vid} not here")
        v.sync()
        base = v.file_name()
        return {"volume": vid,
                "checksums": _needle_checksum_map(base + ".dat",
                                                  base + ".idx")}

    def _volume_receive(self, query: dict, body: bytes) -> dict:
        """POST /admin/volume/receive — crash-safe, verified volume
        copy for automatic re-replication.  Like /admin/copy_volume
        but: files land as .part tmps and are os.replace()d only after
        the rebuilt needle->CRC map matches the source's fsck map
        byte-for-byte, so an executor dying mid-copy leaves only tmp
        files the startup reaper removes, and a corrupt wire transfer
        can never register as a replica."""
        req = json.loads(body)
        vid, source = req["volume"], req["source"]
        if self.store.has_volume(vid):
            raise rpc.RpcError(409, f"volume {vid} already here")
        loc = self.store.free_location()
        if loc is None:
            raise rpc.RpcError(507, "no free disk location on this server")
        collection = req.get("collection", "")
        name = f"{collection}_{vid}" if collection else str(vid)
        base = os.path.join(loc.directory, name)
        tmps = {ext: base + ext + ".part" for ext in (".idx", ".dat")}
        try:
            # .idx before .dat: the copied index never references
            # bytes beyond the copied data snapshot.  Repair traffic
            # rides the low-priority lane, wire-accounted repair.fetch.
            for ext in (".idx", ".dat"):
                rpc.call_to_file(f"http://{source}/admin/volume_file?"
                                 f"volume={vid}&ext={ext}", tmps[ext],
                                 headers={**rpc.PRIORITY_LOW,
                                          **_flows.tag("repair.fetch")})
            want = rpc.call(
                f"http://{source}/admin/volume/checksums?volume={vid}",
                timeout=120.0)["checksums"]
            got = _needle_checksum_map(tmps[".dat"], tmps[".idx"])
            if got != want:
                raise rpc.RpcError(
                    422, f"volume {vid}: copied needle checksums "
                    f"diverge from source ({len(got)} local vs "
                    f"{len(want)} source live needles)")
        except Exception:
            for tmp in tmps.values():
                try:
                    os.remove(tmp)
                except OSError:
                    pass
            raise
        for ext in (".idx", ".dat"):
            os.replace(tmps[ext], base + ext)
        v = self.store.mount_volume(vid)
        self._send_heartbeat()
        return {"volume": vid, "size": v.dat_size(),
                "needles": len(want)}

    def _admin_mount(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        self.store.mount_volume(req["volume"])
        self._send_heartbeat()
        return {}

    def _admin_unmount(self, query: dict, body: bytes) -> dict:
        req = json.loads(body)
        self.store.unmount_volume(req["volume"])
        self._send_heartbeat(full=True)
        return {}

    def _reap_partial_files(self) -> None:
        """Crash-safety sweep at startup: remove interrupted transfer
        tmps (.part from /admin/volume/receive, .dl.tmp from streaming
        downloads).  A repair executor dying mid-copy leaves ONLY
        these — never a half-registered volume — so reaping them is
        the whole recovery story on the receiver side."""
        import glob as _glob
        for loc in self.store.locations:
            for pat in ("*.part", "*.dl.tmp"):
                for path in _glob.glob(os.path.join(loc.directory,
                                                    pat)):
                    try:
                        os.remove(path)
                    except OSError:
                        pass

    def _load_ec_volumes(self) -> None:
        """Discover local EC shards at startup (disk_location_ec.go)."""
        import glob as _glob
        import re
        for loc in self.store.locations:
            for path in _glob.glob(os.path.join(loc.directory, "*.ecx")):
                name = os.path.basename(path)[:-4]
                m = re.match(r"^(?:.+_)?(\d+)$", name)
                if not m:
                    continue
                vid = int(m.group(1))
                if vid not in self.ec_volumes:
                    base = path[:-4]
                    try:
                        self.ec_volumes[vid] = EcVolume(
                            base, vid=vid, device=self.device)
                    except Exception:  # noqa: BLE001 — incomplete shard set
                        continue


def _fence(x) -> None:
    """Wait for a CUDA tensor on the stream it was produced on (the
    coder launches on its device's current stream); host arrays are
    already final."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()


def _needle_checksum_map(dat_path: str, idx_path: str) -> dict:
    """fsck-style content map for one volume file pair: live needle id
    (hex) -> stored CRC (hex, CRC-verified against the data while
    scanning).  Keyed by needle and node-address-free, so two holders
    of the same volume converged exactly when their maps are equal —
    the registration gate for /admin/volume/receive."""
    from ..storage.needle_map import MemoryNeedleMap
    from ..storage.volume_scanner import scan_volume_file
    live = MemoryNeedleMap.load(idx_path)
    out: dict[str, str] = {}
    for needle, _offset, _total in scan_volume_file(dat_path,
                                                    check_crc=True):
        key = f"{needle.id:x}"
        if needle.size == 0:  # tombstone: the needle is deleted
            out.pop(key, None)
        elif needle.id in live:
            out[key] = f"{needle.checksum & 0xFFFFFFFF:08x}"
    return out
