"""Master server: topology keeper, id assigner, growth/vacuum orchestrator
(the port's copy of seaweedfs_tpu/cluster/master.py).

HTTP surface mirrors the reference master's API
(weed/server/master_server.go, master_grpc_server_volume.go):

  POST /heartbeat            volume-server full/delta state (SendHeartbeat)
  GET  /dir/assign           Assign: grow-on-demand then PickForWrite
  GET  /dir/lookup?volumeId= locations for a volume (or EC shards)
  GET  /dir/status           topology snapshot
  POST /vol/grow             explicit growth
  POST /vol/vacuum           force a vacuum scan
  GET  /col/list, POST /col/delete
  GET  /cluster/status
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse

from ..core.replica_placement import ReplicaPlacement
from ..core.ttl import TTL
from ..storage.store import VolumeInfo
from ..stats import flows as _flows
from ..topology.topology import Topology, VolumeGrowOption
from ..topology.volume_growth import VolumeGrowth
from . import rpc


def _vinfo_from_dict(d: dict) -> VolumeInfo:
    return VolumeInfo(
        id=d["id"], collection=d.get("collection", ""),
        size=d.get("size", 0), file_count=d.get("file_count", 0),
        delete_count=d.get("delete_count", 0),
        deleted_byte_count=d.get("deleted_byte_count", 0),
        read_only=d.get("read_only", False),
        replica_placement=d.get("replica_placement", 0),
        ttl=d.get("ttl", 0), compact_revision=d.get("compact_revision", 0),
        max_file_key=d.get("max_file_key", 0),
        version=d.get("version", 3),
        corrupt_count=d.get("corrupt_count", 0),
        modified_at=d.get("modified_at", 0),
        tiered=d.get("tiered", False))


def vinfo_to_dict(v: VolumeInfo) -> dict:
    return {
        "id": v.id, "collection": v.collection, "size": v.size,
        "file_count": v.file_count, "delete_count": v.delete_count,
        "deleted_byte_count": v.deleted_byte_count,
        "read_only": v.read_only,
        "replica_placement": v.replica_placement, "ttl": v.ttl,
        "compact_revision": v.compact_revision,
        "max_file_key": v.max_file_key, "version": v.version,
        "corrupt_count": v.corrupt_count,
        "modified_at": v.modified_at, "tiered": v.tiered,
    }


class MasterServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 volume_size_limit_mb: int = 30 * 1024,
                 default_replication: str = "000",
                 pulse_seconds: int = 5,
                 garbage_threshold: float = 0.3,
                 meta_dir: str | None = None,
                 peers: list[str] | None = None,
                 jwt_signing_key: str = "",
                 jwt_expires_seconds: int = 10,
                 ssl_context=None,
                 admin_scripts: str = "",
                 admin_script_interval: float = 17 * 60,
                 max_concurrent: int = 0,
                 idle_timeout: float = 120.0,
                 transport: str | None = None,
                 slo_read_p99: float | None = None,
                 slo_availability: float | None = None,
                 replication_lag_slo: float | None = None,
                 lifecycle_rules: str = "",
                 lifecycle_interval: float = 60.0,
                 lifecycle_mbps: float = 32.0,
                 tenant_rules: str = "",
                 geo_cluster_id: str = "",
                 geo_vid_stride: int = 1,
                 geo_vid_offset: int = 0,
                 steer_peer: str | None = None,
                 steer_reads: bool = False,
                 steer_refresh: float = 2.0,
                 filer_shards: int = 0,
                 repair_enabled: bool = False,
                 repair_delay: float | None = None,
                 repair_concurrent: int = 2):
        # Write-path JWT (security/jwt.go): when configured, Assign
        # responses carry an `auth` token volume servers require on
        # needle writes/deletes.
        self.jwt_signing_key = jwt_signing_key
        self.jwt_expires_seconds = jwt_expires_seconds
        # Admin-script cron (master_server.go:187-263 startAdminScripts):
        # master.toml maintenance scripts — one shell command per line —
        # run on the leader every interval, wrapped in lock/unlock, so
        # the EC lifecycle (ec.encode/rebuild/balance, volume.balance)
        # runs unattended.
        self.admin_scripts = [ln.strip() for ln in admin_scripts.split("\n")
                              if ln.strip()]
        self.admin_script_interval = admin_script_interval
        # (started_at, line, ok, output-or-error) — observability for
        # tests and the status endpoint.
        self.admin_script_runs: list[tuple[float, str, bool, str]] = []
        # Location push channels (/cluster/watch): the KeepConnected
        # analog (pb/master.proto:10-13, master_grpc_server.go:178) —
        # long-lived streams that receive volume-location changes the
        # moment heartbeats land, so clients invalidate their vid maps
        # without polling.
        self._watchers: list = []
        self._watchers_lock = threading.Lock()
        # Filer metadata-HA plane (-filer.shards=N; 0 keeps it off):
        # filers register + heartbeat like volume servers, and the
        # master owns the shard map — which filer is primary for each
        # namespace shard, at which fencing epoch, with which
        # followers.  Persisted so a master restart cannot regress an
        # epoch (that would un-fence a deposed primary).
        self.filer_shards = int(filer_shards)
        self._filers: dict[str, dict] = {}   # url -> row
        self._filer_lock = threading.RLock()
        self._shard_map: dict[int, dict] = {}
        self._shard_map_version = 0
        self._shard_map_path = f"{meta_dir}/filer_shards.json" \
            if meta_dir else None
        self._load_shard_map()
        if meta_dir:
            import os
            os.makedirs(meta_dir, exist_ok=True)
        seq_path = f"{meta_dir}/seq.dat" if meta_dir else None
        from ..topology.sequence import MemorySequencer
        # Active/active regions must mint volume ids from disjoint
        # residue classes (-geo.vid.stride / -geo.vid.offset): a vid
        # collision would make the regions' lease planes fence each
        # other's unrelated volumes.
        self.topo = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            sequencer=MemorySequencer(seq_path),
            pulse_seconds=pulse_seconds,
            vid_stride=geo_vid_stride, vid_offset=geo_vid_offset)
        self.vg = VolumeGrowth()
        self.default_replication = default_replication
        self.garbage_threshold = garbage_threshold
        # Cross-cluster mirroring lag SLO (-replicate.lag.slo,
        # seconds): healthz degrades (503) while any mirrored volume's
        # oldest unacked change-log record is older than this, and
        # recovers when the standby catches up.
        self.replication_lag_slo = replication_lag_slo
        # Tenancy & QoS plane (-tenant.rules): declarative per-tenant
        # quotas.  Stored-usage rules (max_bytes/max_objects) are
        # enforced HERE at assign time against the heartbeat-fed
        # rollup; rate rules feed this master's own admission buckets.
        # The rollup snapshots to <meta_dir>/tenants.json so a restart
        # answers quota checks before heartbeats repopulate it.
        from ..tenancy import QuotaPolicy, UsageRollup
        from ..tenancy import load_rules as load_tenant_rules
        self.tenant_policy = load_tenant_rules(tenant_rules) \
            if tenant_rules else QuotaPolicy()
        self.usage_rollup = UsageRollup(
            f"{meta_dir}/tenants.json" if meta_dir else None)
        self._last_quota_emit: dict[str, float] = {}
        # Overload protection (-max.concurrent): bounded assignment/
        # lookup concurrency with 429 sheds; /heartbeat, healthz, and
        # the watch streams are admission-exempt.
        self.server = rpc.JsonHttpServer(
            host, port, ssl_context=ssl_context,
            idle_timeout=idle_timeout, transport=transport,
            admission=rpc.AdmissionControl(
                max_concurrent,
                tenant_policy=self.tenant_policy
                if self.tenant_policy.rules else None))
        s = self.server
        s.route("POST", "/heartbeat", self._heartbeat)
        s.route("GET", "/dir/assign", self._assign)
        s.route("POST", "/dir/assign", self._assign)
        s.route("GET", "/dir/lookup", self._lookup)
        s.route("GET", "/dir/status", self._status)
        s.route("GET", "/cluster/watch", self._cluster_watch)
        s.route("POST", "/cluster/raft/add",
                lambda q, b: self._raft_membership(
                    dict(q, _action="add"), b))
        s.route("POST", "/cluster/raft/remove",
                lambda q, b: self._raft_membership(
                    dict(q, _action="remove"), b))
        s.route("GET", "/ui", self._ui)
        from ..utils.pprof import enable_pprof_routes
        enable_pprof_routes(s)
        from ..trace import setup_server_tracing
        setup_server_tracing(s, "master")
        from ..fault.routes import setup_fault_routes
        setup_fault_routes(s)
        from ..events import events_enabled, setup_event_routes
        setup_event_routes(s)
        s.route("GET", "/cluster/healthz", self._healthz)
        s.route("GET", "/cluster/mirror", self._cluster_mirror)
        if events_enabled():
            # The aggregation endpoint honors the same kill switch as
            # /debug/events — -events=false unmounts both surfaces.
            s.route("GET", "/cluster/events", self._cluster_events)
        s.route("POST", "/vol/grow", self._grow)
        s.route("POST", "/vol/vacuum", self._vacuum)
        s.route("GET", "/col/list", self._col_list)
        s.route("POST", "/col/delete", self._col_delete)
        s.route("GET", "/cluster/status", self._cluster_status)
        s.route("GET", "/vol/list", self._vol_list)
        s.route("POST", "/admin/lease", self._admin_lease)
        s.route("POST", "/admin/release", self._admin_release)
        s.route("GET", "/cluster/lifecycle", self._cluster_lifecycle)
        s.route("POST", "/cluster/lifecycle/run",
                self._cluster_lifecycle_run)
        s.route("GET", "/cluster/tenants", self._cluster_tenants)
        s.route("GET", "/cluster/flows", self._cluster_flows)
        s.route("GET", "/cluster/device", self._cluster_device)
        s.route("POST", "/filer/heartbeat", self._filer_heartbeat)
        s.route("GET", "/cluster/filer/shards",
                self._cluster_filer_shards)
        s.route("POST", "/cluster/filer/shards/move",
                self._filer_shard_move)
        s.route("GET", "/cluster/repair", self._cluster_repair)
        s.route("POST", "/cluster/repair/run", self._cluster_repair_run)
        s.route("POST", "/cluster/repair/pause",
                lambda q, b: self._cluster_repair_switch(q, b, True))
        s.route("POST", "/cluster/repair/resume",
                lambda q, b: self._cluster_repair_switch(q, b, False))
        reg = s.enable_metrics("master")
        # Device roofline instruments (process-global singletons): the
        # master runs no EC kernels itself in the deployed topology,
        # but in-process multi-role stacks do, and register_once keeps
        # the scrape single-family either way.
        from ..stats import roofline as _roofline
        for m in (_roofline.kernel_seconds_total,
                  _roofline.kernel_bytes_total,
                  _roofline.kernel_work_total,
                  _roofline.device_occupancy):
            reg.register_once(m)
        # SLO plane: declared objectives drive the burn engine behind
        # /cluster/healthz; /debug/slow + /debug/slo expose exemplars
        # and live quantiles like on the other roles.
        from ..stats.slo import setup_slo_routes
        setup_slo_routes(s)
        # Lock-contention surface: /debug/locks (holders/waiters with
        # stacks + per-lock wait/hold counters).
        from ..stats.contention import setup_contention_routes
        setup_contention_routes(s)
        s.slo.set_objectives(slo_read_p99, slo_availability)
        reg.gauge("SeaweedFS_master_volume_count",
                  "registered volume replicas cluster-wide",
                  callback=lambda: float(self.topo.volume_count))
        reg.gauge("SeaweedFS_master_ec_shard_count",
                  "registered EC shards cluster-wide",
                  callback=lambda: float(self.topo.ec_shard_count))
        reg.gauge("SeaweedFS_master_data_node_count",
                  "live data nodes",
                  callback=lambda: float(len(list(self.topo.leaves()))))
        reg.gauge("SeaweedFS_master_max_volume_id",
                  "volume id high-water mark",
                  callback=lambda: float(self.topo.max_volume_id))
        reg.gauge("SeaweedFS_master_is_leader", "1 on the raft leader",
                  callback=lambda: 1.0 if self.is_leader() else 0.0)
        reg.gauge("SeaweedFS_node_health",
                  "per data node: 1 = heartbeat fresh, 0 = stale",
                  ("node",), callback=self._node_health_values)
        # Durability autopilot instruments (process-global singletons
        # in repair_daemon; register_once keeps multi-master-in-process
        # scrapes single-family).
        from . import repair_daemon as _repair_mod
        reg.register_once(_repair_mod.repairs_total)
        reg.register_once(_repair_mod.repair_seconds)
        reg.gauge("SeaweedFS_repair_queue_depth",
                  "queued automatic repairs by surviving-redundancy "
                  "risk (0 = last replica / decode minimum)",
                  ("risk",),
                  callback=lambda: self.repair.queue_depth_by_risk())
        reg.gauge("SeaweedFS_master_tenant_bytes",
                  "cluster-wide stored bytes by tenant (heartbeat "
                  "rollup, replicas counted per copy)", ("tenant",),
                  callback=lambda: {
                      (t,): float(e["bytes"]) for t, e in
                      self.usage_rollup.totals().items()})
        reg.gauge("SeaweedFS_master_tenant_objects",
                  "cluster-wide stored objects by tenant", ("tenant",),
                  callback=lambda: {
                      (t,): float(e["objects"]) for t, e in
                      self.usage_rollup.totals().items()})
        # Geo locality steering (-replicate.steer): when this region's
        # replica of a mirrored volume is lagging past the lag SLO (or
        # a tenant's home= hint points at the peer region), /dir/lookup
        # reorders its locations list so clients read from the peer
        # cluster's replica first.  Lookup-time only — clients already
        # re-lookup on 429/503, so no read path changes are needed.
        self.geo_cluster_id = geo_cluster_id
        self.steer_peer = steer_peer
        self.steer_reads = steer_reads and bool(steer_peer)
        self.steer_refresh = steer_refresh
        self._steer_lock = threading.Lock()
        self._steer_mirror: tuple[float, dict] = (0.0, {})
        self._steer_locs: dict[int, tuple[float, list]] = {}
        self._grow_lock = threading.Lock()
        self._hb_apply_lock = threading.Lock()  # guards the lock table
        self._hb_node_locks: dict[str, threading.Lock] = {}
        # Nodes currently registered via heartbeat: a key leaving this
        # set (dead-node sweep) emits heartbeat.lost, re-entering emits
        # heartbeat.recovered — the journal's liveness timeline.
        self._hb_known: set[str] = set()
        # node_key -> seq_epoch of the process that said goodbye:
        # straggler heartbeats from that generation are ignored so a
        # drained server can't be resurrected by an in-flight beat
        # racing its own goodbye (a restarted process has a new epoch).
        self._goodbye_epochs: dict[str, int] = {}
        # Exclusive admin lock (wdclient/exclusive_locks): one shell at a
        # time may run mutating maintenance commands.
        self._admin_lock = threading.Lock()
        self._admin_token: int | None = None
        self._admin_holder = ""
        self._admin_expires = 0.0
        self._admin_lock_ttl = 10.0
        self._stop = threading.Event()
        self._sweeper = threading.Thread(target=self._sweep_loop,
                                         daemon=True, name="master-sweep")
        # Data-lifecycle plane (-lifecycle.rules): the policy daemon
        # scans heartbeat stats + /debug/hot coldness and drives
        # tiering/expiry.  Always constructed (healthz and the shell
        # verb report a disabled plane); the loop only starts with
        # rules loaded.
        from ..lifecycle import LifecycleDaemon, Policy, load_rules
        policy = load_rules(lifecycle_rules) if lifecycle_rules \
            else Policy([])
        self.lifecycle = LifecycleDaemon(self, policy,
                                         interval=lifecycle_interval,
                                         mbps=lifecycle_mbps)
        # Durability autopilot (-repair): leader-only daemon that
        # converges the cluster back to declared redundancy after node
        # loss.  Always constructed (the /cluster/repair surfaces and
        # the shell's run-once path report/work on a disarmed plane);
        # only an armed daemon enqueues from the sweep tick.
        from .repair_daemon import RepairDaemon
        self.repair = RepairDaemon(self, enabled=repair_enabled,
                                   delay=repair_delay,
                                   concurrent=repair_concurrent)
        # Multi-master HA: a raft node rides on this HTTP server; the
        # leader owns id issuance, followers proxy mutating requests
        # (server/raft_server.go, master_server.go:155).
        self.raft = None
        self._seq_ceiling = 0  # raft-committed file-id ceiling
        self._raft_id = f"http://{self.server.host}:{self.server.port}"
        self._id_lock = threading.Lock()
        if peers:
            from .raft import RaftNode
            norm = [p if p.startswith("http") else f"http://{p}"
                    for p in peers]
            # Raft identities are scheme-normalized http:// addresses
            # regardless of TLS: -peers lists are written as host:port,
            # and whether the wire is encrypted is the transport's
            # decision (rpc.set_client_ssl_context force_https), not
            # part of a node's identity.
            me = self._raft_id
            if me not in norm:
                # A textual alias of this node left in the peer list
                # would grant phantom self-votes (split brain) and
                # self-deposing heartbeats — refuse instead of guessing.
                raise ValueError(
                    f"-peers must include this master's advertised "
                    f"address {me} (got {norm}); set -ip/-port to match")
            self.raft = RaftNode(
                me, norm, apply_fn=self._raft_apply,
                snapshot_fn=self._raft_snapshot,
                restore_fn=self._raft_restore,
                state_path=f"{meta_dir}/raft.json" if meta_dir else None)
            self.raft.mount(self.server)
            self.topo.next_volume_id_hook = self._next_volume_id_raft
            # HA file-id issuance: swap in the consensus-backed block
            # sequencer (the etcd-sequencer analog) so a failover can
            # never re-issue a committed id range.
            from ..topology.sequence import RaftSequencer
            self.topo.sequencer = RaftSequencer(self._alloc_seq_block)

    # -- raft ----------------------------------------------------------------

    def _raft_apply(self, cmd: dict) -> None:
        if cmd.get("op") == "max_volume_id":
            self.topo.set_max_volume_id(cmd["value"])
        elif cmd.get("op") == "seq_ceiling":
            self._seq_ceiling = max(self._seq_ceiling, cmd["value"])

    def _alloc_seq_block(self, min_start: int, n: int) -> int:
        """Commit a file-id block [start, start+n) through the raft log
        (RaftSequencer's alloc_fn).  Same fencing discipline as volume
        ids: barrier first so a fresh leader sees every inherited
        ceiling before computing the next one."""
        from .raft import NotLeader
        with self._id_lock:
            if not self.raft.is_leader():
                raise NotLeader(self.raft.leader())
            self.raft.barrier()
            start = max(self._seq_ceiling, min_start)
            self.raft.propose({"op": "seq_ceiling", "value": start + n})
            return start

    def _raft_snapshot(self) -> dict:
        """State-machine snapshot for raft log compaction: the
        replicated state is the two id watermarks."""
        with self.topo._lock:
            return {"max_volume_id": max(self.topo._max_volume_id,
                                         self.topo.max_volume_id),
                    "seq_ceiling": self._seq_ceiling}

    def _raft_restore(self, state: dict) -> None:
        if state.get("max_volume_id"):
            self.topo.set_max_volume_id(state["max_volume_id"])
        if state.get("seq_ceiling"):
            self._seq_ceiling = max(self._seq_ceiling,
                                    state["seq_ceiling"])

    def _raft_membership(self, query: dict, body: bytes) -> dict:
        """POST /cluster/raft/{add,remove}?peer=host:port — one-server-
        at-a-time membership change on the leader."""
        if self.raft is None:
            raise rpc.RpcError(400, "raft is not enabled (-peers)")
        peer = query.get("peer", "")
        if not peer:
            raise rpc.RpcError(400, "missing ?peer=host:port")
        if not peer.startswith("http"):
            peer = f"http://{peer}"
        from .raft import NotLeader
        try:
            if query.get("_action") == "remove":
                self.raft.remove_server(peer)
            else:
                self.raft.add_server(peer)
        except NotLeader as e:
            raise rpc.RpcError(
                503, f"not the leader (leader={e.leader})") from None
        except (RuntimeError, ValueError) as e:
            raise rpc.RpcError(409, str(e)) from None
        return {"peers": sorted(self.raft.peers + [self.raft.id])}

    def _next_volume_id_raft(self) -> int:
        from .raft import NotLeader
        with self._id_lock:
            if not self.raft.is_leader():
                raise NotLeader(self.raft.leader())
            # Read-your-own-log fence: a freshly elected leader must
            # apply inherited entries before computing the next id, or
            # it could re-issue the previous leader's last volume id.
            self.raft.barrier()
            with self.topo._lock:
                target = self.topo.stride_align(
                    max(self.topo._max_volume_id,
                        self.topo.max_volume_id) + 1)
            self.raft.propose({"op": "max_volume_id", "value": target})
            return target

    def is_leader(self) -> bool:
        return self.raft is None or self.raft.is_leader()

    def leader_url(self) -> str:
        if self.raft is None or self.raft.is_leader():
            return self.url()
        return self.raft.leader() or self.url()

    def _proxy_to_leader(self, path: str, query: dict, body: bytes,
                         method: str = "POST"):
        """Forward a mutating request to the current leader
        (master_server.go proxyToLeader)."""
        leader = self.raft.leader() if self.raft else None
        # Compare against the scheme-normalized raft identity, not
        # self.url(): under TLS url() is https:// while raft ids stay
        # http://, and a stale self-leader hint must 503 here instead
        # of proxying the request to ourselves.
        if not leader or leader == self._raft_id:
            raise rpc.RpcError(503, "no leader elected yet; retry")
        if query.get("proxied"):
            # Stale mutual leader hints during an election would bounce
            # the request in a cycle of nested blocking calls.
            raise rpc.RpcError(503, "no stable leader yet; retry")
        import urllib.parse
        fwd = {k: v for k, v in query.items() if not k.startswith("_")}
        fwd["proxied"] = "1"
        qs = urllib.parse.urlencode(fwd)
        url = leader + path + (f"?{qs}" if qs else "")
        try:
            return rpc.call(url, method,
                            body if method != "GET" else None)
        except OSError as e:
            # A dead/unreachable leader hint (it was just killed; the
            # election hasn't converged) is a RETRY-ELSEWHERE answer,
            # not an internal error of THIS follower: surfacing it as a
            # 500 would count toward this live follower's circuit
            # breaker and let a failover window open breakers on every
            # healthy master (clients hammer all seeds during one).
            raise rpc.RpcError(
                503, f"leader {leader} unreachable; retry: "
                     f"{type(e).__name__}: {e}") from None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self.repair.enabled:
            self.repair.prepare()
        if self.raft is not None:
            # The device stack /cluster/device and /debug/device report
            # (torch, the card's context, its probed peaks) is set up now,
            # before an HA master serves.  Done in the first of those
            # requests (as the JAX package does), it held the interpreter
            # lock past the raft election timeout (1.8-2.4 s on an H100
            # host, the timeout 0.6-1.2 s): a follower whose topology held
            # no EC volume took over and answered 404 for it until each
            # holder beat again.
            from ..stats import roofline as _roofline
            _roofline.probe_peaks()
        self.server.start()
        self._sweeper.start()
        if self.raft is not None:
            self.raft.start()
        if self.admin_scripts:
            threading.Thread(target=self._admin_script_loop,
                             daemon=True, name="master-cron").start()
        if self.lifecycle.policy.rules:
            self.lifecycle.start()

    def stop(self) -> None:
        self._stop.set()
        self.lifecycle.stop()
        # Final usage snapshot: quota checks after a restart answer
        # from this until heartbeats repopulate the rollup.
        try:
            self.usage_rollup.save(force=True)
        except OSError:
            pass
        if self.raft is not None:
            self.raft.stop()
        self.server.stop()

    def url(self) -> str:
        return self.server.url()

    # -- admin-script cron (startAdminScripts) -------------------------------

    def _admin_script_loop(self) -> None:
        while not self._stop.wait(self.admin_script_interval):
            if not self.is_leader():
                continue
            try:
                self.run_admin_scripts()
            except Exception:  # noqa: BLE001 — cron must never die
                pass

    def run_admin_scripts(self) -> list[tuple[float, str, bool, str]]:
        """One cron round: lock, run every configured script line
        through the shell dispatcher, unlock.  Returns this round's
        (ts, line, ok, output) records (also appended to
        admin_script_runs).  A -batch line runs its kernels in this
        process, on every visible card."""
        from ..shell import CommandEnv, run_command
        from ..utils import glog
        env = CommandEnv(self.url())
        round_runs: list[tuple[float, str, bool, str]] = []
        try:
            lines = list(self.admin_scripts)
            if not any(ln == "lock" for ln in lines):
                lines = ["lock"] + lines + ["unlock"]
            for line in lines:
                ts = time.time()
                try:
                    out = run_command(env, line)
                    round_runs.append((ts, line, True, out))
                except Exception as e:  # noqa: BLE001 — next script
                    glog.warningf("admin script %r: %s", line, e)
                    round_runs.append((ts, line, False, str(e)))
                    if line == "lock":
                        # No exclusive lease (an operator holds it):
                        # maintenance concurrent with their session is
                        # the race the lock prevents.  Abort the round;
                        # the next tick retries.
                        break
        finally:
            env.close()
            self.admin_script_runs.extend(round_runs)
            del self.admin_script_runs[:-200]
        return round_runs

    # -- handlers -----------------------------------------------------------

    def _heartbeat(self, query: dict, body: bytes) -> dict:
        if not self.is_leader():
            # Volume servers register with the leader only; hand back the
            # hint so they redial (volume_grpc_client_to_master.go:60-85).
            # No self-referential fallback: an unknown leader stays None
            # so the volume server rotates seeds instead of spinning here.
            return {"leader": self.raft.leader(), "is_leader": False}
        hb = json.loads(body)
        # Per-node serialization + ordering: concurrent POSTs from one
        # volume server must not let a stale full snapshot erase a
        # just-grown volume, but nodes must not serialize each other.
        node_key = f"{hb['ip']}:{hb['port']}"
        if hb.get("goodbye"):
            # Graceful drain, final beat: unregister NOW — no
            # heartbeat blackout, no dead-sweep window — and remember
            # the goodbyed process generation so a straggler beat from
            # the same (now exiting) process can't re-register it.
            return self._apply_goodbye(node_key, hb)
        with self._hb_apply_lock:
            node_lock = self._hb_node_locks.setdefault(
                node_key, threading.Lock())
            goodbyed = self._goodbye_epochs.get(node_key)
            if goodbyed is not None:
                if goodbyed == hb.get("seq_epoch"):
                    # Straggler from a goodbyed process: acknowledge
                    # without resurrecting the node (a RESTARTED
                    # server has a fresh epoch, registers normally).
                    return {"volume_size_limit":
                            self.topo.volume_size_limit}
                # A different generation is alive on this address: the
                # goodbye record has served its purpose.
                self._goodbye_epochs.pop(node_key, None)
            if node_key not in self._hb_known:
                self._hb_known.add(node_key)
                from ..events import emit as emit_event
                emit_event("heartbeat.recovered", node=node_key,
                           data_center=hb.get("data_center", ""),
                           rack=hb.get("rack", ""))
                # Resurrection fencing: a returning node lifts its
                # drain fence and schedules the dedupe pass that
                # resolves any repair that landed while it was away.
                self.repair.node_returned(node_key)
        with node_lock:
            # Re-check under node_lock: a beat that read the guard
            # before a goodbye landed (and was then preempted) must
            # not re-register the drained node as a ghost — that would
            # restore the exact dead-sweep window goodbyes eliminate.
            goodbyed = self._goodbye_epochs.get(node_key)
            if goodbyed is not None and \
                    goodbyed == hb.get("seq_epoch"):
                return {"volume_size_limit":
                        self.topo.volume_size_limit}
            dn = self.topo.register_data_node(
                hb.get("data_center", "DefaultDataCenter"),
                hb.get("rack", "DefaultRack"),
                hb["ip"], hb["port"], hb.get("public_url", ""),
                hb.get("max_volume_count", 7))
            # Per-directory disk status (all/used/free/percent_used)
            # rides every heartbeat — the health rollup's capacity view.
            if "disks" in hb:
                dn.disk_statuses = hb["disks"]
            if "ec_corrupt" in hb:
                # vid -> unrepaired corrupt shard blocks (scrub): the
                # health rollup reports these EC volumes degraded.
                dn.ec_corrupt = {int(k): v for k, v in
                                 hb["ec_corrupt"].items()}
            # Lifecycle/capacity flags: _assign steers away from
            # draining and reserve-breached nodes.
            dn.draining = bool(hb.get("draining", False))
            dn.low_disk = bool(hb.get("low_disk", False))
            if "slo" in hb:
                # Burn verdict + mergeable quantile sketches: the
                # health rollup degrades on fast burn and folds every
                # node's sketch into the cluster-wide tail.
                dn.slo_state = hb["slo"]
            if "replication" in hb:
                # Per-volume mirroring lag (seq delta + seconds) and
                # pairing config from the node's shipper — the health
                # rollup's lag-SLO input and /cluster/mirror's rows.
                dn.replication = hb["replication"]
            if "leases" in hb:
                # Geo write-lease rows (cluster_id/epoch per mirrored
                # volume): cluster.lease.ls and the mirror rollup read
                # these; steering keys off the mirror lag, not these.
                dn.leases = hb["leases"]
            if "tenants" in hb:
                # Absolute per-(tenant, collection) stored usage:
                # replace this node's rollup rows and write through to
                # the durable snapshot (cadence-gated inside save()).
                self.usage_rollup.update_node(dn.url(), hb["tenants"])
                self.usage_rollup.save()
            if "flows" in hb:
                # Wire-flow ledger rows (absolute totals): keep the
                # previous sample so /cluster/flows can derive rates
                # from successive beats.  The snapshot was serialized
                # BEFORE this heartbeat's bytes went on the wire, so
                # the node's control-sent row lags our live recv
                # counter by exactly the in-flight report; measure
                # that gap now and let the conservation check grant
                # it as slack on this node's control cell.
                me = f"{self.server.host}:{self.server.port}"
                rows = hb["flows"].get("rows", [])
                claimed = sum(r["bytes"] for r in rows
                              if r["peer"] == me
                              and r["purpose"] == "control"
                              and r["direction"] == "out")
                live, _ops = _flows.LEDGER.totals(
                    purpose_="control", direction="in", local=me,
                    peer=dn.url())
                dn.flows_prev = getattr(dn, "flows", None)
                dn.flows = {"ts": time.time(), "rows": rows,
                            "budgets": hb["flows"].get("budgets", {}),
                            "gap": max(0, live - claimed)}
            if "device" in hb:
                # Device roofline rollup (absolute kernel rows +
                # occupancy summary): replaced wholesale each beat,
                # read by /cluster/device and the healthz
                # occupancy-collapse warning.
                dn.device = {"ts": time.time(), **hb["device"]}
            seq = hb.get("seq")
            if seq is not None:
                # The epoch changes when the volume server restarts, so
                # a fresh process's seq=1 isn't mistaken for stale.
                epoch = hb.get("seq_epoch", 0)
                if epoch != getattr(dn, "heartbeat_epoch", None):
                    dn.heartbeat_epoch = epoch
                    dn.last_heartbeat_seq = 0
                if seq <= getattr(dn, "last_heartbeat_seq", 0):
                    return {"volume_size_limit":
                            self.topo.volume_size_limit}
                dn.last_heartbeat_seq = seq
            before = set(dn.volumes) | set(dn.ec_shards)
            if "volumes" in hb:  # full sync
                volumes = [_vinfo_from_dict(v) for v in hb["volumes"]]
                self.topo.sync_data_node_registration(volumes, dn)
            else:  # delta
                self.topo.incremental_sync(
                    [_vinfo_from_dict(v)
                     for v in hb.get("new_volumes", [])],
                    [_vinfo_from_dict(v)
                     for v in hb.get("deleted_volumes", [])],
                    dn)
            if "ec_shards" in hb:
                self.topo.sync_data_node_ec_shards(
                    [(e["id"], e.get("collection", ""), e["shard_bits"],
                      e.get("codec", "rs"))
                     for e in hb["ec_shards"]], dn)
            # Incremental EC deltas (master_grpc_server.go handles the
            # same Heartbeat fields): merge into the node's shard bits.
            for e in hb.get("new_ec_shards", []):
                bits = dn.ec_shards.get(e["id"], 0) | e["shard_bits"]
                self.topo.register_ec_shards(
                    e["id"], e.get("collection", ""), bits, dn)
            for e in hb.get("deleted_ec_shards", []):
                bits = dn.ec_shards.get(e["id"], 0) & ~e["shard_bits"]
                if bits:
                    self.topo.register_ec_shards(
                        e["id"], e.get("collection", ""), bits, dn)
                else:
                    self.topo.unregister_ec_shards(e["id"], dn)
            after = set(dn.volumes) | set(dn.ec_shards)
        if after != before:
            # Push the delta to every /cluster/watch stream — clients
            # drop their stale vid-map entries immediately
            # (master_grpc_server.go:178 broadcast).
            self._broadcast_locations({
                "url": dn.url(), "public_url": dn.public_url,
                "new_vids": sorted(after - before),
                "deleted_vids": sorted(before - after)})
        return {"volume_size_limit": self.topo.volume_size_limit}

    def _apply_goodbye(self, node_key: str, hb: dict) -> dict:
        """Handle a drain goodbye: snapshot the node's holdings,
        unregister it, broadcast the lost vids to /cluster/watch
        streams (clients re-lookup immediately), and record the
        goodbyed epoch so straggler beats can't resurrect it."""
        from ..events import emit as emit_event
        with self._hb_apply_lock:
            node_lock = self._hb_node_locks.setdefault(
                node_key, threading.Lock())
            self._goodbye_epochs[node_key] = hb.get("seq_epoch", 0)
        with node_lock:
            dn = None
            for leaf in list(self.topo.leaves()):
                if leaf.url() == node_key:
                    dn = leaf
                    break
            if dn is None:
                return {"goodbye": True}
            held_volumes = sorted(dn.volumes)
            held_ec = sorted(dn.ec_shards)
            self.topo.unregister_data_node(dn)
            self._hb_known.discard(node_key)
        emit_event("node.drained", node=node_key,
                   volumes=len(held_volumes), ec_shards=len(held_ec))
        # Planned maintenance never repairs: fence every vid this node
        # held until a new generation of the node registers.
        self.repair.node_goodbyed(
            node_key, set(held_volumes) | set(held_ec))
        vids = sorted(set(held_volumes) | set(held_ec))
        if vids:
            self._broadcast_locations({
                "url": dn.url(), "public_url": dn.public_url,
                "new_vids": [], "deleted_vids": vids})
        return {"goodbye": True}

    def _ui(self, query: dict, body: bytes):
        """Status page (the reference's master UI, server/master_ui):
        leader, topology tree with per-node volume counts, admin-cron
        history."""
        from html import escape as esc
        rows = []
        with self.topo._lock:
            for dc in list(self.topo.children.values()):
                for rack in list(dc.children.values()):
                    for dn in list(rack.children.values()):
                        # Everything heartbeat- or client-supplied is
                        # escaped: a hostile collection/rack name must
                        # not script the operator's browser.
                        rows.append(
                            f"<tr><td>{esc(str(dc.id))}</td>"
                            f"<td>{esc(str(rack.id))}</td>"
                            f"<td>{esc(dn.url())}</td>"
                            f"<td>{len(dn.volumes)}</td>"
                            f"<td>{dn.max_volume_count}</td>"
                            f"<td>{len(dn.ec_shards)}</td></tr>")
        cron = "".join(
            f"<tr><td>{time.strftime('%H:%M:%S', time.localtime(ts))}"
            f"</td><td><code>{esc(line)}</code></td>"
            f"<td>{'ok' if ok else 'FAIL'}</td></tr>"
            for ts, line, ok, _out in self.admin_script_runs[-20:])
        html = (
            "<!doctype html><title>seaweedfs-tpu master</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
            "padding:4px 8px}</style>"
            f"<h1>Master {self.url()}</h1>"
            f"<p>leader: {self.is_leader()} &middot; "
            f"max volume id: {self.topo.max_volume_id} &middot; "
            f"volume size limit: "
            f"{self.topo.volume_size_limit >> 20}MB</p>"
            "<h2>Topology</h2><table><tr><th>DC</th><th>Rack</th>"
            "<th>Node</th><th>Volumes</th><th>Max</th>"
            "<th>EC shard groups</th></tr>" + "".join(rows) + "</table>"
            + ("<h2>Admin cron (last 20)</h2><table><tr><th>at</th>"
               "<th>command</th><th>result</th></tr>" + cron + "</table>"
               if cron else "")
            + "<p><a href='/dir/status'>JSON status</a></p>")
        return (200, html.encode(),
                {"Content-Type": "text/html; charset=utf-8"})

    # -- location push (KeepConnected analog) --------------------------------

    def _cluster_watch(self, query: dict, body: bytes):
        """Long-lived location push stream: an initial snapshot of
        every node's volumes, then deltas as heartbeats change them
        (master_grpc_server.go KeepConnected broadcasting
        VolumeLocation messages).  Followers refuse: their topology is
        empty and a heartbeating-but-delta-free stream would silently
        disable push invalidation; the client redials (rotating seeds)
        until it finds the leader.  A deposed leader ends its streams
        from the sweep loop for the same reason."""
        if not self.is_leader():
            raise rpc.RpcError(503, "not the leader; redial")
        stream = rpc.EventStream()
        with self._watchers_lock:
            self._watchers.append(stream)
        stream.on_close(lambda: self._drop_watcher(stream))
        with self.topo._lock:
            for dc in list(self.topo.children.values()):
                for rack in list(dc.children.values()):
                    for dn in list(rack.children.values()):
                        vids = sorted(set(dn.volumes)
                                      | set(dn.ec_shards))
                        if vids:
                            stream.push({"url": dn.url(),
                                         "public_url": dn.public_url,
                                         "new_vids": vids,
                                         "deleted_vids": []})
        return (200, stream, {"Content-Type": "application/x-ndjson"})

    def _drop_watcher(self, stream) -> None:
        with self._watchers_lock:
            if stream in self._watchers:
                self._watchers.remove(stream)

    def _broadcast_locations(self, doc: dict) -> None:
        with self._watchers_lock:
            watchers = list(self._watchers)
        for w in watchers:
            try:
                w.push(doc)
            except Exception:  # noqa: BLE001 — a dying stream cleans
                pass           # itself up via on_close

    @staticmethod
    def _locs_blocked(locs) -> bool:
        """True when ANY replica of a candidate volume sits on a node
        that should not take new writes: draining (rolling restart) or
        below its free-space reserve.  A write to such a volume would
        fail at fan-out time — steer the assignment away instead."""
        return any(getattr(dn, "draining", False)
                   or getattr(dn, "low_disk", False) for dn in locs)

    def _steering_exclude(self):
        """The pick_for_write exclude predicate, or None in the steady
        state: filtering every writable volume through the predicate
        is O(writables x replicas) on the assign hot path, so pay it
        only while at least one node is actually draining or below its
        reserve (one O(nodes) scan per assign)."""
        for dn in list(self.topo.leaves()):
            if getattr(dn, "draining", False) or \
                    getattr(dn, "low_disk", False):
                return self._locs_blocked
        return None

    def _option_from_query(self, query: dict) -> VolumeGrowOption:
        return VolumeGrowOption(
            collection=query.get("collection", ""),
            replica_placement=query.get("replication",
                                        self.default_replication),
            ttl=query.get("ttl", ""),
            data_center=query.get("dataCenter", ""),
            rack=query.get("rack", ""),
            data_node=query.get("dataNode", ""))

    def _quota_verdict(self, tenant: str) -> tuple | None:
        """(rule, used_bytes, used_objects, reasons) when the tenant is
        over a stored-usage quota, else None."""
        rule = self.tenant_policy.rule_for(tenant)
        if rule is None or not (rule.max_bytes or rule.max_objects):
            return None
        used_b, used_o = self.usage_rollup.usage_for(tenant)
        reasons = []
        if rule.max_bytes and used_b >= rule.max_bytes:
            reasons.append(f"stored bytes {used_b} >= "
                           f"max_bytes {rule.max_bytes}")
        if rule.max_objects and used_o >= rule.max_objects:
            reasons.append(f"stored objects {used_o} >= "
                           f"max_objects {rule.max_objects}")
        if not reasons:
            return None
        return (rule, used_b, used_o, reasons)

    def _check_assign_quota(self, tenant: str) -> None:
        """Hard byte/object quotas reject at ASSIGN time — before any
        volume server sees a byte — with the same 403 QuotaExceeded
        the filer/S3 front door answers.  Soft rules only journal (one
        `quota.exceeded` row per tenant per >=5s episode) and surface
        on healthz."""
        if not tenant:
            return
        verdict = self._quota_verdict(tenant)
        if verdict is None:
            return
        rule, used_b, used_o, reasons = verdict
        now = time.monotonic()
        if now - self._last_quota_emit.get(tenant, 0.0) >= 5.0:
            self._last_quota_emit[tenant] = now
            from ..events import emit as emit_event
            emit_event("quota.exceeded", node=self.url(),
                       severity="warn", tenant=tenant,
                       soft=rule.soft, used_bytes=used_b,
                       used_objects=used_o, reason="; ".join(reasons))
        if rule.soft:
            return
        raise rpc.RpcError(
            403, f"QuotaExceeded: tenant {tenant!r} over quota "
                 f"({'; '.join(reasons)}); delete data (and let "
                 f"vacuum reclaim) to resume writes")

    def _assign(self, query: dict, body: bytes) -> dict:
        if not self.is_leader():
            return self._proxy_to_leader("/dir/assign", query, body)
        self._check_assign_quota(query.get("_tenant", ""))
        from .raft import NotLeader
        option = self._option_from_query(query)
        count = int(query.get("count", 1))
        layout = self.topo.layout_for(option)
        if layout.active_volume_count(option) == 0:
            with self._grow_lock:
                if layout.active_volume_count(option) == 0:
                    try:
                        grown = self.vg.grow_by_type(
                            self.topo, option, self._allocate_volume)
                    except NotLeader:
                        # Lost leadership mid-grow; hand the request on.
                        return self._proxy_to_leader("/dir/assign",
                                                     query, body)
                    if grown == 0:
                        raise rpc.RpcError(
                            406, "no free volumes and cannot grow")
                    from ..events import emit as emit_event
                    emit_event("volume.grow", node=self.url(),
                               count=grown, reason="assign",
                               collection=option.collection)
        exclude = self._steering_exclude()
        try:
            fid, count, locs = self.topo.pick_for_write(
                count, option, layout, exclude=exclude)
        except NotLeader:
            # The RaftSequencer's block alloc can discover lost
            # leadership (exactly the failover window it exists for):
            # hand the request to the new leader like the grow path.
            return self._proxy_to_leader("/dir/assign", query, body)
        except TimeoutError as e:
            raise rpc.RpcError(
                503, f"file-id allocation not committed: {e}") from None
        except ValueError:
            # Writable volumes exist, but every one has a replica on a
            # draining or reserve-breached node (rolling restart, disk
            # filling up): grow fresh volumes on the healthy nodes and
            # pick again; if the cluster genuinely has nowhere to put
            # a write, hand the client a paced retry.
            with self._grow_lock:
                try:
                    grown = self.vg.grow_by_type(self.topo, option,
                                                 self._allocate_volume)
                except NotLeader:
                    return self._proxy_to_leader("/dir/assign", query,
                                                 body)
                except Exception:  # noqa: BLE001 — no healthy slots
                    grown = 0
            if grown:
                from ..events import emit as emit_event
                emit_event("volume.grow", node=self.url(), count=grown,
                           reason="steering",
                           collection=option.collection)
            try:
                fid, count, locs = self.topo.pick_for_write(
                    count, option, layout, exclude=exclude)
            except (ValueError, TimeoutError):
                raise rpc.RpcError(
                    503, "no writable volumes outside draining/"
                         "low-disk nodes; retry",
                    headers={"Retry-After": "1"}) from None
            except NotLeader:
                return self._proxy_to_leader("/dir/assign", query,
                                             body)
        dn = locs[0]
        out = {"fid": fid, "count": count,
               "url": dn.url(), "publicUrl": dn.public_url,
               "replicas": [{"url": n.url(), "publicUrl": n.public_url}
                            for n in locs[1:]]}
        if self.jwt_signing_key:
            from ..utils.security import gen_jwt
            out["auth"] = gen_jwt(self.jwt_signing_key,
                                  self.jwt_expires_seconds, fid)
        return out

    def _allocate_volume(self, vid: int, option: VolumeGrowOption,
                         server) -> None:
        rpc.call_json(
            f"http://{server.url()}/admin/assign_volume",
            payload={"volume": vid, "collection": option.collection,
                     "replication": option.replica_placement,
                     "ttl": option.ttl})
        # Optimistic registration; the next heartbeat confirms.
        self.topo.register_volume(VolumeInfo(
            id=vid, collection=option.collection, size=0, file_count=0,
            delete_count=0, deleted_byte_count=0, read_only=False,
            replica_placement=ReplicaPlacement.parse(
                option.replica_placement).to_byte(),
            ttl=TTL.parse(option.ttl).to_uint32(),
            compact_revision=0), server)
        from ..events import emit as emit_event
        emit_event("volume.assign", node=server.url(), vid=vid,
                   collection=option.collection,
                   replication=option.replica_placement)

    def _lookup(self, query: dict, body: bytes) -> dict:
        if not self.is_leader():
            # Volume state lives on the leader (heartbeats go there);
            # followers proxy reads too (master_server.go:155).
            return self._proxy_to_leader("/dir/lookup", query, body,
                                         "GET")
        vid_str = query.get("volumeId", "")
        if "," in vid_str:
            vid_str = vid_str.split(",")[0]
        vid = int(vid_str)
        collection = query.get("collection", "")
        locs = self.topo.lookup(collection, vid)
        if locs:
            locations = [{"url": dn.url(), "publicUrl": dn.public_url}
                         for dn in locs]
            # steered=1 marks a peer master's own steering fetch: never
            # steer it back (two masters steering each other would
            # recurse until a timeout).
            if self.steer_reads and query.get("steered") != "1":
                locations = self._steer_locations(vid, query, locations)
            out = {"volumeId": vid, "locations": locations}
            # Write token for delete/update of an existing fid
            # (operation/delete_content.go fetches a lookup jwt).
            if self.jwt_signing_key and query.get("fileId"):
                from ..utils.security import gen_jwt
                out["auth"] = gen_jwt(self.jwt_signing_key,
                                      self.jwt_expires_seconds,
                                      query["fileId"])
            return out
        ec = self.topo.lookup_ec_shards(vid)
        if ec is not None:
            return {"volumeId": vid, "ecCodec": ec.codec, "ecShards": {
                str(sid): [{"url": dn.url(), "publicUrl": dn.public_url}
                           for dn in dns]
                for sid, dns in ec.locations.items() if dns}}
        raise rpc.RpcError(404, f"volume {vid} not found")

    # -- geo locality steering ----------------------------------------------

    def _peer_mirror_rows(self) -> dict:
        """Per-volume mirror rows from the PEER master's
        /cluster/mirror, cached for `steer_refresh` seconds.  The
        peer's shipper lag for a volume IS our local replica's
        staleness (the peer ships volumes it holds to us), so this map
        answers "is my local copy of vid within the lag SLO?"."""
        with self._steer_lock:
            ts, rows = self._steer_mirror
            if time.time() - ts < self.steer_refresh:
                return rows
        try:
            doc = rpc.call(f"http://{self.steer_peer}/cluster/mirror",
                           timeout=2.0)
            rows = {int(r["volume"]): r
                    for r in doc.get("volumes", [])
                    if "volume" in r}
        except (rpc.RpcError, OSError, ConnectionError, ValueError,
                TypeError):
            rows = {}
        with self._steer_lock:
            self._steer_mirror = (time.time(), rows)
        return rows

    def _peer_locations(self, vid: int, collection: str) -> list:
        """The peer cluster's replica locations for `vid`, from the
        peer master's /dir/lookup, cached for `steer_refresh`
        seconds.  Empty on any failure — steering degrades to
        unsteered, it never breaks a lookup."""
        with self._steer_lock:
            hit = self._steer_locs.get(vid)
            if hit is not None and \
                    time.time() - hit[0] < self.steer_refresh:
                return hit[1]
        locs: list = []
        try:
            qs = urllib.parse.urlencode(
                {"volumeId": vid, "collection": collection,
                 "steered": 1})
            doc = rpc.call(
                f"http://{self.steer_peer}/dir/lookup?{qs}",
                timeout=2.0)
            locs = list(doc.get("locations", []))
        except (rpc.RpcError, OSError, ConnectionError,
                ValueError, TypeError):
            locs = []
        with self._steer_lock:
            self._steer_locs[vid] = (time.time(), locs)
        return locs

    def _steer_locations(self, vid: int, query: dict,
                         locations: list) -> list:
        """Reorder a /dir/lookup answer for geo locality: prepend the
        peer cluster's replicas when (a) the requesting tenant's
        quota rule pins a home= region that isn't ours, or (b) our
        local replica is mirrored FROM the peer and its lag exceeds
        the lag SLO (reads here would see stale data).  Clients walk
        the list in order and re-lookup on 429/503, so steering is
        advisory and self-healing; any steering failure returns the
        unsteered list."""
        prefer_peer = False
        tenant = query.get("tenant", "")
        if tenant and self.geo_cluster_id:
            rule = self.tenant_policy.rule_for(tenant)
            if rule is not None and rule.home and \
                    rule.home != self.geo_cluster_id:
                prefer_peer = True
        if not prefer_peer and self.replication_lag_slo is not None:
            row = self._peer_mirror_rows().get(vid)
            if row is not None and \
                    float(row.get("lag_seconds", 0.0) or 0.0) > \
                    self.replication_lag_slo:
                prefer_peer = True
        if not prefer_peer:
            return locations
        peer_locs = self._peer_locations(
            vid, query.get("collection", ""))
        if not peer_locs:
            return locations
        seen = {loc.get("url") for loc in peer_locs}
        return peer_locs + [loc for loc in locations
                            if loc.get("url") not in seen]

    def _status(self, query: dict, body: bytes) -> dict:
        if not self.is_leader() and self.raft.leader():
            return self._proxy_to_leader("/dir/status", query, body,
                                         "GET")
        def node_dict(n):
            out = {"id": n.id, "volumes": n.volume_count,
                   "max": n.max_volume_count, "free": n.free_space(),
                   "ecShards": n.ec_shard_count}
            if n.children:
                out["children"] = [node_dict(c)
                                   for c in n.children.values()]
            return out
        return {"topology": node_dict(self.topo),
                "max_volume_id": self.topo.max_volume_id}

    def _grow(self, query: dict, body: bytes) -> dict:
        if not self.is_leader():
            return self._proxy_to_leader("/vol/grow", query, body)
        option = self._option_from_query(query)
        count = int(query.get("count", 0)) or None
        with self._grow_lock:
            grown = self.vg.grow_by_type(self.topo, option,
                                         self._allocate_volume,
                                         ) if count is None else \
                self._grow_n(option, count)
        if grown:
            from ..events import emit as emit_event
            emit_event("volume.grow", node=self.url(), count=grown,
                       reason="explicit", collection=option.collection)
        return {"count": grown}

    def _grow_n(self, option: VolumeGrowOption, n: int) -> int:
        grown = 0
        for _ in range(n):
            try:
                servers = self.vg.find_empty_slots_for_one_volume(
                    self.topo, option)
            except ValueError:
                break
            vid = self.topo.next_volume_id()
            try:
                for server in servers:
                    self._allocate_volume(vid, option, server)
            except Exception:  # noqa: BLE001 — a dead server shouldn't
                continue       # void the volumes grown so far
            grown += 1
        return grown

    def _col_list(self, query: dict, body: bytes) -> dict:
        if not self.is_leader():
            return self._proxy_to_leader("/col/list", query, body, "GET")
        return {"collections": sorted(self.topo.collections)}

    def _col_delete(self, query: dict, body: bytes) -> dict:
        if not self.is_leader():
            return self._proxy_to_leader("/col/delete", query, body)
        name = query.get("collection", "")
        col = self.topo.collections.get(name)
        if col is None:
            raise rpc.RpcError(404, f"collection {name!r} not found")
        # Tell every server holding its volumes to delete them.
        deleted = 0
        for vl in col.layouts.values():
            for vid, dns in list(vl.vid2location.items()):
                for dn in dns:
                    try:
                        rpc.call_json(
                            f"http://{dn.url()}/admin/delete_volume",
                            payload={"volume": vid})
                        deleted += 1
                    except rpc.RpcError:
                        pass
        self.topo.delete_collection(name)
        return {"deleted_replicas": deleted}

    def _cluster_status(self, query: dict, body: bytes) -> dict:
        from ..stats.sysstats import proc_cpu_seconds
        out = {"leader": self.leader_url(),
               "is_leader": self.is_leader(),
               "volume_size_limit": self.topo.volume_size_limit,
               "cpu_seconds": proc_cpu_seconds(), "pid": os.getpid()}
        if self.raft is not None:
            out["peers"] = [self.url()] + self.raft.peers
            out["raft"] = {"state": self.raft.state,
                           "term": self.raft.current_term,
                           "commit_index": self.raft.commit_index}
        return out

    # -- health rollup + event aggregation -----------------------------------

    def _node_health_values(self) -> dict:
        """SeaweedFS_node_health{node=} callback: 1 while a node's last
        heartbeat is within the dead-node threshold, else 0."""
        now = time.time()
        fresh = 2 * self.topo.pulse_seconds
        return {(dn.url(),): 1.0 if now - dn.last_seen <= fresh else 0.0
                for dn in list(self.topo.leaves())}

    def health_report(self) -> tuple[bool, dict]:
        """Derived cluster health: per-node liveness (heartbeat age,
        outbound breaker state, disk fill) and per-volume/EC-volume
        health (missing shards, readonly, garbage ratio).  Returns
        (healthy, detail) — the /cluster/healthz and cluster.check
        core."""
        from ..codecs import get_codec
        from . import resilience as _res
        now = time.time()
        fresh = 2 * self.topo.pulse_seconds
        problems: list[str] = []
        nodes = []
        volumes = []
        replication_rows = []
        with self.topo._lock:
            leaves = list(self.topo.leaves())
            ec_map = {vid: ({sid: [dn.url() for dn in dns]
                             for sid, dns in loc.locations.items() if dns},
                            loc.codec)
                      for vid, loc in self.topo.ec_shard_map.items()}
        slo_reads: list[dict] = []
        slo_writes: list[dict] = []
        burning_nodes: list[str] = []
        for dn in leaves:
            age = now - dn.last_seen
            alive = age <= fresh
            breaker = _res._breakers.get(dn.url())
            slo_state = getattr(dn, "slo_state", None) or {}
            row = {"node": dn.url(), "heartbeat_age": round(age, 3),
                   "alive": alive,
                   "breaker": breaker.state if breaker else "closed",
                   "volumes": len(dn.volumes),
                   "ec_shards": len(dn.ec_shards),
                   "draining": getattr(dn, "draining", False),
                   "low_disk": getattr(dn, "low_disk", False),
                   "disks": getattr(dn, "disk_statuses", []),
                   "slo": {k: slo_state.get(k, False)
                           for k in ("declared", "fast_burn",
                                     "slow_burn")}}
            nodes.append(row)
            # Heartbeat-fed SLO state: fast burn degrades the cluster
            # (the node is violating a declared objective NOW); its
            # read/write sketches fold into the cluster-wide tail.
            # Gated on liveness — a dead node's FINAL verdict and
            # window must not haunt the "live" rollup forever (its
            # staleness is already its own problem row above).
            if alive and slo_state.get("fast_burn"):
                burning_nodes.append(dn.url())
                problems.append(
                    f"node {dn.url()}: SLO fast burn — a declared "
                    f"objective's error budget is burning at page "
                    f"rate (see /debug/slo on the node)")
            if alive and isinstance(slo_state.get("read"), dict):
                slo_reads.append(slo_state["read"])
            if alive and isinstance(slo_state.get("write"), dict):
                slo_writes.append(slo_state["write"])
            if not alive:
                problems.append(
                    f"node {dn.url()}: heartbeat stale {age:.1f}s")
            if row["low_disk"]:
                problems.append(
                    f"node {dn.url()}: disk reserve breached — "
                    f"volumes readonly until space recovers")
            if row["breaker"] == "open":
                problems.append(f"node {dn.url()}: circuit breaker open")
            for d in row["disks"]:
                if d.get("percent_used", 0) >= 95.0:
                    problems.append(
                        f"node {dn.url()}: disk {d.get('dir', '?')} "
                        f"{d['percent_used']:.1f}% full")
            for vid, cnt in sorted(getattr(dn, "ec_corrupt",
                                           {}).items()):
                problems.append(
                    f"ec volume {vid}: {cnt} corrupt shard block(s) "
                    f"on {dn.url()} unrepaired")
            repl = getattr(dn, "replication", None)
            if alive and repl:
                for vid, rrow in sorted(
                        (repl.get("volumes") or {}).items()):
                    replication_rows.append(dict(
                        rrow, volume=int(vid), node=dn.url(),
                        peer=repl.get("peer", ""),
                        paused=repl.get("paused", False)))
                    lag = float(rrow.get("lag_seconds", 0) or 0)
                    if self.replication_lag_slo is not None and \
                            lag > self.replication_lag_slo:
                        # Mirror lag SLO breach: the standby would
                        # lose up to `lag` seconds of acked writes if
                        # the primary died now — degrade until it
                        # catches back up to the watermark.
                        problems.append(
                            f"volume {vid} on {dn.url()}: replication "
                            f"lag {lag:.1f}s exceeds SLO "
                            f"{self.replication_lag_slo:g}s "
                            f"({rrow.get('lag_seq', 0)} records "
                            f"unacked by {repl.get('peer', '?')})")
            for v in list(dn.volumes.values()):
                ratio = (v.deleted_byte_count / v.size) if v.size else 0.0
                volumes.append({"id": v.id, "node": dn.url(),
                                "collection": v.collection,
                                "read_only": v.read_only,
                                "corrupt": v.corrupt_count,
                                "garbage_ratio": round(ratio, 4)})
                if v.corrupt_count:
                    # Unrepaired corruption = degraded, exactly like
                    # missing EC shards: the data is at reduced
                    # redundancy until the scrub (or an operator
                    # volume.scrub -repair) heals it.
                    problems.append(
                        f"volume {v.id} on {dn.url()}: "
                        f"{v.corrupt_count} corrupt needle(s) "
                        f"quarantined, unrepaired")
        if not leaves:
            problems.append("no live data nodes")
        ec_volumes = []
        for vid, (locs, codec_name) in sorted(ec_map.items()):
            # Shard counts (and decodability) are per-codec in a
            # mixed-codec cluster, not the RS(10,4) constants.
            try:
                codec = get_codec(codec_name)
            except ValueError:  # unknown codec id in a stale heartbeat
                codec = get_codec("rs")
            total = codec.total_shards
            missing = [s for s in range(total) if s not in locs]
            try:
                codec.repair_plan(tuple(locs), missing)
                recoverable = True
            except ValueError:
                recoverable = False
            ec_volumes.append({"id": vid, "present": len(locs),
                               "codec": codec_name, "missing": missing})
            if not recoverable:
                problems.append(
                    f"ec volume {vid}: UNRECOVERABLE — only "
                    f"{len(locs)} of {total} shards survive "
                    f"({codec_name})")
            elif missing:
                problems.append(
                    f"ec volume {vid}: degraded — missing shards "
                    f"{missing}")
        # Cluster-wide SLO rollup: the master's own tracker plus every
        # node's heartbeat sketches, merged (exact bucket addition,
        # stats/sketch.py) into one read tail and one write tail — the
        # number a load balancer or the bench harness cross-checks.
        from ..stats import slo as _slo
        own = self.server.slo
        own_view = own.heartbeat_view()
        if own_view.get("fast_burn"):
            burning_nodes.append(f"master {self.url()}")
            problems.append(
                f"master {self.url()}: SLO fast burn — a declared "
                f"objective's error budget is burning at page rate")
        slo_reads.append(own_view["read"])
        slo_writes.append(own_view["write"])

        def _qs(dicts: list[dict]) -> dict:
            merged = _slo.merge_sketch_dicts(dicts)
            if merged is None or merged.count == 0:
                return {"count": 0}
            return {"count": merged.count,
                    "p50": merged.quantile(0.5),
                    "p95": merged.quantile(0.95),
                    "p99": merged.quantile(0.99)}

        slo_doc = {"read": _qs(slo_reads), "write": _qs(slo_writes),
                   "sources": len(slo_reads),
                   "fast_burn": burning_nodes}
        # Tenancy rollup: a tenant over a HARD stored quota is a
        # healthz problem row (mirroring the 403s being answered);
        # soft breaches stay warnings — they must not flip the whole
        # cluster to 503 for a load balancer.
        tenancy_rows = []
        tenancy_warnings = []
        for t, ent in sorted(self.usage_rollup.totals().items()):
            verdict = self._quota_verdict(t)
            tenancy_rows.append({"tenant": t, "bytes": ent["bytes"],
                                 "objects": ent["objects"],
                                 "over_quota": verdict is not None})
            if verdict is not None:
                rule, _b, _o, reasons = verdict
                if rule.soft:
                    tenancy_warnings.append(
                        f"tenant {t}: soft quota exceeded — "
                        f"{'; '.join(reasons)}")
                else:
                    problems.append(
                        f"tenant {t}: hard quota exceeded — "
                        f"{'; '.join(reasons)} (writes rejected "
                        f"with 403 QuotaExceeded)")
        # Wire-flow budgets: a sustained per-purpose bandwidth breach
        # is a WARNING (like soft quotas) — background traffic running
        # hot must not flip the cluster to 503 for a load balancer,
        # but operators polling healthz should see it.
        flows_warnings = []
        flow_budget_rows = []
        flow_sources = [(dn.url(),
                         (getattr(dn, "flows", None) or {})
                         .get("budgets", {}))
                        for dn in leaves]
        me_flow = f"{self.server.host}:{self.server.port}"
        flow_sources.append(
            (me_flow, _flows.LEDGER.budget_status(local=me_flow)))
        for node, status in flow_sources:
            for purpose_name, st in sorted(status.items()):
                flow_budget_rows.append(dict(st, node=node,
                                             purpose=purpose_name))
                if st.get("breached"):
                    flows_warnings.append(
                        f"node {node}: {purpose_name} over bandwidth "
                        f"budget — {st.get('rate_bps', 0):.0f} B/s "
                        f"sustained against a "
                        f"{st.get('limit_bps', 0):.0f} B/s limit")
        # Device roofline: sustained pipeline-occupancy collapse on a
        # node is a WARNING (like flow budgets) — a starved device
        # wastes the accelerator but serves data fine, so it must
        # never flip healthz to 503.
        device_warnings = []
        device_rows = []
        for dn in leaves:
            dev = getattr(dn, "device", None)
            if not dev:
                continue
            occ = (dev.get("occupancy") or {})
            for kind, row in sorted((occ.get("latest") or {}).items()):
                device_rows.append(dict(row, node=dn.url(),
                                        pipeline=kind))
            for kind, bad in sorted((occ.get("collapsed")
                                     or {}).items()):
                if bad:
                    latest = (occ.get("latest") or {}).get(kind, {})
                    frac = latest.get("fraction")
                    starving = latest.get("starving_stage") or "?"
                    device_warnings.append(
                        f"node {dn.url()}: {kind} pipeline device "
                        f"occupancy collapsed"
                        + (f" to {frac:.0%}" if frac is not None
                           else "")
                        + f" — starved by {starving}")
        # Geo lease rollup (info-only: a moving or remote-held lease
        # is a normal operating state, not a health problem — the
        # fencing failure mode is 409s on the ship path, and those
        # surface as replication lag here).
        lease_doc = {"volumes": 0, "held_local": 0, "moving": 0}
        for dn in leaves:
            lhb = getattr(dn, "leases", None)
            if not lhb:
                continue
            for lrow in (lhb.get("volumes") or {}).values():
                lease_doc["volumes"] += 1
                if lrow.get("holder_is_local"):
                    lease_doc["held_local"] += 1
                if lrow.get("moving"):
                    lease_doc["moving"] += 1
        # Failure-domain audit: replicas that all landed in one
        # rack/DC despite a placement that demands spread, and EC
        # stripes with more shards on one node than same_rack_count+1
        # allows.  Always a WARNING, never 503 — the data is fully
        # readable; the risk is correlated loss.  This is the
        # placement-violation input the autopilot's dedupe /
        # re-placement pass consumes.
        placement_warnings = self._placement_audit()
        # Filer fleet (metadata-HA plane): registered filers appear
        # beside volume nodes; a dead filer or a primary-less shard is
        # a PROBLEM — namespace writes for that shard fail closed.
        filer_rows, filer_problems = self.filer_health_rows()
        problems.extend(filer_problems)
        doc = {"healthy": not problems, "problems": problems,
               "leader": self.leader_url(), "is_leader": self.is_leader(),
               "nodes": nodes, "volumes": volumes,
               "filers": {"nodes": filer_rows,
                          "num_shards": self.filer_shards},
               "ec_volumes": ec_volumes, "slo": slo_doc,
               "replication": {"lag_slo": self.replication_lag_slo,
                               "cluster_id": self.geo_cluster_id
                               or None,
                               "leases": lease_doc,
                               "volumes": replication_rows},
               "lifecycle": self.lifecycle.status(),
               "tenancy": {"rules": len(self.tenant_policy.rules),
                           "warnings": tenancy_warnings,
                           "tenants": tenancy_rows},
               "flows": {"budgets": flow_budget_rows,
                         "warnings": flows_warnings},
               "device": {"occupancy": device_rows,
                          "warnings": device_warnings},
               "placement": {"warnings": placement_warnings},
               "repair": {"enabled": self.repair.enabled,
                          "paused": self.repair.paused,
                          "queue": len(self.repair._queue),
                          "inflight": len(self.repair._inflight)}}
        return not problems, doc

    def _placement_audit(self) -> list[str]:
        """Failure-domain audit rows for health_report (warning-only):
        replicated volumes whose copies all share one rack/DC when the
        placement demands spread, and EC stripes concentrating more
        than same_rack_count+1 shards on a single node."""
        warnings = []
        with self.topo._lock:
            for cname, coll in self.topo.collections.items():
                label = cname or "(default)"
                for layout in coll.layouts.values():
                    rp = layout.rp
                    for vid, locs in sorted(
                            layout.vid2location.items()):
                        if len(locs) < 2:
                            continue
                        dcs = {dn.get_data_center().id for dn in locs}
                        racks = {(dn.get_data_center().id,
                                  dn.get_rack().id) for dn in locs}
                        if rp.diff_data_center_count and len(dcs) == 1:
                            warnings.append(
                                f"volume {vid} ({label}, rp={rp}): all "
                                f"{len(locs)} replicas in data center "
                                f"{next(iter(dcs))}")
                        elif rp.diff_rack_count and len(racks) == 1:
                            warnings.append(
                                f"volume {vid} ({label}, rp={rp}): all "
                                f"{len(locs)} replicas in rack "
                                f"{next(iter(racks))[1]}")
            for vid, loc in sorted(self.topo.ec_shard_map.items()):
                rp = None
                coll = self.topo.collections.get(loc.collection)
                if coll is not None and coll.layouts:
                    rp = next(iter(coll.layouts.values())).rp
                if rp is None:
                    rp = ReplicaPlacement.parse(self.default_replication)
                limit = rp.same_rack_count + 1
                per_node: dict[str, int] = {}
                for sid, dns in loc.locations.items():
                    for dn in dns:
                        url = dn.url()
                        per_node[url] = per_node.get(url, 0) + 1
                for url, n in sorted(per_node.items()):
                    if n > limit:
                        warnings.append(
                            f"ec volume {vid} "
                            f"({loc.collection or '(default)'}): "
                            f"{n} shards on {url} "
                            f"(placement allows {limit})")
        return warnings

    def _cluster_mirror(self, query: dict, body: bytes) -> dict:
        """GET /cluster/mirror — the pairing status rollup: which
        nodes ship to which standby master, per-volume watermarks and
        lag, the configured lag SLO, and a cluster-level verdict
        (`caught_up` = every mirrored volume's lag is zero) — the
        cutover gate the shell polls."""
        if not self.is_leader():
            return self._proxy_to_leader("/cluster/mirror", query,
                                         body, "GET")
        rows = []
        peers = set()
        paused = []
        leases: dict[str, dict] = {}
        with self.topo._lock:
            leaves = list(self.topo.leaves())
        for dn in leaves:
            lhb = getattr(dn, "leases", None)
            if lhb:
                for vid, lrow in sorted(
                        (lhb.get("volumes") or {}).items()):
                    leases[vid] = dict(lrow, node=dn.url())
            repl = getattr(dn, "replication", None)
            if not repl:
                continue
            peers.add(repl.get("peer", ""))
            if repl.get("paused"):
                paused.append(dn.url())
            for vid, rrow in sorted(
                    (repl.get("volumes") or {}).items()):
                rows.append(dict(rrow, volume=int(vid),
                                 node=dn.url(),
                                 peer=repl.get("peer", "")))
        return {"paired": bool(rows or peers),
                "peers": sorted(p for p in peers if p),
                "paused_nodes": paused,
                "lag_slo": self.replication_lag_slo,
                "caught_up": bool(rows) and all(
                    not r.get("lag_seq") for r in rows),
                "cluster_id": self.geo_cluster_id or None,
                "leases": leases,
                "volumes": rows}

    def _cluster_tenants(self, query: dict, body: bytes) -> dict:
        """GET /cluster/tenants — the tenancy rollup: per-tenant stored
        usage (heartbeat-fed, replicas per copy), the matching quota
        rule, and an over_quota verdict per tenant — the shell's
        `cluster.tenants` / `tenant.ls` source."""
        if not self.is_leader():
            return self._proxy_to_leader("/cluster/tenants", query,
                                         body, "GET")
        tenants: dict[str, dict] = {}
        for t, ent in sorted(self.usage_rollup.totals().items()):
            row = {"bytes": ent["bytes"], "objects": ent["objects"],
                   "collections": ent["collections"]}
            rule = self.tenant_policy.rule_for(t)
            if rule is not None:
                row["rule"] = rule.to_dict()
                over = []
                if rule.max_bytes and ent["bytes"] >= rule.max_bytes:
                    over.append("bytes")
                if rule.max_objects and \
                        ent["objects"] >= rule.max_objects:
                    over.append("objects")
                row["over_quota"] = over
                row["enforcement"] = "soft" if rule.soft else "hard"
            tenants[t] = row
        return {"tenants": tenants,
                "rules": self.tenant_policy.to_dict()["rules"],
                "leader": self.url()}

    # -- wire-flow traffic matrix (stats/flows.py) ---------------------------

    def _flow_samples(self) -> dict:
        """node -> (current flow sample, previous sample or None) for
        every flow source: heartbeat-fed volume servers plus this
        master's own live ledger (the master doesn't heartbeat to
        itself — snapshot it here, keeping the last poll's snapshot
        so back-to-back /cluster/flows calls still have a rate base)."""
        samples: dict[str, tuple] = {}
        with self.topo._lock:
            leaves = list(self.topo.leaves())
        for dn in leaves:
            cur = getattr(dn, "flows", None)
            if cur:
                samples[dn.url()] = (cur,
                                     getattr(dn, "flows_prev", None))
        # Scheme-less "host:port", matching the ledger's local
        # identity and the X-Weed-Node header the peers recorded.
        me = f"{self.server.host}:{self.server.port}"
        now = time.time()
        cur = {"ts": now,
               "rows": _flows.LEDGER.snapshot(local=me),
               "budgets": _flows.LEDGER.budget_status(local=me)}
        prev = getattr(self, "_flows_self_prev", None)
        if prev is None or now - prev["ts"] >= 1.0:
            self._flows_self_prev = cur
        samples[me] = (cur, prev)
        return samples

    def _cluster_flows(self, query: dict, body: bytes) -> dict:
        """GET /cluster/flows — the cluster traffic matrix: per
        (src, dst, purpose) cell, cumulative GB both as sent by the
        source and as received by the destination, a rate derived
        from successive ledger samples, per-purpose totals, a
        top-talker link ranking, the per-node budget rollup, and a
        conservation verdict (sender's count must match the
        receiver's within max(1%, 4KB); a reporting node's control
        cell additionally gets the gap MEASURED at merge time — the
        heartbeat POST carries a snapshot that can't include its own
        bytes).  ?purpose= filters to one catalog entry."""
        if not self.is_leader():
            return self._proxy_to_leader("/cluster/flows", query,
                                         body, "GET")
        want = query.get("purpose", "")
        if want:
            _flows.validate(want)
        samples = self._flow_samples()
        cells: dict[tuple, dict] = {}
        for node, (cur, prev) in samples.items():
            prows: dict[tuple, int] = {}
            dt = 0.0
            if prev:
                dt = max(cur["ts"] - prev["ts"], 1e-9)
                for r in prev.get("rows", []):
                    prows[(r["peer"], r["purpose"],
                           r["direction"])] = r["bytes"]
            for r in cur.get("rows", []):
                purpose = r["purpose"]
                if want and purpose != want:
                    continue
                if r["direction"] == "out":
                    key = (node, r["peer"], purpose)
                    side = "sent"
                else:
                    key = (r["peer"], node, purpose)
                    side = "recv"
                c = cells.setdefault(key, {
                    "src": key[0], "dst": key[1], "purpose": purpose,
                    "sent_bytes": None, "recv_bytes": None,
                    "sent_ops": 0, "recv_ops": 0, "rate_bps": 0.0})
                c[side + "_bytes"] = (c[side + "_bytes"] or 0) \
                    + r["bytes"]
                c[side + "_ops"] += r["ops"]
                if prev and r["direction"] == "out":
                    delta = r["bytes"] - prows.get(
                        (r["peer"], purpose, "out"), 0)
                    if delta > 0:
                        c["rate_bps"] += delta / dt
        me = f"{self.server.host}:{self.server.port}"
        gaps = {node: cur.get("gap", 0)
                for node, (cur, _p) in samples.items()}
        paired = 0
        violations: list[dict] = []
        purpose_totals: dict[str, int] = {}
        links: dict[tuple, int] = {}
        for c in cells.values():
            sent, recv = c["sent_bytes"], c["recv_bytes"]
            if sent is not None and recv is not None:
                paired += 1
                skew = abs(sent - recv)
                slack = gaps.get(c["src"], 0) \
                    if c["dst"] == me and c["purpose"] == "control" \
                    else 0
                if skew > max(0.01 * max(sent, recv), 4096 + slack):
                    violations.append({
                        "src": c["src"], "dst": c["dst"],
                        "purpose": c["purpose"], "sent": sent,
                        "recv": recv, "skew": skew})
            vol = sent if sent is not None else (recv or 0)
            c["gb"] = round(vol / float(1 << 30), 6)
            c["rate_bps"] = round(c["rate_bps"], 1)
            purpose_totals[c["purpose"]] = \
                purpose_totals.get(c["purpose"], 0) + vol
            links[(c["src"], c["dst"])] = \
                links.get((c["src"], c["dst"]), 0) + vol
        top = [{"src": s, "dst": d, "bytes": b,
                "gb": round(b / float(1 << 30), 6)}
               for (s, d), b in sorted(links.items(),
                                       key=lambda kv: -kv[1])[:10]]
        budgets = {node: cur.get("budgets", {})
                   for node, (cur, _p) in samples.items()
                   if cur.get("budgets")}
        rows = sorted(cells.values(),
                      key=lambda c: -(c["sent_bytes"]
                                      if c["sent_bytes"] is not None
                                      else (c["recv_bytes"] or 0)))
        return {"ts": time.time(), "leader": self.url(),
                "nodes": sorted(samples),
                "purposes": {p: {"bytes": b,
                                 "gb": round(b / float(1 << 30), 6)}
                             for p, b in sorted(purpose_totals.items(),
                                                key=lambda kv:
                                                -kv[1])},
                "cells": rows, "top_talkers": top, "budgets": budgets,
                "conservation": {"paired_cells": paired,
                                 "ok": not violations,
                                 "violations": violations}}

    def _cluster_device(self, query: dict, body: bytes) -> dict:
        """GET /cluster/device — the device roofline rollup: every
        node's heartbeat-carried kernel rows merged into one cluster
        table keyed by (kernel, codec, dtype, geometry), per-node
        pipeline occupancy with collapse verdicts, and this master's
        own probed peaks.  ?codec= / ?kernel= filter the table."""
        from ..stats import roofline as _roofline
        if not self.is_leader():
            return self._proxy_to_leader("/cluster/device", query,
                                         body, "GET")
        want_kernel = query.get("kernel", "")
        if want_kernel:
            _roofline.validate(want_kernel)
        want_codec = query.get("codec", "")
        with self.topo._lock:
            leaves = list(self.topo.leaves())
        nodes: dict[str, dict] = {}
        merged: dict[tuple, dict] = {}
        warnings: list[str] = []
        for dn in leaves:
            dev = getattr(dn, "device", None)
            if not dev:
                continue
            occ = dev.get("occupancy") or {}
            nodes[dn.url()] = {"ts": dev.get("ts"),
                               "occupancy": occ,
                               "kernels": dev.get("kernels", [])}
            if occ.get("any_collapsed"):
                slow = [k for k, v in
                        (occ.get("collapsed") or {}).items() if v]
                warnings.append(
                    f"{dn.url()}: device occupancy collapsed on "
                    f"{','.join(sorted(slow)) or 'pipeline'}")
            for row in dev.get("kernels", []):
                if want_kernel and row["kernel"] != want_kernel:
                    continue
                if want_codec and row["codec"] != want_codec:
                    continue
                key = (row["kernel"], row["codec"], row["dtype"],
                       row["geometry"])
                m = merged.setdefault(key, {
                    "kernel": key[0], "codec": key[1],
                    "dtype": key[2], "geometry": key[3], "count": 0,
                    "seconds": 0.0, "bytes": 0, "work": 0,
                    "achieved_p50": None, "nodes": 0})
                m["count"] += row.get("count", 0)
                m["seconds"] = round(
                    m["seconds"] + row.get("seconds", 0.0), 6)
                m["bytes"] += row.get("bytes", 0)
                m["work"] += row.get("work", 0)
                m["nodes"] += 1
                p50 = row.get("achieved_p50")
                if p50 is not None:
                    # Worst node's median: the headline should surface
                    # the laggard, not average it away.
                    cur = m["achieved_p50"]
                    m["achieved_p50"] = p50 if cur is None \
                        else min(cur, p50)
        # In-process multi-role stacks run kernels in the master
        # process itself; fold the local ledger in under our own url.
        local = _roofline.LEDGER.heartbeat_view()
        if local["kernels"] and self.url() not in nodes:
            nodes[self.url()] = {"ts": time.time(),
                                 "occupancy": local["occupancy"],
                                 "kernels": local["kernels"]}
        table = sorted(merged.values(),
                       key=lambda m: (-m["seconds"], m["kernel"]))
        return {"ts": time.time(), "leader": self.url(),
                "peaks": _roofline.probe_peaks(),
                "nodes": nodes, "kernels": table,
                "warnings": warnings}

    def _cluster_lifecycle(self, query: dict, body: bytes) -> dict:
        """GET /cluster/lifecycle — the daemon's rules, scan history,
        and recent actions (the shell's cluster.lifecycle)."""
        if not self.is_leader():
            return self._proxy_to_leader("/cluster/lifecycle", query,
                                         body, "GET")
        return self.lifecycle.status()

    def _cluster_lifecycle_run(self, query: dict, body: bytes) -> dict:
        """POST /cluster/lifecycle/run — one synchronous policy scan
        (the shell's `cluster.lifecycle run`; tests drive the daemon
        through this instead of waiting out -lifecycle.interval)."""
        if not self.is_leader():
            return self._proxy_to_leader("/cluster/lifecycle/run",
                                         query, body, "POST")
        return self.lifecycle.scan_once()

    def _cluster_repair(self, query: dict, body: bytes) -> dict:
        """GET /cluster/repair — durability autopilot status: queue,
        in-flight repairs with per-repair phase, fresh scan (dry-run
        plan with hysteresis/suppression annotations), history tail,
        MTTR histogram."""
        if not self.is_leader():
            return self._proxy_to_leader("/cluster/repair", query,
                                         b"", "GET")
        return self.repair.status()

    def _cluster_repair_run(self, query: dict, body: bytes) -> dict:
        """POST /cluster/repair/run — one synchronous repair drain
        (the shell's `cluster.repair run` / `volume.fix.replication`;
        tests drive the daemon through this instead of waiting out
        hysteresis).  Body may carry {"kinds": ["replicate"|"ec"]}."""
        if not self.is_leader():
            return self._proxy_to_leader("/cluster/repair/run",
                                         query, body, "POST")
        kinds = None
        if body:
            kinds = json.loads(body).get("kinds")
        return self.repair.run_now(kinds=kinds)

    def _cluster_repair_switch(self, query: dict, body: bytes,
                               pause: bool) -> dict:
        """POST /cluster/repair/pause|resume — runtime governor (pause
        before risky maintenance the drain fence can't see)."""
        path = "/cluster/repair/" + ("pause" if pause else "resume")
        if not self.is_leader():
            return self._proxy_to_leader(path, query, body, "POST")
        return self.repair.pause() if pause else self.repair.resume()

    def _healthz(self, query: dict, body: bytes):
        """GET /cluster/healthz — 200/503 for load balancers, JSON
        detail for humans.  A follower answers for itself: 200 while a
        leader is known (it can proxy), 503 when the cluster is
        leaderless."""
        if not self.is_leader():
            leader = self.raft.leader()
            return (200 if leader else 503,
                    {"healthy": bool(leader), "is_leader": False,
                     "leader": leader,
                     "problems": [] if leader else ["no leader elected"]})
        ok, doc = self.health_report()
        return (200 if ok else 503, doc)

    def _cluster_events(self, query: dict, body: bytes):
        """GET /cluster/events — master-side aggregation into one
        cluster timeline: this process's journal merged with every
        registered data node's /debug/events, deduplicated by
        (journal token, seq) so roles sharing an in-process journal
        are not double-counted."""
        import urllib.parse

        from ..events import JOURNAL, TYPES
        type_ = query.get("type", "")
        if type_ and type_ not in TYPES:
            raise rpc.RpcError(400, f"unknown event type {type_!r}")
        severity = query.get("severity", "")
        try:
            since = float(query.get("since", 0) or 0)
            limit = int(query.get("limit", 0) or 0)
        except ValueError:
            raise rpc.RpcError(400, "since/limit must be numbers") \
                from None
        fwd = {k: v for k, v in (("type", type_),
                                 ("since", query.get("since", "")),
                                 ("severity", severity)) if v}
        qs = urllib.parse.urlencode(fwd)
        merged: dict[tuple, dict] = {}
        for ev in JOURNAL.snapshot(type_=type_, since=since,
                                   severity=severity):
            merged[(JOURNAL.token, ev["seq"])] = ev
        # Fan the per-node fetches out: during an incident (exactly
        # when this timeline is being polled) unreachable nodes are
        # likely, and N serial 5s connect timeouts would stall the
        # handler thread for the whole window.
        nodes = list(self.topo.leaves())

        def _fetch(dn):
            url = f"http://{dn.url()}/debug/events" \
                + (f"?{qs}" if qs else "")
            try:
                out = rpc.call(url, timeout=5.0)
                return dn, out if isinstance(out, dict) else None
            except Exception:  # noqa: BLE001 — endpoint off / node gone
                return dn, None

        results = []
        threads = []
        for dn in nodes:
            th = threading.Thread(
                target=lambda d=dn: results.append(_fetch(d)))
            th.start()
            threads.append(th)
        for th in threads:
            th.join()
        reached, failed = 1, 0
        for dn, out in results:
            if out is None:
                failed += 1
                continue
            reached += 1
            token = out.get("token", dn.url())
            for ev in out.get("events", []):
                merged.setdefault((token, ev.get("seq", 0)), ev)
        events = sorted(merged.values(), key=lambda e: e["ts"])
        if limit > 0:
            events = events[-limit:]
        return {"events": events, "servers_reached": reached,
                "servers_failed": failed}

    def _vol_list(self, query: dict, body: bytes) -> dict:
        """Detailed topology dump (master VolumeList RPC): every node with
        its full per-volume info and EC shard bits — the shell's view."""
        if not self.is_leader():
            return self._proxy_to_leader("/vol/list", query, body, "GET")
        dcs = []
        with self.topo._lock:  # heartbeats mutate these dicts concurrently
            for dc in list(self.topo.children.values()):
                racks = []
                for rack in list(dc.children.values()):
                    nodes = []
                    for dn in list(rack.children.values()):
                        nodes.append({
                            "id": dn.id, "url": dn.url(),
                            "public_url": dn.public_url,
                            "max_volume_count": dn.max_volume_count,
                            "volumes": [vinfo_to_dict(v)
                                        for v in list(dn.volumes.values())],
                            "ec_shards": [
                                {"id": vid, "shard_bits": bits,
                                 "codec": self.topo.ec_codec(vid)}
                                for vid, bits in dn.ec_shards.items()],
                        })
                    racks.append({"id": rack.id, "nodes": nodes})
                dcs.append({"id": dc.id, "racks": racks})
        return {"topology": {"data_centers": dcs},
                "volume_size_limit": self.topo.volume_size_limit}

    def _admin_lease(self, query: dict, body: bytes) -> dict:
        """LeaseAdminToken: grant/renew the exclusive maintenance lock."""
        if not self.is_leader():
            return self._proxy_to_leader("/admin/lease", query, body)
        req = json.loads(body) if body else {}
        name = req.get("name", "shell")
        prev = req.get("token")
        now = time.time()
        with self._admin_lock:
            held = (self._admin_token is not None
                    and now < self._admin_expires)
            if held and self._admin_token != prev:
                raise rpc.RpcError(
                    409, f"admin lock held by {self._admin_holder}")
            self._admin_token = prev or (hash((name, now)) & 0x7FFFFFFF)
            self._admin_holder = name
            self._admin_expires = now + self._admin_lock_ttl
            return {"token": self._admin_token,
                    "ttl": self._admin_lock_ttl}

    def _admin_release(self, query: dict, body: bytes) -> dict:
        if not self.is_leader():
            return self._proxy_to_leader("/admin/release", query, body)
        req = json.loads(body) if body else {}
        with self._admin_lock:
            if self._admin_token == req.get("token"):
                self._admin_token = None
                self._admin_holder = ""
                self._admin_expires = 0.0
        return {}

    # -- vacuum orchestration ------------------------------------------------

    def _vacuum(self, query: dict, body: bytes) -> dict:
        threshold = float(query.get("garbageThreshold",
                                    self.garbage_threshold))
        return {"vacuumed": self._run_vacuum_scan(threshold)}

    def _run_vacuum_scan(self, threshold: float) -> list[int]:
        """Ask each node for garbage ratios; vacuum replicas over threshold
        (reference: topology/topology_vacuum.go)."""
        vacuumed = []
        for dn in list(self.topo.leaves()):
            try:
                status = rpc.call_json(f"http://{dn.url()}/admin/status",
                                       payload={})
            except Exception:  # noqa: BLE001
                continue
            for v in status.get("volumes", []):
                if v.get("garbage_ratio", 0) > threshold:
                    try:
                        rpc.call_json(
                            f"http://{dn.url()}/admin/vacuum",
                            payload={"volume": v["id"]})
                        vacuumed.append(v["id"])
                    except rpc.RpcError:
                        pass
        return vacuumed

    # -- filer metadata-HA plane (shard map + filer registry) ----------------

    def _load_shard_map(self) -> None:
        if not self._shard_map_path:
            return
        try:
            with open(self._shard_map_path) as f:
                doc = json.load(f)
            self._shard_map = {int(k): v
                               for k, v in doc.get("shards",
                                                   {}).items()}
            self._shard_map_version = int(doc.get("version", 0))
            if not self.filer_shards:
                self.filer_shards = int(doc.get("num_shards", 0))
        except (OSError, ValueError):
            pass

    def _store_shard_map(self) -> None:
        """Atomic tmp+fsync+rename: a restart must never regress an
        epoch (that would un-fence a deposed primary)."""
        if not self._shard_map_path:
            return
        import os
        tmp = f"{self._shard_map_path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"version": self._shard_map_version,
                           "num_shards": self.filer_shards,
                           "shards": {str(k): v for k, v in
                                      self._shard_map.items()}}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._shard_map_path)
        except OSError:
            pass

    def _shard_map_doc(self) -> dict:
        return {"num_shards": self.filer_shards,
                "version": self._shard_map_version,
                "shards": {str(k): v
                           for k, v in self._shard_map.items()}}

    def _filer_fresh_cutoff(self) -> float:
        return time.time() - 2 * self.topo.pulse_seconds

    def _live_filers(self) -> list[str]:
        cutoff = self._filer_fresh_cutoff()
        return sorted(u for u, row in self._filers.items()
                      if row.get("last_seen", 0) >= cutoff)

    def _filer_heartbeat(self, query: dict, body: bytes):
        """Filer registration + pulse (the volume-server /heartbeat
        analog).  The response carries the shard map when the plane is
        armed — map distribution rides the beat, no extra poll."""
        if not self.is_leader():
            return {"leader": self.raft.leader(), "is_leader": False}
        hb = json.loads(body or b"{}")
        url = hb.get("url", "")
        if not url:
            raise rpc.RpcError(400, "filer heartbeat without url")
        with self._filer_lock:
            known = url in self._filers
            self._filers[url] = {
                "url": url, "last_seen": time.time(),
                "signature": hb.get("signature", 0),
                "shards": hb.get("shards", {}),
            }
            if not known:
                from ..events import emit as emit_event
                emit_event("heartbeat.recovered", node=url,
                           role="filer")
            if self.filer_shards > 0:
                self._assign_filer_shards()
                return {"is_leader": True, "pulse_seconds":
                        self.topo.pulse_seconds, **self._shard_map_doc()}
        return {"is_leader": True,
                "pulse_seconds": self.topo.pulse_seconds}

    def _assign_filer_shards(self) -> None:
        """Round-robin unowned shards over the live fleet and keep
        follower sets current.  Runs under _filer_lock.  Never touches
        a shard whose primary is alive — reassignment of dead
        primaries is the sweep's job (promotion needs the
        most-caught-up follower, not the next in rotation)."""
        live = self._live_filers()
        if not live:
            return
        changed = False
        for k in range(self.filer_shards):
            row = self._shard_map.get(k)
            if row is None or not row.get("primary"):
                primary = live[k % len(live)]
                row = {"primary": primary,
                       "epoch": (row or {}).get("epoch", 0) + 1,
                       "followers": [u for u in live
                                     if u != primary][:2]}
                self._shard_map[k] = row
                changed = True
                continue
            followers = [u for u in live
                         if u != row["primary"]][:2]
            if set(followers) - set(row.get("followers", [])):
                # Grow-only refresh: new fleet members join as
                # followers; members missing a beat are NOT dropped
                # here (the sweep owns death) — flapping would churn
                # the sync set.
                row["followers"] = sorted(
                    set(row.get("followers", [])) | set(followers))
                changed = True
        if changed:
            self._shard_map_version += 1
            self._store_shard_map()

    def _sweep_dead_filers(self) -> None:
        """Failover: a shard whose primary missed 2 pulses promotes
        the most-caught-up live follower at epoch+1 (the epoch fence
        makes the deposed primary's late pushes refusable)."""
        if self.filer_shards <= 0:
            return
        from ..events import emit as emit_event
        with self._filer_lock:
            live = set(self._live_filers())
            for url in sorted(set(self._filers) - live):
                if not self._filers[url].get("_mourned"):
                    self._filers[url]["_mourned"] = True
                    emit_event("heartbeat.lost", node=url,
                               severity="warn", role="filer")
            changed = False
            lease_cutoff = time.time() - 3 * self.topo.pulse_seconds
            for k, row in sorted(self._shard_map.items()):
                primary = row.get("primary")
                if primary in live:
                    continue
                prow = self._filers.get(primary)
                if prow and prow.get("last_seen", 0) >= lease_cutoff:
                    # Dead to us, but its primary lease (renewed for
                    # 3 pulses at its last heartbeat) may still be
                    # live behind a partition — promoting now could
                    # produce two acking primaries.  Wait it out.
                    continue
                # Most-caught-up follower: ask each candidate for its
                # LIVE journal position — the heartbeat rows can be a
                # pulse stale, and promoting the wrong follower would
                # lose every op acked since its beat.  Fall back to
                # the heartbeat row when a candidate can't answer.
                from ..fault import registry as _fault
                best, best_seq = None, -1
                for f in row.get("followers", []):
                    if f not in live:
                        continue
                    try:
                        if _fault.ARMED:
                            _fault.hit("wan.partition", peer=f,
                                       shard=k)
                        st = rpc.call(
                            f + f"/.meta/shard/status?shard={k}",
                            timeout=2.0)
                        seq = int(st.get("last_seq", 0))
                    except Exception:  # noqa: BLE001 — stale fallback
                        srow = self._filers[f].get("shards",
                                                   {}).get(str(k), {})
                        seq = int(srow.get("last_seq", 0))
                    if seq > best_seq:
                        best, best_seq = f, seq
                if best is None:
                    continue  # contested: fails closed until a
                    #           follower comes back
                old = primary
                row["primary"] = best
                row["epoch"] = int(row.get("epoch", 0)) + 1
                row["followers"] = [u for u in live if u != best]
                changed = True
                emit_event("shard.promote", node=best, severity="warn",
                           shard=k, old_primary=old or "",
                           epoch=row["epoch"], last_seq=best_seq)
                self._push_shard_acquire(k, row,
                                         self._shard_map_version + 1)
            if changed:
                self._shard_map_version += 1
                self._store_shard_map()

    def _push_shard_acquire(self, shard: int, row: dict,
                            version: int) -> None:
        """Best-effort immediate acquire push — the next heartbeat
        map is the backstop if this misses."""
        from ..fault import registry as _fault
        try:
            if _fault.ARMED:
                _fault.hit("wan.partition", peer=row["primary"],
                           shard=shard)
            rpc.call_json(row["primary"] + "/.meta/shard/acquire",
                          payload={"shard": shard,
                                   "epoch": row["epoch"],
                                   "followers": row["followers"],
                                   "version": version},
                          timeout=5.0)
        except Exception:  # noqa: BLE001
            pass

    def _cluster_filer_shards(self, query: dict, body: bytes):
        with self._filer_lock:
            cutoff = self._filer_fresh_cutoff()
            filers = [{"url": u,
                       "alive": row.get("last_seen", 0) >= cutoff,
                       "age_seconds": round(
                           time.time() - row.get("last_seen", 0), 3),
                       "shards": row.get("shards", {})}
                      for u, row in sorted(self._filers.items())]
            return {**self._shard_map_doc(), "filers": filers}

    def _filer_shard_move(self, query: dict, body: bytes):
        """filer.shards.move: demote-first primary transfer.  The old
        primary stops acking BEFORE the new one exists anywhere;
        mid-move the shard is contested and fails closed (the
        lease.py begin_move stance)."""
        if not self.is_leader():
            return self._proxy_to_leader("/cluster/filer/shards/move",
                                         query, body)
        req = json.loads(body or b"{}")
        shard = int(req.get("shard", -1))
        to = req.get("to", "")
        from ..events import emit as emit_event
        with self._filer_lock:
            row = self._shard_map.get(shard)
            if row is None:
                raise rpc.RpcError(404, f"no such shard {shard}")
            if to not in self._live_filers():
                raise rpc.RpcError(
                    409, f"target filer {to} not registered/alive")
            if to == row.get("primary"):
                return {"moved": False, "already": True, **row}
            old = row.get("primary")
            if old:
                from ..fault import registry as _fault
                try:
                    if _fault.ARMED:
                        _fault.hit("wan.partition", peer=old,
                                   shard=shard)
                    rpc.call_json(old + "/.meta/shard/demote",
                                  payload={"shard": shard,
                                           "epoch": row["epoch"]},
                                  timeout=5.0)
                except Exception:  # noqa: BLE001 — unreachable old
                    # primary.  Demote-first fails CLOSED (the geo
                    # lease-move stance): while its lease may still
                    # be live behind a partition, transferring the
                    # shard could produce two acking primaries.
                    # Once the lease TTL has surely lapsed, the
                    # epoch bump below fences its pushes instead.
                    last = self._filers.get(old, {}).get("last_seen",
                                                         0)
                    if last >= time.time() - \
                            3 * self.topo.pulse_seconds:
                        raise rpc.RpcError(
                            503, f"shard {shard} NOT moved: old "
                            f"primary {old} unreachable and its "
                            "lease may still be live; retry after "
                            "the lease TTL") from None
            row["primary"] = to
            row["epoch"] = int(row.get("epoch", 0)) + 1
            row["followers"] = [u for u in self._live_filers()
                                if u != to]
            self._shard_map_version += 1
            self._store_shard_map()
            emit_event("shard.move", node=to, shard=shard,
                       old_primary=old or "", epoch=row["epoch"])
            self._push_shard_acquire(shard, row,
                                     self._shard_map_version)
            return {"moved": True, "shard": shard,
                    "old_primary": old or "", **row}

    def filer_health_rows(self) -> tuple[list[dict], list[str]]:
        """(rows, problems) for /cluster/healthz + cluster.check."""
        with self._filer_lock:
            cutoff = self._filer_fresh_cutoff()
            rows, problems = [], []
            for u, row in sorted(self._filers.items()):
                alive = row.get("last_seen", 0) >= cutoff
                nprim = sum(
                    1 for r in self._shard_map.values()
                    if r.get("primary") == u)
                rows.append({
                    "url": u, "alive": alive,
                    "age_seconds": round(
                        time.time() - row.get("last_seen", 0), 3),
                    "shards_primary": nprim})
                if not alive:
                    problems.append(f"filer {u} missed heartbeats "
                                    "(last seen "
                                    f"{rows[-1]['age_seconds']}s ago)")
            for k in range(self.filer_shards):
                row = self._shard_map.get(k)
                if row is None or not row.get("primary") or \
                        row["primary"] not in {
                            r["url"] for r in rows if r["alive"]}:
                    problems.append(
                        f"filer shard {k} has no live primary "
                        "(writes fail closed)")
            return rows, problems

    def _sweep_loop(self) -> None:
        """Dead-node detection (CollectDeadNodeAndFullVolumes)."""
        while not self._stop.wait(self.topo.pulse_seconds):
            if self.raft is not None and not self.is_leader():
                # Deposed: heartbeats now land on the new leader, so
                # our watch streams would heartbeat forever without
                # deltas — end them; clients redial and find the
                # leader.
                with self._watchers_lock:
                    doomed, self._watchers = self._watchers, []
                for w in doomed:
                    try:
                        w.end()
                    except Exception:  # noqa: BLE001
                        pass
                continue
            self._sweep_dead_nodes()
            self._sweep_dead_filers()
            # Durability autopilot rides the sweep cadence: scan for
            # redundancy deficits the sweep just created (or healed)
            # and drive the repair queue.  tick() never raises.
            self.repair.tick()

    def _sweep_dead_nodes(self) -> None:
        """One dead-node collection round — the sweep loop's body,
        callable directly so tests can drive heartbeat.lost through the
        real path without waiting out a pulse interval."""
        from ..events import emit as emit_event
        from ..trace import root_span
        for dn in self.topo.collect_dead_nodes():
            with root_span("master.dead_node_sweep", "master",
                           node=dn.url()):
                # Snapshot what the node held BEFORE unregistering:
                # unregister_ec_shards drains dn.ec_shards, and both
                # the journal record and the location broadcast must
                # report the pre-death holdings.
                held_volumes = sorted(dn.volumes)
                held_ec = sorted(dn.ec_shards)
                self.topo.unregister_data_node(dn)
                self._hb_known.discard(dn.url())
                emit_event("heartbeat.lost", node=dn.url(),
                           severity="warn",
                           age_seconds=round(
                               time.time() - dn.last_seen, 3),
                           volumes=len(held_volumes),
                           ec_shards=len(held_ec))
                # Dead node: every vid it held needs re-lookup.
                vids = sorted(set(held_volumes) | set(held_ec))
                if vids:
                    self._broadcast_locations({
                        "url": dn.url(), "public_url": dn.public_url,
                        "new_vids": [], "deleted_vids": vids})
