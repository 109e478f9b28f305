"""Server-role subcommands of the port: so far `master`
(reference: weed/command/master.go; seaweedfs_tpu/command/servers.py).

`run_master` starts the in-process `MasterServer` and blocks until
SIGINT/SIGTERM.  The volume, filer, gateway and all-in-one roles come
with the volume-server slice of the port (ROADMAP queue 1, 8b and on).

Global flags every server role honors (parsed by the dispatcher,
command/__init__.py, before the role starts):

  -v <level>          glog verbosity — arms the `glog.v(n)` gates
                      (env WEED_V when the flag is absent)
  -events.file <path> persist the cluster event journal as JSONL
  -events.buffer <n>  event ring capacity; -events=false unmounts the
                      event endpoints
  -flows.budget "purpose=RATE,..."
                      per-purpose bandwidth ceilings for the wire-flow
                      plane (e.g. "repair.fetch=50MB/s"); sustained
                      breaches emit flows.budget events and healthz
                      warnings.  -flows.sustain <s> tunes the breach
                      window (default 2s)
  -debug.traces / -debug.faults / -faults "point=spec;..."
                      observability and fault-injection opt-ins
"""
from __future__ import annotations

import signal
import threading

from ..utils import glog
from . import Command, Flags, register


def _security(component: str):
    """Server SSLContext for `component` from the process-wide
    security.toml (reference: security.LoadServerTLS with the shared
    viper config, weed/security/tls.go).  The client half of the plane
    is installed once by the CLI dispatcher before any command runs.
    Config mistakes (bad client_auth, missing cert files) exit with a
    message instead of a traceback."""
    from ..utils.security import load_server_tls, security_configuration
    try:
        ctx = load_server_tls(security_configuration(), component)
    except Exception as e:  # noqa: BLE001 — bad values / cert paths
        import sys
        print(f"security.toml [grpc.{component}]: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    if ctx is not None:
        glog.infof("serving TLS (security.toml [grpc.%s])", component)
    return ctx


def _transport_flag(flags: Flags) -> str | None:
    """-transport=aio|threads: the role's network core.  `aio` is the
    netcore event loop (readiness-driven accept/read/reap, handlers on
    a bounded worker pool — million-connection front door); `threads`
    is thread-per-connection.  Absent = SEAWEEDFS_TPU_TRANSPORT env,
    else threads."""
    return flags.get("transport") or None


def _slo_flags(flags: Flags) -> dict:
    """-slo.read.p99 (seconds) / -slo.availability (0.999 or 99.9):
    declared objectives for the role's SLO burn engine (stats/slo.py).
    0/absent = undeclared — quantiles and /debug/slow exemplars still
    run, but nothing can burn."""
    return {"slo_read_p99": flags.get_float("slo.read.p99", 0.0) or None,
            "slo_availability":
                flags.get_float("slo.availability", 0.0) or None}


def _wait_forever(servers: list, grace: float | None = None) -> int:
    stop = threading.Event()

    def handler(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)
    try:
        stop.wait()
    finally:
        # Graceful lifecycle: SIGTERM/SIGINT first DRAINS every role
        # that supports it — refuse new writes (503 + Retry-After so
        # clients fail over), finish in-flight requests up to
        # -shutdown.grace, goodbye the master so it unregisters with
        # no dead-sweep window — and only then tears listeners down.
        for s in servers:
            drain = getattr(s, "drain", None)
            if drain is None:
                continue
            try:
                drain(grace) if grace is not None else drain()
            except Exception as e:  # noqa: BLE001 — still stop below
                glog.warningf("drain failed: %s", e)
        for s in reversed(servers):
            s.stop()
    return 0


def _start_master_grpc(m, flags: Flags, ip: str) -> None:
    """The wire-compatible gRPC plane (http port + 10000) is not ported
    yet (ROADMAP queue 1, slice 11): log that it is off, as the
    reference does when grpcio is missing, and serve HTTP alone."""
    if flags.get_bool("grpc", True):
        glog.warningf("gRPC plane disabled (not ported yet)")
    return None


def run_master(flags: Flags, args: list[str]) -> int:
    from ..cluster.master import MasterServer as Master
    from ..utils.config import load_configuration
    # -peers=host1:9333,host2:9333 turns on raft HA (raft_server.go).
    peers = [p if p.startswith("http") else f"http://{p}"
             for p in flags.get("peers", "").split(",") if p]
    # master.toml [master.maintenance]: unattended EC/balance lifecycle
    # (master_server.go startAdminScripts).
    mcfg = load_configuration("master")
    m = Master(
        host=flags.get("ip", "127.0.0.1"),
        port=flags.get_int("port", 9333),
        meta_dir=flags.get("mdir") or None,
        volume_size_limit_mb=flags.get_int("volumeSizeLimitMB", 30 * 1024),
        default_replication=flags.get("defaultReplication", "000"),
        garbage_threshold=flags.get_float("garbageThreshold", 0.3),
        peers=peers or None,
        jwt_signing_key=flags.get("jwt.key", ""),
        ssl_context=_security("master"),
        admin_scripts=mcfg.get_string("master.maintenance.scripts"),
        admin_script_interval=60 * mcfg.get_int(
            "master.maintenance.sleep_minutes", 17),
        max_concurrent=flags.get_int("max.concurrent", 0),
        idle_timeout=flags.get_float("idle.timeout", 120.0),
        transport=_transport_flag(flags),
        # -replicate.lag.slo (seconds): cross-cluster mirror lag above
        # which /cluster/healthz degrades (0/absent = no SLO).
        replication_lag_slo=flags.get_float("replicate.lag.slo",
                                            0.0) or None,
        # Data-lifecycle plane: -lifecycle.rules names a policy file
        # (line grammar or TOML) and turns on the leader-side daemon
        # that tiers cold volumes and vacuums expired TTL data;
        # -lifecycle.mbps throttles its tier-upload bandwidth.
        lifecycle_rules=flags.get("lifecycle.rules", ""),
        lifecycle_interval=flags.get_float("lifecycle.interval", 60.0),
        lifecycle_mbps=flags.get_float("lifecycle.mbps", 32.0),
        # Tenancy plane: -tenant.rules names the quota/QoS policy file
        # (line grammar or TOML) — hard quotas reject at /dir/assign,
        # rps/bw limits throttle with 429, weights drive DRR fairness.
        tenant_rules=flags.get("tenant.rules", ""),
        # Geo active/active: -geo.cluster.id names THIS region;
        # -replicate.steer (with -replicate.steer.peer = the peer
        # region's master) reorders /dir/lookup toward the freshest
        # in-SLO replica, refreshed every -replicate.steer.refresh s.
        geo_cluster_id=flags.get("geo.cluster.id", ""),
        # Disjoint vid residue classes per region (e.g. stride=2 with
        # offset 0 on one region, 1 on the other): active/active
        # masters must never mint the same volume id.
        geo_vid_stride=int(flags.get("geo.vid.stride", "1")),
        geo_vid_offset=int(flags.get("geo.vid.offset", "0")),
        steer_peer=(_norm_master(flags.get("replicate.steer.peer"))
                    .removeprefix("http://")
                    if flags.get("replicate.steer.peer") else None),
        steer_reads=flags.get_bool("replicate.steer", False),
        steer_refresh=flags.get_float("replicate.steer.refresh", 2.0),
        # Metadata HA: -filer.shards=N arms the sharded filer plane —
        # registered filers get consistent-hash-on-directory shards
        # with an epoch-fenced primary each and log-replicated
        # followers; 0 (default) leaves filers standalone.
        # -pulseSeconds sets the master's liveness clock: dead-node
        # sweeps run at 2 pulses and a dead shard primary's lease is
        # waited out for 3 — without the flag, failover time is
        # welded to the 5s default.
        filer_shards=flags.get_int("filer.shards", 0),
        pulse_seconds=flags.get_float("pulseSeconds", 5.0),
        # Durability autopilot: -repair arms the leader-side daemon
        # that automatically re-replicates and EC-rebuilds after node
        # loss; -repair.delay is the hysteresis window before a
        # deficit is acted on (default 2x the dead-sweep threshold),
        # -repair.concurrent bounds parallel repairs.
        repair_enabled=flags.get_bool("repair", False),
        repair_delay=flags.get_float("repair.delay", 0.0) or None,
        repair_concurrent=flags.get_int("repair.concurrent", 2),
        **_slo_flags(flags))
    m.start()
    glog.infof("master serving at %s", m.server.url())
    g = _start_master_grpc(m, flags, flags.get("ip", "127.0.0.1"))
    return _wait_forever([m] + ([g] if g else []))


def _norm_master(addr: str) -> str:
    return addr if addr.startswith("http") else f"http://{addr}"


register(Command("master", "master -port=9333 -mdir=/tmp/meta"
                 " [-transport=aio|threads]"
                 " [-replicate.lag.slo=30(s)]"
                 " [-lifecycle.rules=rules.txt]"
                 " [-lifecycle.interval=60] [-lifecycle.mbps=32]"
                 " [-tenant.rules=tenants.txt]"
                 " [-geo.cluster.id=A] [-geo.vid.stride=2]"
                 " [-geo.vid.offset=0] [-replicate.steer]"
                 " [-replicate.steer.peer=peer-master:9333]"
                 " [-replicate.steer.refresh=2]"
                 " [-filer.shards=0] [-pulseSeconds=5]",
                 "start a master server", run_master))
