"""Server-role subcommands of the port: `master`, `volume`, `filer`,
`msg.broker`, `s3`, `webdav` and the all-in-one `server` (reference:
weed/command/master.go, volume.go, filer.go, msg_broker.go, s3.go,
webdav.go, server.go; seaweedfs_tpu/command/servers.py).

Each starts its in-process server(s) and blocks until SIGINT/SIGTERM.
`volume` and `server` take `-device=cuda|cpu` (default cuda): the device
every EC coder of the volume server runs on; without a card, `cuda`
refuses to start.  Each role also serves its wire-compatible gRPC plane
on its http port + 10000 where grpcio and protobuf are installed, and
logs that the plane is off where they are not.

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
import sys
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
        # Timed: a signal the kernel delivers to another thread only
        # marks the handler pending, and a main thread blocked in an
        # untimed wait never runs it (the reference's role then ignores
        # SIGTERM for good).  Waking each second runs it.
        while not stop.wait(1.0):
            pass
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


# The port's gRPC servers, by module below the package (pb/ imports
# grpcio and protobuf, so it is imported only when a plane starts).
_PKG = __name__.split(".")[0]


def _start_grpc_plane(server_obj, flags: Flags, ip: str,
                      component: str, server_cls_path: str,
                      allow_port_flag: bool = True):
    """Start one wire-compatible gRPC plane on http port + 10000
    (ParseServerToGrpcAddress convention; -grpc.port overrides on the
    primary role, -grpc=false disables).  TLS rides the same
    security.toml [grpc.<component>] section as the HTTPS plane; a
    config mistake exits with a message like _security() does.  Without
    grpcio or protobuf the plane is off, logged, and the role serves
    HTTP alone, as the reference does."""
    if not flags.get_bool("grpc", True):
        return None
    import importlib
    try:
        mod_name, cls_name = server_cls_path.rsplit(".", 1)
        cls = getattr(importlib.import_module(f"{_PKG}.{mod_name}"),
                      cls_name)
    except ImportError as e:
        glog.warningf("gRPC plane disabled (grpcio missing: %s)", e)
        return None
    from ..utils.security import (grpc_server_credentials,
                                  security_configuration)
    try:
        creds = grpc_server_credentials(security_configuration(),
                                        component)
    except Exception as e:  # noqa: BLE001 — bad values / cert paths
        print(f"security.toml [grpc.{component}]: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    port = flags.get_int("grpc.port", 0) if allow_port_flag else 0
    g = cls(server_obj, host=ip, port=port or None, credentials=creds)
    g.start()
    glog.infof("%s gRPC (%s) at %s", component, cls.SERVICE, g.addr())
    return g


def _start_master_grpc(m, flags: Flags, ip: str,
                       allow_port_flag: bool = True):
    return _start_grpc_plane(m, flags, ip, "master",
                             "pb.master_grpc.MasterGrpcServer",
                             allow_port_flag)


def _start_filer_grpc(fs, flags: Flags, ip: str,
                      allow_port_flag: bool = True):
    return _start_grpc_plane(fs, flags, ip, "filer",
                             "pb.filer_grpc.FilerGrpcServer",
                             allow_port_flag)


def _start_volume_grpc(vs, flags: Flags, ip: str,
                       allow_port_flag: bool = True):
    return _start_grpc_plane(vs, flags, ip, "volume",
                             "pb.volume_grpc.VolumeGrpcServer",
                             allow_port_flag)


def _device_flag(flags: Flags):
    """-device=cuda|cpu: where the role's EC kernels run.  A card that
    is not there exits with the reason instead of a traceback, and is
    never replaced by the CPU."""
    from ..ops.erasure import resolve_device
    try:
        return resolve_device(flags.get("device", "cuda"))
    except (RuntimeError, ValueError) as e:
        print(f"-device: {e}", file=sys.stderr)
        raise SystemExit(2) from None


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


def run_volume(flags: Flags, args: list[str]) -> int:
    from ..cluster.volume_server import VolumeServer
    device = _device_flag(flags)
    dirs = [d for d in flags.get("dir", "./data").split(",") if d]
    maxes = [int(x) for x in flags.get("max", "8").split(",")]
    if len(maxes) == 1:
        maxes = maxes * len(dirs)
    vs = VolumeServer(
        master_url=[_norm_master(u) for u in
                    flags.get("mserver", "127.0.0.1:9333").split(",")],
        directories=dirs,
        host=flags.get("ip", "127.0.0.1"),
        port=flags.get_int("port", 8080),
        max_volume_counts=maxes,
        data_center=flags.get("dataCenter", "DefaultDataCenter"),
        rack=flags.get("rack", "DefaultRack"),
        jwt_signing_key=flags.get("jwt.key", ""),
        ssl_context=_security("volume"),
        read_redirect=flags.get_bool("read.redirect", True),
        # Data-integrity knobs: -fsync forces per-write durability
        # (every POST acks only after .dat AND .idx are fsynced);
        # -scrub.mbps bounds the background integrity sweep's disk
        # bandwidth and -scrub.interval its cadence (0 = on-demand
        # only via volume.scrub / POST /admin/scrub).
        fsync=flags.get_bool("fsync", False),
        scrub_mbps=flags.get_float("scrub.mbps", 32.0),
        scrub_interval=flags.get_float("scrub.interval", 3600.0),
        # Overload & lifecycle knobs: -max.concurrent bounds per-lane
        # request concurrency (0 = no shedding), -disk.reserve (MB)
        # flips volumes readonly before ENOSPC, -shutdown.grace bounds
        # the drain wait on SIGTERM, -idle.timeout reaps stalled
        # (slow-loris) connections.
        max_concurrent=flags.get_int("max.concurrent", 0),
        queue_depth=flags.get_int("max.queue", 0) or None,
        shutdown_grace=flags.get_float("shutdown.grace", 30.0),
        disk_reserve_mb=flags.get_float("disk.reserve", 0.0),
        idle_timeout=flags.get_float("idle.timeout", 120.0),
        transport=_transport_flag(flags),
        # -read.sendfile.min: smallest whole-needle GET served by the
        # zero-copy sendfile slice path (0 disables; default 4KB).
        sendfile_min=(int(flags.get("read.sendfile.min"))
                      if flags.get("read.sendfile.min") != "" else None),
        # -ec.codec: default erasure codec for /admin/ec/generate —
        # "rs" (reference-compatible RS(10,4)) or "lrc" (LRC(10,2,2),
        # 5-read single-shard repair).
        ec_codec=flags.get("ec.codec", "rs"),
        # Cross-cluster async mirroring: -replicate.peer names the
        # STANDBY cluster's master; every local write/delete journals
        # to a per-volume change log and a background shipper tails it
        # to the peer.  -replicate.collections opts specific
        # collections in ("" or `default` = the default collection);
        # empty = mirror everything.
        replicate_peer=(_norm_master(flags.get("replicate.peer"))
                        if flags.get("replicate.peer") else None),
        replicate_collections=flags.get("replicate.collections", ""),
        replicate_interval=flags.get_float("replicate.interval", 0.5),
        # Geo active/active: -geo.cluster.id names THIS region and
        # turns on the per-volume `.lease` fencing plane (writes at a
        # non-holder forward to the holder; stale-epoch batches 409);
        # -replicate.compress zlib-compresses shipped batches so the
        # rlog.ship flow purpose meters actual WAN bytes.
        geo_cluster_id=flags.get("geo.cluster.id", ""),
        replicate_compress=flags.get_bool("replicate.compress", False),
        # Remote-tier knobs: -tier.cache.mb bounds the read-through
        # block cache for tiered volumes; -tier.promote.hits (>0) turns
        # on auto-promotion — a tiered volume whose cache sees that
        # many distinct reads inside -tier.promote.window seconds is
        # downloaded back local.
        tier_cache_mb=flags.get_float("tier.cache.mb", 64.0),
        tier_promote_hits=flags.get_int("tier.promote.hits", 0),
        tier_promote_window=flags.get_float("tier.promote.window", 60.0),
        # Tenancy plane: same policy file as the master's -tenant.rules
        # — here it drives the per-tenant token buckets and DRR weights
        # on this node's admission lanes.
        tenant_rules=flags.get("tenant.rules", ""),
        device=device,
        # -slo.read.p99 / -slo.availability: declared objectives for
        # the burn engine; exemplars + quantiles run regardless.
        **_slo_flags(flags))
    vs.start()
    glog.infof("volume server serving at %s (dirs %s, device %s)",
               vs.server.url(), dirs, device)
    g = _start_volume_grpc(vs, flags, flags.get("ip", "127.0.0.1"))
    return _wait_forever([vs] + ([g] if g else []),
                         grace=flags.get_float("shutdown.grace", 30.0))


def run_msg_broker(flags: Flags, args: list[str]) -> int:
    from ..messaging.broker import MessageBroker
    filer = flags.get("filer", "127.0.0.1:8888")
    mb = MessageBroker(
        filer if filer.startswith("http") else f"http://{filer}",
        host=flags.get("ip", "127.0.0.1"),
        port=flags.get_int("port", 17777),
        ssl_context=_security("msg_broker"))
    mb.start()
    glog.infof("message broker serving at %s", mb.url())
    g = _start_grpc_plane(
        mb, flags, flags.get("ip", "127.0.0.1"), "msg_broker",
        "pb.messaging_grpc.MessagingGrpcServer")
    return _wait_forever([mb] + ([g] if g else []))


def run_filer(flags: Flags, args: list[str]) -> int:
    from ..filer.server import FilerServer
    fs = FilerServer(
        master_url=[_norm_master(u) for u in
                    flags.get("master", "127.0.0.1:9333").split(",")],
        host=flags.get("ip", "127.0.0.1"),
        port=flags.get_int("port", 8888),
        store_path=flags.get("dir") or None,
        collection=flags.get("collection", ""),
        replication=flags.get("defaultReplicaPlacement") or None,
        metrics_port=flags.get_int("metricsPort", 0) or None,
        ssl_context=_security("filer"),
        cipher=flags.get_bool("encryptVolumeData", False),
        transport=_transport_flag(flags),
        # Front-door read/write knobs: -filer.cache.mb bounds the
        # read-through chunk cache; -filer.pack.threshold (bytes, 0 =
        # off) group-commits small uploads into shared needles;
        # -filer.proxy.min (bytes, 0 = off) floors the direct
        # volume→client relay for large single-chunk reads.
        cache_mb=(int(flags.get("filer.cache.mb"))
                  if flags.get("filer.cache.mb") != "" else None),
        pack_threshold=flags.get_int("filer.pack.threshold", 0),
        pack_max_bytes=flags.get_int("filer.pack.max", 1 << 20),
        pack_linger=flags.get_float("filer.pack.linger", 0.008),
        proxy_min=(int(flags.get("filer.proxy.min"))
                   if flags.get("filer.proxy.min") != "" else None),
        # Tenancy plane: -tenant.rules arms the filer's front-door QoS
        # gate; -filer.cache.tenant.mb caps any one tenant's share of
        # the chunk cache (0/absent = no per-tenant cap).
        tenant_rules=flags.get("tenant.rules", ""),
        cache_tenant_mb=(int(flags.get("filer.cache.tenant.mb"))
                         if flags.get("filer.cache.tenant.mb") != ""
                         else None),
        # Metadata-HA plane: the heartbeat cadence to the master (the
        # primary lease TTL is 3 pulses) and where the per-shard
        # journals live (default: <-dir>.shards).
        pulse_seconds=flags.get_float("pulseSeconds", 5.0),
        ha_dir=flags.get("filer.ha.dir") or None,
        **_slo_flags(flags))
    fs.start()
    glog.infof("filer serving at %s", fs.server.url())
    g = _start_filer_grpc(fs, flags, flags.get("ip", "127.0.0.1"))
    return _wait_forever([fs] + ([g] if g else []))


def _s3_identities(config_path: str):
    """Load identities from the reference's JSON config shape
    (s3api/auth_credentials.go); None (no -config flag) lets the
    gateway fall back to filer-backed IAM."""
    import json

    from ..s3api.auth import identities_from_dict
    if not config_path:
        return None
    with open(config_path) as f:
        return identities_from_dict(json.load(f))


def run_s3(flags: Flags, args: list[str]) -> int:
    from ..s3api.server import S3ApiServer
    s3 = S3ApiServer(
        filer_url=_norm_master(flags.get("filer", "127.0.0.1:8888")),
        host=flags.get("ip", "127.0.0.1"),
        port=flags.get_int("port", 8333),
        identities=_s3_identities(flags.get("config")),
        metrics_port=flags.get_int("metricsPort", 0) or None,
        ssl_context=_security("s3"))
    s3.start()
    glog.infof("s3 gateway serving at %s", s3.server.url())
    return _wait_forever([s3])


def run_webdav(flags: Flags, args: list[str]) -> int:
    from ..webdav.server import WebDavServer
    dav = WebDavServer(
        filer_url=_norm_master(flags.get("filer", "127.0.0.1:8888")),
        host=flags.get("ip", "127.0.0.1"),
        port=flags.get_int("port", 7333),
        metrics_port=flags.get_int("metricsPort", 0) or None,
        ssl_context=_security("webdav"))
    dav.start()
    glog.infof("webdav serving at %s", dav.server.url())
    return _wait_forever([dav])


def run_server(flags: Flags, args: list[str]) -> int:
    """All-in-one: master + volume [+ filer [+ s3] [+ webdav]]."""
    from ..cluster.master import MasterServer as Master
    from ..cluster.volume_server import VolumeServer
    device = _device_flag(flags)
    servers: list = []
    ip = flags.get("ip", "127.0.0.1")
    m = Master(host=ip, port=flags.get_int("master.port", 9333),
               meta_dir=flags.get("mdir") or None,
               volume_size_limit_mb=flags.get_int(
                   "volumeSizeLimitMB", 30 * 1024),
               default_replication=flags.get("defaultReplication", "000"),
               ssl_context=_security("master"),
               lifecycle_rules=flags.get("lifecycle.rules", ""),
               lifecycle_interval=flags.get_float("lifecycle.interval",
                                                  60.0),
               lifecycle_mbps=flags.get_float("lifecycle.mbps", 32.0),
               tenant_rules=flags.get("tenant.rules", ""),
               # Durability autopilot flags mirror the standalone
               # master command.
               repair_enabled=flags.get_bool("repair", False),
               repair_delay=flags.get_float("repair.delay", 0.0)
               or None,
               repair_concurrent=flags.get_int("repair.concurrent", 2),
               # -transport applies to EVERY embedded role, like -slo.*.
               transport=_transport_flag(flags),
               # -slo.* applies to EVERY embedded role, same as the
               # standalone commands — half-declared objectives would
               # silently disable master-side burn.
               **_slo_flags(flags))
    m.start()
    servers.append(m)
    dirs = [d for d in flags.get("dir", "./data").split(",") if d]
    maxes = [int(x) for x in flags.get("volume.max", "8").split(",")]
    if len(maxes) == 1:
        maxes = maxes * len(dirs)
    try:
        vs = VolumeServer(master_url=m.server.url(), directories=dirs,
                          host=ip, port=flags.get_int("volume.port", 8080),
                          max_volume_counts=maxes,
                          data_center=flags.get("dataCenter",
                                                "DefaultDataCenter"),
                          rack=flags.get("rack", "DefaultRack"),
                          ssl_context=_security("volume"),
                          fsync=flags.get_bool("fsync", False),
                          scrub_mbps=flags.get_float("scrub.mbps", 32.0),
                          scrub_interval=flags.get_float("scrub.interval",
                                                         3600.0),
                          max_concurrent=flags.get_int("max.concurrent",
                                                       0),
                          shutdown_grace=flags.get_float("shutdown.grace",
                                                         30.0),
                          disk_reserve_mb=flags.get_float("disk.reserve",
                                                          0.0),
                          ec_codec=flags.get("ec.codec", "rs"),
                          tier_cache_mb=flags.get_float("tier.cache.mb",
                                                        64.0),
                          tier_promote_hits=flags.get_int(
                              "tier.promote.hits", 0),
                          tier_promote_window=flags.get_float(
                              "tier.promote.window", 60.0),
                          tenant_rules=flags.get("tenant.rules", ""),
                          transport=_transport_flag(flags),
                          device=device,
                          **_slo_flags(flags))
    except BaseException:
        m.stop()
        raise
    vs.start()
    servers.append(vs)
    glog.infof("master at %s, volume at %s", m.server.url(),
               vs.server.url())
    g = _start_master_grpc(m, flags, ip)
    if g:
        servers.append(g)
    vg = _start_volume_grpc(vs, flags, ip, allow_port_flag=False)
    if vg:
        servers.append(vg)
    if flags.get_bool("filer", False):
        from ..filer.server import FilerServer
        fs = FilerServer(master_url=m.server.url(), host=ip,
                         port=flags.get_int("filer.port", 8888),
                         store_path=flags.get("filer.dir") or None,
                         transport=_transport_flag(flags),
                         pack_threshold=flags.get_int(
                             "filer.pack.threshold", 0),
                         tenant_rules=flags.get("tenant.rules", ""),
                         ssl_context=_security("filer"))
        fs.start()
        servers.append(fs)
        glog.infof("filer at %s", fs.server.url())
        fg = _start_filer_grpc(fs, flags, ip, allow_port_flag=False)
        if fg:
            servers.append(fg)
        if flags.get_bool("s3", False):
            from ..s3api.server import S3ApiServer
            s3 = S3ApiServer(filer_url=fs.server.url(), host=ip,
                             port=flags.get_int("s3.port", 8333),
                             identities=_s3_identities(
                                 flags.get("s3.config")),
                             ssl_context=_security("s3"))
            s3.start()
            servers.append(s3)
            glog.infof("s3 at %s", s3.server.url())
        if flags.get_bool("webdav", False):
            from ..webdav.server import WebDavServer
            dav = WebDavServer(filer_url=fs.server.url(), host=ip,
                               port=flags.get_int("webdav.port", 7333),
                               ssl_context=_security("webdav"))
            dav.start()
            servers.append(dav)
            glog.infof("webdav at %s", dav.server.url())
    return _wait_forever(servers,
                         grace=flags.get_float("shutdown.grace", 30.0))


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
register(Command("volume",
                 "volume -port=8080 -dir=/data -max=8 -mserver=host:9333"
                 " [-device=cuda|cpu]"
                 " [-transport=aio|threads] [-read.sendfile.min=4096]"
                 " [-fsync] [-scrub.mbps=32] [-scrub.interval=3600]"
                 " [-max.concurrent=0] [-disk.reserve=0(MB)]"
                 " [-shutdown.grace=30] [-ec.codec=rs|lrc]"
                 " [-slo.read.p99=0.05] [-slo.availability=99.9]"
                 " [-tier.cache.mb=64] [-tier.promote.hits=0]"
                 " [-tier.promote.window=60] [-tenant.rules=tenants.txt]"
                 " [-replicate.peer=standby-master:9333]"
                 " [-replicate.collections=a,b] [-replicate.interval=0.5]"
                 " [-geo.cluster.id=A] [-replicate.compress]",
                 "start a volume server", run_volume))
register(Command("filer", "filer -port=8888 -master=host:9333"
                 " [-transport=aio|threads] [-filer.cache.mb=64]"
                 " [-filer.pack.threshold=0(B)] [-filer.pack.max=1048576]"
                 " [-filer.pack.linger=0.008] [-filer.proxy.min=262144]"
                 " [-tenant.rules=tenants.txt]"
                 " [-filer.cache.tenant.mb=0]"
                 " [-pulseSeconds=5] [-filer.ha.dir=...]",
                 "start a filer server", run_filer))
register(Command("msg.broker", "msg.broker -port=17777 -filer=host:8888",
                 "start a pub/sub message broker", run_msg_broker))
register(Command("s3", "s3 -port=8333 -filer=host:8888",
                 "start an S3-compatible gateway", run_s3))
register(Command("webdav", "webdav -port=7333 -filer=host:8888",
                 "start a WebDAV gateway", run_webdav))
register(Command("server",
                 "server -dir=/data [-device=cuda|cpu] [-filer=true]"
                 " [-s3=true] [-s3.config=identities.json] [-webdav=true]"
                 " [-transport=aio|threads]"
                 " [-lifecycle.rules=rules.txt]"
                 " [-tenant.rules=tenants.txt]"
                 " [-tier.cache.mb=64] [-tier.promote.hits=0]",
                 "start master+volume(+filer+s3+webdav) in one process",
                 run_server))
