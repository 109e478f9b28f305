"""Both packages' clusters side by side, for the port's cluster tests
(tests/test_torch_master.py, _topology.py, _rpc.py, _resilience.py,
_tenancy.py, _slo.py, _lifecycle.py, _repair_daemon.py, _security.py,
_cluster*.py, _shell.py, _batch_*_live.py, _volume_server.py).

`mod(pkg, name)` imports one package's module by its path below the
package, `pair(name)` both (the JAX package's first).  `both(scenario)`
runs `scenario(pkg)` for each package with the module-global `random`
seeded alike (topology cookies and placement picks read it), holds the
two answers equal and returns the port's.

`LiveCluster(pkg, root)` is one package's master and volume servers in
this process (the port's on `device="cpu"`, the kernels' plain
versions; the JAX package's under the suite's CPU platform), with the
shell environment and client of the same package; the `pkg` fixture
runs a test once per package.  `seed_placement` gives one package's
file-id cookies and volume picks a seeded stream of their own;
`grpc_pair_port` a server port below the ephemeral range whose gRPC
twin (+10000) is free too, from a slice of its own for each xdist
worker.

`count_plain_launches` lets chip_smoke's phases rehearse on the CPU.

`hermetic_port_state` is the port's twin of the autouse fixture in
tests/conftest.py, which resets only the JAX package's process globals;
a test file uses it by importing it.  `pin_clocks` stands a settable
clock in for `time` in every module whose answers or bytes carry the
wall clock, in both packages, so that two masters fed the same beats,
or two clusters fed the same writes, answer alike: needle timestamps,
the volume servers' location caches, scrub stamps and journal events
then match.
"""

from __future__ import annotations

import importlib
import os
import random
import signal
import socket
import time

import pytest
import torch

# One intra-op thread: the suite runs several workers side by side, and
# timing-bound tests in other files must not lose their cores.
torch.set_num_threads(1)

PACKAGES = ("seaweedfs_tpu", "seaweedfs_tpu_torch")
PORT = PACKAGES[1]
# Modules whose answers carry time.time(): heartbeat ages and sweeps,
# SLO exemplars, usage snapshots, the lifecycle and repair daemons'
# histories, JWT expiries; and the volume server's: needle
# last-modified and append stamps, the location caches' ages, scrub
# stamps, journal events and flow samples.
CLOCKED = ("cluster.master", "topology.topology", "stats.slo",
           "tenancy.accounting", "lifecycle.daemon", "cluster.repair_daemon",
           "utils.security", "cluster.volume_server", "storage.volume",
           "storage.scrub", "events.journal", "stats.flows")
EPOCH_S = 1_700_000_000.0
# A live-cluster test's own deadline: several times its slowest run on a
# loaded host, so that a hung server fails the test, not the suite.
CLUSTER_DEADLINE_S = 300


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def pair(name: str) -> tuple:
    return tuple(mod(pkg, name) for pkg in PACKAGES)


def both(scenario, seed: int = 0):
    """scenario(pkg) for each package, `random` seeded alike before
    each; the answers must be equal.  Returns the port's."""
    out = []
    for pkg in PACKAGES:
        random.seed(seed)
        out.append(scenario(pkg))
    assert out[1] == out[0]
    return out[1]


# Server ports.  Their gRPC planes bind port + 10000, 22000-31999:
# outside this range, so no server's port is another's gRPC plane, and
# below the ephemeral range (32768 and up on Linux).
PORT_RANGE = range(12000, 22000)


def port_slice() -> range:
    """The ports this process hands out: under xdist, worker gwN of M
    takes the N-th of M equal slices of PORT_RANGE, so that no two
    workers ever hand out one port; outside xdist, the whole range."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    count = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if not worker.startswith("gw") or count < 2:
        return PORT_RANGE
    size = len(PORT_RANGE) // count
    lo = PORT_RANGE.start + int(worker[2:]) * size
    return range(lo, lo + size)


_unused_ports: list[int] = []


def grpc_pair_port() -> int:
    """A port for a server whose gRPC plane binds port + 10000: both
    free, and both below the ephemeral range (32768 and up on Linux),
    where no outbound connection of this host takes them.  A server on
    port 0 gets an ephemeral port, and its gRPC twin can then be the
    source port of any connection in the suite.  Ports come from this
    process's `port_slice`, each once in a shuffled pass over the slice
    before any comes again: a server of another worker never takes a
    port this one stopped and means to restart on, and a port reused
    within the process is at least a slice's worth of servers old."""
    ports = port_slice()
    for _ in range(2 * len(ports)):
        if not _unused_ports:
            _unused_ports.extend(
                random.SystemRandom().sample(ports, len(ports)))
        port = _unused_ports.pop()
        try:
            with socket.socket() as a, socket.socket() as b:
                a.bind(("127.0.0.1", port))
                b.bind(("127.0.0.1", port + 10000))
            return port
        except OSError:
            continue
    raise RuntimeError("no free port pair below the ephemeral range")


def drop_idle_connections() -> None:
    """Close both packages' idle keep-alive client connections.  Each
    package's pool is process-wide and keyed by host and port, and the
    servers of an earlier test have closed its connections to them: a
    server that takes one of those ports again would otherwise meet
    them, and the reference's client raises when the two it tries are
    dead (ROADMAP, reference faults)."""
    for pkg in PACKAGES:
        pool = mod(pkg, "cluster.rpc")._pool
        with pool._lock:
            idle = [c for conns in pool._idle.values() for c in conns]
            pool._idle.clear()
        for conn in idle:
            conn.close()


def seed_placement(monkeypatch, pkg: str, seed: int) -> None:
    """Give `pkg`'s file-id cookies and write-volume picks a seeded
    stream of their own.  Both draw from the process-wide `random`,
    which a retry's backoff jitter also draws from: one retry under a
    loaded host (a keep-alive connection the server had just closed)
    shifts every later cookie and pick, and two runs store the same
    bytes under different file ids."""
    rng = random.Random(seed)
    for name in ("topology.topology", "topology.volume_layout"):
        monkeypatch.setattr(mod(pkg, name), "random", rng)


def outcome(fn, *args, **kw):
    """("ok", value) or ("raise", exception class name, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the outcome is the result
        return ("raise", type(e).__name__, str(e))


def _reset_port_globals() -> None:
    from seaweedfs_tpu_torch import fault
    from seaweedfs_tpu_torch.cluster import resilience
    from seaweedfs_tpu_torch.stats import flows, roofline
    from seaweedfs_tpu_torch.storage import chunk_cache, remote_cache
    fault.disarm_all()
    resilience.reset_breakers()
    flows.LEDGER.reset()
    chunk_cache.CACHE.reset()
    remote_cache.CACHE.reset()
    roofline.LEDGER.reset()


@pytest.fixture(autouse=True)
def hermetic_port_state(monkeypatch):
    """The port's per-host breakers, armed faults, wire-flow ledger,
    chunk and tier block caches and roofline ledger (which a volume
    server's heartbeat carries) are process-global: start and end every
    test clean.  A volume server's EC location caches and scrub daemon
    live on the server, which each test builds anew.  Both packages'
    `rpc.free_port` gives ports below the ephemeral range
    (`grpc_pair_port`): a server restarted on its port, or a gRPC plane
    on port + 10000, otherwise finds it taken as the source port of some
    connection of the suite.  Every test starts with both packages'
    client pools empty (`drop_idle_connections`)."""
    for pkg in PACKAGES:
        monkeypatch.setattr(mod(pkg, "cluster.rpc"), "free_port",
                            grpc_pair_port)
    drop_idle_connections()
    _reset_port_globals()
    yield
    _reset_port_globals()


class Clock:
    """Stands in for the `time` module: `time()` and `gmtime()` read
    `now`, which the test moves; everything else is the real module."""

    def __init__(self, now: float = EPOCH_S):
        self.now = now

    def time(self) -> float:
        return self.now

    def time_ns(self) -> int:
        return int(self.now * 1e9)

    def gmtime(self, secs: float | None = None) -> time.struct_time:
        return time.gmtime(self.now if secs is None else secs)

    def __getattr__(self, name):
        return getattr(time, name)


def pin_clocks(monkeypatch, now: float = EPOCH_S) -> Clock:
    """One Clock as `time` in every CLOCKED module of both packages."""
    clock = Clock(now)
    for pkg in PACKAGES:
        for name in CLOCKED:
            monkeypatch.setattr(mod(pkg, name), "time", clock)
    return clock


@pytest.fixture
def cluster_deadline():
    """Raise TimeoutError in the test (its teardown still runs) once it
    has run CLUSTER_DEADLINE_S; test files of live clusters use it
    through `pytest.mark.usefixtures`."""
    def expire(signum, frame):
        raise TimeoutError(f"live-cluster test ran past its "
                           f"{CLUSTER_DEADLINE_S} s deadline")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, CLUSTER_DEADLINE_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(params=PACKAGES)
def pkg(request) -> str:
    """Runs a test once for the JAX package and once for the port."""
    return request.param


def device_kw(pkg: str) -> dict:
    """The port's servers and shell run on the CPU here."""
    return {"device": "cpu"} if pkg == PORT else {}


class LiveCluster:
    """One package's master and `n` volume servers in this process, on
    localhost ports.  `racks` names each server's rack; the master's
    pulse defaults to 60 s so that no dead-node sweep empties the
    topology in a slow test."""

    def __init__(self, pkg: str, root, n: int = 3, racks=None,
                 master_kw: dict | None = None, vs_kw: dict | None = None):
        self.pkg = pkg
        self.root = str(root)
        self.rpc = mod(pkg, "cluster.rpc")
        self.master = mod(pkg, "cluster.master").MasterServer(
            **{"volume_size_limit_mb": 64, "meta_dir": self.root,
               "pulse_seconds": 60, **(master_kw or {})})
        self.master.start()
        self.vs_kw = {"pulse_seconds": 60, **(vs_kw or {})}
        self.servers = []
        self._envs: list = []
        try:
            for i in range(n):
                self.add_server(rack=racks[i] if racks else "DefaultRack")
        except BaseException:
            self.stop()
            raise

    def add_server(self, **kw):
        d = os.path.join(self.root, f"vs{len(self.servers)}")
        os.makedirs(d, exist_ok=True)
        vs = mod(self.pkg, "cluster.volume_server").VolumeServer(
            self.master.url(), [d], **{**self.vs_kw, **kw},
            **device_kw(self.pkg))
        vs.start()
        self.servers.append(vs)
        return vs

    def url(self) -> str:
        return self.master.url()

    def client(self):
        return mod(self.pkg, "cluster.client").WeedClient(self.url())

    def env(self):
        e = mod(self.pkg, "shell").CommandEnv(self.url(),
                                              **device_kw(self.pkg))
        self._envs.append(e)
        return e

    def run(self, env, line: str) -> str:
        return mod(self.pkg, "shell").run_command(env, line)

    def freshen(self) -> None:
        """A full heartbeat from every live server, and empty EC
        location caches, so the next lookups see the cluster as is."""
        for vs in self.servers:
            if not vs._stop.is_set():
                vs._send_heartbeat(full=True)
            vs._ec_loc_cache.clear()

    def server(self, url: str):
        return next(vs for vs in self.servers if vs.url() == url)

    def stop(self) -> None:
        for e in self._envs:
            e.close()
        for vs in self.servers:
            if not vs._stop.is_set():
                vs.stop()
        self.master.stop()


def count_plain_launches(monkeypatch) -> None:
    """On the CPU the kernel wrappers run their plain versions and count
    no launch; for a rehearsal of chip_smoke's phases count each
    OUTERMOST plain K1/K2 call as one launch of its instantiation, and
    as a volume-axis launch when it carries more than one volume (K2's
    plain version calls K1's, and with a volume axis both loop)."""
    from seaweedfs_tpu_torch.ops import coder_cuda as cc
    depth = [0]

    def counted(fn, wrapper, variants, pick):
        def inner(masks, shards, *a, **k):
            depth[0] += 1
            try:
                out = fn(masks, shards, *a, **k)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                wrapper.launches += 1
                wrapper.variant_launches[variants[pick(
                    shards.shape[-2], masks.shape[0] // 8)]] += 1
                if shards.dim() == 3 and shards.shape[0] > 1:
                    wrapper.volume_launches += 1
            return out
        return inner

    monkeypatch.setattr(cc, "apply_bitmatrix_torch", counted(
        cc.apply_bitmatrix_torch, cc.apply_bitmatrix, cc.K1_VARIANTS,
        cc.k1_variant))
    monkeypatch.setattr(cc, "apply_bitmatrix_crc_torch", counted(
        cc.apply_bitmatrix_crc_torch, cc.apply_bitmatrix_crc,
        cc.K2_VARIANTS, cc.k2_variant))
