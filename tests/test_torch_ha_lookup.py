"""Phase 11's `/dir/lookup` 404, reproduced on the CPU in both packages.

The cluster is phase 11's HA primary cut to size: three raft masters
with `-repair` (each a `python -m <package> master` process), four
volume servers in this process at a one-second pulse, `ec.encode` of
one volume, and a holder stopped without a goodbye.  From the stop
until the leader's repair daemon has put every shard back on a live
node, `/dir/lookup` is polled through every master every 50 ms and every
answer that is not 200 is kept, with the time since the stop.

Each lead of the 404 has its window widened on purpose, not by luck:
- the leader's first rebuild set-up (`cluster_rebuild.make_mesh`, where
  the leader imports its device stack and builds the mesh) holds the
  interpreter lock for 2.5 pulses, as torch's import, a card's context
  and its stream pool do on a card's host (0.3-2.4 s there);
- one surviving holder's beat fails once while it is assembled, as
  iterating its EC map while `/admin/ec/mount` changes it does.

The lock hold is what gives the 404.  The stalled leader answers no
beat and sends no raft append for longer than the election timeout
(0.6-1.2 s), so a follower whose topology holds no EC volume takes
over; through every master the volume is "not found" until each
survivor's beat reaches the new leader, and survivors whose beats
queued behind the stall are swept as lost.  The reference shows it.
The port sets its rebuild path up when a `-repair` master starts
(`RepairDaemon.prepare`), so the stall falls before the master serves
and the repair runs without an election.  A failed beat gives no 404
in either package, but in the reference it ends that holder's pulse
thread: the master sweeps a live node and its shards vanish from every
lookup.  The port's pulse logs the failure and beats again on the next
tick.

The same lock hold at an HA master's first device set-up (where
`/cluster/device` brings up torch, a card's context and the probed
peaks; 1.8-2.4 s on a card's host), in masters without `-repair`, gives
the same 404 in the reference at the leader's first `/cluster/device`.
The port's HA master sets its device stack up at start, before it
serves.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from _torch_cluster import (PACKAGES, PORT,  # noqa: F401
                            cluster_deadline, device_kw,
                            hermetic_port_state, mod)

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("cluster_deadline")]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PULSE = 1.0          # every role's -pulseSeconds
HOLD = 2.5 * PULSE   # the widened set-up stall
DEADLINE = 60.0      # every wait is bounded, never a fixed sleep
POLL = 0.05

# A master process with its rebuild set-up (make_mesh) wrapped: it
# holds the interpreter lock for `hold` seconds (ctypes.PyDLL keeps it
# across the C call), then builds the mesh on the CPU.
LAUNCH = """\
import ctypes, runpy, sys
pkg, hold = sys.argv.pop(1), float(sys.argv.pop(1))
if pkg != "seaweedfs_tpu":
    for name in ("jax", "jaxlib", "seaweedfs_tpu"):
        sys.modules[name] = None
import importlib
cr = importlib.import_module(pkg + ".parallel.cluster_rebuild")
real = cr.make_mesh
def make_mesh(devices=None):
    if hold > 0:
        ctypes.PyDLL(None).usleep(int(hold * 1e6))
    if devices is None and pkg != "seaweedfs_tpu":
        import torch
        devices = [torch.device("cpu")]
    return real(devices)
cr.make_mesh = make_mesh
runpy.run_module(pkg, run_name="__main__", alter_sys=True)
"""

# A master process whose first device set-up (roofline.probe_peaks, where
# /cluster/device and /debug/device bring up torch, a card's context and
# the peaks) holds the interpreter lock for `hold` seconds, as they do on
# a card's host (1.8-2.4 s there).
LAUNCH_PEAKS = """\
import ctypes, runpy, sys
pkg, hold = sys.argv.pop(1), float(sys.argv.pop(1))
if pkg != "seaweedfs_tpu":
    for name in ("jax", "jaxlib", "seaweedfs_tpu"):
        sys.modules[name] = None
import importlib
rl = importlib.import_module(pkg + ".stats.roofline")
real, held = rl.probe_peaks, []
def probe_peaks(*a, **k):
    if not held:
        held.append(1)
        ctypes.PyDLL(None).usleep(int(hold * 1e6))
    return real(*a, **k)
rl.probe_peaks = probe_peaks
runpy.run_module(pkg, run_name="__main__", alter_sys=True)
"""


def wait_for(pred, what: str, timeout: float = DEADLINE):
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} not reached in {timeout} s")
        time.sleep(POLL)


class HaCluster:
    """Three `-repair` masters as processes of `pkg`, four volume
    servers of `pkg` in this process."""

    def __init__(self, pkg: str, root, hold: float, repair: bool = True,
                 launch: str = LAUNCH):
        self.pkg = pkg
        self.rpc = mod(pkg, "cluster.rpc")
        ports = [self.rpc.free_port() for _ in range(3)]
        self.murls = [f"http://127.0.0.1:{p}" for p in ports]
        peers = ",".join(f"127.0.0.1:{p}" for p in ports)
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
        self.procs, self.logs = [], []
        for i, port in enumerate(ports):
            log = open(root / f"m{i}.log", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", launch, pkg, str(hold), "master",
                 f"-port={port}", f"-mdir={root}/m{i}", f"-peers={peers}",
                 "-volumeSizeLimitMB=8", "-defaultReplication=000",
                 f"-pulseSeconds={PULSE}"]
                + (["-repair", "-repair.delay=0.5"] if repair else []),
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        VolumeServer = mod(pkg, "cluster.volume_server").VolumeServer
        self.servers = {}
        for i in range(4):
            d = root / f"vs{i}"
            d.mkdir()
            vs = VolumeServer(self.murls, [str(d)], max_volume_counts=[7],
                              pulse_seconds=PULSE, rack=f"rack{i // 2}",
                              **device_kw(pkg))
            vs.start()
            self.servers[vs.url()] = vs

    def status(self, url: str) -> dict | None:
        try:
            return self.rpc.call(url + "/cluster/status", timeout=2.0)
        except Exception:  # noqa: BLE001 — a stalled or starting master
            return None

    def leader(self) -> str | None:
        roles = [(u, self.status(u)) for u in self.murls]
        leaders = [u for u, st in roles if st and st.get("is_leader")]
        return leaders[0] if len(leaders) == 1 else None

    def terms(self) -> dict:
        return {u: (st or {}).get("raft", {}).get("term")
                for u, st in ((u, self.status(u)) for u in self.murls)}

    def lookup(self, url: str, vid: int):
        return self.rpc.call_status(f"{url}/dir/lookup?volumeId={vid}",
                                    timeout=5.0)

    def stop(self) -> None:
        for vs in self.servers.values():
            try:
                vs.stop()
            except Exception:  # noqa: BLE001 — the victim is stopped
                pass
        for p in self.procs:
            p.kill()
            p.wait(30)
        for log in self.logs:
            log.close()


def shard_holders(doc: dict) -> dict:
    return {int(s): sorted(loc["url"] for loc in locs)
            for s, locs in doc.get("ecShards", {}).items()}


def leader_of_four(cl) -> str | None:
    """The raft leader once every master serves and the leader's healthz
    counts four volume servers.  Two masters elect a leader while the
    third may still be starting (its imports, a loaded host), and the
    lookups polled after encode_one would meet it unserving.  A master
    that lost the lead since `cl.leader()` answers without "nodes" (and
    names the new leader): not yet."""
    if not all(cl.status(u) for u in cl.murls):
        return None
    leader = cl.leader()
    if leader is None:
        return None
    doc = cl.rpc.call_status(leader + "/cluster/healthz", timeout=2.0)[1]
    return leader if len(doc.get("nodes", ())) == 4 else None


def encode_one(cl: HaCluster, pkg: str) -> tuple[str, int, dict]:
    """Through the raft leader: one volume of 24 needles, `ec.encode` of
    it, and its 14 shards at the leader; (leader, vid, shard holders)."""
    wait_for(cl.leader, "a raft leader")
    leader = wait_for(lambda: leader_of_four(cl),
                      "four volume servers at the leader")
    cl.rpc.call(f"{leader}/vol/grow?count=1&collection=ha", "POST")
    client = mod(pkg, "cluster.client").WeedClient(list(cl.murls))
    rng = np.random.default_rng(11)
    fids = {}
    for i in range(24):
        data = rng.integers(0, 256, 2000 + 997 * i,
                            dtype=np.uint8).tobytes()
        fids[client.upload_data(data, collection="ha")] = data
    vids = {int(f.split(",")[0]) for f in fids}
    assert len(vids) == 1, vids
    vid = vids.pop()
    shell = mod(pkg, "shell")
    env = shell.CommandEnv(leader, **device_kw(pkg))
    try:
        shell.run_command(env, "lock")
        out = shell.run_command(env, f"ec.encode -volumeId {vid}")
    finally:
        env.close()
    assert f"volume {vid} -> ec shards" in out, out

    def encoded():
        status, doc = cl.lookup(leader, vid)
        holders = shard_holders(doc) if status == 200 else {}
        return holders if len(holders) == 14 and all(
            holders.values()) else None
    holders = wait_for(encoded, "14 shards at the leader")
    return leader, vid, holders


def scenario(pkg: str, root, lead: str) -> dict:
    """The cluster through ec.encode and a holder's stop, with `lead`'s
    window widened ("setup": the rebuild set-up's lock hold, "beat": a
    survivor's failed beat); the lookups' answers until the repair
    lands (or, for "beat", until the failing holder's shards leave the
    lookup)."""
    cl = HaCluster(pkg, root, HOLD if lead == "setup" else 0.0)
    try:
        leader, vid, holders = encode_one(cl, pkg)
        counts = {}
        for sid, urls in holders.items():
            for u in urls:
                counts.setdefault(u, []).append(sid)
        victim = max(counts, key=lambda u: (len(counts[u]) <= 4,
                                            len(counts[u]), u))
        live = [u for u in cl.servers if u != victim]
        terms0 = cl.terms()
        failing = None
        if lead == "beat":
            # One surviving holder's next beat raises while it is assembled.
            failing = next(u for u in live if u in counts)
            vs = cl.servers[failing]
            real, fired = vs._ec_shard_infos, []

            def raise_once():
                if not fired:
                    fired.append(time.monotonic())
                    raise RuntimeError(
                        "dictionary changed size during iteration")
                return real()
            vs._ec_shard_infos = raise_once
        t_kill = time.monotonic()
        cl.servers[victim].stop()

        answers: list = []
        vanished: list = []
        done = threading.Event()

        def poll(url):
            while not done.is_set():
                t0 = time.monotonic()
                try:
                    status, doc = cl.lookup(url, vid)
                except Exception as e:  # noqa: BLE001 — a timeout
                    status, doc = type(e).__name__, {}
                held = shard_holders(doc) if status == 200 else {}
                if status != 200:
                    answers.append((round(t0 - t_kill, 2), url, status,
                                    str(doc.get("error", ""))[:80]))
                elif failing and held and not any(
                        failing in us for us in held.values()):
                    # A live holder swept: its shards are gone from the
                    # lookup (the repair may now lack survivors).
                    vanished.append(round(t0 - t_kill, 2))
                    done.set()
                elif len(held) == 14 and all(
                        any(u in live for u in us) for us in held.values()):
                    done.set()
                done.wait(max(0.0, POLL - (time.monotonic() - t0)))
        pollers = [threading.Thread(target=poll, args=(u,), daemon=True)
                   for u in cl.murls]
        for t in pollers:
            t.start()
        done.wait(DEADLINE)
        repaired = not vanished and done.is_set()
        done.set()
        for t in pollers:
            t.join(10)
        leader_after = wait_for(cl.leader, "a raft leader")
        lost = []
        for u in cl.murls:
            doc = cl.rpc.call(f"{u}/cluster/events?type=heartbeat.lost",
                              timeout=10.0)
            lost += [e["node"] for e in doc["events"]]
        return {"repaired": repaired,
                "not_200": sorted(answers),
                "not_found": [a for a in answers if a[2] == 404],
                "term_moved": cl.terms() != terms0,
                "leader_moved": leader_after != leader,
                "swept_live": sorted(set(lost) & set(live)),
                "live_holder_vanished": bool(vanished),
                "swept_victim": victim in lost,
                "pulse_threads_alive": all(
                    cl.servers[u]._hb_thread.is_alive() for u in live)}
    finally:
        cl.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_no_404_across_a_rebuild_setup_stall_in_the_port_only(pkg,
                                                              tmp_path):
    out = scenario(pkg, tmp_path, "setup")
    assert out["repaired"], out
    assert out["swept_victim"], out
    if pkg == PORT:
        assert out["not_200"] == [] and not out["term_moved"] \
            and out["swept_live"] == [], out
    else:
        assert out["not_found"], out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_pulse_survives_a_failed_beat_in_the_port_only(pkg, tmp_path):
    out = scenario(pkg, tmp_path, "beat")
    assert out["not_found"] == [], out
    if pkg == PORT:
        assert out["repaired"] and out["swept_victim"], out
        assert out["pulse_threads_alive"] and out["swept_live"] == [] \
            and not out["live_holder_vanished"], out
    else:
        assert not out["pulse_threads_alive"] and out["swept_live"] \
            and out["live_holder_vanished"], out


def device_scenario(pkg: str, root) -> dict:
    """Three masters without `-repair` whose first device set-up holds
    the interpreter lock for HOLD, through ec.encode; then one GET
    /cluster/device on the leader, the lookups of the volume polled
    through every master from just before it until HOLD + 3 pulses
    after."""
    cl = HaCluster(pkg, root, HOLD, repair=False, launch=LAUNCH_PEAKS)
    try:
        leader, vid, _holders = encode_one(cl, pkg)
        terms0 = cl.terms()
        answers: list = []
        done = threading.Event()

        def poll(url):
            while not done.is_set():
                t0 = time.monotonic()
                try:
                    status, doc = cl.lookup(url, vid)
                except Exception as e:  # noqa: BLE001 — a timeout
                    status, doc = type(e).__name__, {}
                if status != 200:
                    answers.append((url, status,
                                    str(doc.get("error", ""))[:80]))
                done.wait(max(0.0, POLL - (time.monotonic() - t0)))
        pollers = [threading.Thread(target=poll, args=(u,), daemon=True)
                   for u in cl.murls]
        for t in pollers:
            t.start()
        t0 = time.monotonic()
        doc = cl.rpc.call(f"{leader}/cluster/device", timeout=DEADLINE)
        took = time.monotonic() - t0
        done.wait(HOLD + 3 * PULSE)
        done.set()
        for t in pollers:
            t.join(10)
        wait_for(cl.leader, "a raft leader")
        return {"peaks": "peaks" in doc, "device_s": round(took, 2),
                "not_200": sorted(answers),
                "not_found": [a for a in answers if a[1] == 404],
                "term_moved": cl.terms() != terms0}
    finally:
        cl.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_no_404_across_an_ha_master_device_setup_stall_in_the_port_only(
        pkg, tmp_path):
    out = device_scenario(pkg, tmp_path)
    assert out["peaks"], out
    if pkg == PORT:
        assert out["not_200"] == [] and not out["term_moved"] \
            and out["device_s"] < HOLD, out
    else:
        assert out["term_moved"] and out["not_found"], out


def test_leader_wait_holds_for_every_master_and_a_lost_lead():
    """The third master is still starting when two have elected m1, and
    m1 has lost the lead when its healthz answers: the wait goes on
    until all three serve and the new leader counts four servers."""
    serving = [[True, True, False], [True, True, True], [True, True, True]]
    answers = [
        (200, {"healthy": True, "is_leader": False,
               "leader": "http://m2", "problems": []}),
        (200, {"nodes": [{}] * 4})]
    leaders = ["http://m1", "http://m2"]
    polls = iter(up for row in serving for up in row)

    class Cl:
        murls = ["http://m1", "http://m2", "http://m3"]

        def status(self, url):
            return {"is_leader": False} if next(polls) else None

        def leader(self):
            return leaders.pop(0)

        class rpc:
            @staticmethod
            def call_status(url, timeout):
                return answers.pop(0)

    cl = Cl()
    assert wait_for(lambda: leader_of_four(cl), "four servers") \
        == "http://m2"
    assert not leaders and not answers
