"""The port's raft under fault injection, held against the JAX package's.

Each case of tests/test_raft_faults.py runs once per package on the same
schedule of partitions, leader kills, snapshot races and membership
churn.  Both packages must end in the same committed state: the same
applied prefix where the schedule fixes it, and the same verdicts on the
two safety properties where load makes the count vary (no committed
entry lost or reordered, ids unique across every failover).  Timings are
not compared; every wait has a deadline of 15 s or more.
"""

from __future__ import annotations

import threading
import time

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from test_torch_raft import (DEADLINE, each_package, start_ha, stop_ha,
                             wait_for, wait_leader)

pytestmark = pytest.mark.torch


class Net:
    """Bidirectional partition fabric over RaftNode.transport."""

    def __init__(self, rpc):
        self.rpc = rpc
        self.cut: set[frozenset] = set()

    def isolate(self, node_id: str, others: list[str]) -> None:
        for o in others:
            if o != node_id:
                self.cut.add(frozenset((node_id, o)))

    def heal(self) -> None:
        self.cut.clear()

    def transport_for(self, node_id: str):
        def call(url: str, *a, **kw):
            target = url.split("/raft/")[0]
            if frozenset((node_id, target)) in self.cut:
                raise ConnectionError(f"partitioned: {node_id} -/-> {target}")
            return self.rpc.call_json(url, *a, **kw)
        return call


def mk_cluster(P, n, d, sinks, net=None, compact_threshold=1000):
    servers = [P.rpc.JsonHttpServer() for _ in range(n)]
    urls = [s.url() for s in servers]
    nodes = []
    for i, s in enumerate(servers):
        node = P.raft.RaftNode(
            urls[i], urls, apply_fn=lambda cmd, i=i: sinks[i].append(cmd),
            state_path=str(d / f"raft{i}.json"),
            election_timeout=(0.25, 0.5), heartbeat_interval=0.06,
            compact_threshold=compact_threshold)
        if net is not None:
            node.transport = net.transport_for(urls[i])
        node.mount(s)
        s.start()
        nodes.append(node)
    for node in nodes:
        node.start()
    return servers, urls, nodes


def converged(sinks, n):
    wait_for(lambda: all(len(vals(s)) >= n for s in sinks),
             what=f"{n} applied entries")


def vals(sink):
    return [c.get("v") for c in sink if "v" in c]


def teardown(nodes, servers):
    for x in nodes:
        x.stop()
    for s in servers:
        s.stop()


def errors(P):
    return (TimeoutError, P.raft.NotLeader)


def test_partitioned_leader_cannot_commit_and_steps_down(tmp_path):
    def scenario(P, d):
        net = Net(P.rpc)
        sinks = [[], [], []]
        servers, urls, nodes = mk_cluster(P, 3, d, sinks, net)
        try:
            leader = wait_leader(P, nodes)
            leader.propose({"v": 0})
            converged(sinks, 1)
            net.isolate(leader.id, urls)
            with pytest.raises(errors(P)):
                leader.propose({"v": "lost"}, timeout=1.5)
            majority = [x for x in nodes if x is not leader]
            new_leader = wait_leader(P, majority, exclude=(leader,))
            for i in range(1, 4):
                new_leader.propose({"v": i}, timeout=DEADLINE)
            converged([sinks[nodes.index(x)] for x in majority], 4)
            net.heal()
            old = sinks[nodes.index(leader)]
            wait_for(lambda: leader.state != P.raft.LEADER
                     and len(vals(old)) >= 4)
            converged(sinks, 4)
            return {"prefixes": [vals(s)[:4] for s in sinks],
                    "lost_anywhere": any("lost" in vals(s) for s in sinks),
                    "old_leader_stepped_down": True}
        finally:
            teardown(nodes, servers)

    state = each_package(scenario, tmp_path)
    assert state["prefixes"] == [[0, 1, 2, 3]] * 3
    assert not state["lost_anywhere"]


def test_no_commit_without_quorum(tmp_path):
    def scenario(P, d):
        net = Net(P.rpc)
        sinks = [[], [], []]
        servers, urls, nodes = mk_cluster(P, 3, d, sinks, net)
        try:
            leader = wait_leader(P, nodes)
            leader.propose({"v": 0})
            converged(sinks, 1)
            for u in urls:
                net.isolate(u, urls)
            with pytest.raises(errors(P)):
                leader.propose({"v": "never"}, timeout=1.5)
            during = [("never" in vals(s)) for s in sinks]
            net.heal()
            for _ in range(5):
                nl = wait_leader(P, nodes)
                try:
                    nl.propose({"v": 1}, timeout=DEADLINE)
                    break
                except errors(P):
                    continue
            converged(sinks, 2)
            wait_for(lambda: len({tuple(map(str, vals(s)[:2]))
                                  for s in sinks}) == 1)
            heads = {tuple(map(str, vals(s)[:2])) for s in sinks}
            # "never" may commit after the heal if the old leader kept
            # its term and replicated it (uncommitted need not be lost);
            # only loss or divergence is illegal.
            return {"committed_without_quorum": any(during),
                    "one_history": len(heads) == 1,
                    "legal_head": heads <= {("0", "1"), ("0", "never")}}
        finally:
            teardown(nodes, servers)

    state = each_package(scenario, tmp_path)
    assert state == {"committed_without_quorum": False, "one_history": True,
                     "legal_head": True}


def test_partition_heal_cycles_converge_identically(tmp_path):
    def scenario(P, d):
        net = Net(P.rpc)
        sinks = [[], [], []]
        servers, urls, nodes = mk_cluster(P, 3, d, sinks, net)
        try:
            seq = 0
            committed: list[int] = []
            for cycle in range(3):
                leader = wait_leader(P, nodes)
                for _ in range(3):
                    try:
                        leader.propose({"v": seq}, timeout=5)
                        committed.append(seq)
                    except errors(P):
                        pass
                    seq += 1
                victim = leader if cycle % 2 == 0 else \
                    next(x for x in nodes if x is not leader)
                net.isolate(victim.id, urls)
                time.sleep(0.6)  # the partition's length, not a wait
                net.heal()
            for _ in range(10):
                leader = wait_leader(P, nodes)
                try:
                    leader.propose({"v": "fin"}, timeout=DEADLINE)
                    break
                except errors(P):
                    continue
            else:
                raise AssertionError("fin never committed")
            wait_for(lambda: all(vals(s) and vals(s)[-1] == "fin"
                                 for s in sinks)
                     and len({tuple(map(str, vals(s)))
                              for s in sinks}) == 1)
            final = vals(sinks[0])
            pos = [final.index(v) for v in committed if v in final]
            return {"identical": len({tuple(map(str, vals(s)))
                                      for s in sinks}) == 1,
                    "acked_all_present": all(v in final for v in committed),
                    "acked_in_order": pos == sorted(pos),
                    "ends_with_fin": final[-1] == "fin"}
        finally:
            teardown(nodes, servers)

    state = each_package(scenario, tmp_path)
    assert all(state.values()), state


def test_install_snapshot_races_live_appends(tmp_path):
    def scenario(P, d):
        net = Net(P.rpc)
        sinks = [[], [], []]
        servers, urls, nodes = mk_cluster(P, 3, d, sinks, net,
                                          compact_threshold=30)
        try:
            leader = wait_leader(P, nodes)
            follower = next(x for x in nodes if x is not leader)
            fi = nodes.index(follower)
            net.isolate(follower.id, urls)
            for i in range(80):
                leader.propose({"v": i}, timeout=DEADLINE)
            live = [s for j, s in enumerate(sinks) if j != fi]
            converged(live, 80)
            compacted = leader.log_base > 0
            stop = threading.Event()
            appended = []

            def hammer():
                i = 80
                while not stop.is_set():
                    try:
                        leader.propose({"v": i}, timeout=5)
                        appended.append(i)
                        i += 1
                    except errors(P):
                        return
                    time.sleep(0.005)

            th = threading.Thread(target=hammer, daemon=True)
            th.start()
            net.heal()
            wait_for(lambda: follower.last_applied >= 80)
            stop.set()
            th.join(timeout=DEADLINE)
            total = 80 + len(appended)
            converged(live, total)
            wait_for(lambda: follower.last_applied == leader.last_applied)
            lv = vals(sinks[nodes.index(leader)])
            fv = vals(sinks[fi])
            return {"compacted": compacted,
                    "leader_exact": lv == list(range(total)),
                    "follower_clean_suffix": fv == lv[len(lv) - len(fv):],
                    "same_applied_index":
                        follower.last_applied == leader.last_applied}
        finally:
            teardown(nodes, servers)

    state = each_package(scenario, tmp_path)
    assert all(state.values()), state


def test_membership_change_under_load(tmp_path):
    def scenario(P, d):
        net = Net(P.rpc)
        sinks = [[], [], [], []]
        servers, urls, nodes = mk_cluster(P, 3, d, sinks[:3], net)
        s4 = P.rpc.JsonHttpServer()
        n4 = P.raft.RaftNode(s4.url(), [s4.url()], apply_fn=sinks[3].append,
                             state_path=str(d / "raft3.json"),
                             election_timeout=(0.2, 0.4),
                             heartbeat_interval=0.05)
        n4.in_config = False
        n4.transport = net.transport_for(s4.url())
        n4.mount(s4)
        s4.start()
        n4.start()
        try:
            leader = wait_leader(P, nodes)
            stop = threading.Event()
            acked = []

            def load():
                i = 0
                while not stop.is_set():
                    try:
                        leader.propose({"v": i}, timeout=5)
                        acked.append(i)
                    except errors(P):
                        return
                    i += 1
                    time.sleep(0.004)

            th = threading.Thread(target=load, daemon=True)
            th.start()
            wait_for(lambda: len(acked) >= 10, what="load running")
            leader.add_server(s4.url(), timeout=DEADLINE)
            n_at_add = len(acked)
            wait_for(lambda: len(acked) >= n_at_add + 10)
            victim = next(x for x in nodes if x is not leader)
            leader.remove_server(victim.id, timeout=DEADLINE)
            n_at_remove = len(acked)
            wait_for(lambda: len(acked) >= n_at_remove + 10)
            stop.set()
            th.join(timeout=DEADLINE)
            li = nodes.index(leader)
            wait_for(lambda: len(vals(sinks[3])) >= len(acked)
                     and len(vals(sinks[li])) >= len(acked))
            in_order = all(vals(s)[:len(acked)] == acked
                           for s in (sinks[li], sinks[3]))
            # The removed node learns it is out from the removal entry,
            # which the leader keeps sending it until it has it.
            wait_for(lambda: not victim.in_config and n4.in_config,
                     what="the membership changes applied")
            return {"load_ran": len(acked) > 20, "in_order": in_order,
                    "victim_out": not victim.in_config,
                    "joiner_in": n4.in_config,
                    "n_peers": len(leader.peers)}
        finally:
            n4.stop()
            s4.stop()
            teardown(nodes, servers)

    state = each_package(scenario, tmp_path)
    assert state == {"load_ran": True, "in_order": True, "victim_out": True,
                     "joiner_in": True, "n_peers": 2}


def test_partitioned_candidate_term_inflation_rejoin(tmp_path):
    def scenario(P, d):
        net = Net(P.rpc)
        sinks = [[], [], []]
        servers, urls, nodes = mk_cluster(P, 3, d, sinks, net)
        try:
            leader = wait_leader(P, nodes)
            for i in range(3):
                leader.propose({"v": i})
            converged(sinks, 3)
            outsider = next(x for x in nodes if x is not leader)
            net.isolate(outsider.id, urls)
            wait_for(lambda: outsider.current_term
                     >= leader.current_term + 2, what="term inflation")
            net.heal()
            for _ in range(5):
                nl = wait_leader(P, nodes)
                try:
                    nl.propose({"v": 3}, timeout=DEADLINE)
                    break
                except errors(P):
                    continue
            converged(sinks, 4)
            return {"prefixes": [vals(s)[:4] for s in sinks]}
        finally:
            teardown(nodes, servers)

    state = each_package(scenario, tmp_path)
    assert state["prefixes"] == [[0, 1, 2, 3]] * 3


# -- master-level schedules (leader kill mid-operation) -----------------------


def wait_registered_leader(P, masters, exclude=()):
    deadline = time.monotonic() + DEADLINE
    while time.monotonic() < deadline:
        leaders = [m for m in masters
                   if m.raft.state == P.raft.LEADER and m not in exclude]
        if len(leaders) == 1 and list(leaders[0].topo.leaves()):
            return leaders[0]
        time.sleep(0.05)
    raise AssertionError("no master leader with a registered node")


def assign_any(P, masters):
    last = None
    for m in masters:
        try:
            out = P.rpc.call(m.url() + "/dir/assign?count=1", timeout=3)
            if "fid" in out:
                return out["fid"]
            last = P.rpc.RpcError(500, str(out))
        except Exception as e:  # noqa: BLE001 — the failover window
            last = e
    raise last


def test_leader_kill_during_sequencer_advance(tmp_path):
    def scenario(P, d):
        masters, vs = start_ha(P, d)
        try:
            leader = wait_registered_leader(P, masters)
            fids: list[str] = []
            lock = threading.Lock()
            stop = threading.Event()

            def worker():
                while not stop.is_set():
                    try:
                        fid = assign_any(P, masters)
                    except Exception:  # noqa: BLE001 — failover window
                        time.sleep(0.05)
                        continue
                    with lock:
                        fids.append(fid)

            threads = [threading.Thread(target=worker, daemon=True)
                       for _ in range(4)]
            for th in threads:
                th.start()
            wait_for(lambda: len(fids) >= 25, what="assigns before kill")
            leader.stop()
            survivors = [m for m in masters if m is not leader]
            new_leader = wait_registered_leader(P, survivors,
                                                exclude=(leader,))
            n_at_kill = len(fids)
            wait_for(lambda: len(fids) >= n_at_kill + 25,
                     what="assigns after kill")
            stop.set()
            for th in threads:
                th.join(timeout=DEADLINE)
            keys = [int(f.split(",")[1][:-8], 16) for f in fids]
            return {"load_ran": len(fids) > 50,
                    "fids_unique": len(set(fids)) == len(fids),
                    "keys_unique": len(set(keys)) == len(keys),
                    "new_ceiling_above_all": new_leader._seq_ceiling
                    > max(keys)}
        finally:
            stop_ha(masters, vs)

    state = each_package(scenario, tmp_path)
    assert all(state.values()), state


def test_leader_kill_during_volume_growth(tmp_path):
    def scenario(P, d):
        masters, vs = start_ha(P, d)
        try:
            leader = wait_registered_leader(P, masters)
            stop = threading.Event()
            grown = []

            def grower():
                while not stop.is_set():
                    for m in masters:
                        try:
                            P.rpc.call_json(m.url() + "/vol/grow?count=1",
                                            "POST", timeout=3)
                            grown.append(m)
                            break
                        except Exception:  # noqa: BLE001 — failover
                            continue
                    time.sleep(0.05)

            th = threading.Thread(target=grower, daemon=True)
            th.start()
            wait_for(lambda: len(grown) >= 2, what="growth before kill")
            leader.stop()
            survivors = [m for m in masters if m is not leader]
            new_leader = wait_registered_leader(P, survivors,
                                                exclude=(leader,))
            n_at_kill = len(grown)
            wait_for(lambda: len(grown) >= n_at_kill + 2,
                     what="growth after kill")
            stop.set()
            th.join(timeout=DEADLINE)

            def vids_now():
                vs._send_heartbeat(full=True)
                return [v.id for dn in new_leader.topo.leaves()
                        for v in dn.volumes.values()]
            wait_for(lambda: len(vids_now()) >= 2,
                     what="the grown volumes at the new leader")
            vids = vids_now()
            fid = assign_any(P, survivors)
            return {"vids_unique": len(vids) == len(set(vids)),
                    "grew": len(vids) >= 2,
                    "ceiling_covers": new_leader.topo._max_volume_id
                    >= max(vids),
                    "assign_works": "," in fid}
        finally:
            stop_ha(masters, vs)

    state = each_package(scenario, tmp_path)
    assert all(state.values()), state


def test_exactly_once_apply_across_leader_kill(tmp_path):
    def scenario(P, d):
        sinks = [[], [], []]
        servers, urls, nodes = mk_cluster(P, 3, d, sinks)
        try:
            leader = wait_leader(P, nodes)
            for i in range(10):
                leader.propose({"v": i})
            li = nodes.index(leader)
            leader.stop()
            servers[li].stop()
            survivors = [x for x in nodes if x is not leader]
            nl = wait_leader(P, survivors, exclude=(leader,))
            nl.propose({"v": 10}, timeout=DEADLINE)
            live = [sinks[nodes.index(x)] for x in survivors]
            converged(live, 11)
            return {"survivors": [vals(s) for s in live]}
        finally:
            teardown(nodes, servers)

    state = each_package(scenario, tmp_path)
    assert state["survivors"] == [list(range(11))] * 2


def test_divergent_uncommitted_log_truncated_on_rejoin(tmp_path):
    def scenario(P, d):
        net = Net(P.rpc)
        sinks = [[], [], []]
        servers, urls, nodes = mk_cluster(P, 3, d, sinks, net)
        try:
            leader = wait_leader(P, nodes)
            leader.propose({"v": "base"})
            converged(sinks, 1)
            net.isolate(leader.id, urls)
            for tag in ("dead-a", "dead-b"):
                try:
                    leader.propose({"v": tag}, timeout=0.8)
                except errors(P):
                    pass
            majority = [x for x in nodes if x is not leader]
            nl = wait_leader(P, majority, exclude=(leader,))
            for i in range(3):
                nl.propose({"v": i}, timeout=DEADLINE)
            converged([sinks[nodes.index(x)] for x in majority], 4)
            net.heal()
            old = sinks[nodes.index(leader)]
            wait_for(lambda: len(vals(old)) >= 4)
            logged = [e["cmd"].get("v") for e in leader.log
                      if "v" in e.get("cmd", {})]
            return {"old_leader_applied": vals(old)[:4],
                    "dead_applied": any(t in vals(old)
                                        for t in ("dead-a", "dead-b")),
                    "dead_logged": any(t in logged
                                       for t in ("dead-a", "dead-b"))}
        finally:
            teardown(nodes, servers)

    state = each_package(scenario, tmp_path)
    assert state == {"old_leader_applied": ["base", 0, 1, 2],
                     "dead_applied": False, "dead_logged": False}
