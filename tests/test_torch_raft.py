"""The port's raft and multi-master HA held against the JAX package's.

Each case of tests/test_raft.py runs once per package on the same
schedule, and the two packages' committed state must be equal: the
commands every state machine applied, the volume-id and file-id
ceilings, and the peers.  Timings are not compared.  A mixed cluster of
two reference masters and one port master shows the wire protocol is
shared: it elects one leader and commits one log.
"""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest

from _torch_cluster import (PACKAGES, PORT, device_kw,  # noqa: F401
                            hermetic_port_state, mod)

pytestmark = pytest.mark.torch

# Every wait is bounded by a deadline of this many seconds, never a
# fixed sleep: the suite runs beside other workers under xdist.
DEADLINE = 20.0


def pkg_mods(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(
        pkg=pkg, rpc=mod(pkg, "cluster.rpc"), raft=mod(pkg, "cluster.raft"),
        master=mod(pkg, "cluster.master"),
        volume_server=mod(pkg, "cluster.volume_server"),
        sequence=mod(pkg, "topology.sequence"))


def each_package(scenario, tmp_path):
    """scenario(P, dir) per package; the committed states must agree."""
    out = []
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        out.append(scenario(pkg_mods(pkg), d))
    assert out[1] == out[0]
    return out[1]


def wait_for(pred, timeout=DEADLINE, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.03)
    raise AssertionError(f"{what} not reached in {timeout} s")


def mk_raft_cluster(P, n, d, sinks, **node_kw):
    servers = [P.rpc.JsonHttpServer() for _ in range(n)]
    urls = [s.url() for s in servers]
    nodes = []
    for i, s in enumerate(servers):
        node = P.raft.RaftNode(
            urls[i], urls,
            apply_fn=lambda cmd, i=i: sinks[i].append(cmd),
            state_path=str(d / f"raft{i}.json"),
            election_timeout=(0.2, 0.4), heartbeat_interval=0.05,
            **node_kw)
        node.mount(s)
        s.start()
        nodes.append(node)
    for node in nodes:
        node.start()
    return servers, nodes


def wait_leader(P, nodes, timeout=DEADLINE, exclude=()):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [x for x in nodes
                   if x.state == P.raft.LEADER and x not in exclude]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.03)
    raise AssertionError("no single leader elected")


def propose(P, nodes, cmd, exclude=()):
    """Commit `cmd` through the leader, as a client does: a node that
    lost the lead before it appended the command answers NotLeader, and
    the command goes to the next leader.  With a 0.2-0.4 s election
    timeout, a follower on a loaded host can start an election between
    `wait_leader` and the proposal.  A command that was appended and
    then lost the lead may yet commit, so that NotLeader is raised."""
    deadline = time.monotonic() + DEADLINE
    while True:
        leader = wait_leader(P, nodes, exclude=exclude)
        try:
            return leader.propose(cmd, timeout=DEADLINE)
        except P.raft.NotLeader:
            if any(e.get("cmd") is cmd for e in list(leader.log)) \
                    or time.monotonic() > deadline:
                raise


def teardown(nodes, servers):
    for x in nodes:
        x.stop()
    for s in servers:
        s.stop()


def user_cmds(sink):
    return [c for c in sink if c.get("op") not in ("noop", "config")]


def test_raft_elects_single_leader_and_replicates(tmp_path):
    def scenario(P, d):
        sinks = [[], [], []]
        servers, nodes = mk_raft_cluster(P, 3, d, sinks)
        try:
            leader = wait_leader(P, nodes)
            for i in range(5):
                leader.propose({"op": "max_volume_id", "value": i + 1})
            wait_for(lambda: all(len(user_cmds(s)) == 5 for s in sinks))
            follower = next(x for x in nodes if x is not leader)
            with pytest.raises(P.raft.NotLeader) as ei:
                follower.propose({"op": "x"})
            return {"applied": [user_cmds(s) for s in sinks],
                    "follower_names_leader": ei.value.leader == leader.id,
                    "peers": [sorted(nodes.index(next(
                        m for m in nodes if m.id == p)) for p in x.peers)
                        for x in nodes]}
        finally:
            teardown(nodes, servers)

    state = each_package(scenario, tmp_path)
    assert all([c["value"] for c in s] == [1, 2, 3, 4, 5]
               for s in state["applied"])
    assert state["follower_names_leader"]


def test_raft_leader_failover_preserves_log(tmp_path):
    def scenario(P, d):
        sinks = [[], [], []]
        servers, nodes = mk_raft_cluster(P, 3, d, sinks)
        try:
            for i in range(3):
                propose(P, nodes, {"v": i})
            leader = wait_leader(P, nodes)
            dead = nodes.index(leader)
            leader.stop()
            servers[dead].stop()
            survivors = [x for x in nodes if x is not leader]
            propose(P, survivors, {"v": 99})
            new_leader = wait_leader(P, survivors)
            live = [sinks[nodes.index(x)] for x in survivors]
            wait_for(lambda: all(len(user_cmds(s)) == 4 for s in live))
            return {"survivors": [user_cmds(s) for s in live],
                    "new_leader_differs": new_leader is not leader}
        finally:
            teardown(nodes, servers)

    state = each_package(scenario, tmp_path)
    assert all([c["v"] for c in s] == [0, 1, 2, 99]
               for s in state["survivors"])


def test_raft_state_persistence(tmp_path):
    def scenario(P, d):
        server = P.rpc.JsonHttpServer()
        applied = []
        node = P.raft.RaftNode(server.url(), [server.url()], applied.append,
                               state_path=str(d / "solo.json"),
                               election_timeout=(0.1, 0.2),
                               heartbeat_interval=0.05)
        node.mount(server)
        server.start()
        node.start()
        wait_leader(P, [node])
        node.propose({"v": 1})
        node.propose({"v": 2})
        node.stop()
        server.stop()
        node2 = P.raft.RaftNode("http://x", ["http://x"], applied.append,
                                state_path=str(d / "solo.json"))
        return {"log": [e["cmd"] for e in node2.log
                        if e["cmd"].get("op") != "noop"],
                "term_kept": node2.current_term >= 1,
                "applied": user_cmds(applied)}

    state = each_package(scenario, tmp_path)
    assert state["log"] == [{"v": 1}, {"v": 2}] and state["term_kept"]


def test_raft_same_term_stepdown_keeps_vote(tmp_path):
    def scenario(P, d):
        node = P.raft.RaftNode("http://me",
                               ["http://me", "http://a", "http://b"],
                               apply_fn=lambda cmd: None,
                               state_path=str(d / "n.json"))

        def vote(term, cand):
            return node._h_request_vote({}, json.dumps(
                {"term": term, "candidate_id": cand,
                 "last_log_index": 0, "last_log_term": 0}).encode())

        steps = [vote(5, "http://a")]
        node.state = "candidate"
        steps.append(node._h_append_entries({}, json.dumps(
            {"term": 5, "leader_id": "http://a", "prev_log_index": 0,
             "prev_log_term": 0, "entries": [],
             "leader_commit": 0}).encode()))
        steps.append(node.voted_for)
        steps.append(vote(5, "http://b"))
        steps.append(vote(6, "http://b"))
        with open(d / "n.json") as f:
            meta = json.load(f)
        return {"steps": steps, "meta": meta}

    state = each_package(scenario, tmp_path)
    s = state["steps"]
    assert s[0]["vote_granted"] and s[2] == "http://a"
    assert not s[3]["vote_granted"] and s[4]["vote_granted"]


# -- multi-master HA ---------------------------------------------------------


def start_ha(P, d, n=3, pkgs=None):
    """n masters with -peers (per-master package from `pkgs`, else P's)
    and one volume server of P's package following them."""
    ports = [P.rpc.free_port() for _ in range(n)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    masters = []
    for i, p in enumerate(ports):
        md = d / f"m{i}"
        md.mkdir()
        MP = pkg_mods(pkgs[i]) if pkgs else P
        m = MP.master.MasterServer(port=p, volume_size_limit_mb=64,
                                   meta_dir=str(md), peers=urls,
                                   pulse_seconds=60)
        m.raft.election_timeout = (0.2, 0.4)
        m.raft.heartbeat_interval = 0.05
        m.start()
        masters.append(m)
    vs = P.volume_server.VolumeServer(urls, [str(d / "vs")], pulse_seconds=1,
                                      **device_kw(P.pkg))
    vs.start()
    return masters, vs


def stop_ha(masters, vs):
    vs.stop()
    for m in masters:
        try:
            m.stop()
        except Exception:  # noqa: BLE001 — some already stopped in-test
            pass


def wait_master_leader(P, masters, timeout=DEADLINE, registered=False):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [m for m in masters if m.raft.state == P.raft.LEADER]
        if len(leaders) == 1 and (not registered
                                  or list(leaders[0].topo.leaves())):
            return leaders[0]
        time.sleep(0.05)
    raise AssertionError("no master leader")


def leader_and_follower(P, masters):
    """The registered leader and a follower that names it.  A follower
    learns the leader from its first append and answers an assign with
    503 "no leader elected yet" until then."""
    leader = wait_master_leader(P, masters, registered=True)
    follower = next(m for m in masters if m is not leader)
    wait_for(lambda: follower.raft.leader() == leader.url(),
             what="a follower that names the leader")
    return leader, follower


def test_master_ha_assign_via_follower(tmp_path):
    def scenario(P, d):
        masters, vs = start_ha(P, d)
        try:
            leader, follower = leader_and_follower(P, masters)
            out = P.rpc.call(follower.url() + "/dir/assign?count=1")
            s1 = P.rpc.call(leader.url() + "/cluster/status")
            s2 = P.rpc.call(follower.url() + "/cluster/status")
            return {"fid": "fid" in out and bool(out["url"]),
                    "same_leader": s1["leader"] == s2["leader"]
                    == leader.url(),
                    "is_leader": [s1["is_leader"], s2["is_leader"]],
                    "max_volume_id": leader.topo._max_volume_id}
        finally:
            stop_ha(masters, vs)

    state = each_package(scenario, tmp_path)
    assert state["fid"] and state["same_leader"]
    assert state["is_leader"] == [True, False]


def test_follower_named_the_leader_before_its_assign():
    """The follower has not had its first append when the leader is
    elected and registered: the pair comes back once it names the
    leader."""
    heard = [None, None, "http://m1"]

    class Raft:
        def __init__(self, state, leader):
            self.state, self._leader = state, leader

        def leader(self):
            return self._leader()

    class Master:
        def __init__(self, url, state, leader):
            self._url, self.raft = url, Raft(state, leader)
            self.topo = SimpleNamespace(leaves=lambda: ["node"])

        def url(self):
            return self._url

    P = SimpleNamespace(raft=SimpleNamespace(LEADER="leader"))
    leader = Master("http://m1", "leader", lambda: "http://m1")
    follower = Master("http://m2", "follower",
                      lambda: heard.pop(0) if len(heard) > 1 else heard[0])
    assert leader_and_follower(P, [leader, follower]) == (leader, follower)
    assert follower.raft.leader() == "http://m1" and heard == ["http://m1"]


def assign_after_reregistration(P, master):
    """The node row can precede its full beat's volume list: retry the
    406 ("cannot grow") until the re-registration lands."""
    deadline = time.monotonic() + DEADLINE
    while True:
        try:
            return P.rpc.call(master.url() + "/dir/assign?count=1")
        except P.rpc.RpcError as e:
            if e.status != 406 or time.monotonic() >= deadline:
                raise
            time.sleep(0.2)


def test_master_ha_volume_id_consensus_across_failover(tmp_path):
    def scenario(P, d):
        masters, vs = start_ha(P, d)
        try:
            leader = wait_master_leader(P, masters, registered=True)
            out1 = P.rpc.call(leader.url() + "/dir/assign?count=1")
            vid1 = int(out1["fid"].split(",")[0])
            ceiling1 = leader.topo._max_volume_id
            leader.stop()
            survivors = [m for m in masters if m is not leader]
            new_leader = wait_master_leader(P, survivors, registered=True)
            # The node row can land before its full beat's volume list;
            # an assign in that window grows a volume at the new leader
            # in one run and not in the next.  Assign once the new
            # leader holds every volume the node has, so that neither
            # leader grows more than the first assign did.
            held = sum(len(loc.volumes) for loc in vs.store.locations)
            wait_for(lambda: sum(len(dn.volumes) for dn in
                                 new_leader.topo.leaves()) == held,
                     what="the node's volumes at the new leader")
            assign_after_reregistration(P, new_leader)
            covered = new_leader.topo._max_volume_id >= vid1
            grown = new_leader.topo.next_volume_id()
            return {"ceiling_before": ceiling1, "covered": covered,
                    "grown_vid": grown, "grown_above": grown > vid1}
        finally:
            stop_ha(masters, vs)

    state = each_package(scenario, tmp_path)
    assert state["covered"] and state["grown_above"]
    assert state["grown_vid"] > state["ceiling_before"]


def test_master_ha_file_id_sequencer_across_failover(tmp_path):
    def scenario(P, d):
        masters, vs = start_ha(P, d)
        try:
            leader = wait_master_leader(P, masters, registered=True)
            assert isinstance(leader.topo.sequencer,
                              P.sequence.RaftSequencer)
            first = [leader.topo.sequencer.next_file_id() for _ in range(5)]
            leader.stop()
            rest = [m for m in masters if m is not leader]
            new_leader = wait_master_leader(P, rest, registered=True)
            second = [new_leader.topo.sequencer.next_file_id()
                      for _ in range(5)]
            return {"first": first, "second": second,
                    "seq_ceiling": new_leader._seq_ceiling}
        finally:
            stop_ha(masters, vs)

    state = each_package(scenario, tmp_path)
    first, second = state["first"], state["second"]
    assert sorted(set(first)) == first and min(second) > max(first)
    assert state["seq_ceiling"] == second[0] + \
        mod(PORT, "topology.sequence").RaftSequencer.BLOCK


# -- snapshot / compaction / membership ---------------------------------------


def test_log_compaction_bounds_journal(tmp_path):
    def scenario(P, d):
        applied = {"v": 0}
        state_path = str(d / "solo.json")

        def mk():
            return P.raft.RaftNode(
                "http://127.0.0.1:1", [],
                apply_fn=lambda cmd: applied.__setitem__("v", cmd["value"]),
                snapshot_fn=lambda: {"v": applied["v"]},
                restore_fn=lambda s: applied.__setitem__("v", s.get("v", 0)),
                state_path=state_path, compact_threshold=50,
                election_timeout=(0.1, 0.2), heartbeat_interval=0.05)

        node = mk()
        node.start()
        wait_for(node.is_leader)
        try:
            for i in range(1, 301):
                node.propose({"op": "set", "value": i})
            wait_for(lambda: node.log_base > 0)
            with open(state_path + ".log") as f:
                journal_lines = sum(1 for _ in f)
            out = {"compacted": node.log_base > 0 and len(node.log) < 300,
                   "journal_bounded": journal_lines < 300,
                   "applied": applied["v"]}
        finally:
            node.stop()
        applied["v"] = 0
        node2 = mk()
        node2.start()
        wait_for(node2.is_leader)
        try:
            node2.propose({"op": "set", "value": 301}, timeout=DEADLINE)
            out["after_restart"] = applied["v"]
            out["restored_from_snapshot"] = node2.log_base > 0
        finally:
            node2.stop()
        return out

    state = each_package(scenario, tmp_path)
    assert state == {"compacted": True, "journal_bounded": True,
                     "applied": 300, "after_restart": 301,
                     "restored_from_snapshot": True}


def test_far_behind_follower_catches_up_via_snapshot(tmp_path):
    def scenario(P, d):
        sinks = [[], [], []]
        servers, nodes = mk_raft_cluster(
            P, 3, d, sinks, snapshot_fn=lambda: {},
            restore_fn=lambda s: None, compact_threshold=40)
        try:
            leader = wait_leader(P, nodes)
            lagger = next(n for n in nodes if n is not leader)
            li = nodes.index(lagger)
            servers[li].stop()
            lagger.in_config = False
            for i in range(1, 201):
                leader.propose({"op": "set", "value": i}, timeout=DEADLINE)
            wait_for(lambda: leader.log_base > 0)
            lagger.in_config = True
            servers[li].start()
            wait_for(lambda: lagger.log_base >= leader.log_base > 0,
                     what="snapshot install")
            wait_for(lambda: lagger.commit_index >= leader.commit_index)
            leader_vals = [c["value"] for c in user_cmds(
                sinks[nodes.index(leader)])]
            lag_vals = [c["value"] for c in user_cmds(sinks[li])]
            return {"leader_applied": leader_vals,
                    "lagger_suffix": lag_vals == leader_vals[
                        len(leader_vals) - len(lag_vals):],
                    "installed": lagger.log_base >= 1}
        finally:
            teardown(nodes, servers)

    state = each_package(scenario, tmp_path)
    assert state["leader_applied"] == list(range(1, 201))
    assert state["installed"] and state["lagger_suffix"]


def test_membership_add_and_remove_server(tmp_path):
    def scenario(P, d):
        sinks = [[], [], []]
        servers, nodes = mk_raft_cluster(P, 3, d, sinks)
        extra = []
        s4 = P.rpc.JsonHttpServer()
        n4 = None
        try:
            leader = wait_leader(P, nodes)
            leader.propose({"op": "set", "value": 1})
            n4 = P.raft.RaftNode(
                s4.url(), [s4.url(), leader.id], apply_fn=extra.append,
                state_path=str(d / "raft4.json"),
                election_timeout=(0.2, 0.4), heartbeat_interval=0.05)
            n4.mount(s4)
            s4.start()
            n4.start()
            leader.add_server(s4.url())
            added = s4.url() in leader.peers
            leader.propose({"op": "set", "value": 2}, timeout=DEADLINE)
            wait_for(lambda: any(c.get("value") == 2 for c in extra))
            wait_for(lambda: all(s4.url() in n.peers for n in nodes))
            leader.remove_server(s4.url())
            removed = s4.url() not in leader.peers
            wait_for(lambda: not n4.in_config)
            wait_for(lambda: all(s4.url() not in n.peers for n in nodes),
                     what="every member applied the removal")
            with pytest.raises(ValueError):
                leader.remove_server(leader.id)
            return {"added": added, "removed": removed,
                    "joiner_applied": user_cmds(extra),
                    "n_peers": sorted(len(n.peers) for n in nodes)}
        finally:
            teardown(nodes, servers)
            if n4 is not None:
                n4.stop()
            s4.stop()

    state = each_package(scenario, tmp_path)
    assert state["added"] and state["removed"]
    assert {"op": "set", "value": 2} in state["joiner_applied"]


# -- one wire protocol: reference and port masters in one raft group -----------


def test_mixed_masters_elect_one_leader_and_commit_one_log(tmp_path):
    """Two reference masters and one port master (-peers naming all
    three) elect one leader and commit the same log; the volume-id and
    file-id ceilings agree on every member."""
    pkgs = [PACKAGES[0], PACKAGES[0], PORT]
    P = pkg_mods(PACKAGES[0])
    masters, vs = start_ha(P, tmp_path, pkgs=pkgs)
    try:
        leader = wait_master_leader(P, masters, registered=True)
        assert sum(m.is_leader() for m in masters) == 1
        # Through the port master whatever its role: proxied or served.
        port_master = masters[2]
        fids = [P.rpc.call(port_master.url() + "/dir/assign?count=1")["fid"]
                for _ in range(3)]
        assert len(set(fids)) == 3
        grown = leader.topo.next_volume_id()

        def logs():
            return [[(e["term"], e["cmd"]) for e in m.raft.log]
                    for m in masters]

        wait_for(lambda: all(m.raft.commit_index == leader.raft.commit_index
                             and m.raft.last_applied
                             == leader.raft.commit_index for m in masters),
                 what="every member applied the leader's log")
        assert logs()[0] == logs()[1] == logs()[2]
        ceilings = {(m.topo._max_volume_id, m._seq_ceiling) for m in masters}
        assert ceilings == {(grown, leader._seq_ceiling)}
        status = [m.raft._h_status({}, b"") for m in masters]
        assert {s["leader"] for s in status} == {leader.raft.id}
        # Kill whichever leads: the two survivors (one of each package
        # when a reference master led) elect and extend the same log.
        leader.stop()
        rest = [m for m in masters if m is not leader]
        new_leader = wait_master_leader(P, rest)
        new_leader.raft.propose({"op": "max_volume_id",
                                 "value": grown + 1}, timeout=DEADLINE)
        wait_for(lambda: all(m.raft.last_applied
                             == new_leader.raft.commit_index for m in rest))
        assert [[(e["term"], e["cmd"]) for e in m.raft.log]
                for m in rest][0] == \
            [[(e["term"], e["cmd"]) for e in m.raft.log] for m in rest][1]
        assert {m.topo._max_volume_id for m in rest} == {grown + 1}
    finally:
        stop_ha(masters, vs)
