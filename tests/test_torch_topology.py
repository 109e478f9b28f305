"""The port's topology (topology/) against seaweedfs_tpu's: the cases of
tests/test_topology.py and the near-expiry layout case of
tests/test_lifecycle.py, each run for both packages with `random`
seeded alike and the answers (ids, fids, placements, counters) held
equal."""

from __future__ import annotations

import random
import time

import pytest

from _torch_cluster import both, hermetic_port_state, mod  # noqa: F401

pytestmark = pytest.mark.torch


def _vinfo(pkg, vid, collection="", size=0, read_only=False, rp=0, ttl=0,
           max_file_key=0, modified_at=0):
    return mod(pkg, "storage.store").VolumeInfo(
        id=vid, collection=collection, size=size, file_count=0,
        delete_count=0, deleted_byte_count=0, read_only=read_only,
        replica_placement=rp, ttl=ttl, compact_revision=0,
        max_file_key=max_file_key, modified_at=modified_at)


def _cluster(topo, dcs=2, racks=2, nodes=2, max_volumes=10):
    """dc{i}/rack{j}/node ip 10.i.j.k:8080."""
    return [topo.register_data_node(f"dc{i}", f"rack{j}", f"10.{i}.{j}.{k}",
                                    8080, max_volume_count=max_volumes)
            for i in range(dcs) for j in range(racks) for k in range(nodes)]


def _topo(pkg, **kw):
    return mod(pkg, "topology.topology").Topology(**kw)


def _option(pkg, **kw):
    return mod(pkg, "topology.topology").VolumeGrowOption(**kw)


def test_register_and_counters():
    def run(pkg):
        topo = _topo(pkg)
        nodes = _cluster(topo, dcs=1, racks=1, nodes=2, max_volumes=5)
        assert topo.max_volume_count == 10
        topo.register_volume(_vinfo(pkg, 1), nodes[0])
        topo.register_volume(_vinfo(pkg, 2), nodes[0])
        assert topo.volume_count == 2
        assert nodes[0].free_space() == 3
        assert topo.free_space() == 8
        return topo.volume_count, topo.free_space()
    both(run)


def test_full_sync_add_remove():
    def run(pkg):
        topo = _topo(pkg)
        (dn,) = _cluster(topo, dcs=1, racks=1, nodes=1)
        new, _ = topo.sync_data_node_registration(
            [_vinfo(pkg, 1), _vinfo(pkg, 2)], dn)
        assert [v.id for v in new] == [1, 2]
        _, deleted = topo.sync_data_node_registration([_vinfo(pkg, 2)], dn)
        assert [v.id for v in deleted] == [1]
        assert topo.volume_count == 1
        assert topo.lookup("", 2) == [dn]
        assert topo.lookup("", 1) == []
        return [v.id for v in deleted]
    both(run)


def test_writable_requires_enough_replicas():
    def run(pkg):
        topo = _topo(pkg)
        nodes = _cluster(topo, dcs=1, racks=1, nodes=2)
        v = _vinfo(pkg, 5, rp=1)  # 001 -> 2 copies
        topo.register_volume(v, nodes[0])
        with pytest.raises(ValueError, match="no more writable"):
            topo.pick_for_write(1, _option(pkg, replica_placement="001"))
        topo.register_volume(v, nodes[1])
        fid, count, locs = topo.pick_for_write(
            1, _option(pkg, replica_placement="001"))
        assert count == 1 and len(locs) == 2
        assert int(fid.split(",")[0]) == 5
        return fid, [n.id for n in locs]
    both(run)


def test_oversized_not_writable():
    def run(pkg):
        topo = _topo(pkg, volume_size_limit=1000)
        (dn,) = _cluster(topo, dcs=1, racks=1, nodes=1)
        topo.register_volume(_vinfo(pkg, 1, size=2000), dn)
        with pytest.raises(ValueError):
            topo.pick_for_write(1, _option(pkg))
        topo.register_volume(_vinfo(pkg, 2, size=10), dn)
        fid, _, _ = topo.pick_for_write(1, _option(pkg))
        assert fid.startswith("2,")
        return fid
    both(run)


def test_dead_node_unregisters_volumes():
    def run(pkg):
        topo = _topo(pkg)
        nodes = _cluster(topo, dcs=1, racks=1, nodes=2)
        topo.register_volume(_vinfo(pkg, 1), nodes[0])
        assert topo.lookup("", 1) == [nodes[0]]
        topo.unregister_data_node(nodes[0])
        assert topo.lookup("", 1) == []
        # Counter hygiene: only node 1's capacity (10 slots) remains.
        assert topo.max_volume_count == 10
        assert topo.volume_count == 0
        return topo.max_volume_count
    both(run)


def test_sequencer_monotonic_and_restart(tmp_path):
    def run(pkg):
        seq = mod(pkg, "topology.sequence").MemorySequencer
        meta = str(tmp_path / f"{pkg}.seq.dat")
        s = seq(meta)
        a = s.next_file_id(10)
        b = s.next_file_id(1)
        assert b == a + 10
        s.set_max(5000)
        assert s.next_file_id() == 5001
        # A restart never hands out an id twice.
        c = seq(meta).next_file_id()
        assert c > b
        with open(meta, "rb") as f:
            return a, b, c, f.read()
    both(run)


def test_heartbeat_raises_sequencer():
    def run(pkg):
        topo = _topo(pkg)
        (dn,) = _cluster(topo, dcs=1, racks=1, nodes=1)
        topo.register_volume(_vinfo(pkg, 1, max_file_key=999), dn)
        key = topo.next_file_key()
        assert key >= 1000
        return key
    both(run)


def test_ec_shard_registration():
    def run(pkg):
        bits = mod(pkg, "ec.shard_bits").ShardBits
        topo = _topo(pkg)
        nodes = _cluster(topo, dcs=1, racks=1, nodes=2)
        topo.register_ec_shards(7, "c", int(bits(0).add_shard_id(0)
                                            .add_shard_id(1)), nodes[0])
        topo.register_ec_shards(7, "c", int(bits(0).add_shard_id(2)),
                                nodes[1])
        locs = topo.lookup_ec_shards(7)
        assert locs.locations[0] == [nodes[0]]
        assert locs.locations[2] == [nodes[1]]
        assert topo.ec_shard_count == 3
        # Shrink node 0 to shard 1 only.
        topo.register_ec_shards(7, "c", int(bits(0).add_shard_id(1)),
                                nodes[0])
        assert topo.lookup_ec_shards(7).locations.get(0, []) == []
        assert topo.ec_shard_count == 2
        topo.unregister_ec_shards(7, nodes[0])
        topo.unregister_ec_shards(7, nodes[1])
        assert topo.lookup_ec_shards(7) is None
        assert topo.ec_shard_count == 0
    both(run)


def test_growth_placement_respects_rp():
    """Placement honoring 'one other DC, one other rack, one same rack'."""
    def run(pkg):
        topo = _topo(pkg)
        _cluster(topo, dcs=2, racks=3, nodes=3, max_volumes=10)
        vg = mod(pkg, "topology.volume_growth").VolumeGrowth(
            random.Random(42))
        picks = []
        for _ in range(10):
            servers = vg.find_empty_slots_for_one_volume(
                topo, _option(pkg, replica_placement="111"))
            assert len(servers) == 4  # main, same rack, other rack, DC
            assert len({s.id for s in servers}) == 4
            assert len({s.get_data_center().id for s in servers}) == 2
            assert len({(s.get_data_center().id, s.get_rack().id)
                        for s in servers}) == 3
            picks.append([s.id for s in servers])
        return picks
    both(run)


def test_growth_same_rack_placement():
    def run(pkg):
        topo = _topo(pkg)
        _cluster(topo, dcs=1, racks=1, nodes=4)
        vg = mod(pkg, "topology.volume_growth").VolumeGrowth(
            random.Random(7))
        servers = vg.find_empty_slots_for_one_volume(
            topo, _option(pkg, replica_placement="002"))
        assert len(servers) == 3
        assert len({s.id for s in servers}) == 3  # distinct nodes
        return [s.id for s in servers]
    both(run)


def test_growth_insufficient_topology():
    def run(pkg):
        topo = _topo(pkg)
        _cluster(topo, dcs=1, racks=1, nodes=1)
        vg = mod(pkg, "topology.volume_growth").VolumeGrowth(
            random.Random(1))
        with pytest.raises(ValueError) as ei:
            vg.find_empty_slots_for_one_volume(
                topo, _option(pkg, replica_placement="010"))
        return str(ei.value)
    both(run)


def test_grow_by_type_allocates_on_servers():
    def run(pkg):
        growth = mod(pkg, "topology.volume_growth")
        topo = _topo(pkg)
        _cluster(topo, dcs=1, racks=1, nodes=3)
        vg = growth.VolumeGrowth(random.Random(3))
        allocated = []

        def allocate(vid, option, server):
            allocated.append((vid, server.id))
            # Simulate the heartbeat that follows a real allocation.
            topo.register_volume(
                _vinfo(pkg, vid, rp=int(option.replica_placement)), server)

        grown = vg.grow_by_type(
            topo, _option(pkg, replica_placement="001"), allocate)
        assert grown == growth.target_count_per_grow(2) == 6
        assert len(allocated) == 12  # 6 volumes x 2 replicas
        fid, _, locs = topo.pick_for_write(
            1, _option(pkg, replica_placement="001"))
        assert len(locs) == 2
        return allocated, fid
    both(run)


def test_pick_for_write_dc_preference():
    def run(pkg):
        topo = _topo(pkg)
        nodes = _cluster(topo, dcs=2, racks=1, nodes=1)
        topo.register_volume(_vinfo(pkg, 1), nodes[0])   # dc0
        topo.register_volume(_vinfo(pkg, 2), nodes[1])   # dc1
        fids = []
        for _ in range(5):
            fid, _, locs = topo.pick_for_write(
                1, _option(pkg, data_center="dc1"))
            assert fid.startswith("2,")
            assert locs[0].get_data_center().id == "dc1"
            fids.append(fid)
        return fids
    both(run)


def test_layout_steers_writes_off_near_expiry_volumes():
    now = int(time.time())

    def run(pkg):
        ttl = mod(pkg, "core.ttl").TTL
        layout = mod(pkg, "topology.volume_layout").VolumeLayout(
            mod(pkg, "core.replica_placement").ReplicaPlacement.parse("000"),
            ttl.parse("10m"), 1 << 30)
        dn = mod(pkg, "topology.node").DataNode("n1", "127.0.0.1", 8080)
        t10 = ttl.parse("10m").to_uint32()
        layout.register_volume(_vinfo(pkg, 1, collection="c", ttl=t10,
                                      modified_at=now), dn)
        fresh = 1 in layout.writables
        # Past half the TTL since the newest write: no new assignments.
        layout.register_volume(_vinfo(pkg, 1, collection="c", ttl=t10,
                                      modified_at=now - 400), dn)
        assert fresh and 1 not in layout.writables
        return sorted(layout.writables)
    both(run)
