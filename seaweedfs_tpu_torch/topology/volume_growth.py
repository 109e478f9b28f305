"""VolumeGrowth: find placement slots honoring replica placement.

Port of weed/topology/volume_growth.go findEmptySlotsForOneVolume: a
three-level weighted random search — pick DiffDataCenterCount+1 data
centers (the main one must have enough racks/free slots), then
DiffRackCount+1 racks in the main DC, then SameRackCount+1 servers in the
main rack — followed by one server from each other rack / other DC.
"""

from __future__ import annotations

import random

from ..core.replica_placement import ReplicaPlacement
from .node import DataCenter, DataNode, Rack
from .topology import Topology, VolumeGrowOption

# grow-by count per copy count (volume_growth.go:51-68)
_GROW_COUNTS = {1: 7, 2: 6, 3: 3}


def target_count_per_grow(copy_count: int) -> int:
    return _GROW_COUNTS.get(copy_count, 1)


class VolumeGrowth:
    def __init__(self, rng: random.Random | None = None):
        self.rng = rng or random.Random()

    @staticmethod
    def _node_eligible(n) -> bool:
        """A data node that may take a new volume replica: has a free
        slot and is neither draining (rolling restart) nor below its
        free-space reserve.  The rack/DC free-node COUNTS must apply
        the same veto as the server-level pick, or growth can commit
        to a rack whose only free nodes are all draining and fail."""
        return (n.free_space() >= 1
                and not getattr(n, "draining", False)
                and not getattr(n, "low_disk", False))

    def find_empty_slots_for_one_volume(
            self, topo: Topology,
            option: VolumeGrowOption) -> list[DataNode]:
        rp = ReplicaPlacement.parse(option.replica_placement)

        def dc_filter(node) -> str | None:
            if option.data_center and isinstance(node, DataCenter) and \
                    node.id != option.data_center:
                return f"not preferred data center {option.data_center}"
            if len(node.children) < rp.diff_rack_count + 1:
                return (f"only {len(node.children)} racks, need "
                        f"{rp.diff_rack_count + 1}")
            needed = rp.diff_rack_count + rp.same_rack_count + 1
            if node.free_space() < needed:
                return f"free {node.free_space()} < expected {needed}"
            possible_racks = 0
            for rack in node.children.values():
                free_nodes = sum(1 for n in rack.children.values()
                                 if self._node_eligible(n))
                if free_nodes >= rp.same_rack_count + 1:
                    possible_racks += 1
            if possible_racks < rp.diff_rack_count + 1:
                return (f"only {possible_racks} racks with >="
                        f"{rp.same_rack_count + 1} free nodes")
            return None

        main_dc, other_dcs = topo.pick_nodes_by_weight(
            rp.diff_data_center_count + 1, dc_filter, self.rng)

        def rack_filter(node) -> str | None:
            if option.rack and isinstance(node, Rack) and \
                    node.id != option.rack:
                return f"not preferred rack {option.rack}"
            if node.free_space() < rp.same_rack_count + 1:
                return (f"free {node.free_space()} < "
                        f"{rp.same_rack_count + 1}")
            if len(node.children) < rp.same_rack_count + 1:
                return (f"only {len(node.children)} data nodes")
            free_nodes = sum(1 for n in node.children.values()
                             if self._node_eligible(n))
            if free_nodes < rp.same_rack_count + 1:
                return f"only {free_nodes} eligible data nodes"
            return None

        main_rack, other_racks = main_dc.pick_nodes_by_weight(
            rp.diff_rack_count + 1, rack_filter, self.rng)

        def replica_filter(node) -> str | None:
            """Shared node veto: full, draining (rolling restart), or
            below its free-space reserve — none may take a new
            volume."""
            if node.free_space() < 1:
                return "no free slot"
            if getattr(node, "draining", False):
                return "draining"
            if getattr(node, "low_disk", False):
                return "below disk reserve"
            return None

        def server_filter(node) -> str | None:
            if option.data_node and isinstance(node, DataNode) and \
                    node.id != option.data_node:
                return f"not preferred data node {option.data_node}"
            return replica_filter(node)

        main_server, other_servers = main_rack.pick_nodes_by_weight(
            rp.same_rack_count + 1, server_filter, self.rng)

        servers: list[DataNode] = [main_server]  # type: ignore[list-item]
        servers.extend(other_servers)  # same rack
        for rack in other_racks:
            r, _ = rack.pick_nodes_by_weight(1, replica_filter,
                                             self.rng)
            servers.append(r)
        for dc in other_dcs:
            # One server anywhere in the other DC with a free slot
            # (same eligibility veto as the rack-level picks).
            candidates = [n for n in dc.leaves()
                          if self._node_eligible(n)]
            if not candidates:
                raise ValueError(f"no free server in data center {dc.id}")
            servers.append(self.rng.choice(candidates))
        return servers  # type: ignore[return-value]

    def grow_by_type(self, topo: Topology, option: VolumeGrowOption,
                     allocate_fn) -> int:
        """Grow target_count volumes; allocate_fn(vid, option, server) does
        the actual volume-server RPC.  Returns #volumes grown."""
        rp = ReplicaPlacement.parse(option.replica_placement)
        target = target_count_per_grow(rp.copy_count())
        grown = 0
        for _ in range(target):
            try:
                servers = self.find_empty_slots_for_one_volume(topo, option)
            except ValueError:
                break
            vid = topo.next_volume_id()
            ok = True
            for server in servers:
                try:
                    allocate_fn(vid, option, server)
                except Exception:  # noqa: BLE001
                    ok = False
                    break
            if ok:
                grown += 1
        return grown
