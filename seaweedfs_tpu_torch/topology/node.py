"""Topology node tree: Topology -> DataCenter -> Rack -> DataNode.

Behavioral port of weed/topology/node.go with up-propagated counters and
the weighted random placement picker (`PickNodesByWeight`,
node.go:65-125): candidates are weighted by free volume slots, drawn
without replacement, and the first node must additionally satisfy a
filter; earlier draws get priority.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Iterable


class Node:
    node_type = "Node"

    def __init__(self, id_: str):
        self.id = id_
        self.parent: Node | None = None
        self.children: dict[str, Node] = {}
        self.volume_count = 0
        self.active_volume_count = 0
        self.ec_shard_count = 0
        self.max_volume_count = 0
        self.max_volume_id = 0
        self._lock = threading.RLock()

    # -- counters ----------------------------------------------------------

    def free_space(self) -> int:
        # Matches FreeSpace(): EC shards consume slots at ~1/10 volume.
        free = self.max_volume_count - self.volume_count
        if self.ec_shard_count > 0:
            free -= self.ec_shard_count // 10 + 1
        return free

    def up_adjust_counts(self, volume_delta: int = 0, active_delta: int = 0,
                         ec_delta: int = 0, max_delta: int = 0) -> None:
        node: Node | None = self
        while node is not None:
            node.volume_count += volume_delta
            node.active_volume_count += active_delta
            node.ec_shard_count += ec_delta
            node.max_volume_count += max_delta
            node = node.parent

    def up_adjust_max_volume_id(self, vid: int) -> None:
        node: Node | None = self
        while node is not None:
            node.max_volume_id = max(node.max_volume_id, vid)
            node = node.parent

    # -- tree --------------------------------------------------------------

    def link_child(self, child: "Node") -> None:
        with self._lock:
            if child.id not in self.children:
                self.children[child.id] = child
                child.parent = self
                self.up_adjust_counts(
                    volume_delta=child.volume_count,
                    active_delta=child.active_volume_count,
                    ec_delta=child.ec_shard_count,
                    max_delta=child.max_volume_count)
                self.up_adjust_max_volume_id(child.max_volume_id)

    def unlink_child(self, child_id: str) -> None:
        with self._lock:
            child = self.children.pop(child_id, None)
            if child is not None:
                child.parent = None
                self.up_adjust_counts(
                    volume_delta=-child.volume_count,
                    active_delta=-child.active_volume_count,
                    ec_delta=-child.ec_shard_count,
                    max_delta=-child.max_volume_count)

    def get_or_create(self, id_: str, factory) -> "Node":
        with self._lock:
            node = self.children.get(id_)
            if node is None:
                node = factory(id_)
                self.link_child(node)
            return node

    def leaves(self) -> Iterable["DataNode"]:
        if isinstance(self, DataNode):
            yield self
            return
        for child in list(self.children.values()):
            yield from child.leaves()

    # -- placement ---------------------------------------------------------

    def pick_nodes_by_weight(self, number_of_nodes: int,
                             filter_first_fn: Callable[["Node"], str | None],
                             rng: random.Random | None = None,
                             ) -> tuple["Node", list["Node"]]:
        """Weighted random pick of `number_of_nodes` children.

        filter_first_fn returns None if the node qualifies as the first
        (main) node, else an error string.  Raises ValueError otherwise.
        """
        rng = rng or random
        candidates: list[Node] = []
        weights: list[int] = []
        for node in self.children.values():
            fs = node.free_space()
            if fs <= 0:
                continue
            candidates.append(node)
            weights.append(fs)
        if len(candidates) < number_of_nodes:
            raise ValueError(
                f"{self.id}: only {len(candidates)} candidates with free "
                f"space, need {number_of_nodes}")

        # Draw without replacement, probability proportional to free slots.
        total = sum(weights)
        sorted_candidates: list[Node] = []
        w = weights[:]
        for _ in range(len(candidates)):
            point = rng.randrange(total) if total > 0 else 0
            acc = 0
            for k, wk in enumerate(w):
                if wk and acc <= point < acc + wk:
                    sorted_candidates.append(candidates[k])
                    total -= wk
                    w[k] = 0
                    break
                acc += wk

        errs = []
        for k, node in enumerate(sorted_candidates):
            err = filter_first_fn(node)
            if err is None:
                if k >= number_of_nodes - 1:
                    rest = sorted_candidates[:number_of_nodes - 1]
                else:
                    rest = (sorted_candidates[:k] +
                            sorted_candidates[k + 1:number_of_nodes])
                return node, rest
            errs.append(f"{node.id}: {err}")
        raise ValueError("no matching node found!\n" + "\n".join(errs))

    def is_data_node(self) -> bool:
        return isinstance(self, DataNode)


class DataNode(Node):
    node_type = "DataNode"

    def __init__(self, id_: str, ip: str = "", port: int = 0,
                 public_url: str = "", max_volume_count: int = 7):
        super().__init__(id_)
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.max_volume_count = max_volume_count
        self.volumes: dict[int, object] = {}  # vid -> VolumeInfo
        self.ec_shards: dict[int, int] = {}   # vid -> ShardBits
        self.last_seen = 0.0
        # Lifecycle/capacity flags fed by heartbeats: a draining node
        # is leaving gracefully (rolling restart), a low_disk node has
        # breached its free-space reserve — neither takes new volumes
        # or write assignments (volume_growth / master._assign).
        self.draining = False
        self.low_disk = False

    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def add_or_update_volume(self, v) -> bool:
        """Returns True if new."""
        is_new = v.id not in self.volumes
        if is_new:
            self.volumes[v.id] = v
            self.up_adjust_counts(volume_delta=1,
                                  active_delta=0 if v.read_only else 1)
            self.up_adjust_max_volume_id(v.id)
        else:
            old = self.volumes[v.id]
            if old.read_only != v.read_only:
                self.up_adjust_counts(
                    active_delta=-1 if v.read_only else 1)
            self.volumes[v.id] = v
        return is_new

    def delete_volume(self, vid: int):
        v = self.volumes.pop(vid, None)
        if v is not None:
            self.up_adjust_counts(volume_delta=-1,
                                  active_delta=0 if v.read_only else -1)
        return v

    def get_data_center(self) -> "DataCenter":
        node = self
        while node is not None and not isinstance(node, DataCenter):
            node = node.parent
        return node

    def get_rack(self) -> "Rack":
        node = self
        while node is not None and not isinstance(node, Rack):
            node = node.parent
        return node


class Rack(Node):
    node_type = "Rack"

    def get_or_create_data_node(self, id_: str, ip: str, port: int,
                                public_url: str = "",
                                max_volume_count: int = 7) -> DataNode:
        dn = self.children.get(id_)
        if dn is None:
            dn = DataNode(id_, ip, port, public_url, max_volume_count)
            self.link_child(dn)  # propagates counters incl. max slots
        else:
            if dn.max_volume_count != max_volume_count:
                dn.up_adjust_counts(
                    max_delta=max_volume_count - dn.max_volume_count)
                dn.max_volume_count = max_volume_count
        return dn  # type: ignore[return-value]


class DataCenter(Node):
    node_type = "DataCenter"

    def get_or_create_rack(self, id_: str) -> Rack:
        return self.get_or_create(id_, Rack)  # type: ignore[return-value]
