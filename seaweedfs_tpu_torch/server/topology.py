"""Master-side cluster topology: DC → rack → DataNode tree, volume
layouts, EC shard map.

Reference: weed/topology (Topology topology.go:38, VolumeLayout
volume_layout.go, growth volume_growth.go:98). Registration comes from
heartbeats (SyncDataNodeRegistration topology.go:579, incremental
:632); nodes live in a nested DataCenter/Rack tree with a flat id
index alongside. Rack-aware EC placement planning lives in
ec/placement.py.

Port of seaweedfs_tpu/server/topology.py, whole. One addition:
`Topology(rng=...)` takes the source of `pick_for_write`'s draw (default
the `random` module, as there), so a caller can seed it.
"""

from __future__ import annotations

import json
import queue
import random
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Optional

from ..pb import cluster_pb2 as pb
from ..utils import metrics as _M


@dataclass
class DataNode:
    node_id: str  # "ip:port"
    ip: str
    port: int
    public_url: str
    grpc_port: int
    data_center: str = ""
    rack: str = ""
    max_volume_count: int = 8
    volumes: dict[int, pb.VolumeInfoMsg] = field(default_factory=dict)
    ec_shards: dict[int, pb.EcShardInfoMsg] = field(default_factory=dict)
    last_seen: float = field(default_factory=time.time)
    # identity of the heartbeat stream currently feeding this node; a
    # stale stream's cleanup must not unregister a node a newer stream owns
    owner_token: object = None
    # device-telemetry blob learned ONLY from heartbeats
    # (Heartbeat.ec_telemetry_json): per-chip queue load + breaker
    # state + stage EWMAs. Surfaced in /cluster/status and the
    # sw_ec_queue_load fleet gauges; {} until the node reports.
    ec_telemetry: dict = field(default_factory=dict)

    def location(self) -> pb.Location:
        return pb.Location(
            url=f"{self.ip}:{self.port}",
            public_url=self.public_url,
            grpc_port=self.grpc_port,
            data_center=self.data_center,
        )

    def free_slots(self) -> int:
        used = len(self.volumes) + (len(self.ec_shards) + 9) // 10
        return max(self.max_volume_count - used, 0)


@dataclass
class Rack:
    """DC → rack → DataNode tree level (reference weed/topology Rack)."""

    name: str
    nodes: dict[str, DataNode] = field(default_factory=dict)

    def free_slots(self) -> int:
        return sum(n.free_slots() for n in self.nodes.values())


@dataclass
class DataCenter:
    name: str
    racks: dict[str, Rack] = field(default_factory=dict)

    def free_slots(self) -> int:
        return sum(r.free_slots() for r in self.racks.values())

    def all_nodes(self):
        for r in self.racks.values():
            yield from r.nodes.values()


class Topology:
    def __init__(
        self,
        volume_size_limit: int = 30 * 1024**3,
        dead_after: float = 30.0,
        sequencer=None,
        rng=None,
    ):
        self.volume_size_limit = volume_size_limit
        self.dead_after = dead_after
        self._lock = threading.RLock()
        self.nodes: dict[str, DataNode] = {}
        # per-volume auto-vacuum opt-out (volume.vacuum.disable)
        self.vacuum_disabled: set[int] = set()
        # nested tree view (reference Topology: DC -> rack -> node);
        # self.nodes stays the flat id index into the same DataNode
        # objects
        self.data_centers: dict[str, DataCenter] = {}
        self.max_volume_id = 0
        if sequencer is None:
            # snowflake: needle ids must survive master restarts — a
            # reused id would overwrite an existing blob in its volume
            from ..utils.sequence import SnowflakeSequencer

            sequencer = SnowflakeSequencer()
        self._sequencer = sequencer
        # pick_for_write's draw: anything with `choice` (a seeded
        # random.Random, or the module itself)
        self.rng = random if rng is None else rng
        # KeepConnected subscribers: queues fed a VolumeLocationUpdate
        # per topology change (reference master KeepConnected streaming)
        self._subscribers: list[queue.Queue] = []
        # fleet telemetry gauges sample every live topology at scrape
        # time (weak: a test's dead master must not pin stale series)
        _topologies.add(self)

    # ----------------------------------------------------- keepconnected

    def subscribe(self) -> tuple[queue.Queue, list[pb.VolumeLocationUpdate]]:
        """Register a KeepConnected session: returns (delta queue, full
        snapshot — one update per node listing everything it holds)."""
        with self._lock:
            q: queue.Queue = queue.Queue(maxsize=4096)
            q.overflowed = False
            self._subscribers.append(q)
            snapshot = [
                pb.VolumeLocationUpdate(
                    url=f"{n.ip}:{n.port}",
                    public_url=n.public_url,
                    grpc_port=n.grpc_port,
                    new_vids=sorted(n.volumes),
                    new_ec_vids=sorted(n.ec_shards),
                )
                for n in self.nodes.values()
            ]
            return q, snapshot

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    def _publish_locked(self, update: pb.VolumeLocationUpdate) -> None:
        for q in list(self._subscribers):
            try:
                q.put_nowait(update)
            except queue.Full:
                # a wedged client must NOT keep serving its now-stale
                # map as authoritative: poison the session so the
                # KeepConnected loop ends the stream and the client
                # reconnects with a fresh snapshot
                q.overflowed = True
                self._subscribers.remove(q)

    def publish_leader(self, leader: str) -> None:
        """Push a leader-change notice to every session (clients
        reconnect to the new leader)."""
        with self._lock:
            self._publish_locked(pb.VolumeLocationUpdate(leader=leader))

    def _node_delta_locked(
        self,
        node: DataNode,
        new_vids=(),
        deleted_vids=(),
        new_ec=(),
        deleted_ec=(),
        gone: bool = False,
    ) -> None:
        if not (new_vids or deleted_vids or new_ec or deleted_ec or gone):
            return
        self._publish_locked(
            pb.VolumeLocationUpdate(
                url=f"{node.ip}:{node.port}",
                public_url=node.public_url,
                grpc_port=node.grpc_port,
                new_vids=sorted(new_vids),
                deleted_vids=sorted(deleted_vids),
                new_ec_vids=sorted(new_ec),
                deleted_ec_vids=sorted(deleted_ec),
                server_gone=gone,
            )
        )

    # -------------------------------------------------------- heartbeats

    @staticmethod
    def _absorb_telemetry(node: DataNode, hb: pb.Heartbeat) -> None:
        """Adopt the heartbeat's device-telemetry blob (best-effort: a
        malformed blob from a skewed-version server must never poison
        registration)."""
        if not hb.ec_telemetry_json:
            return
        try:
            tele = json.loads(hb.ec_telemetry_json)
        except ValueError:
            return
        if isinstance(tele, dict):
            tele["received_at"] = time.time()
            node.ec_telemetry = tele

    def sync_registration(self, node: DataNode, hb: pb.Heartbeat) -> None:
        """Full-list registration (first heartbeat / periodic refresh)."""
        with self._lock:
            # re-insert if a stale stream's cleanup raced us out
            self.nodes.setdefault(node.node_id, node)
            old_vids = set(node.volumes)
            old_ec = set(node.ec_shards)
            if hb.volumes or hb.has_no_volumes:
                node.volumes = {v.id: v for v in hb.volumes}
            if hb.ec_shards or hb.has_no_ec_shards:
                node.ec_shards = {e.id: e for e in hb.ec_shards}
            for v in node.volumes.values():
                self.max_volume_id = max(self.max_volume_id, v.id)
            node.last_seen = time.time()
            self._absorb_telemetry(node, hb)
            self._node_delta_locked(
                node,
                new_vids=set(node.volumes) - old_vids,
                deleted_vids=old_vids - set(node.volumes),
                new_ec=set(node.ec_shards) - old_ec,
                deleted_ec=old_ec - set(node.ec_shards),
            )

    def incremental_update(self, node: DataNode, hb: pb.Heartbeat) -> None:
        with self._lock:
            added_vids, removed_vids = set(), set()
            added_ec, removed_ec = set(), set()
            for v in hb.new_volumes:
                if v.id not in node.volumes:
                    added_vids.add(v.id)
                node.volumes[v.id] = v
                self.max_volume_id = max(self.max_volume_id, v.id)
            for vid in hb.deleted_volumes:
                if node.volumes.pop(vid, None) is not None:
                    removed_vids.add(vid)
            for e in hb.new_ec_shards:
                cur = node.ec_shards.get(e.id)
                if cur is not None:
                    if e.generation < cur.generation:
                        continue  # stale report loses to the newer generation
                    if e.generation == cur.generation:
                        e.shard_bits |= cur.shard_bits
                else:
                    added_ec.add(e.id)
                node.ec_shards[e.id] = e
            for e in hb.deleted_ec_shards:
                cur = node.ec_shards.get(e.id)
                if cur is None:
                    continue
                cur.shard_bits &= ~e.shard_bits
                if cur.shard_bits == 0:
                    node.ec_shards.pop(e.id, None)
                    removed_ec.add(e.id)
            node.last_seen = time.time()
            self._absorb_telemetry(node, hb)
            self._node_delta_locked(
                node,
                new_vids=added_vids,
                deleted_vids=removed_vids,
                new_ec=added_ec,
                deleted_ec=removed_ec,
            )

    def register_node(self, hb: pb.Heartbeat) -> DataNode:
        with self._lock:
            node_id = f"{hb.ip}:{hb.port}"
            node = self.nodes.get(node_id)
            if node is None:
                node = DataNode(
                    node_id=node_id,
                    ip=hb.ip,
                    port=hb.port,
                    public_url=hb.public_url or node_id,
                    grpc_port=hb.grpc_port,
                    data_center=hb.data_center,
                    rack=hb.rack,
                    max_volume_count=int(hb.max_volume_count) or 8,
                )
                self.nodes[node_id] = node
                self._tree_add_locked(node)
            if hb.max_volume_count:
                node.max_volume_count = int(hb.max_volume_count)
            return node

    def _tree_add_locked(self, node: DataNode) -> None:
        dc = self.data_centers.setdefault(
            node.data_center, DataCenter(node.data_center)
        )
        rack = dc.racks.setdefault(node.rack, Rack(node.rack))
        rack.nodes[node.node_id] = node

    def _tree_remove_locked(self, node: DataNode) -> None:
        dc = self.data_centers.get(node.data_center)
        if dc is None:
            return
        rack = dc.racks.get(node.rack)
        if rack is None:
            return
        rack.nodes.pop(node.node_id, None)
        if not rack.nodes:
            dc.racks.pop(node.rack, None)
        if not dc.racks:
            self.data_centers.pop(node.data_center, None)

    def unregister_node(self, node_id: str, owner_token: object = None) -> None:
        """With `owner_token`, remove only if that stream still owns the
        node (reconnect-race guard)."""
        with self._lock:
            node = self.nodes.get(node_id)
            if node is None:
                return
            if owner_token is not None and node.owner_token is not owner_token:
                return
            self.nodes.pop(node_id, None)
            self._tree_remove_locked(node)
            self._node_delta_locked(node, gone=True)

    def collections(self) -> list[str]:
        with self._lock:
            cols = set()
            for n in self.nodes.values():
                for v in n.volumes.values():
                    cols.add(v.collection)
                for e in n.ec_shards.values():
                    cols.add(e.collection)
            return sorted(cols)

    def prune_dead(self) -> list[str]:
        cutoff = time.time() - self.dead_after
        with self._lock:
            dead = [nid for nid, n in self.nodes.items() if n.last_seen < cutoff]
            for nid in dead:
                node = self.nodes.pop(nid)
                self._tree_remove_locked(node)
                self._node_delta_locked(node, gone=True)
            return dead

    # ------------------------------------------------------------ lookup

    def lookup(self, vid: int) -> list[pb.Location]:
        with self._lock:
            return [
                n.location() for n in self.nodes.values() if vid in n.volumes
            ]

    def lookup_ec(self, vid: int) -> dict[int, list[pb.Location]]:
        """shard_id -> locations."""
        with self._lock:
            out: dict[int, list[pb.Location]] = {}
            for n in self.nodes.values():
                e = n.ec_shards.get(vid)
                if e is None:
                    continue
                for sid in range(32):
                    if e.shard_bits & (1 << sid):
                        out.setdefault(sid, []).append(n.location())
            return out

    # ---------------------------------------------------- write planning

    def next_needle_id(self) -> int:
        return self._sequencer.next_id()

    def next_volume_id(self) -> int:
        with self._lock:
            self.max_volume_id += 1
            return self.max_volume_id

    def optimistic_add_volume(self, node: DataNode, vol: pb.VolumeInfoMsg) -> None:
        """Register a just-allocated volume before its heartbeat
        confirms it — and PUBLISH the delta, so KeepConnected sessions
        learn new volumes without waiting a heartbeat period."""
        with self._lock:
            fresh = vol.id not in node.volumes
            node.volumes[vol.id] = vol
            self.max_volume_id = max(self.max_volume_id, vol.id)
            if fresh:
                self._node_delta_locked(node, new_vids=(vol.id,))

    def apply_allocated_volume_id(self, hint: int) -> int:
        """Raft state-machine apply: allocate past both the replicated
        max and the heartbeat-observed max (`hint` is the proposer's
        view; followers converge on the same value in log order)."""
        with self._lock:
            self.max_volume_id = max(self.max_volume_id, hint) + 1
            return self.max_volume_id

    # a volume at this fraction of the size limit is "crowded": still
    # writable, but the layout steers new writes elsewhere and asks for
    # growth before the bucket fills (reference volume_layout.go
    # crowded-state transitions)
    CROWDED_FRACTION = 0.9

    def writable_volumes(
        self,
        collection: str,
        replication: str,
        ttl: str = "",
        disk_type: str = "",
    ) -> list[tuple[int, list[DataNode]]]:
        """(vid, holders) for volumes writable under the given policy.
        The (collection, replication, ttl, diskType) tuple buckets
        volumes the way the reference's VolumeLayout does."""
        copies = _replica_copies(replication)
        with self._lock:
            by_vid: dict[int, list[DataNode]] = {}
            for n in self.nodes.values():
                for v in n.volumes.values():
                    if (
                        v.collection == collection
                        and not v.read_only
                        and v.size < self.volume_size_limit
                        and (not replication or v.replica_placement == replication)
                        and v.ttl == (ttl or "")
                        and (
                            not disk_type
                            or (v.disk_type or "hdd") == disk_type
                        )
                    ):
                        by_vid.setdefault(v.id, []).append(n)
            return [
                (vid, holders)
                for vid, holders in sorted(by_vid.items())
                if len(holders) >= copies
            ]

    def _is_crowded(self, vid: int, holders: list[DataNode]) -> bool:
        limit = self.volume_size_limit * self.CROWDED_FRACTION
        return any(
            n.volumes[vid].size >= limit for n in holders if vid in n.volumes
        )

    def pick_for_write(
        self,
        collection: str,
        replication: str,
        ttl: str = "",
        disk_type: str = "",
    ) -> Optional[tuple[int, list[DataNode]]]:
        candidates = self.writable_volumes(
            collection, replication, ttl, disk_type
        )
        if not candidates:
            return None
        roomy = [
            c for c in candidates if not self._is_crowded(c[0], c[1])
        ]
        # crowded volumes are a last resort, not an equal choice
        return self.rng.choice(roomy or candidates)

    def all_crowded(
        self,
        collection: str,
        replication: str,
        ttl: str = "",
        disk_type: str = "",
    ) -> bool:
        """True when the bucket is writable only through crowded
        volumes — the master's cue to grow BEFORE writes start
        failing (reference crowded → grow transition)."""
        candidates = self.writable_volumes(
            collection, replication, ttl, disk_type
        )
        return bool(candidates) and all(
            self._is_crowded(vid, holders) for vid, holders in candidates
        )

    def plan_growth(self, replication: str) -> list[DataNode]:
        """Pick target nodes for one new volume honoring the replica
        placement code XYZ: X copies on other data centers, Y on other
        racks (same DC), Z on other servers of the same rack (reference
        findEmptySlotsForOneVolume, volume_growth.go:192)."""
        from ..storage.super_block import ReplicaPlacement

        try:
            rp = ReplicaPlacement.parse(replication or "000")
        except ValueError:
            return []
        x, y, z = rp.diff_data_centers, rp.diff_racks, rp.same_rack

        def pick_per_group(groups, count, exclude_key):
            """One available node per distinct group — each diff-DC /
            diff-rack copy must land on a DIFFERENT DC/rack. None =
            unsatisfiable. Groups ordered by aggregate free slots."""
            if count == 0:
                return []
            picked = []
            for key, members in sorted(
                groups.items(),
                key=lambda kv: -sum(n.free_slots() for n in kv[1]),
            ):
                if key == exclude_key:
                    continue
                avail = [n for n in members if n.free_slots() > 0]
                if not avail:
                    continue
                picked.append(max(avail, key=lambda n: n.free_slots()))
                if len(picked) == count:
                    return picked
            return None

        with self._lock:
            avail = sorted(
                (n for n in self.nodes.values() if n.free_slots() > 0),
                key=lambda n: -n.free_slots(),
            )
            if len(avail) < 1 + x + y + z:
                return []
            for primary in avail:
                dc = self.data_centers.get(primary.data_center)
                if dc is None:
                    continue
                rack = dc.racks.get(primary.rack)
                same_rack = [
                    n
                    for n in (rack.nodes.values() if rack else ())
                    if n is not primary and n.free_slots() > 0
                ]
                other_rack = pick_per_group(
                    {
                        rk: list(r.nodes.values())
                        for rk, r in dc.racks.items()
                    },
                    count=y,
                    exclude_key=primary.rack,
                )
                other_dc = pick_per_group(
                    {
                        dk: list(d.all_nodes())
                        for dk, d in self.data_centers.items()
                    },
                    count=x,
                    exclude_key=primary.data_center,
                )
                if (
                    len(same_rack) >= z
                    and other_rack is not None
                    and other_dc is not None
                ):
                    return [primary] + same_rack[:z] + other_rack + other_dc
            return []

    def collection_volumes(self, name: str) -> list[tuple[int, str, int]]:
        """(vid, ip, grpc_port) of every normal volume in a collection."""
        with self._lock:
            return [
                (v.id, n.ip, n.grpc_port)
                for n in self.nodes.values()
                for v in n.volumes.values()
                if v.collection == name
            ]

    def collection_ec_shards(self, name: str) -> list[tuple[int, str, int, list[int]]]:
        """(vid, ip, grpc_port, shard_ids) per holder for EC volumes of
        a collection."""
        with self._lock:
            return [
                (
                    e.id,
                    n.ip,
                    n.grpc_port,
                    [i for i in range(32) if e.shard_bits & (1 << i)],
                )
                for n in self.nodes.values()
                for e in n.ec_shards.values()
                if e.collection == name
            ]

    def garbage_candidates(self, threshold: float) -> list[tuple[int, str, int]]:
        """(vid, ip, grpc_port) of garbage-heavy writable volumes.
        Volumes an operator disabled via volume.vacuum.disable are
        skipped (reference topology Volume.SkipVacuum)."""
        with self._lock:
            return [
                (v.id, n.ip, n.grpc_port)
                for n in self.nodes.values()
                for v in n.volumes.values()
                if v.size > 0
                and not v.read_only
                and v.id not in self.vacuum_disabled
                and v.deleted_bytes / max(v.size, 1) > threshold
            ]

    # ------------------------------------------------------------- stats

    def statistics(self) -> pb.StatisticsResponse:
        with self._lock:
            vols = {v.id for n in self.nodes.values() for v in n.volumes.values()}
            ecs = {e.id for n in self.nodes.values() for e in n.ec_shards.values()}
            return pb.StatisticsResponse(
                used_size=sum(
                    v.size for n in self.nodes.values() for v in n.volumes.values()
                ),
                file_count=sum(
                    v.file_count
                    for n in self.nodes.values()
                    for v in n.volumes.values()
                ),
                volume_count=len(vols),
                ec_volume_count=len(ecs),
                node_count=len(self.nodes),
            )

    def to_proto(self) -> pb.TopologyResponse:
        with self._lock:
            return pb.TopologyResponse(
                max_volume_id=self.max_volume_id,
                nodes=[
                    pb.DataNodeInfo(
                        id=n.node_id,
                        location=n.location(),
                        volumes=list(n.volumes.values()),
                        ec_shards=list(n.ec_shards.values()),
                        max_volume_count=n.max_volume_count,
                        rack=n.rack,
                        data_center=n.data_center,
                    )
                    for n in sorted(self.nodes.values(), key=lambda n: n.node_id)
                ],
            )


# --------------------------------------------------------------------------
# Fleet telemetry gauges: heartbeat-learned per-chip queue load and pod
# breaker health across every live Topology (scrape-time callbacks over
# a weak registry, as sw_ec_chip_breaker_open samples its breakers). These are
# the MASTER-side series; the per-server sw_ec_queue_* counters come
# from each volume server's own scheduler.
# --------------------------------------------------------------------------

_topologies: "weakref.WeakSet[Topology]" = weakref.WeakSet()


def _iter_chip_loads():
    seen = set()
    for topo in list(_topologies):
        for node in list(topo.nodes.values()):
            chips = node.ec_telemetry.get("chips")
            if not isinstance(chips, dict):
                continue
            for chip, c in chips.items():
                key = (node.node_id, chip)
                if key in seen:  # two topologies tracking one node
                    continue
                seen.add(key)
                try:
                    load = float(c.get("load", 0))
                except (TypeError, AttributeError, ValueError):
                    continue
                yield {"node": node.node_id, "chip": chip}, load


def _iter_breakers_open():
    seen = set()
    for topo in list(_topologies):
        for node in list(topo.nodes.values()):
            tele = node.ec_telemetry
            if not tele or node.node_id in seen:
                continue
            seen.add(node.node_id)
            try:
                n_open = float(tele.get("breakers_open", 0))
            except (TypeError, ValueError):
                continue
            yield {"node": node.node_id}, n_open


_M.REGISTRY.gauge(
    "sw_ec_queue_load",
    "per-chip device-queue load (cost units queued + in flight), "
    "heartbeat-learned per node",
    ("node", "chip"),
    fn=_iter_chip_loads,
)
_M.REGISTRY.gauge(
    "sw_ec_fleet_breakers_open",
    "open per-chip fallback breakers per node (heartbeat-learned): "
    ">0 = that host's chips are failing over to CPU",
    ("node",),
    fn=_iter_breakers_open,
)


def _replica_copies(replication: str) -> int:
    """Replica placement 'XYZ' => 1 + sum of digits (copies across DC/
    rack/server; reference super_block/replica_placement.go)."""
    if not replication:
        return 1
    digits = [int(c) for c in replication if c.isdigit()]
    return 1 + sum(digits[:3])
