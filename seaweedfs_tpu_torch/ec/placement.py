"""Rack-aware EC shard placement planning.

Port of seaweedfs_tpu/ec/placement.py (reference
weed/shell/command_ec_common.go:60-120, the EcBalance algorithm, and
weed/storage/erasure_coding/ecbalancer/): per collection, deduplicate
shard copies, spread each volume's shards across racks (bounded by the
per-rack average), then even them across servers within each rack, and
finally flatten total per-server counts inside every rack; with
`data_gravity`, drift shards toward chip-rich, lightly loaded hosts.

The same scoring (`_pick_dest_node`) places the MQ stream parity's
remote shards (mq/stream_parity.py `_place_gen_shards`) and the volume
server's regenerated shards (server/volume_grpc.py
`_distribute_lost_shards`, through `plan_shard_placement`).

Pure planning: callers snapshot the cluster into NodeViews, get back an
ordered list of Move/Drop operations (or a shard -> host map), and
execute them with their own RPCs (the shell's `ec.balance` does copy +
mount / unmount + delete per move).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

# Load normalizer for the scalar gravity score: one typical encode
# batch's cost units (4 parity rows x 16 MiB), so
# `ec_load / GRAVITY_LOAD_NORM` reads as "batches outstanding".
GRAVITY_LOAD_NORM = float(4 << 24)


def telemetry_stale_after() -> float:
    """SEAWEED_EC_TELEMETRY_STALE_S: heartbeat telemetry older than this
    stops steering placement (default 30 s, about 15 missed 2 s
    heartbeats). A dead node's last-reported idle chips must not keep
    attracting bytes."""
    try:
        return float(os.environ.get("SEAWEED_EC_TELEMETRY_STALE_S", "30"))
    except ValueError:
        return 30.0


@dataclass
class NodeView:
    """One server as the planner sees it."""

    id: str
    rack: str = ""
    data_center: str = ""
    free_slots: int = 100
    # Disk headroom in bytes; -1 = unknown (slot-only planning). Known
    # headroom both gates a destination (a shard must fit) and breaks
    # scoring ties toward the roomiest node.
    free_bytes: int = -1
    # Live compute load (summed per-chip queue cost units); -1 = unknown,
    # scored as idle.
    ec_load: float = -1.0
    # open fallback breakers on the node: such a node loses any close call
    ec_breakers_open: int = 0
    # per-op/stage EWMA seconds from the node's flight recorder; device
    # stage pressure breaks final ties
    ec_stage_ewma_s: float = -1.0
    # heartbeat-learned chip count; 0 = unknown or none
    ec_chips: int = 0
    # seconds since the node's telemetry was last absorbed; -1 = never
    telemetry_age_s: float = -1.0
    # vid -> set of shard ids held
    shards: dict[int, set[int]] = field(default_factory=dict)

    def shard_count(self) -> int:
        return sum(len(s) for s in self.shards.values())

    def rack_key(self) -> tuple[str, str]:
        return (self.data_center, self.rack)

    def gravity_score(self) -> float:
        """Scalar data-gravity attractiveness: chips discounted by live
        load, open breakers and device-stage pressure; 0 for a node that
        reports no chips. `_pick_dest_node` scores with the equivalent
        tuple (`gravity_key`), so ordering stays exact."""
        if self.ec_chips <= 0:
            return 0.0
        score = self.ec_chips / (1.0 + max(self.ec_load, 0.0) / GRAVITY_LOAD_NORM)
        if self.ec_breakers_open > 0:
            score /= 1.0 + self.ec_breakers_open
        if self.ec_stage_ewma_s > 0:
            score /= 1.0 + self.ec_stage_ewma_s
        return score


@dataclass(frozen=True)
class Move:
    vid: int
    shard_id: int
    src: str
    dst: str
    reason: str


@dataclass(frozen=True)
class Drop:
    """Delete a duplicate shard copy (dedupe)."""

    vid: int
    shard_id: int
    node: str


def node_view_for(
    node_id: str,
    rack: str,
    data_center: str,
    max_volume_count: int,
    num_volumes: int,
    ec_entries,
    collection: str = "",
    used_bytes: int = -1,
    capacity_bytes: int = -1,
    ec_telemetry: dict | None = None,
    now: float | None = None,
    stale_after: float | None = None,
) -> NodeView:
    """The one topology -> NodeView mapping (shard-bit expansion and the
    slots x 10 capacity formula).

    `ec_entries`: EcShardInfoMsg-shaped objects (.id, .shard_bits,
    .collection). Every collection counts against capacity; only the
    selected one (if any) is planned. `used_bytes` and `capacity_bytes`
    (both >= 0) give the node's disk headroom, else it stays unknown (-1,
    slot-only planning).

    `ec_telemetry` is the node's heartbeat-learned device telemetry (the
    volume server's `_ec_telemetry_json`): per-chip queue loads sum into
    `ec_load`, the chip map's size is `ec_chips`, open breakers are
    `ec_breakers_open`, and the device-stage EWMAs sum into
    `ec_stage_ewma_s`. None or {} keeps them unknown. A blob whose
    `received_at` (the master's absorb time, else the sender's `ts`) is
    older than `stale_after` seconds (default `telemetry_stale_after()`)
    gives no signal, only its age in `telemetry_age_s`: a dead node's
    last idle chips must not keep attracting bytes."""
    shards: dict[int, set[int]] = {}
    all_shards = 0
    for e in ec_entries:
        all_shards += bin(e.shard_bits).count("1")
        if collection and e.collection != collection:
            continue
        shards[e.id] = {i for i in range(32) if e.shard_bits & (1 << i)}
    ec_load = -1.0
    breakers = 0
    stage_ewma = -1.0
    n_chips = 0
    age_s = -1.0
    if ec_telemetry:
        try:
            stamped = float(ec_telemetry.get("received_at") or ec_telemetry.get("ts") or 0.0)
        except (TypeError, ValueError):
            stamped = 0.0
        if stamped > 0:
            age_s = max((now if now is not None else time.time()) - stamped, 0.0)
        if stale_after is None:
            stale_after = telemetry_stale_after()
        if age_s >= 0 and age_s > stale_after:
            ec_telemetry = None  # aged out: only the age stays
    if ec_telemetry:
        chips = ec_telemetry.get("chips")
        if isinstance(chips, dict):
            n_chips = len(chips)
            try:
                ec_load = float(sum(c.get("load", 0) for c in chips.values()))
            except (TypeError, AttributeError):
                ec_load = -1.0
        try:
            breakers = int(ec_telemetry.get("breakers_open", 0))
        except (TypeError, ValueError):
            breakers = 0
        ewmas = ec_telemetry.get("stage_ewma_s")
        if isinstance(ewmas, dict):
            try:
                stage_ewma = float(sum(v for k2, v in ewmas.items()
                                       if k2.endswith(("h2d_dispatch", "device_drain"))))
            except (TypeError, ValueError):
                stage_ewma = -1.0
    return NodeView(
        id=node_id,
        rack=rack,
        data_center=data_center,
        free_slots=max((int(max_volume_count or 8) - num_volumes) * 10 - all_shards, 0),
        free_bytes=(max(capacity_bytes - used_bytes, 0)
                    if capacity_bytes >= 0 and used_bytes >= 0 else -1),
        ec_load=ec_load,
        ec_breakers_open=breakers,
        ec_stage_ewma_s=stage_ewma,
        ec_chips=n_chips,
        telemetry_age_s=age_s,
        shards=shards,
    )


def plan_ec_balance(
    nodes: list[NodeView], max_moves: int = 10_000,
    data_gravity: bool = False, max_gravity_moves: int = 4,
) -> tuple[list[Drop], list[Move]]:
    """Full balance pass: dedupe -> across racks -> within racks ->
    per-rack total flattening. Mutates the NodeViews to reflect planned
    operations so later stages see earlier decisions.

    `data_gravity=True` (the `ec.balance -dataGravity` flag) appends a
    final stage that drifts shards from chip-poor or loaded nodes toward
    chip-rich low-load ones, bounded by `max_gravity_moves` and behind
    the spread invariants: a gravity move never makes per-volume spread
    worse on any node or rack, never exceeds the slot gate, and shuns
    destinations known to have no byte headroom (per-shard byte sizes
    are not in the topology snapshot; the byte-exact fit gate lives in
    `plan_shard_placement(shard_bytes=)` and the rebalance planner)."""
    by_id = {n.id: n for n in nodes}
    drops = _plan_dedupe(nodes)
    moves: list[Move] = []
    moves += _plan_across_racks(nodes, by_id)
    moves += _plan_within_racks(nodes, by_id)
    moves += _plan_rack_totals(nodes, by_id)
    if data_gravity:
        moves += _plan_gravity(nodes, by_id, max_gravity_moves)
    return drops, moves[:max_moves]


def plan_shard_placement(
    nodes: list[NodeView], vid: int, shard_ids: list[int], shard_bytes: int = 0,
) -> dict[int, str]:
    """Pick a destination server for each shard of `vid`: fewest shards
    of this volume (spread the loss domain), then fewest total shards,
    then most free slots, then most disk headroom. Mutates the views as
    it assigns (slots and headroom), so successive shards spread instead
    of stacking on one node. `shard_bytes` (when > 0) also gates on
    known headroom: a shard is never planned onto a node it cannot fit.
    Shards no node can take are absent from the result (the caller
    keeps them local)."""
    plan: dict[int, str] = {}
    for sid in sorted(shard_ids):
        dest = _pick_dest_node(nodes, vid, shard_bytes=shard_bytes)
        if dest is None:
            continue
        dest.shards.setdefault(vid, set()).add(sid)
        dest.free_slots -= 1
        if dest.free_bytes >= 0:
            dest.free_bytes = max(dest.free_bytes - shard_bytes, 0)
        plan[sid] = dest.id
    return plan


# ------------------------------------------------------------------ stages


def _plan_dedupe(nodes: list[NodeView]) -> list[Drop]:
    """A shard held by several servers keeps the copy on the
    least-loaded holder; the rest are dropped (doDeduplicateEcShards)."""
    holders: dict[tuple[int, int], list[NodeView]] = defaultdict(list)
    for n in nodes:
        for vid, sids in n.shards.items():
            for sid in sids:
                holders[(vid, sid)].append(n)
    drops: list[Drop] = []
    for (vid, sid), hs in sorted(holders.items()):
        if len(hs) <= 1:
            continue
        hs.sort(key=lambda n: (n.shard_count(), n.id))
        for extra in hs[1:]:
            drops.append(Drop(vid, sid, extra.id))
            extra.shards[vid].discard(sid)
    return drops


def _racks(nodes: list[NodeView]) -> dict[tuple[str, str], list[NodeView]]:
    racks: dict[tuple[str, str], list[NodeView]] = defaultdict(list)
    for n in nodes:
        racks[n.rack_key()].append(n)
    return racks


def gravity_key(n: NodeView) -> tuple:
    """The gravity half of destination scoring: no open chip breakers
    before open ones, then more chips before fewer, then lower live load
    before higher. Tuple-exact, so ordering never depends on float
    rounding."""
    return (n.ec_breakers_open > 0, -n.ec_chips, max(n.ec_load, 0.0))


def _pick_dest_node(
    candidates: list[NodeView], vid: int, shard_bytes: int = 0,
) -> NodeView | None:
    """Score a destination: fewest shards of this volume, then fewest
    total shards, then most free slots, then `gravity_key`, then most
    known headroom, then lower device-stage pressure, then the id.
    Gravity ranks behind the spread and slot invariants on purpose: it
    splits capacity ties and never overrides them. A node with known
    headroom below `shard_bytes` is not a candidate at all."""
    best = None
    for n in candidates:
        if n.free_slots <= 0:
            continue
        if shard_bytes > 0 and 0 <= n.free_bytes < shard_bytes:
            continue
        key = (
            len(n.shards.get(vid, ())),
            n.shard_count(),
            -n.free_slots,
            *gravity_key(n),
            -max(n.free_bytes, 0),
            max(n.ec_stage_ewma_s, 0.0),
            n.id,
        )
        if best is None or key < best[0]:
            best = (key, n)
    return best[1] if best else None


def _apply_move(m: Move, by_id: dict[str, NodeView]) -> None:
    src, dst = by_id[m.src], by_id[m.dst]
    src.shards[m.vid].discard(m.shard_id)
    if not src.shards[m.vid]:
        del src.shards[m.vid]
    dst.shards.setdefault(m.vid, set()).add(m.shard_id)
    src.free_slots += 1
    dst.free_slots -= 1


def _plan_across_racks(nodes: list[NodeView], by_id: dict[str, NodeView]) -> list[Move]:
    """Per volume: no rack may hold more than ceil(total_shards /
    rack_count) shards (doBalanceEcShardsAcrossRacks)."""
    moves: list[Move] = []
    racks = _racks(nodes)
    if len(racks) < 2:
        return moves
    vids = sorted({vid for n in nodes for vid in n.shards})
    for vid in vids:
        rack_shards: dict[tuple[str, str], list[tuple[str, int]]] = defaultdict(list)
        for n in nodes:
            for sid in sorted(n.shards.get(vid, ())):
                rack_shards[n.rack_key()].append((n.id, sid))
        total = sum(len(v) for v in rack_shards.values())
        if total == 0:
            continue
        avg = -(-total // len(racks))  # ceil
        for rk in sorted(rack_shards, key=lambda k: -len(rack_shards[k])):
            overflow = rack_shards[rk][avg:]
            for node_id, sid in overflow:
                # destination racks scored by fewest shards of this volume,
                # then aggregate free slots (pickRackToBalanceShardsInto);
                # the next-best rack when the favourite has no capacity
                ranked = sorted(
                    (k for k in racks if k != rk),
                    key=lambda k: (
                        sum(len(by_id[n.id].shards.get(vid, ())) for n in racks[k]),
                        -sum(n.free_slots for n in racks[k]),
                        k,
                    ),
                )
                dest = None
                for dest_rk in ranked:
                    dest = _pick_dest_node(racks[dest_rk], vid)
                    if dest is not None:
                        break
                if dest is None:
                    continue
                m = Move(vid, sid, node_id, dest.id, "across-racks")
                _apply_move(m, by_id)
                moves.append(m)
    return moves


def _plan_within_racks(nodes: list[NodeView], by_id: dict[str, NodeView]) -> list[Move]:
    """Per volume, per rack: spread that volume's shards evenly across
    the rack's servers (doBalanceEcShardsWithinOneRack)."""
    moves: list[Move] = []
    for rk, members in sorted(_racks(nodes).items()):
        if len(members) < 2:
            continue
        vids = sorted({vid for n in members for vid in n.shards})
        for vid in vids:
            held = [(n, sorted(n.shards.get(vid, ()))) for n in members]
            total = sum(len(s) for _, s in held)
            if total == 0:
                continue
            avg = -(-total // len(members))  # ceil
            for n, sids in held:
                for sid in sids[avg:]:
                    candidates = [c for c in members
                                  if c is not n and len(c.shards.get(vid, ())) < avg]
                    dest = _pick_dest_node(candidates, vid)
                    if dest is None:
                        continue
                    m = Move(vid, sid, n.id, dest.id, "within-rack")
                    _apply_move(m, by_id)
                    moves.append(m)
    return moves


def _plan_gravity(nodes: list[NodeView], by_id: dict[str, NodeView], max_moves: int) -> list[Move]:
    """Data-gravity drift (ec.balance -dataGravity): move shards off the
    worst-gravity holders onto strictly better-gravity nodes, without
    disturbing what the spread stages established. A move is legal only
    when the destination's `gravity_key` is strictly better, per-volume
    per-node spread does not get worse (dst_count + 1 <= src_count),
    with >= 2 racks the destination rack stays within the ceil(total /
    racks) ceiling for that volume, and the destination has a free slot
    and is not known to be out of byte headroom (free_bytes == 0).
    Bounded by `max_moves` per pass."""
    moves: list[Move] = []
    racks = _racks(nodes)
    multi_rack = len(racks) >= 2

    def rack_count(rk: tuple[str, str], vid: int) -> int:
        return sum(len(n.shards.get(vid, ())) for n in racks[rk])

    # worst gravity first: their shards want to leave
    for src in sorted(nodes, key=lambda n: gravity_key(n), reverse=True):
        for vid in sorted(src.shards):
            total = sum(len(n.shards.get(vid, ())) for n in nodes)
            ceiling = -(-total // len(racks)) if multi_rack else total
            for sid in sorted(src.shards.get(vid, set())):
                if len(moves) >= max_moves:
                    return moves
                candidates = [
                    d
                    for d in nodes
                    if d is not src
                    and d.free_slots > 0
                    and d.free_bytes != 0
                    and gravity_key(d) < gravity_key(src)
                    and len(d.shards.get(vid, ())) + 1 <= len(src.shards.get(vid, ()))
                    and (
                        not multi_rack
                        or d.rack_key() == src.rack_key()
                        or rack_count(d.rack_key(), vid) + 1 <= ceiling
                    )
                ]
                if not candidates:
                    break  # no better-gravity home for this volume here
                dest = min(candidates, key=lambda d: (
                    *gravity_key(d), -d.free_slots, -max(d.free_bytes, 0), d.id))
                m = Move(vid, sid, src.id, dest.id, "gravity")
                _apply_move(m, by_id)
                moves.append(m)
    return moves


def _plan_rack_totals(nodes: list[NodeView], by_id: dict[str, NodeView]) -> list[Move]:
    """Flatten total per-server shard counts inside each rack without
    disturbing per-volume spread: only move a volume the destination
    does not already hold (balanceEcRack)."""
    moves: list[Move] = []
    for rk, members in sorted(_racks(nodes).items()):
        if len(members) < 2:
            continue
        total = sum(n.shard_count() for n in members)
        avg = total / len(members)
        for _ in range(256):
            members_sorted = sorted(members, key=lambda n: (n.shard_count(), n.id))
            low, high = members_sorted[0], members_sorted[-1]
            if not (high.shard_count() > avg and low.shard_count() + 1 <= avg):
                break
            movable = [
                (vid, sid)
                for vid, sids in sorted(high.shards.items())
                for sid in sorted(sids)
                if vid not in low.shards
            ]
            if not movable or low.free_slots <= 0:
                break
            vid, sid = movable[0]
            m = Move(vid, sid, high.id, low.id, "rack-total")
            _apply_move(m, by_id)
            moves.append(m)
    return moves
