"""EC shard placement: the destination scoring of the rack-aware planner.

Port of the part of seaweedfs_tpu/ec/placement.py that the MQ stream
parity's remote placement (mq/stream_parity.py `_place_gen_shards`) and
the volume server's hand-off of regenerated shards
(server/volume_grpc.py `_distribute_lost_shards`) call:
`telemetry_stale_after`, `NodeView`, `node_view_for`,
`plan_shard_placement`, `gravity_key` and `_pick_dest_node` (the scoring
of pickEcNodeToBalanceShardsInto, weed/shell/command_ec_common.go). The
balancer's `Move`/`Drop`, `plan_ec_balance` and the rack and gravity
planners come with the shell and the maintenance worker.

Pure planning: callers snapshot the hosts into NodeViews and get back a
shard -> host map.
"""

from __future__ import annotations

import os
import time
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
