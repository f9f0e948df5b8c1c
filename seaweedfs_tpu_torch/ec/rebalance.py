"""Hot-volume rebalancing: move whole EC shard sets toward compute.

Port of seaweedfs_tpu/ec/rebalance.py, whole. Bytes that already landed
stay wherever disk headroom put them, so a hot EC volume whose shards sit
on a chip-poor (or breaker-open, or queue-saturated) node reconstructs
slowly while chip-rich nodes idle. This module is the data-gravity layer
for existing bytes:

- **heat** (:func:`volume_heat`): per-EC-volume ``read_bytes`` /
  ``reconstructed_bytes`` counters ride the heartbeat telemetry blob
  (``ClusterHalf._ec_telemetry_json`` -> ``ec_volumes``); the shell's
  ``cluster.status`` shows them per node.
- **planner** (:func:`plan_hot_migrations`): rank (volume heat x holder
  chip-deficit), pick a strictly-better-gravity destination honouring
  every placement invariant (slot capacity, byte headroom, per-volume
  spread, across-rack ceiling), move the holder's whole shard set.
- **driver** (:func:`drive_migration`): copy (net-plane sendfile
  preferred) -> verify against the sidecar -> unmount source -> mount
  destination -> delete source. Generation-fenced, idempotent on a
  crash-rerun, and never two mounted holders: the source unmounts before
  the destination mounts.

The planner is pure (NodeViews + heat dicts in, Migrations out); the
driver takes gRPC stubs through a resolver.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .. import faults
from ..utils import metrics as _M
from ..utils import trace
from ..utils.glog import logger
from .placement import NodeView, gravity_key

log = logger("ec.rebalance")

_migrations_total = _M.REGISTRY.counter(
    "sw_ec_migrations_total",
    "hot-volume shard-set migrations driven, by outcome",
    ("outcome",),
)


def min_heat_bytes() -> int:
    """SEAWEED_EC_REBALANCE_MIN_HEAT_MB: a volume must serve at least
    this many read/reconstruction bytes per scan window on one holder
    before the scanner considers migrating it (default 1 MiB)."""
    try:
        return int(
            float(os.environ.get("SEAWEED_EC_REBALANCE_MIN_HEAT_MB", "1"))
            * (1 << 20)
        )
    except ValueError:
        return 1 << 20


def max_migrations_per_sweep() -> int:
    """SEAWEED_EC_REBALANCE_MAX_MOVES: migrations dispatched per scan
    sweep (default 1 — one bounded move per tick keeps the plane
    convergent, the scan_for_ec_scrub discipline)."""
    try:
        return max(int(os.environ.get("SEAWEED_EC_REBALANCE_MAX_MOVES", "1")), 1)
    except ValueError:
        return 1


def min_gravity_gain() -> float:
    """SEAWEED_EC_REBALANCE_MIN_GAIN: destination gravity_score must
    exceed the holder's by this factor before a migration is worth its
    wire bytes (default 1.5)."""
    try:
        return float(os.environ.get("SEAWEED_EC_REBALANCE_MIN_GAIN", "1.5"))
    except ValueError:
        return 1.5


def volume_heat(telemetry: dict | None) -> dict[int, int]:
    """Extract {vid: heat_bytes} from one node's telemetry blob's
    ``ec_volumes`` map (read + reconstructed bytes — reconstruction
    weighs double: it is the work gravity exists to move toward
    chips). Malformed blobs read as no heat."""
    if not telemetry:
        return {}
    vols = telemetry.get("ec_volumes")
    if not isinstance(vols, dict):
        return {}
    out: dict[int, int] = {}
    for vid, c in vols.items():
        try:
            out[int(vid)] = int(c.get("read_bytes", 0)) + 2 * int(
                c.get("reconstructed_bytes", 0)
            )
        except (TypeError, ValueError, AttributeError):
            continue
    return out


@dataclass(frozen=True)
class Migration:
    """Move the holder `src`'s whole shard set of `vid` to `dst`."""

    vid: int
    src: str
    dst: str
    shard_ids: tuple[int, ...]
    heat: int
    src_gravity: float
    dst_gravity: float

    def rank(self) -> float:
        """heat x chip-deficit: what the scanner sorts on."""
        return self.heat * max(self.dst_gravity - self.src_gravity, 0.0)


def plan_hot_migrations(
    nodes: list[NodeView],
    heat: dict[str, dict[int, int]],
    *,
    shard_bytes: dict[int, int] | None = None,
    min_heat: int | None = None,
    max_migrations: int | None = None,
    min_gain: float | None = None,
) -> list[Migration]:
    """Rank hot (volume, holder) pairs by heat x holder chip-deficit
    and plan bounded whole-shard-set migrations toward strictly
    better-gravity nodes.

    `heat` is {node_id: {vid: bytes served this window}} (see
    :func:`volume_heat`); `shard_bytes` ({vid: bytes per shard}) gates
    destinations on known disk headroom. Deterministic under a fixed
    input (ties break on vid then node id); mutates nothing — planned
    moves are reflected in LOCAL copies of the capacity counters so a
    sweep never plans two migrations onto headroom that only exists
    once.

    Invariants (a migration is never planned that would violate them):

    - destination holds NO shard of the volume (per-node spread can
      only improve or stay equal — the whole set moves);
    - destination has >= len(shard_ids) free slots and, when byte
      headroom is known, fits len(shard_ids) x shard_bytes;
    - with >= 2 racks, the destination rack stays within the
      ceil(total/racks) across-rack ceiling for the volume;
    - destination gravity_score >= min_gain x holder gravity_score
      (and strictly better by `gravity_key`).
    """
    if min_heat is None:
        min_heat = min_heat_bytes()
    if max_migrations is None:
        max_migrations = max_migrations_per_sweep()
    if min_gain is None:
        min_gain = min_gravity_gain()
    by_id = {n.id: n for n in nodes}
    racks: dict[tuple[str, str], list[NodeView]] = {}
    for n in nodes:
        racks.setdefault(n.rack_key(), []).append(n)
    multi_rack = len(racks) >= 2

    # candidate (heat x deficit) ranking over every hot holder
    scored: list[tuple[float, int, str]] = []
    for node_id, vols in heat.items():
        holder = by_id.get(node_id)
        if holder is None:
            continue
        h_score = holder.gravity_score()
        best = max(
            (
                n.gravity_score()
                for n in nodes
                if n is not holder and n.free_slots > 0
            ),
            default=0.0,
        )
        deficit = max(best - h_score, 0.0)
        if deficit <= 0.0:
            continue
        for vid, heat_bytes in vols.items():
            if heat_bytes < min_heat or not holder.shards.get(vid):
                continue
            scored.append((heat_bytes * deficit, vid, node_id))
    scored.sort(key=lambda t: (-t[0], t[1], t[2]))

    plans: list[Migration] = []
    # local capacity mutation so one sweep's plans don't stack
    free_slots = {n.id: n.free_slots for n in nodes}
    free_bytes = {n.id: n.free_bytes for n in nodes}
    moved_vids: set[int] = set()
    for _rank, vid, src_id in scored:
        if len(plans) >= max_migrations:
            break
        if vid in moved_vids:
            continue  # one migration per volume per sweep
        src = by_id[src_id]
        sids = tuple(sorted(src.shards.get(vid, ())))
        if not sids:
            continue
        per_shard = (shard_bytes or {}).get(vid, 0)
        need_bytes = per_shard * len(sids)
        total = sum(len(n.shards.get(vid, ())) for n in nodes)
        ceiling = -(-total // len(racks)) if multi_rack else total

        def rack_count(rk: tuple[str, str]) -> int:
            return sum(len(n.shards.get(vid, ())) for n in racks[rk])

        candidates = [
            d
            for d in nodes
            if d is not src
            and not d.shards.get(vid)
            and free_slots[d.id] >= len(sids)
            and not (need_bytes > 0 and 0 <= free_bytes[d.id] < need_bytes)
            and gravity_key(d) < gravity_key(src)
            and d.gravity_score() >= min_gain * max(src.gravity_score(), 1e-9)
            and (
                not multi_rack
                or d.rack_key() == src.rack_key()
                or rack_count(d.rack_key()) + len(sids) <= ceiling
            )
        ]
        if not candidates:
            continue
        dst = min(
            candidates,
            key=lambda d: (*gravity_key(d), -free_slots[d.id], d.id),
        )
        plans.append(
            Migration(
                vid=vid,
                src=src.id,
                dst=dst.id,
                shard_ids=sids,
                heat=int((heat.get(src_id) or {}).get(vid, 0)),
                src_gravity=src.gravity_score(),
                dst_gravity=dst.gravity_score(),
            )
        )
        moved_vids.add(vid)
        free_slots[dst.id] -= len(sids)
        if free_bytes[dst.id] >= 0:
            free_bytes[dst.id] = max(free_bytes[dst.id] - need_bytes, 0)
    return plans


# ---------------------------------------------------------------------------
# Driver — the ec_migrate worker task body (also driven by the
# crash-rerun tests).
# ---------------------------------------------------------------------------


def drive_migration(
    vid: int,
    collection: str,
    src_grpc: str,
    dst_grpc: str,
    shard_ids,
    *,
    stub_for,
    lookup_ec=None,
    timeout: float = 3600.0,
) -> dict:
    """Execute one whole-shard-set migration: copy -> (sidecar-verified
    inside ``VolumeEcShardsCopy``) -> unmount source -> mount
    destination -> delete source files.

    ``stub_for(grpc_addr)`` returns a volume-service stub;
    ``lookup_ec()`` (optional) returns the live ``{sid: [urls]}``
    holder map used for idempotent re-runs.

    Ordering is the NEVER-TWO-MOUNTED-HOLDERS protocol:

    1. copy lands the shard files (+ index/sidecar on first contact)
       at the destination, atomically per file, UNMOUNTED — the source
       keeps serving; a crash here changed nothing visible.
    2. source unmounts the set (files stay on its disk): reads degrade
       to reconstruction for at most the mount gap; at no instant do
       two holders advertise the same shard.
    3. destination mounts (its heartbeat advertises the set).
    4. source deletes its now-redundant files.

    A re-run after ANY crash window converges: the copy is idempotent
    (atomic per-file replace, bit-verified against the sidecar),
    unmount/mount/delete are no-ops where already done, and the final
    state is exactly one mounted holder. Fault points
    ``ec.migrate.{before_copy,after_copy,after_unmount,after_mount}``
    enumerate the windows for the chaos tests."""
    sids = sorted(int(s) for s in shard_ids)
    if not sids:
        return {"migrated": [], "skipped": "empty shard set"}
    sp = trace.start(
        "ec.migrate", volume=vid, src=src_grpc, dst=dst_grpc, shards=sids
    )
    try:
        with trace.activate(sp):
            return _drive_migration(
                vid, collection, src_grpc, dst_grpc, sids,
                stub_for=stub_for, lookup_ec=lookup_ec, timeout=timeout,
                span=sp,
            )
    except BaseException:
        _migrations_total.inc(outcome="failed")
        raise
    finally:
        trace.finish(sp)


def _drive_migration(
    vid, collection, src_grpc, dst_grpc, sids, *, stub_for, lookup_ec,
    timeout, span
):
    from ..pb import cluster_pb2 as pb

    src = stub_for(src_grpc)
    dst = stub_for(dst_grpc)
    md = trace.grpc_metadata()

    # Idempotence scouting: which of the set does the destination
    # already SERVE (mounted + advertised)? A prior run that crashed
    # after its mount only needs the source cleanup.
    dst_has: set[int] = set()
    src_has: set[int] = set()
    if lookup_ec is not None:
        try:
            located = lookup_ec()
        except Exception as e:  # noqa: BLE001 — scouting is best-effort
            log.warning("migrate ec %d: holder lookup failed: %s", vid, e)
            located = {}
        for sid, urls in located.items():
            if int(sid) not in sids:
                continue
            for u in urls:
                if u == dst_grpc:
                    dst_has.add(int(sid))
                if u == src_grpc:
                    src_has.add(int(sid))
    need_copy = [s for s in sids if s not in dst_has]
    trace.event(
        span, "migrate_scout", dst_has=sorted(dst_has),
        src_has=sorted(src_has), need_copy=need_copy,
    )

    faults.fire("ec.migrate.before_copy", volume=vid)
    if need_copy:
        # index/sidecar files ride along when the destination has no
        # shard of this volume yet (the ec.balance first_on_dst rule)
        first_on_dst = not dst_has
        dst.VolumeEcShardsCopy(
            pb.EcShardsCopyRequest(
                volume_id=vid,
                collection=collection,
                shard_ids=need_copy,
                source_url=src_grpc,
                copy_ecx=first_on_dst,
                copy_ecj=first_on_dst,
                copy_vif=first_on_dst,
                copy_ecsum=first_on_dst,
            ),
            timeout=timeout,
            metadata=md,
        )
    faults.fire("ec.migrate.after_copy", volume=vid)

    # Source stops serving BEFORE the destination starts: never two
    # mounted holders. Unmount of an already-unmounted set is a no-op.
    src.VolumeEcShardsUnmount(
        pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=sids),
        timeout=60,
        metadata=md,
    )
    faults.fire("ec.migrate.after_unmount", volume=vid)

    dst.VolumeEcShardsMount(
        pb.EcShardsMountRequest(volume_id=vid, collection=collection),
        timeout=60,
        metadata=md,
    )
    faults.fire("ec.migrate.after_mount", volume=vid)

    # Source cleanup: the destination serves the set now; the source
    # files are redundant bytes (and a future dedupe target).
    src.VolumeEcShardsDelete(
        pb.EcShardsDeleteRequest(
            volume_id=vid, collection=collection, shard_ids=sids
        ),
        timeout=60,
        metadata=md,
    )
    _migrations_total.inc(outcome="done")
    return {"migrated": sids, "copied": need_copy, "src": src_grpc,
            "dst": dst_grpc}
