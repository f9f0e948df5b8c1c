"""Worker-fleet control plane, hosted by the master.

Port of seaweedfs_tpu/worker/control.py, whole (reference
weed/admin/maintenance: scanner -> queue -> dispatcher, and
weed/admin/plugin: registry, scheduler and dispatcher over
PluginControlService.WorkerStream). One bidi stream per worker carries
registration, heartbeats, task assignment and progress.

- the fleet's metric families (`sw_ec_fleet_*`), `KNOWN_KINDS` and
  `VOLUME_INDEPENDENT_KINDS`;
- `WorkerControl`: `submit` (one live task per kind and volume, params
  validated against the kind's descriptor), the dispatch loop, the
  servicer of the `swworker.WorkerControl` RPCs (`WorkerStream`,
  `SubmitTask`, `ListTasks`, `ListWorkers`, `Get`/`SetMaintenanceConfig`),
  `snapshot` and `stop`;
- the scanners the master's maintenance loop calls: full and write-quiet
  volumes (`ec_encode`), volume-count spread (`balance`), EC shard
  spread (`ec_balance`), the fleet scrub (`ec_scrub`, one volume per
  sweep) with its peer-fetch rebuild dispatch (`ec_rebuild -fromPeers`)
  from the aggregated reports, data gravity (`ec_migrate`) and the
  lifecycle sweep (`s3_lifecycle`, which a worker hands to the filer's
  RunLifecycle).

It imports nothing of the EC package at module level: a master alone
imports no torch until a balance or gravity scanner runs.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field

from ..pb import worker_pb2 as wk
from ..utils import metrics as _M
from ..utils.glog import logger

_log = logger("worker.control")

# Fleet-wide scrub health, aggregated from ec_scrub task reports (the
# master's own view of bitrot across every holder — per-server scrub
# daemons only ever see their own disks).
_fleet_volumes = _M.REGISTRY.gauge(
    "sw_ec_fleet_scrubbed_volumes",
    "EC volumes with a completed fleet scrub report",
)
_fleet_corrupt = _M.REGISTRY.gauge(
    "sw_ec_fleet_corrupt_shards",
    "corrupt EC shards across the fleet (latest scrub reports)",
)
_fleet_missing = _M.REGISTRY.gauge(
    "sw_ec_fleet_missing_shards",
    "advertised-but-missing EC shards across the fleet",
)
_fleet_dispatch = _M.REGISTRY.counter(
    "sw_ec_fleet_peer_rebuild_dispatch_total",
    "peer-fetch rebuild tasks dispatched for unrebuildable holders",
)
_migrate_dispatch = _M.REGISTRY.counter(
    "sw_ec_fleet_migration_dispatch_total",
    "hot-volume ec_migrate tasks dispatched by the gravity scanner",
)


@dataclass
class _Worker:
    worker_id: str
    capabilities: set
    max_concurrent: int
    backend: str
    outbox: "queue.Queue" = field(default_factory=queue.Queue)
    active: int = 0
    last_seen: float = field(default_factory=time.time)
    # declarative per-job config (reference weed/admin/plugin):
    # kind -> TaskDescriptor proto
    descriptors: dict = field(default_factory=dict)


@dataclass
class _Task:
    task_id: str
    kind: str
    volume_id: int
    collection: str
    backend: str
    params: dict = field(default_factory=dict)
    state: str = "pending"  # pending|assigned|running|done|failed
    worker_id: str = ""
    progress: float = 0.0
    error: str = ""
    created: float = field(default_factory=time.time)
    attempts: int = 0


KNOWN_KINDS = (
    "ec_encode", "vacuum", "balance", "s3_lifecycle", "ec_balance", "iceberg",
    "ec_scrub", "ec_rebuild", "ec_migrate",
)
# cluster-wide kinds always submit with volume_id=0: the shell skips the
# -volumeId requirement for them and the worker scopes their cluster
# lease by KIND (task/<kind>) instead of the shared volume/0 name
VOLUME_INDEPENDENT_KINDS = ("ec_balance", "s3_lifecycle", "iceberg")
WORKER_STALE_SECONDS = 30.0
TASK_RETENTION = 1000  # terminal tasks kept for task.list history


class WorkerControl:
    """Registry + queue + dispatcher; also the gRPC servicer."""

    def __init__(self, topo=None, config_get=None, config_set=None):
        """topo: the master Topology, used to resolve volume collections
        and scan for maintenance candidates.

        config_get/config_set: callbacks the hosting master wires in so
        the admin plane can read/tune maintenance policy over gRPC
        (reference admin/maintenance config_schema.go). config_get() ->
        dict of MaintenanceConfig fields; config_set(dict) applies them
        live."""
        self.topo = topo
        self.config_get = config_get
        self.config_set = config_set
        self._lock = threading.Condition()
        self._workers: dict[str, _Worker] = {}
        self._tasks: dict[str, _Task] = {}
        self._pending: list[str] = []
        # (size, since_ts) per volume for the quiet-period check
        self._size_watch: dict[int, tuple[int, float]] = {}
        # vid -> last fleet-scrub submit ts (the stagger state)
        self._scrub_watch: dict[int, float] = {}
        # (node_id, vid) -> last-seen lifetime heat counter, so the
        # gravity scanner ranks per-sweep heat DELTAS, not totals
        self._heat_prev: dict[tuple[str, int], int] = {}
        # last sweep's planned migrations (status surfaces)
        self.last_migrations: list[dict] = []
        # vid -> latest aggregated ec_scrub report (fleet health view)
        self.scrub_reports: dict[int, dict] = {}
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._dispatcher.start()

    # ----------------------------------------------------------- queueing

    def _resolve_collection(self, volume_id: int) -> str:
        if self.topo is None:
            return ""
        with self.topo._lock:
            for n in self.topo.nodes.values():
                v = n.volumes.get(volume_id)
                if v is not None:
                    return v.collection
        return ""

    def submit(
        self,
        kind: str,
        volume_id: int,
        collection: str = "",
        backend: str = "",
        params: dict | None = None,
    ) -> str:
        with self._lock:  # _workers mutates under this lock
            plugin_kinds = sorted(
                set().union(*(w.capabilities for w in self._workers.values()))
                if self._workers
                else set()
            )
        if kind not in KNOWN_KINDS and kind not in plugin_kinds:
            raise ValueError(
                f"unknown task kind {kind!r} (built-in: {KNOWN_KINDS}; "
                f"connected plugin kinds: {plugin_kinds or 'none'})"
            )
        # explicit = the CALLER stated params; periodic scanners submit
        # with none and must never conflict with an operator's task
        explicit = bool(params)
        params = self._validate_params(kind, dict(params or {}))
        if kind in VOLUME_INDEPENDENT_KINDS:
            # normalize at the ONE choke point: an explicit nonzero vid
            # for a cluster-wide kind would split its dedupe and run
            # the same sweep twice back-to-back
            volume_id = 0
        if not collection:
            # collection determines on-disk paths; a task executed with
            # the wrong one fails AFTER destructive steps
            collection = self._resolve_collection(volume_id)
        task_id = uuid.uuid4().hex[:12]
        with self._lock:
            self._prune_locked()
            # dedupe: one live task per (kind, volume). A duplicate
            # with DIFFERENT params must fail loudly, not silently
            # drop the caller's overrides.
            for t in self._tasks.values():
                if (
                    t.kind == kind
                    and t.volume_id == volume_id
                    # for cluster-wide kinds the collection is part of
                    # the identity (ec_balance of A vs B is different
                    # work); for per-volume kinds it must NOT be — a
                    # mistyped -collection would split the one-live-
                    # task-per-volume guarantee and run a destructive
                    # task under the wrong on-disk paths
                    and (
                        kind not in VOLUME_INDEPENDENT_KINDS
                        or t.collection == collection
                    )
                    and t.state in ("pending", "assigned", "running")
                ):
                    if explicit and params != t.params:
                        # name only the differing KEYS: values can be
                        # credentials (iceberg carries secret_key) and
                        # this string goes back to any submit caller
                        diff = sorted(
                            k
                            for k in set(params) | set(t.params)
                            if params.get(k) != t.params.get(k)
                        )
                        raise ValueError(
                            f"task {t.task_id} for {kind}/{volume_id} is "
                            f"already live with different params (keys: "
                            f"{diff}); cancel it before re-submitting"
                        )
                    return t.task_id
            self._tasks[task_id] = _Task(
                task_id, kind, volume_id, collection, backend, params
            )
            self._pending.append(task_id)
            self._lock.notify_all()
        return task_id

    def _prune_locked(self) -> None:
        terminal = [
            t for t in self._tasks.values() if t.state in ("done", "failed")
        ]
        if len(terminal) > TASK_RETENTION:
            terminal.sort(key=lambda t: t.created)
            for t in terminal[: len(terminal) - TASK_RETENTION]:
                self._tasks.pop(t.task_id, None)

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                self._lock.wait(timeout=0.5)
                # evict hung workers: an open-but-dead stream would pin
                # its tasks 'assigned' forever (heartbeats come every ~1s)
                now = time.time()
                for w in list(self._workers.values()):
                    if now - w.last_seen > WORKER_STALE_SECONDS:
                        w.outbox.put(None)  # closes its pump -> requeue
                still_pending = []
                for task_id in self._pending:
                    t = self._tasks.get(task_id)
                    if t is None or t.state != "pending":
                        continue
                    w = self._pick_worker(t.kind)
                    if w is None:
                        still_pending.append(task_id)
                        continue
                    t.state = "assigned"
                    t.worker_id = w.worker_id
                    w.active += 1
                    assign = wk.TaskAssign(
                        task_id=t.task_id,
                        kind=t.kind,
                        volume_id=t.volume_id,
                        collection=t.collection,
                        backend=t.backend or w.backend,
                    )
                    for pk, pv in t.params.items():
                        assign.params[pk] = pv
                    w.outbox.put(wk.ServerMessage(assign=assign))
                self._pending = still_pending

    def _validate_params(self, kind: str, params: dict) -> dict:
        """Validate submitted params against the kind's declarative
        descriptor (reference weed/admin/plugin DESIGN: per-job config
        schema declared by the worker at registration). Unknown keys
        and type/range violations are rejected; declared defaults fill
        absent fields."""
        desc = None
        with self._lock:
            for w in self._workers.values():
                if kind in w.descriptors:
                    desc = w.descriptors[kind]
                    break
        if desc is None:
            if params:
                raise ValueError(
                    f"task kind {kind!r} declares no config fields"
                )
            return {}
        fields = {f.name: f for f in desc.fields}
        for name in params:
            if name not in fields:
                raise ValueError(
                    f"unknown param {name!r} for {kind!r} "
                    f"(declared: {sorted(fields)})"
                )
        out: dict = {}
        for name, f in fields.items():
            raw = params.get(name, f.default)
            if raw == "" and name not in params:
                continue  # optional, no default
            if f.type == "int":
                try:
                    v = int(raw)
                except ValueError:
                    raise ValueError(f"param {name!r} must be an int") from None
            elif f.type == "float":
                try:
                    v = float(raw)
                except ValueError:
                    raise ValueError(f"param {name!r} must be a float") from None
            elif f.type == "bool":
                if str(raw).lower() not in ("true", "false", "0", "1"):
                    raise ValueError(f"param {name!r} must be a bool")
                v = str(raw).lower() in ("true", "1")
            else:
                v = str(raw)
            if f.type in ("int", "float") and not (f.min == f.max == 0):
                if not (f.min <= float(v) <= f.max):
                    raise ValueError(
                        f"param {name!r}={v} outside [{f.min}, {f.max}]"
                    )
            # NORMALIZED storage ('0.30' == '0.3', 'True' == 'true'):
            # the duplicate-conflict check compares these strings
            out[name] = str(v).lower() if f.type == "bool" else str(v)
        return out

    def _pick_worker(self, kind: str):
        best = None
        for w in self._workers.values():
            if kind not in w.capabilities or w.active >= w.max_concurrent:
                continue
            if best is None or w.active < best.active:
                best = w
        return best

    # ------------------------------------------------------------ servicer

    def WorkerStream(self, request_iterator, context):
        worker: _Worker | None = None
        recv_done = threading.Event()

        def receiver():
            nonlocal worker
            try:
                for msg in request_iterator:
                    kind = msg.WhichOneof("body")
                    if kind == "register":
                        r = msg.register
                        with self._lock:
                            worker = _Worker(
                                worker_id=r.worker_id or uuid.uuid4().hex[:8],
                                capabilities=set(r.capabilities),
                                max_concurrent=r.max_concurrent or 1,
                                backend=r.backend or "auto",
                                descriptors={
                                    d.kind: d for d in r.descriptors
                                },
                            )
                            self._workers[worker.worker_id] = worker
                            self._lock.notify_all()
                        worker.outbox.put(wk.ServerMessage(ack=wk.ServerAck()))
                    elif kind == "heartbeat" and worker is not None:
                        worker.last_seen = time.time()
                    elif kind == "update" and worker is not None:
                        self._apply_update(worker, msg.update)
            except Exception:
                pass  # stream torn down mid-read (worker vanished)
            finally:
                recv_done.set()
                if worker is not None:
                    worker.outbox.put(None)

        t = threading.Thread(target=receiver, daemon=True)
        t.start()
        # wait for registration, then pump the outbox; no deadline —
        # bailing early while the receiver may still register would
        # leak a ghost worker whose outbox nobody drains
        while worker is None and not recv_done.is_set():
            time.sleep(0.05)
        if worker is None:
            return
        try:
            while context.is_active():
                try:
                    item = worker.outbox.get(timeout=0.5)
                except queue.Empty:
                    continue
                if item is None:
                    return
                yield item
        finally:
            with self._lock:
                # a reconnected stream may have re-registered this id
                # with a NEW worker object: only remove our own
                if self._workers.get(worker.worker_id) is worker:
                    self._workers.pop(worker.worker_id, None)
                # requeue tasks the dead worker was running
                for task in self._tasks.values():
                    if task.worker_id == worker.worker_id and task.state in (
                        "assigned",
                        "running",
                    ):
                        task.state = "pending"
                        task.worker_id = ""
                        self._pending.append(task.task_id)
                self._lock.notify_all()

    def _apply_update(self, worker: _Worker, u: wk.TaskUpdate) -> None:
        scrub_done: _Task | None = None
        with self._lock:
            t = self._tasks.get(u.task_id)
            if t is None:
                return
            t.progress = u.progress
            if u.state == "running":
                t.state = "running"
            elif u.state in ("done", "failed"):
                if (
                    u.state == "failed"
                    and "cluster lock" in u.error
                    and t.attempts < 5
                ):
                    # transient contention (a shell holds the volume
                    # lease): requeue instead of terminal failure
                    t.attempts += 1
                    t.state = "pending"
                    t.error = u.error
                    t.worker_id = ""
                    self._pending.append(t.task_id)
                else:
                    t.state = u.state
                    t.error = u.error
                    if t.kind == "ec_scrub" and u.detail:
                        scrub_done = t
                worker.active = max(worker.active - 1, 0)
                self._lock.notify_all()
        if scrub_done is not None:
            # outside the registry lock: aggregation re-enters submit()
            # when it dispatches a peer-fetch rebuild
            self._record_scrub_report(scrub_done, u.detail)

    def SubmitTask(self, request, context):
        try:
            task_id = self.submit(
                request.kind,
                request.volume_id,
                request.collection,
                request.backend,
                params=dict(request.params),
            )
        except ValueError as e:
            return wk.SubmitTaskResponse(error=str(e))
        return wk.SubmitTaskResponse(task_id=task_id)

    def ListTasks(self, request, context):
        with self._lock:
            return wk.ListTasksResponse(
                tasks=[
                    wk.TaskInfo(
                        task_id=t.task_id,
                        kind=t.kind,
                        volume_id=t.volume_id,
                        state=t.state,
                        worker_id=t.worker_id,
                        progress=t.progress,
                        error=t.error,
                    )
                    for t in sorted(
                        self._tasks.values(), key=lambda t: t.created
                    )
                ]
            )

    def ListWorkers(self, request, context):
        workers, _ = self.snapshot()
        with self._lock:
            descs = {
                wid: list(w.descriptors.values())
                for wid, w in self._workers.items()
            }
        return wk.ListWorkersResponse(
            workers=[
                wk.WorkerInfo(
                    worker_id=w["worker_id"],
                    capabilities=w["capabilities"],
                    backend=w["backend"],
                    active=w["active"],
                    max_concurrent=w["max_concurrent"],
                    descriptors=descs.get(w["worker_id"], []),
                )
                for w in workers
            ]
        )

    def GetMaintenanceConfig(self, request, context):
        cfg = self.config_get() if self.config_get else {}
        return wk.MaintenanceConfig(**cfg)

    def SetMaintenanceConfig(self, request, context):
        if self.config_set is None or self.config_get is None:
            return wk.SetMaintenanceConfigResponse(
                error="maintenance config not wired on this master"
            )
        # Read-modify-write: fields absent from the request keep their
        # current value (proto3 optional presence) — a client tuning one
        # knob must not silently zero the others. Held under the lock so
        # two concurrent partial updates cannot interleave and drop one
        # client's knob.
        with self._lock:
            cfg = dict(self.config_get())
            for key in (
                "ec_auto_fullness",
                "ec_quiet_seconds",
                "garbage_threshold",
                "vacuum_interval_seconds",
                "balance_spread",
                "lifecycle_interval_seconds",
                "lifecycle_filer",
                "ec_balance_interval_seconds",
                "ec_scrub_interval_seconds",
                "ec_rebalance_interval_seconds",
            ):
                if request.HasField(key):
                    cfg[key] = getattr(request, key)
            try:
                self.config_set(cfg)
            except ValueError as e:
                return wk.SetMaintenanceConfigResponse(error=str(e))
        return wk.SetMaintenanceConfigResponse()

    def snapshot(self) -> tuple[list[dict], list[dict]]:
        """(workers, tasks) rows for status UIs — the public view, so
        consumers never touch the registry's locking internals."""
        with self._lock:
            workers = [
                {
                    "worker_id": w.worker_id,
                    "capabilities": sorted(w.capabilities),
                    "backend": w.backend,
                    "active": w.active,
                    "max_concurrent": w.max_concurrent,
                }
                for w in self._workers.values()
            ]
            tasks = [
                {
                    "task_id": t.task_id,
                    "kind": t.kind,
                    "volume_id": t.volume_id,
                    "state": t.state,
                    "progress": t.progress,
                    "worker_id": t.worker_id,
                    "error": t.error,
                    "created": t.created,
                }
                for t in self._tasks.values()
            ]
        return workers, tasks

    def stop(self) -> None:
        self._stop.set()

    # ---------------------------------------------------------- detection

    def scan_for_ec_candidates(
        self, topo, fullness: float, volume_size_limit: int, quiet_seconds: float = 0.0
    ) -> list[str]:
        """Auto-detect volumes ready for EC (reference maintenance
        scanner / ec detection.go): full enough AND quiet — encoding
        freezes writes, so actively-written volumes must settle first.
        Quiet = reported size unchanged for quiet_seconds."""
        now = time.time()
        candidates = []
        with topo._lock:
            seen = set()
            for n in topo.nodes.values():
                for v in n.volumes.values():
                    if v.id in seen:
                        continue
                    seen.add(v.id)
                    if v.size >= fullness * volume_size_limit:
                        candidates.append((v.id, v.collection, v.size))
        submitted = []
        for vid, col, size in candidates:
            prev = self._size_watch.get(vid)
            if prev is None or prev[0] != size:
                self._size_watch[vid] = (size, now)
                if quiet_seconds > 0:
                    continue  # just started watching; not yet quiet
            elif now - prev[1] < quiet_seconds:
                continue
            try:
                submitted.append(self.submit("ec_encode", vid, col))
            except ValueError:
                # a live operator task for this volume, or a transient
                # validation issue — the PERIODIC scanner must never
                # kill its hosting loop over it
                continue
        return submitted

    def scan_for_balance_candidates(
        self, topo, spread: int
    ) -> list[str]:
        """Auto-detect imbalance (reference worker balance detection):
        when the busiest node holds >= `spread` more normal volumes
        than the idlest, submit ONE move of a volume the idle node does
        not already replicate. One task per sweep keeps the plane
        convergent instead of thrashing."""
        # full snapshot under the lock: heartbeats mutate node.volumes
        # live, and a KeyError here would kill the hosting scan loop
        with topo._lock:
            nodes = [
                (
                    f"{n.ip}:{n.grpc_port}",
                    {vid: v.collection for vid, v in n.volumes.items()},
                )
                for n in topo.nodes.values()
            ]
        if len(nodes) < 2:
            return []
        nodes.sort(key=lambda nv: len(nv[1]))
        low_addr, low_vols = nodes[0]
        high_addr, high_vols = nodes[-1]
        if len(high_vols) - len(low_vols) < max(spread, 1):
            return []
        movable = sorted(set(high_vols) - set(low_vols))
        if not movable:
            return []
        vid = movable[0]
        try:
            return [
                self.submit(
                    "balance",
                    vid,
                    high_vols[vid],
                    params={"source": high_addr, "target": low_addr},
                )
            ]
        except ValueError:
            return []

    def scan_for_ec_balance(self, topo) -> list[str]:
        """Auto-detect EC shard imbalance (reference worker ec_balance
        detection): run the SAME planner the shell and the worker task
        use over a topology snapshot; any planned drop or move means
        the cluster is out of shape, so submit ONE ec_balance task
        (which re-plans live and executes the full pass)."""
        from ..ec.placement import node_view_for, plan_ec_balance

        with topo._lock:
            views = [
                node_view_for(
                    f"{n.ip}:{n.grpc_port}",
                    n.rack,
                    n.data_center,
                    n.max_volume_count,
                    len(n.volumes),
                    list(n.ec_shards.values()),
                    # heartbeat-learned live chip load: the balance
                    # detector sees compute pressure the same way the
                    # executor's placement scoring will
                    ec_telemetry=n.ec_telemetry,
                )
                for n in topo.nodes.values()
            ]
        if len(views) < 2:
            return []
        drops, moves = plan_ec_balance(views)
        if not drops and not moves:
            return []
        try:
            return [self.submit("ec_balance", 0)]
        except ValueError:
            return []

    def scan_for_ec_scrub(self, topo, period: float) -> list[str]:
        """Fleet-coordinated scrub (reference: maintenance workers own
        hygiene, not each box): every EC volume's shards get verified
        once per `period` FLEET-WIDE — the ec_scrub task walks every
        holder of the volume, so spreading VOLUMES across the window
        spreads the I/O across holders. One submission per sweep (most
        overdue volume first), the same keep-the-plane-convergent rule
        as the balance scanners; with a tick interval well under the
        period, volumes naturally stagger instead of stampeding."""
        now = time.time()
        with topo._lock:
            vols = {
                e.id: e.collection
                for n in topo.nodes.values()
                for e in n.ec_shards.values()
            }
        # evict state for volumes that left the topology (deleted /
        # decoded back to a normal volume): a stale report would hold
        # the fleet gauges nonzero and list the gone volume as
        # unrebuildable forever, and the dict would grow unbounded
        with self._lock:
            gone = [v for v in self.scrub_reports if v not in vols]
            for v in gone:
                del self.scrub_reports[v]
            for v in [v for v in self._scrub_watch if v not in vols]:
                del self._scrub_watch[v]
            reports = list(self.scrub_reports.values())
        if gone:
            self._update_fleet_gauges(reports)
        due = [
            vid
            for vid in vols
            if now - self._scrub_watch.get(vid, 0.0) >= period
        ]
        if not due:
            return []
        due.sort(key=lambda v: (self._scrub_watch.get(v, 0.0), v))
        vid = due[0]
        try:
            tid = self.submit("ec_scrub", vid, vols[vid])
        except ValueError:
            return []  # a live operator task for this volume
        self._scrub_watch[vid] = now
        return [tid]

    def scan_for_ec_rebalance(
        self,
        topo,
        min_heat: int | None = None,
        max_moves: int | None = None,
        min_gain: float | None = None,
    ) -> list[str]:
        """Data-gravity sweep (ec/rebalance.py): rank every EC volume's
        per-holder heat (read/reconstruction byte DELTAS since the last
        sweep, heartbeat-learned) against the holder's chip-deficit and
        dispatch bounded `ec_migrate` worker tasks moving whole shard
        sets toward chip-rich low-load nodes. One planner drives the
        scanner AND the shell's dry-run so they cannot drift; the same
        keep-the-plane-convergent discipline as the other scanners
        (default one migration per sweep)."""
        from ..ec.placement import node_view_for
        from ..ec.rebalance import plan_hot_migrations, volume_heat

        with topo._lock:
            nodes = [
                (
                    f"{n.ip}:{n.grpc_port}",
                    n.rack,
                    n.data_center,
                    n.max_volume_count,
                    len(n.volumes),
                    list(n.ec_shards.values()),
                    dict(n.ec_telemetry),
                )
                for n in topo.nodes.values()
            ]
        if len(nodes) < 2:
            return []
        views = []
        heat: dict[str, dict[int, int]] = {}
        shard_bytes: dict[int, int] = {}
        collections: dict[int, str] = {}
        with self._lock:
            for nid, rack, dc, maxvol, nvol, ecs, tele in nodes:
                views.append(
                    node_view_for(
                        nid, rack, dc, maxvol, nvol, ecs,
                        ec_telemetry=tele,
                    )
                )
                for e in ecs:
                    if e.shard_size:
                        shard_bytes[e.id] = int(e.shard_size)
                    collections.setdefault(e.id, e.collection)
                deltas: dict[int, int] = {}
                for vid, total in volume_heat(tele).items():
                    prev = self._heat_prev.get((nid, vid))
                    self._heat_prev[(nid, vid)] = total
                    if prev is None:
                        continue  # first sighting: no window yet
                    # counter reset (volume-server restart without
                    # persisted heat): re-baseline with a ZERO window
                    # instead of crediting the full lifetime value —
                    # one restart must not read as a sudden hot spot
                    # and trigger spurious migrations. Servers that DO
                    # persist heat across restart (ec_volume .heat
                    # sidecar) never hit this branch: their counters
                    # resume monotonically.
                    deltas[vid] = total - prev if total >= prev else 0
                if deltas:
                    heat[nid] = deltas
            # evict state for (node, vid) pairs that left the topology
            live = {
                (nid, e.id)
                for nid, _r, _d, _m, _v, ecs, _t in nodes
                for e in ecs
            }
            for key in [k for k in self._heat_prev if k not in live]:
                del self._heat_prev[key]
        plans = plan_hot_migrations(
            views, heat, shard_bytes=shard_bytes,
            min_heat=min_heat, max_migrations=max_moves, min_gain=min_gain,
        )
        submitted = []
        records = []
        with self._lock:
            live_before = set(self._tasks)
        for mig in plans:
            rec = {
                "volume_id": mig.vid,
                "src": mig.src,
                "dst": mig.dst,
                "shards": list(mig.shard_ids),
                "heat": mig.heat,
                "src_gravity": round(mig.src_gravity, 3),
                "dst_gravity": round(mig.dst_gravity, 3),
                "ts": time.time(),
            }
            try:
                tid = self.submit(
                    "ec_migrate",
                    mig.vid,
                    collections.get(mig.vid, ""),
                    params={
                        "source": mig.src,
                        "target": mig.dst,
                        "shards": ",".join(str(s) for s in mig.shard_ids),
                    },
                )
            except ValueError as e:
                # a live operator task for this volume / param conflict:
                # the gravity loop must never die over a dispatch race
                _log.warning(
                    "ec_migrate dispatch for %d skipped: %s", mig.vid, e
                )
                continue
            if tid in live_before:
                # submit() deduped onto a migration already in flight
                # (one that outlives a sweep period): not a fresh
                # dispatch — counting/logging it would inflate the
                # counter and fill EcMigrations with duplicates
                continue
            _migrate_dispatch.inc()
            rec["task_id"] = tid
            records.append(rec)
            submitted.append(tid)
            _log.info(
                "dispatched ec_migrate: volume %d (%s -> %s, shards %s, "
                "heat %d B, gravity %.2f -> %.2f)",
                mig.vid, mig.src, mig.dst, list(mig.shard_ids),
                mig.heat, mig.src_gravity, mig.dst_gravity,
            )
        if records:
            with self._lock:
                self.last_migrations = (records + self.last_migrations)[:20]
        return submitted

    def _record_scrub_report(self, t: _Task, detail: str) -> None:
        """Fold one completed ec_scrub task's JSON report into the
        fleet view (master /cluster/status + Prometheus), and dispatch
        a peer-fetch rebuild for every holder the report marks
        quarantined-but-unrebuildable (< k verified-good local shards —
        the case per-server repair can never fix)."""
        try:
            doc = json.loads(detail)
        except ValueError:
            return
        holders = doc.get("holders", {})
        if not isinstance(holders, dict):
            return
        with self._lock:
            self.scrub_reports[t.volume_id] = {
                "ts": time.time(),
                "collection": t.collection,
                "holders": holders,
            }
            reports = list(self.scrub_reports.values())
        self._update_fleet_gauges(reports)
        dests = sorted(
            {
                h["grpc"]
                for h in holders.values()
                if h.get("unrebuildable") and h.get("grpc")
            }
        )
        if not dests:
            return
        try:
            # ONE task carrying every unrebuildable holder (comma-
            # separated): the worker drives them sequentially, because
            # two concurrent peer rebuilds of the same volume could
            # both regenerate a cluster-lost shard and mint duplicates
            self.submit(
                "ec_rebuild",
                t.volume_id,
                t.collection,
                params={"fromPeers": "true", "holder": ",".join(dests)},
            )
            _fleet_dispatch.inc()
            _log.info(
                "dispatched peer-fetch rebuild for ec %d on %s "
                "(unrebuildable holders)", t.volume_id, dests,
            )
        except ValueError as e:
            # duplicate live task / param conflict: the fleet loop
            # must never die over a dispatch race
            _log.warning(
                "peer-fetch dispatch for ec %d skipped: %s",
                t.volume_id, e,
            )

    @staticmethod
    def _update_fleet_gauges(reports: list[dict]) -> None:
        _fleet_volumes.set(len(reports))
        _fleet_corrupt.set(
            sum(
                len(h.get("bad", []))
                for r in reports
                for h in r["holders"].values()
            )
        )
        _fleet_missing.set(
            sum(
                len(h.get("missing", [])) + h.get("legacy_missing", 0)
                for r in reports
                for h in r["holders"].values()
            )
        )

    def scrub_summary(self) -> dict:
        """Fleet scrub health for status UIs: per-volume latest report
        plus roll-up counts."""
        with self._lock:
            reports = {
                vid: {
                    "ts": r["ts"],
                    "collection": r["collection"],
                    "holders": {
                        url: dict(h) for url, h in r["holders"].items()
                    },
                }
                for vid, r in self.scrub_reports.items()
            }
        corrupt = sum(
            len(h.get("bad", []))
            for r in reports.values()
            for h in r["holders"].values()
        )
        missing = sum(
            len(h.get("missing", [])) + h.get("legacy_missing", 0)
            for r in reports.values()
            for h in r["holders"].values()
        )
        unreb = sorted(
            {
                vid
                for vid, r in reports.items()
                if any(
                    h.get("unrebuildable") for h in r["holders"].values()
                )
            }
        )
        return {
            "volumes": len(reports),
            "corrupt_shards": corrupt,
            "missing_shards": missing,
            "unrebuildable_volumes": unreb,
            "reports": reports,
        }

    def scan_for_lifecycle(self, filer_addr: str) -> list[str]:
        """Submit the periodic lifecycle sweep against the configured
        filer (volume_id 0: the task is filer-scoped)."""
        if not filer_addr:
            return []
        try:
            return [
                self.submit(
                    "s3_lifecycle", 0, params={"filer": filer_addr}
                )
            ]
        except ValueError:
            return []
