"""Maintenance worker: connects to the master's WorkerControl stream,
registers its capabilities and task descriptors, and executes the tasks
it is assigned with progress reporting.

Port of seaweedfs_tpu/worker/worker.py (reference weed/worker: the
client.go bidi stream and the tasks/registry.go task types, and the
plugin worker's JobHandler model, plugin/worker/worker.go):

- `Worker`: the descriptors, the stream (`_messages`, `run`, `stop`),
  `_report`, `_execute` (one request id and trace root per task) and
  `_execute_task` under the per-volume (or, for a cluster-wide kind,
  per-kind) cluster lease;
- the tasks `ec_encode` (readonly -> generate -> mount -> delete the
  source, the shell's `ec.encode` pipeline over RPCs), `vacuum`,
  `balance`, `ec_balance` (the port shell's `ec.balance`), `s3_lifecycle`
  (the filer's `RunLifecycle`, where the metadata lives), `iceberg` (the
  gateway's catalog maintenance route, signed by remote storage's
  `RemoteS3Client`), `ec_scrub`
  (every holder's `ScrubEcVolume`, local repair where k good shards
  remain, the JSON report the master aggregates), `ec_rebuild`
  (`-fromPeers` for the holders the fleet scrub found unrebuildable) and
  `ec_migrate` (`ec/rebalance.drive_migration`).

The worker never touches the card itself: the volume servers' EC RPCs
launch the kernels, on the task's backend or the worker's (`cuda` by
default). Where the port differs from the JAX worker:

- `backend` takes cuda, cpu or auto and defaults to cuda (the JAX
  default is auto); another name raises ValueError;
- `run` asks the master group for its leader (`RaftStatus`) before each
  connect, so the stream reaches the master whose scanners submit; the
  JAX worker dials the first master of its group until a lease call
  re-homes its client.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid

import grpc

from ..client.master_client import MasterClient, volume_channel
from ..ec import fleet
from ..pb import cluster_pb2 as pb
from ..pb import rpc
from ..pb import worker_pb2 as wk
from ..shell.commands import BACKENDS
from ..utils import request_id as _rid
from ..utils import trace
from .control import VOLUME_INDEPENDENT_KINDS


class Worker:
    def __init__(
        self,
        master: str = "localhost:9333",
        capabilities: tuple = (
            "ec_encode", "vacuum", "balance", "s3_lifecycle", "ec_balance",
            "iceberg", "ec_scrub", "ec_rebuild", "ec_migrate",
        ),
        backend: str = "cuda",
        max_concurrent: int = 2,
        worker_id: str = "",
    ):
        if backend not in BACKENDS:
            raise ValueError(
                f"-backend {backend}: the port runs its EC on cuda, cpu or auto"
            )
        self.master_addr = master
        self.worker_id = worker_id or f"worker-{uuid.uuid4().hex[:8]}"
        self.capabilities = capabilities
        self.backend = backend
        self.max_concurrent = max_concurrent
        # declarative per-job config (reference weed/admin/plugin):
        # built-in kinds ship their tunables; plugin workers may extend
        self.descriptors: list[wk.TaskDescriptor] = [
            wk.TaskDescriptor(
                kind="ec_encode",
                display_name="Erasure encode",
                description="RS 10+4 encode a sealed volume into shards",
                fields=[
                    wk.ConfigField(
                        name="batch_mb",
                        type="int",
                        default="16",
                        help="device batch size per shard (MiB)",
                        min=1,
                        max=256,
                    )
                ],
            ),
            wk.TaskDescriptor(
                kind="vacuum",
                display_name="Vacuum",
                description="compact a volume, dropping deleted needles",
                fields=[
                    wk.ConfigField(
                        name="garbage_threshold",
                        type="float",
                        default="0",
                        help="minimum reclaimable fraction "
                        "(0 = always compact, the historical behavior)",
                        min=0.0,
                        max=1.0,
                    )
                ],
            ),
            wk.TaskDescriptor(
                kind="balance",
                display_name="Volume balance",
                description="move one volume replica between nodes "
                "(readonly -> copy -> delete at source)",
                fields=[
                    wk.ConfigField(
                        name="source",
                        type="string",
                        default="",
                        help="grpc host:port of the replica to move",
                    ),
                    wk.ConfigField(
                        name="target",
                        type="string",
                        default="",
                        help="grpc host:port of the receiving node",
                    ),
                ],
            ),
            wk.TaskDescriptor(
                kind="ec_balance",
                display_name="EC shard balance",
                description="dedupe + rack-aware spread of EC shards "
                "(runs the shell planner/executor)",
                fields=[
                    wk.ConfigField(
                        name="collection",
                        type="string",
                        default="",
                        help="restrict to one collection (empty = all)",
                    ),
                ],
            ),
            wk.TaskDescriptor(
                kind="ec_scrub",
                display_name="Fleet EC scrub",
                description="verify one EC volume's shards against the "
                ".ecsum sidecar on EVERY holder; repair locally where "
                "possible, report unrebuildable holders to the master",
                fields=[
                    wk.ConfigField(
                        name="repair",
                        type="bool",
                        default="true",
                        help="rebuild corrupt/missing shards on holders "
                        "that still have k verified-good local shards",
                    ),
                ],
            ),
            wk.TaskDescriptor(
                kind="ec_rebuild",
                display_name="EC rebuild",
                description="regenerate missing/corrupt EC shards on a "
                "holder; -fromPeers streams sibling shards from peer "
                "holders when the holder has fewer than k local shards",
                fields=[
                    wk.ConfigField(
                        name="fromPeers",
                        type="bool",
                        default="false",
                        help="peer-fetch rebuild (cluster self-healing)",
                    ),
                    wk.ConfigField(
                        name="holder",
                        type="string",
                        default="",
                        help="grpc host:port of the holder(s) to rebuild "
                        "on, comma-separated, driven sequentially "
                        "(empty = biggest holder, or smallest with "
                        "fromPeers)",
                    ),
                ],
            ),
            wk.TaskDescriptor(
                kind="ec_migrate",
                display_name="EC hot-volume migration",
                description="move one holder's whole EC shard set to a "
                "chip-rich low-load node (data gravity): copy over the "
                "native shard plane, verify vs .ecsum, unmount source, "
                "mount destination — never two mounted holders",
                fields=[
                    wk.ConfigField(
                        name="source",
                        type="string",
                        default="",
                        help="grpc host:port of the holder to drain",
                    ),
                    wk.ConfigField(
                        name="target",
                        type="string",
                        default="",
                        help="grpc host:port of the receiving node",
                    ),
                    wk.ConfigField(
                        name="shards",
                        type="string",
                        default="",
                        help="comma-separated shard ids to move (empty "
                        "= every shard the source currently holds)",
                    ),
                ],
            ),
            wk.TaskDescriptor(
                kind="iceberg",
                display_name="Iceberg snapshot expiry",
                description="expire old unreferenced table snapshots "
                "via the S3 gateway's catalog maintenance endpoint",
                fields=[
                    wk.ConfigField(
                        name="s3",
                        type="string",
                        default="",
                        help="host:port of the S3 gateway",
                    ),
                    wk.ConfigField(
                        name="access_key",
                        type="string",
                        default="",
                        help="Admin-capable access key",
                    ),
                    wk.ConfigField(
                        name="secret_key",
                        type="string",
                        default="",
                        help="secret for access_key",
                    ),
                    wk.ConfigField(
                        name="older_than_days",
                        type="float",
                        default="30",
                        help="expire snapshots older than this",
                        min=0.0,
                        max=36500.0,
                    ),
                    wk.ConfigField(
                        name="bucket",
                        type="string",
                        default="",
                        help="single table bucket (empty = whole catalog)",
                    ),
                ],
            ),
            wk.TaskDescriptor(
                kind="s3_lifecycle",
                display_name="S3 lifecycle sweep",
                description="apply bucket lifecycle rules (expiration, "
                "noncurrent cleanup, upload aborts) on a filer",
                fields=[
                    wk.ConfigField(
                        name="filer",
                        type="string",
                        default="",
                        help="grpc host:port of the filer to sweep",
                    ),
                    wk.ConfigField(
                        name="bucket",
                        type="string",
                        default="",
                        help="single bucket to sweep (empty = all)",
                    ),
                ],
            ),
        ]
        self._outbox: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._mc = MasterClient(master)
        self.completed: list[str] = []

    # ------------------------------------------------------------- stream

    def _messages(self):
        yield wk.WorkerMessage(
            register=wk.Register(
                worker_id=self.worker_id,
                capabilities=list(self.capabilities),
                max_concurrent=self.max_concurrent,
                backend=self.backend,
                descriptors=[
                    d for d in self.descriptors if d.kind in self.capabilities
                ],
            )
        )
        while not self._stop.is_set():
            try:
                msg = self._outbox.get(timeout=1.0)
                yield msg
            except queue.Empty:
                yield wk.WorkerMessage(heartbeat=wk.WorkerHeartbeat())

    def run(self) -> None:
        """Connect-and-serve loop; reconnects on stream loss."""
        while not self._stop.is_set():
            try:
                self._mc._resolve_leader()
                channel = grpc.insecure_channel(self._mc.grpc_addr)
                stub = rpc.Stub(channel, rpc.WORKER_SERVICE)
                for server_msg in stub.WorkerStream(self._messages()):
                    if self._stop.is_set():
                        break
                    if server_msg.WhichOneof("body") == "assign":
                        threading.Thread(
                            target=self._execute,
                            args=(server_msg.assign,),
                            daemon=True,
                        ).start()
                channel.close()
            except grpc.RpcError:
                if self._stop.wait(1.0):
                    return

    def stop(self) -> None:
        self._stop.set()

    # -------------------------------------------------------------- tasks

    def _report(
        self,
        task_id: str,
        state: str,
        progress: float = 0.0,
        error: str = "",
        detail: str = "",
    ) -> None:
        self._outbox.put(
            wk.WorkerMessage(
                update=wk.TaskUpdate(
                    task_id=task_id, state=state, progress=progress,
                    error=error, detail=detail,
                )
            )
        )

    def _execute(self, assign: wk.TaskAssign) -> None:
        # One request id per task, seeded from the task id: every
        # holder this task drives (scrub, rebuild, mount RPCs) logs the
        # SAME id, so grepping one fleet task across servers works.
        # When the flight recorder is armed the task is the trace root
        # — a dispatched peer-fetch rebuild and every peer shard-read
        # it triggers share this trace id.
        _rid.ensure(assign.task_id or None)
        sp = trace.start(
            f"task.{assign.kind}", name=assign.task_id,
            volume=assign.volume_id, worker=self.worker_id,
        )
        try:
            with trace.activate(sp):
                self._execute_task(assign)
        finally:
            trace.finish(sp)

    def _execute_task(self, assign: wk.TaskAssign) -> None:
        self._report(assign.task_id, "running", 0.0)
        if assign.kind in VOLUME_INDEPENDENT_KINDS:
            lock_name = f"task/{assign.kind}"
        else:
            lock_name = f"volume/{assign.volume_id}"
        token = ""
        try:
            # per-volume cluster lease: a shell ec.encode on the same
            # volume (which takes the same lease) cannot interleave with
            # this task's destructive steps
            token = self._mc.lock(
                lock_name, self.worker_id, ttl=3600.0, wait=5.0
            )
            detail = ""
            if assign.kind == "ec_encode":
                self._task_ec_encode(assign)
            elif assign.kind == "vacuum":
                self._task_vacuum(assign)
            elif assign.kind == "balance":
                self._task_balance(assign)
            elif assign.kind == "s3_lifecycle":
                self._task_s3_lifecycle(assign)
            elif assign.kind == "ec_balance":
                self._task_ec_balance(assign)
            elif assign.kind == "iceberg":
                self._task_iceberg(assign)
            elif assign.kind == "ec_scrub":
                detail = self._task_ec_scrub(assign)
            elif assign.kind == "ec_rebuild":
                detail = self._task_ec_rebuild(assign)
            elif assign.kind == "ec_migrate":
                detail = self._task_ec_migrate(assign)
            else:
                raise RuntimeError(f"unknown task kind {assign.kind}")
            self._report(assign.task_id, "done", 1.0, detail=detail)
            self.completed.append(assign.task_id)
        except Exception as e:
            self._report(assign.task_id, "failed", 0.0, error=str(e))
        finally:
            if token:
                self._mc.unlock(lock_name, token)

    def _holder_stubs(self, vid: int):
        locs = self._mc.lookup(vid, refresh=True)
        if not locs:
            raise RuntimeError(f"volume {vid} has no locations")
        out = []
        for loc in locs:
            ch = volume_channel(loc)
            out.append((loc, ch, rpc.volume_stub(ch)))
        return out

    def _task_ec_encode(self, assign: wk.TaskAssign) -> None:
        vid = assign.volume_id
        holders = self._holder_stubs(vid)
        try:
            for _, _, stub in holders:
                stub.VolumeMarkReadonly(
                    pb.VolumeCommandRequest(volume_id=vid), timeout=30
                )
            self._report(assign.task_id, "running", 0.2)
            _, _, gen_stub = holders[0]
            try:
                batch_mb = int(assign.params.get("batch_mb", "") or 0)
            except ValueError:
                batch_mb = 0
            gen_stub.VolumeEcShardsGenerate(
                pb.EcShardsGenerateRequest(
                    volume_id=vid,
                    collection=assign.collection,
                    backend=assign.backend or self.backend,
                    batch_mb=batch_mb,
                ),
                timeout=3600,
                metadata=trace.grpc_metadata(),
            )
            self._report(assign.task_id, "running", 0.8)
            gen_stub.VolumeEcShardsMount(
                pb.EcShardsMountRequest(
                    volume_id=vid, collection=assign.collection
                ),
                timeout=60,
                metadata=trace.grpc_metadata(),
            )
            for _, _, stub in holders:
                stub.VolumeDelete(
                    pb.VolumeCommandRequest(volume_id=vid), timeout=60
                )
        finally:
            for _, ch, _ in holders:
                ch.close()

    def _task_balance(self, assign: wk.TaskAssign) -> None:
        """Move one replica: readonly at source -> VolumeCopy into the
        target -> delete at source (reference worker balance task /
        shell volume.move). A failed copy restores the source
        writable so the move never strands the volume."""
        vid = assign.volume_id
        source = assign.params.get("source", "")
        target = assign.params.get("target", "")
        if not source or not target:
            raise RuntimeError("balance needs source and target params")
        with grpc.insecure_channel(source) as src_ch:
            src = rpc.volume_stub(src_ch)
            src.VolumeMarkReadonly(
                pb.VolumeCommandRequest(volume_id=vid), timeout=30
            )
            self._report(assign.task_id, "running", 0.2)
            try:
                with grpc.insecure_channel(target) as dst_ch:
                    r = rpc.volume_stub(dst_ch).VolumeCopy(
                        pb.EcShardsCopyRequest(
                            volume_id=vid,
                            collection=assign.collection,
                            source_url=source,
                        ),
                        timeout=3600,
                    )
                if r.error:
                    raise RuntimeError(f"copy failed: {r.error}")
            except Exception:
                src.VolumeMarkWritable(
                    pb.VolumeCommandRequest(volume_id=vid), timeout=30
                )
                raise
            self._report(assign.task_id, "running", 0.8)
            last_err: Exception | None = None
            for _attempt in range(3):
                try:
                    src.VolumeDelete(
                        pb.VolumeCommandRequest(volume_id=vid), timeout=60
                    )
                    return
                except grpc.RpcError as e:
                    last_err = e
                    time.sleep(1.0)
            # copy landed but the source copy survives (readonly, so no
            # divergence) — fail LOUDLY so an operator finishes the move
            raise RuntimeError(
                f"balance: volume {vid} copied to {target} but source "
                f"delete on {source} failed after retries ({last_err}); "
                "volume is duplicated and readonly at the source"
            )

    def _task_iceberg(self, assign: wk.TaskAssign) -> None:
        """Iceberg snapshot expiry (reference worker tasks: the iceberg
        maintenance kind). The catalog lives inside the S3 gateway, so
        the task POSTs its Admin-gated /iceberg/v1/maintenance route
        with the sigv4 client the remote-storage SPI already ships."""
        import json as _json

        from ..remote.s3_client import RemoteS3Client

        s3 = assign.params.get("s3", "")
        if not s3:
            raise RuntimeError("iceberg needs an s3 (gateway host:port) param")
        try:
            days = float(assign.params.get("older_than_days", "") or 30)
        except ValueError:
            days = 30.0
        older = int(time.time() * 1000) - int(days * 86400_000)
        bucket = assign.params.get("bucket", "")
        body = {"older-than-ms": older}
        if not bucket:
            body["all-buckets"] = True
        client = RemoteS3Client(
            f"http://{s3}",
            assign.params.get("access_key", ""),
            assign.params.get("secret_key", ""),
        )
        path = (
            f"/iceberg/v1/{bucket}/maintenance"
            if bucket
            else "/iceberg/v1/maintenance"
        )
        r = client._request(
            "POST",
            path,
            payload=_json.dumps(body).encode(),
            extra_headers={"Content-Type": "application/json"},
        )
        out = r.json()
        if not isinstance(out, dict) or "tables_scanned" not in out:
            raise RuntimeError(f"unexpected maintenance response: {out!r}")

    def _task_s3_lifecycle(self, assign: wk.TaskAssign) -> None:
        """Delegate the sweep to the filer that owns the metadata."""
        from ..pb import filer_pb2 as fpb

        filer = assign.params.get("filer", "")
        if not filer:
            raise RuntimeError("s3_lifecycle needs a filer param")
        with grpc.insecure_channel(filer) as ch:
            r = rpc.filer_stub(ch).RunLifecycle(
                fpb.LifecycleRunRequest(
                    bucket=assign.params.get("bucket", "")
                ),
                timeout=3600,
            )
        if r.error:
            raise RuntimeError(r.error)

    def _task_ec_balance(self, assign: wk.TaskAssign) -> None:
        """Rack-aware EC shard rebalancing: reuses the SHELL's planner
        and executor (ec/placement.py + ec.balance) so the worker and
        the operator path cannot drift — per-volume leases are taken
        inside the command itself."""
        import re
        import shlex

        from ..shell.commands import ShellEnv, run_command

        env = ShellEnv(self.master_addr)
        try:
            # the param is caller-supplied text headed for a shlex-split
            # argparse command line: quote it AND reject non-name shapes
            # (a leading "-" would read as a flag and argparse's
            # SystemExit is not an Exception — the task would hang in
            # 'running' instead of failing). -collection on task.submit
            # arrives in assign.collection, a plugin param override wins.
            col = assign.params.get("collection", "") or assign.collection
            if col and not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.\-]*", col):
                raise RuntimeError(f"invalid collection name {col!r}")
            out = run_command(
                env,
                "ec.balance"
                + (f" -collection {shlex.quote(col)}" if col else ""),
            )
            if out.startswith("error"):
                raise RuntimeError(out)
        finally:
            env.close()

    def _task_ec_scrub(self, assign: wk.TaskAssign) -> str:
        """Fleet scrub of ONE EC volume: verify shards vs .ecsum on
        EVERY holder (the same walk the shell's ec.scrub does), repair
        in place on holders that still have k verified-good local
        shards, and report holders that do NOT — the master's control
        loop turns those into peer-fetch rebuild dispatches. Returns
        the JSON report the master aggregates (TaskUpdate.detail)."""
        vid = assign.volume_id
        shard_locs = self._mc.lookup_ec(vid, refresh=True)
        if not shard_locs:
            raise RuntimeError(f"ec volume {vid} has no holders")
        data_shards = 0
        try:
            for n in self._mc.topology().nodes:
                for e in n.ec_shards:
                    if e.id == vid and e.data_shards:
                        data_shards = e.data_shards
        except grpc.RpcError:
            pass
        if not data_shards:
            from ..ec.context import DATA_SHARDS

            data_shards = DATA_SHARDS
        repair = str(assign.params.get("repair", "true")).lower() in (
            "true", "1",
        )
        holder_sids, loc_by_url = fleet.holder_maps(shard_locs)
        holders: dict[str, dict] = {}
        for url, loc in sorted(loc_by_url.items()):
            dest = fleet.grpc_addr(loc)
            entry = {
                "grpc": dest, "checked": 0, "bad": [], "missing": [],
                "legacy_missing": 0, "quarantined": [], "rebuilt": [],
                "repaired": [], "journal_recovered": 0,
                "unrebuildable": False, "error": "",
            }
            holders[url] = entry
            with grpc.insecure_channel(dest) as ch:
                stub = rpc.volume_stub(ch)
                try:
                    r = stub.ScrubEcVolume(
                        pb.ScrubRequest(
                            volume_id=vid, collection=assign.collection
                        ),
                        timeout=3600,
                        metadata=trace.grpc_metadata(),
                    )
                except grpc.RpcError as e:
                    entry["error"] = e.code().name
                    continue
                if r.error:
                    entry["error"] = r.error
                    continue
                facts = fleet.holder_scrub_facts(
                    r, holder_sids.get(url, set()), data_shards
                )
                entry["checked"] = facts["checked"]
                # crash-recovery evidence: pending repair journals the
                # holder replayed/rolled back before this verify pass
                entry["journal_recovered"] = int(r.repair_journal_recovered)
                entry["bad"] = facts["bad"]
                entry["quarantined"] = facts["quarantined"]
                entry["missing"] = facts["missing"]
                # pre-checked_shards holders report losses only as a
                # count; carried separately so the fleet gauges still
                # see them (per-sid ids are unknowable)
                entry["legacy_missing"] = facts["legacy_gone"]
                if not facts["hurt"]:
                    continue
                if facts["unrebuildable"]:
                    # per-server repair can never fix this holder: the
                    # master dispatches a peer-fetch rebuild from the
                    # aggregated report
                    entry["unrebuildable"] = True
                    continue
                if not repair:
                    continue
                try:
                    rr = stub.VolumeEcShardsRebuild(
                        pb.EcShardsRebuildRequest(
                            volume_id=vid, collection=assign.collection
                        ),
                        timeout=3600,
                        metadata=trace.grpc_metadata(),
                    )
                    stub.VolumeEcShardsMount(
                        pb.EcShardsMountRequest(
                            volume_id=vid, collection=assign.collection
                        ),
                        timeout=60,
                        metadata=trace.grpc_metadata(),
                    )
                    entry["rebuilt"] = sorted(
                        int(x) for x in rr.rebuilt_shard_ids
                    )
                    entry["repaired"] = sorted(
                        int(x) for x in rr.repaired_shard_ids
                    )
                except grpc.RpcError as e:
                    entry["error"] = f"rebuild: {e.details()}"
        return json.dumps({"volume_id": vid, "holders": holders})

    def _task_ec_rebuild(self, assign: wk.TaskAssign) -> str:
        """Rebuild dispatcher: drive VolumeEcShardsRebuild on chosen
        holders — `fromPeers` selects the cluster-level peer-fetch path
        (the task the fleet scrub loop submits for unrebuildable
        holders); `holder` pins the server(s) (comma-separated, driven
        SEQUENTIALLY: concurrent peer rebuilds of one volume could both
        regenerate a cluster-lost shard and mint duplicates), default
        is the shell ec.rebuild heuristic (biggest holder, or the
        SMALLEST for fromPeers — the subset holder local rebuild
        refuses on)."""
        vid = assign.volume_id
        from_peers = str(assign.params.get("fromPeers", "")).lower() in (
            "true", "1",
        )
        holder = assign.params.get("holder", "")
        if not holder:
            shard_locs = self._mc.lookup_ec(vid, refresh=True)
            if not shard_locs:
                raise RuntimeError(f"ec volume {vid} has no holders")
            by_url, loc_by_url = fleet.holder_maps(shard_locs)
            url = fleet.pick_rebuild_holder(by_url, smallest=from_peers)
            loc = loc_by_url[url]
            holder = fleet.grpc_addr(loc)
        results = []
        errors = []
        for dest in [h for h in holder.split(",") if h]:
            try:
                with grpc.insecure_channel(dest) as ch:
                    stub = rpc.volume_stub(ch)
                    r = stub.VolumeEcShardsRebuild(
                        pb.EcShardsRebuildRequest(
                            volume_id=vid,
                            collection=assign.collection,
                            backend=assign.backend or self.backend,
                            from_peers=from_peers,
                        ),
                        timeout=3600,
                        metadata=trace.grpc_metadata(),
                    )
                    if not from_peers:
                        # the peer-fetch path mounts exactly the shards
                        # it owns/adopts itself; a blanket mount here
                        # would also pick up unmounted handoff copies
                        # kept after a failed distribute and advertise
                        # a duplicate holder
                        stub.VolumeEcShardsMount(
                            pb.EcShardsMountRequest(
                                volume_id=vid, collection=assign.collection
                            ),
                            timeout=60,
                            metadata=trace.grpc_metadata(),
                        )
            except grpc.RpcError as e:
                # keep driving the remaining holders: one refused/dead
                # holder must not strand the rest until the next scrub
                # period
                errors.append(f"{dest}: {e.code().name}: {e.details()}")
                continue
            results.append(
                {
                    "holder": dest,
                    "from_peers": from_peers,
                    "rebuilt": sorted(int(x) for x in r.rebuilt_shard_ids),
                    "fetched": sorted(int(x) for x in r.fetched_shard_ids),
                    "distributed": sorted(
                        int(x) for x in r.distributed_shard_ids
                    ),
                    # leaf-granular in-place repairs: healed without a
                    # whole-shard rebuild (~k·64 KiB wire per leaf)
                    "repaired": sorted(
                        int(x) for x in r.repaired_shard_ids
                    ),
                }
            )
        if errors and not results:
            raise RuntimeError("; ".join(errors))
        return json.dumps({"results": results, "errors": errors})

    def _task_ec_migrate(self, assign: wk.TaskAssign) -> str:
        """Hot-volume migration (data gravity, ec/rebalance.py): move
        the source holder's shard set of this volume to the target
        node. Runs under the volume lease the task framework already
        took, so it cannot interleave with an ec.balance of the same
        volume. Idempotent: a crash-rerun converges to exactly one
        mounted holder."""
        from ..ec.rebalance import drive_migration

        vid = assign.volume_id
        source = assign.params.get("source", "")
        target = assign.params.get("target", "")
        if not source or not target:
            raise RuntimeError("ec_migrate needs source and target params")
        shards = [
            int(s) for s in assign.params.get("shards", "").split(",") if s
        ]
        if not shards:
            # every shard the source currently advertises
            by_url, loc_by_url = fleet.holder_maps(
                self._mc.lookup_ec(vid, refresh=True)
            )
            for url, sids in by_url.items():
                if fleet.grpc_addr(loc_by_url[url]) == source:
                    shards = sorted(sids)
            if not shards:
                raise RuntimeError(
                    f"source {source} holds no shards of ec volume {vid}"
                )
        channels: dict[str, grpc.Channel] = {}

        def stub_for(addr: str):
            ch = channels.get(addr)
            if ch is None:
                ch = channels[addr] = grpc.insecure_channel(addr)
            return rpc.volume_stub(ch)

        def lookup_ec():
            located = self._mc.lookup_ec(vid, refresh=True)
            return {
                sid: [fleet.grpc_addr(l) for l in locs]
                for sid, locs in located.items()
            }

        try:
            out = drive_migration(
                vid, assign.collection, source, target, shards,
                stub_for=stub_for, lookup_ec=lookup_ec,
            )
        except grpc.RpcError as e:
            raise RuntimeError(
                f"migrate {source} -> {target}: {e.code().name}: "
                f"{e.details()}"
            ) from e
        finally:
            for ch in channels.values():
                ch.close()
        return json.dumps(out)

    def _task_vacuum(self, assign: wk.TaskAssign) -> None:
        # declarative per-job config: garbage_threshold from the
        # validated TaskAssign params. Absent = 0 = ALWAYS compact (the
        # pre-descriptor behavior; an explicitly submitted vacuum must
        # not silently become a no-op), matching the declared default.
        try:
            threshold = float(assign.params.get("garbage_threshold", "") or 0.0)
        except ValueError:
            threshold = 0.0
        for _, ch, stub in self._holder_stubs(assign.volume_id):
            try:
                stub.VacuumVolume(
                    pb.VacuumRequest(
                        volume_id=assign.volume_id,
                        garbage_threshold=threshold,
                    ),
                    timeout=3600,
                )
            finally:
                ch.close()
