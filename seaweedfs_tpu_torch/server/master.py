"""Master server: heartbeat sink, fid assignment, volume and EC lookup,
volume growth, cluster locks, raft HA over the volume-id allocator.

Port of seaweedfs_tpu/server/master.py (reference
weed/server/master_server.go, master_grpc_server.go:66 SendHeartbeat,
master_grpc_server_assign.go:50 Assign with growth, the HTTP /dir/assign
and /dir/lookup handlers):

- `MasterService`, the `sw.Seaweed` servicer: every RPC of the JAX table
  (pb/rpc.py MASTER_SERVICE), with the JAX answers, errors and
  leader-only rules;
- `MasterServer`: the topology, the raft node and its wiring
  (`_raft_apply`, `_raft_restore`, `_alloc_volume_id`,
  `_on_leader_change`), the gRPC server with the master and raft
  services, the HTTP plane (`/dir/assign`, `/dir/lookup`, `/metrics`,
  `/`, `/ui` with the maintenance fleet's tables, `/cluster/status` with
  the fleet scrub's `EcFleetScrub` and the gravity scanner's
  `EcMigrations`, `/dir/status`, `/debug/slo`, `/debug/pprof`), over
  HTTPS where the master is given `tls` (utils/tls.py), the worker fleet's
  control plane (`worker/control.py` `WorkerControl` on the
  `swworker.WorkerControl` service) with the live maintenance config
  (`_maintenance_config`, `_apply_maintenance_config`), the maintenance
  loop (`prune_dead`, `vacuum_once` and the scanners: auto-EC, balance,
  lifecycle, EC balance, fleet scrub, data gravity), the opt-in
  telemetry, `start`, `stop` and `wait`.

Every master scans and submits, the leader or not, as in the JAX package:
a worker streams to the leader, so a follower's tasks wait. The maintenance
config is this master's own, not replicated.

Given `dlm_filers` (filer gRPC addresses), the lease API (AdminLock,
AdminUnlock, AdminLockStatus) is a client of the filer lock ring
(filer/lock_ring.py `DlmClient`) instead of this master's own table, as
in the JAX package. `EcStreams` and `EcResidency.local` read this
process's stream and residency registries only where the port's EC
package is already loaded (a combined deployment): a master alone does
not import torch to answer a status read.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import grpc

from ..pb import cluster_pb2 as pb
from ..pb import rpc
from ..storage.file_id import FileId, new_cookie
from ..storage.ttl import TTL
from ..utils.glog import logger
from ..utils.pprof import handle_debug_endpoint
from .cluster_lock import LockManager
from .raft import RaftNode
from .topology import DataNode, Topology

log = logger("master")

# collections become file-name prefixes on volume servers: path
# separators or control characters must never reach the storage layer
_COLLECTION_RE = re.compile(r"^[A-Za-z0-9_.\-]*$")


def _loaded(name: str):
    """The port's module `name` where this process has imported it."""
    return sys.modules.get(f"{__package__.rsplit('.', 1)[0]}.{name}")


def _ec_stream_summary() -> dict:
    """Streaming-EC roll-up for /cluster/status (open encode-on-write
    streams, parity lag, lifetime counters) of this process."""
    mod = _loaded("ec.stream_encode")
    try:
        return mod.stream_summary() if mod is not None else {}
    except Exception:  # noqa: BLE001 — status must never depend on the EC stack
        return {}


def _ec_residency_summary() -> dict:
    """This process's chip residency-ledger snapshot for /cluster/status."""
    mod = _loaded("ec.device_queue")
    try:
        return mod.residency_snapshot() if mod is not None else {}
    except Exception:  # noqa: BLE001
        return {}


def _telemetry_stale_after() -> float:
    """SEAWEED_EC_TELEMETRY_STALE_S (ec/placement.py's knob, read here
    without importing the EC package)."""
    try:
        return float(os.environ.get("SEAWEED_EC_TELEMETRY_STALE_S", "30"))
    except ValueError:
        return 30.0


class MasterService:
    """gRPC servicer (method-per-RPC, see pb/rpc.py)."""

    def __init__(self, topo: Topology, jwt_key: str = "", raft=None):
        self.topo = topo
        self.jwt_key = jwt_key
        self.raft = raft  # None = a single master without raft (tests construct this)
        self._grow_lock = threading.Lock()
        self.locks = LockManager()
        # the filer lock ring's client where the master is given filers
        self.dlm = None
        # volume-id allocation goes through raft when HA is on
        self.alloc_volume_id = topo.next_volume_id

    def _not_leader(self) -> str | None:
        """None when this master may serve; otherwise the leader hint."""
        if self.raft is None or self.raft.is_leader:
            return None
        return self.raft.leader or ""

    # ------------------------------------------------------- heartbeats

    def SendHeartbeat(self, request_iterator, context):
        leader = self._not_leader()
        if leader is not None:
            # redirect: volume servers must feed the leader's topology
            yield pb.HeartbeatResponse(leader=leader)
            return
        node: DataNode | None = None
        token = object()
        try:
            for hb in request_iterator:
                if self._not_leader() is not None:
                    yield pb.HeartbeatResponse(leader=self.raft.leader or "")
                    return
                if node is None:
                    node = self.topo.register_node(hb)
                    node.owner_token = token
                    self.topo.sync_registration(node, hb)
                elif hb.volumes or hb.has_no_volumes or hb.ec_shards or hb.has_no_ec_shards:
                    self.topo.sync_registration(node, hb)
                else:
                    self.topo.incremental_update(node, hb)
                yield pb.HeartbeatResponse(volume_size_limit=self.topo.volume_size_limit)
        finally:
            # stream closed = node gone; owner_token keeps a stale stream's
            # cleanup from removing the node a newer stream re-registered
            if node is not None:
                self.topo.unregister_node(node.node_id, owner_token=token)

    # ---------------------------------------------------- keepconnected

    def KeepConnected(self, request: pb.KeepConnectedRequest, context):
        """Streaming vid-location session (reference masterclient.go:483):
        full snapshot, then deltas; a leader change tells the client to
        reconnect elsewhere."""
        leader = self._not_leader()
        if leader is not None:
            yield pb.VolumeLocationUpdate(leader=leader)
            return
        import queue as _queue

        q, snapshot = self.topo.subscribe()
        try:
            for u in snapshot:
                yield u
            if self.raft is not None:
                # snapshot-complete marker: leader == the serving master
                yield pb.VolumeLocationUpdate(leader=self.raft.node_id)
            while context is None or context.is_active():
                if q.overflowed:
                    return  # a delta was lost: end the stream, the client re-syncs
                try:
                    u = q.get(timeout=1.0)
                except _queue.Empty:
                    if self._not_leader() is not None:
                        yield pb.VolumeLocationUpdate(leader=self.raft.leader or "")
                        return
                    continue
                yield u
                if u.leader:
                    return  # stepped down: the client reconnects to the leader
        finally:
            self.topo.unsubscribe(q)

    # ------------------------------------------------------------ locks

    def AdminLock(self, request: pb.LockRequest, context) -> pb.LockResponse:
        leader = self._not_leader()
        if leader is not None:
            return pb.LockResponse(error=f"not leader; leader={leader}")
        if self.dlm is not None:
            # filer lock ring configured: the master's lease API is a
            # CLIENT of it (reference: shell/admin locks ride the cluster
            # lock_manager ring): locks survive master AND single-filer
            # failures
            try:
                r = self.dlm.lock(request.name, request.owner, request.ttl_seconds or 60.0,
                                  request.token)
            except ConnectionError as e:
                return pb.LockResponse(error=str(e))
            return pb.LockResponse(ok=r.ok, token=r.token, holder=r.holder,
                                   expires_ns=int(r.remaining * 1e9), error=r.error)
        ok, token, holder, remaining = self.locks.acquire(
            request.name, request.owner, request.ttl_seconds or 60.0, request.token)
        return pb.LockResponse(ok=ok, token=token, holder=holder, expires_ns=int(remaining * 1e9),
                               error="" if ok else f"held by {holder}")

    def AdminUnlock(self, request: pb.UnlockRequest, context) -> pb.UnlockResponse:
        leader = self._not_leader()
        if leader is not None:
            return pb.UnlockResponse(error=f"not leader; leader={leader}")
        if self.dlm is not None:
            try:
                r = self.dlm.unlock(request.name, request.token)
            except ConnectionError as e:
                return pb.UnlockResponse(error=str(e))
            return pb.UnlockResponse(ok=r.ok, error=r.error)
        ok = self.locks.release(request.name, request.token)
        return pb.UnlockResponse(ok=ok, error="" if ok else "not held by this token")

    def VacuumControl(self, request, context) -> pb.VolumeCommandResponse:
        """volume.vacuum.enable/disable: per-volume opt-out from the
        periodic garbage sweep (reference Volume.SkipVacuum)."""
        with self.topo._lock:
            if request.disable:
                self.topo.vacuum_disabled.add(request.volume_id)
            else:
                self.topo.vacuum_disabled.discard(request.volume_id)
        return pb.VolumeCommandResponse()

    def AdminLockStatus(self, request, context) -> pb.LockStatusResponse:
        # leases live on the leader only: a deposed master's table must not
        # pass for cluster state
        self._abort_if_follower(context)
        rows = self.dlm.status() if self.dlm is not None else self.locks.status()
        return pb.LockStatusResponse(locks=[
            pb.LockRow(name=n, owner=o, expires_ns=int(r * 1e9)) for n, o, r in rows])

    # ----------------------------------------------------------- assign

    def Assign(self, request: pb.AssignRequest, context) -> pb.AssignResponse:
        leader = self._not_leader()
        if leader is not None:
            return pb.AssignResponse(error=f"not leader; leader={leader}")
        count = max(int(request.count), 1)
        if not _COLLECTION_RE.match(request.collection):
            return pb.AssignResponse(error=f"invalid collection name {request.collection!r}")
        # canonical TTLs ("90" -> "90m"): volume servers report canonical
        # ones in heartbeats, and the layout buckets compare strings
        try:
            ttl = str(TTL.parse(request.ttl))
        except ValueError as e:
            return pb.AssignResponse(error=f"bad ttl: {e}")
        dt = request.disk_type
        picked = self.topo.pick_for_write(request.collection, request.replication, ttl, disk_type=dt)
        if picked is None:
            if self._grow(request.collection, request.replication, ttl, disk_type=dt):
                picked = self.topo.pick_for_write(request.collection, request.replication, ttl,
                                                  disk_type=dt)
        elif self.topo.all_crowded(request.collection, request.replication, ttl, disk_type=dt):
            # crowded-state growth: serve this assign from the crowded volume
            # and add capacity in the background (reference volume_layout.go)
            threading.Thread(target=self._grow, args=(request.collection, request.replication, ttl),
                             kwargs={"disk_type": dt}, daemon=True).start()
        if picked is None:
            return pb.AssignResponse(error="no writable volumes and growth failed")
        vid, holders = picked
        fid = FileId(vid, self.topo.next_needle_id(), new_cookie())
        token = ""
        if self.jwt_key:
            from ..utils.security import sign_jwt

            token = sign_jwt(self.jwt_key, str(fid))
        return pb.AssignResponse(fid=str(fid), count=count, location=holders[0].location(),
                                 replicas=[n.location() for n in holders[1:]], jwt=token)

    def _grow(self, collection: str, replication: str, ttl: str = "",
              disk_type: str = "") -> list[int]:
        """Allocate one new volume on planned targets (reference
        VolumeGrowth.findEmptySlotsForOneVolume + AllocateVolume RPCs)."""
        with self._grow_lock:
            targets = self.topo.plan_growth(replication)
            if not targets:
                return []
            vid = self.alloc_volume_id()
            ok = []
            for node in targets:
                try:
                    with grpc.insecure_channel(f"{node.ip}:{node.grpc_port}") as ch:
                        rpc.volume_stub(ch).AllocateVolume(pb.AllocateVolumeRequest(
                            volume_id=vid, collection=collection, replication=replication, ttl=ttl,
                            disk_type=disk_type), timeout=10)
                    ok.append(node)
                except grpc.RpcError:
                    continue
            if not ok:
                return []
            # optimistic registration; the next heartbeat confirms
            for node in ok:
                self.topo.optimistic_add_volume(node, pb.VolumeInfoMsg(
                    id=vid, collection=collection, replica_placement=replication, ttl=ttl,
                    # a typed grow must be typed in the layout too, or the
                    # re-pick that follows filters it out
                    disk_type=disk_type or "hdd"))
            return [vid]

    def VolumeGrow(self, request: pb.VolumeGrowRequest, context) -> pb.VolumeGrowResponse:
        if self._not_leader() is not None:
            return pb.VolumeGrowResponse()
        if not _COLLECTION_RE.match(request.collection):
            return pb.VolumeGrowResponse()
        try:
            ttl = str(TTL.parse(request.ttl))
        except ValueError:
            return pb.VolumeGrowResponse()
        vids = []
        for _ in range(max(int(request.count), 1)):
            vids.extend(self._grow(request.collection, request.replication, ttl))
        return pb.VolumeGrowResponse(volume_ids=vids)

    # ----------------------------------------------------------- lookup

    def LookupVolume(self, request, context) -> pb.LookupVolumeResponse:
        leader = self._not_leader()
        if leader is not None:
            # a follower's topology is not authoritative (leader-only reads,
            # reference topology.go:217)
            return pb.LookupVolumeResponse(volume_locations=[
                pb.VolumeLocations(volume_id=vid, error=f"not leader; leader={leader}")
                for vid in request.volume_ids])
        out = []
        for vid in request.volume_ids:
            locs = self.topo.lookup(vid)
            if not locs:
                # EC volumes answer plain lookups too: any shard holder
                seen = {}
                for ls in self.topo.lookup_ec(vid).values():
                    for loc in ls:
                        seen[loc.url] = loc
                locs = list(seen.values())
            out.append(pb.VolumeLocations(volume_id=vid, locations=locs,
                                          error="" if locs else f"volume {vid} not found"))
        return pb.LookupVolumeResponse(volume_locations=out)

    def LookupEcVolume(self, request, context) -> pb.LookupEcVolumeResponse:
        leader = self._not_leader()
        if leader is not None:
            return pb.LookupEcVolumeResponse(volume_id=request.volume_id,
                                             error=f"not leader; leader={leader}")
        shard_locs = self.topo.lookup_ec(request.volume_id)
        return pb.LookupEcVolumeResponse(
            volume_id=request.volume_id,
            shard_locations=[pb.EcShardLocation(shard_id=sid, locations=locs)
                             for sid, locs in sorted(shard_locs.items())],
            error="" if shard_locs else f"ec volume {request.volume_id} not found")

    def _abort_if_follower(self, context) -> None:
        """Topology reads are leader-only (reference topology.go:217): a
        follower's view is empty, not merely stale."""
        leader = self._not_leader()
        if leader is not None:
            if context is not None:
                context.abort(grpc.StatusCode.FAILED_PRECONDITION, f"not leader; leader={leader}")
            raise RuntimeError(f"not leader; leader={leader}")

    def Statistics(self, request, context) -> pb.StatisticsResponse:
        self._abort_if_follower(context)
        return self.topo.statistics()

    def Topology(self, request, context) -> pb.TopologyResponse:
        self._abort_if_follower(context)
        return self.topo.to_proto()

    def CollectionList(self, request, context) -> pb.CollectionListResponse:
        self._abort_if_follower(context)
        return pb.CollectionListResponse(collections=self.topo.collections())

    def CollectionDelete(self, request, context) -> pb.CollectionDeleteResponse:
        """Drop every volume and EC shard set of a collection cluster-wide
        (reference CollectionDelete). Partial failures are reported: a
        skipped node's volumes would come back with its next heartbeat."""
        leader = self._not_leader()
        if leader is not None:
            return pb.CollectionDeleteResponse(error=f"not leader; leader={leader}")
        if not request.name:
            return pb.CollectionDeleteResponse(error="refusing to delete the default collection")
        deleted, failures = [], []
        for vid, ip, gport in self.topo.collection_volumes(request.name):
            try:
                with grpc.insecure_channel(f"{ip}:{gport}") as ch:
                    r = rpc.volume_stub(ch).VolumeDelete(pb.VolumeCommandRequest(volume_id=vid),
                                                         timeout=60)
                if r.error:
                    failures.append(f"volume {vid}@{ip}: {r.error}")
                else:
                    deleted.append(vid)
            except grpc.RpcError as e:
                failures.append(f"volume {vid}@{ip}: {e.code().name}")
        for vid, ip, gport, sids in self.topo.collection_ec_shards(request.name):
            try:
                with grpc.insecure_channel(f"{ip}:{gport}") as ch:
                    stub = rpc.volume_stub(ch)
                    stub.VolumeEcShardsUnmount(pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=sids),
                                               timeout=60)
                    stub.VolumeEcShardsDelete(pb.EcShardsDeleteRequest(
                        volume_id=vid, collection=request.name, shard_ids=sids), timeout=60)
                deleted.append(vid)
            except grpc.RpcError as e:
                failures.append(f"ec {vid}@{ip}: {e.code().name}")
        return pb.CollectionDeleteResponse(deleted_volume_ids=sorted(set(deleted)),
                                           error="; ".join(failures))


class MasterServer:
    """gRPC + HTTP front for one Topology, with raft over its allocator.

    `peers`: every master of the HA group (this one included), as HTTP
    host:port addresses; raft replicates the allocation state across them
    (reference raft_hashicorp.go). Empty or None: a single master, its
    own leader at once."""

    def __init__(
        self,
        ip: str = "localhost",
        port: int = 9333,
        grpc_port: int = 0,
        volume_size_limit: int = 30 * 1024**3,
        jwt_key: str = "",
        garbage_threshold: float = 0.3,
        vacuum_interval: float = 60.0,
        peers: list[str] | str | None = None,
        meta_dir: str | None = None,
        election_timeout: tuple[float, float] = (0.4, 0.8),
        tls=None,
        telemetry_url: str = "",
        ec_auto_fullness: float = 0.0,
        ec_quiet_seconds: float = 60.0,
        ec_scrub_interval: float = 0.0,
        ec_rebalance_interval: float = 0.0,
        dlm_filers: list[str] | None = None,
    ):
        """ec_auto_fullness > 0 turns on the auto-EC scanner: a volume at
        that fraction of the size limit, its size unchanged for
        ec_quiet_seconds, gets an ec_encode task for the worker fleet.
        ec_scrub_interval > 0: every EC volume scrubbed fleet-wide once per
        that many seconds (ec_scrub tasks, one volume per tick), with a
        peer-fetch rebuild dispatched for any holder that cannot heal
        itself. ec_rebalance_interval > 0: the data-gravity scanner's
        period (ec_migrate tasks). `tls` (a utils/tls.TlsConfig) serves
        HTTPS on `port`. `dlm_filers` (filer gRPC addresses): the lease
        API rides the filer lock ring instead of this master's table."""
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port or (port + 10000)
        self.topo = Topology(volume_size_limit=volume_size_limit)
        if isinstance(peers, str):
            peers = [p.strip() for p in peers.split(",") if p.strip()]
        self.node_id = f"{ip}:{port}"
        self.raft = RaftNode(
            node_id=self.node_id,
            peers=list(peers or []),
            state_dir=meta_dir,
            apply_fn=self._raft_apply,
            election_timeout=election_timeout,
            snapshot_fn=lambda: {"max_volume_id": self.topo.max_volume_id},
            restore_fn=self._raft_restore,
        )
        self.raft.on_leader_change = self._on_leader_change
        self.service = MasterService(self.topo, jwt_key=jwt_key, raft=self.raft)
        if dlm_filers:
            from ..filer.lock_ring import DlmClient

            self.service.dlm = DlmClient(list(dlm_filers))
        self.service.alloc_volume_id = self._alloc_volume_id
        self.garbage_threshold = garbage_threshold
        self.vacuum_interval = vacuum_interval
        self.ec_auto_fullness = ec_auto_fullness
        self.ec_quiet_seconds = ec_quiet_seconds
        # the scanners' periods and switches, re-read every maintenance
        # tick (0 = off), so a live SetMaintenanceConfig needs no restart
        self.ec_scrub_interval = ec_scrub_interval
        self.ec_rebalance_interval = ec_rebalance_interval
        self._ec_rebalance_last = 0.0
        self.balance_spread = 0.0
        self.lifecycle_interval = 0.0
        self.lifecycle_filer = ""
        self._lifecycle_last = 0.0
        self.ec_balance_interval = 0.0
        self._ec_balance_last = 0.0
        self._vacuum_stop = threading.Event()
        self._vacuum_thread = threading.Thread(target=self._vacuum_loop, daemon=True)

        from ..worker.control import WorkerControl

        self.worker_control = WorkerControl(
            topo=self.topo,
            config_get=self._maintenance_config,
            config_set=self._apply_maintenance_config,
        )
        self._grpc = grpc.server(futures.ThreadPoolExecutor(max_workers=32))
        rpc.add_service(self._grpc, rpc.MASTER_SERVICE, self.service)
        rpc.add_service(self._grpc, rpc.WORKER_SERVICE, self.worker_control)
        rpc.add_service(self._grpc, rpc.RAFT_SERVICE, self.raft)
        self._grpc.add_insecure_port(f"{ip}:{self.grpc_port}")

        self._http = ThreadingHTTPServer((ip, port), self._handler_class())
        self.tls = tls
        if tls is not None:
            tls.wrap_server(self._http)
        self._http_thread = threading.Thread(target=self._http.serve_forever, daemon=True)

        # opt-in phone-home (reference weed/telemetry/collector.go:14):
        # leader-only aggregate counts, never names or data
        from ..utils.telemetry import TelemetryCollector

        def _tele_stats() -> dict:
            st = self.topo.statistics()
            return {"volume_count": st.volume_count, "ec_volume_count": st.ec_volume_count,
                    "server_count": st.node_count, "used_size": st.used_size,
                    "file_count": st.file_count}

        self.telemetry = TelemetryCollector(telemetry_url, _tele_stats,
                                            is_leader_fn=lambda: self.raft.is_leader)

    # --------------------------------------------------------------- ha

    def _raft_apply(self, kind: str, value: int) -> int:
        if kind == "alloc_volume_id":
            return self.topo.apply_allocated_volume_id(value)
        return 0

    def _raft_restore(self, state: dict) -> None:
        """Reload the snapshot state machine (log compaction,
        InstallSnapshot): the allocator never goes backwards."""
        self.topo.max_volume_id = max(self.topo.max_volume_id, int(state.get("max_volume_id", 0)))

    def _alloc_volume_id(self) -> int:
        """Volume ids are allocated through the replicated log, so a
        failed-over leader never hands one out again."""
        return self.raft.propose("alloc_volume_id", self.topo.max_volume_id)

    def _on_leader_change(self, leader: str) -> None:
        self.topo.publish_leader(leader)

    @property
    def is_leader(self) -> bool:
        return self.raft.is_leader

    # ------------------------------------------------------------- http

    def cluster_status(self) -> dict:
        """/cluster/status and /dir/status: the topology's nodes and the
        heartbeat-learned device telemetry per node, with its age and
        whether the stale gate (SEAWEED_EC_TELEMETRY_STALE_S) has stopped
        it from steering placement."""
        topo = self.topo.to_proto()
        stale_after = _telemetry_stale_after()
        now = time.time()
        tele = {}
        for node in list(self.topo.nodes.values()):
            if not node.ec_telemetry:
                continue
            blob = dict(node.ec_telemetry)
            stamped = blob.get("received_at") or blob.get("ts")
            try:
                age = max(now - float(stamped), 0.0)
            except (TypeError, ValueError):
                age = -1.0
            blob["age_s"] = round(age, 1)
            blob["stale"] = bool(age > stale_after >= 0)
            tele[node.node_id] = blob
        return {
            "IsLeader": True,
            "MaxVolumeId": topo.max_volume_id,
            "DataNodes": [{"id": n.id, "volumes": len(n.volumes), "ecShards": len(n.ec_shards)}
                          for n in topo.nodes],
            "EcTelemetry": tele,
            # fleet scrub health: per-holder bitrot and quarantine from the
            # ec_scrub task reports (worker/control.py)
            "EcFleetScrub": self.worker_control.scrub_summary(),
            # the gravity scanner's latest ec_migrate dispatches
            "EcMigrations": self.worker_control.last_migrations,
            "EcStreams": _ec_stream_summary(),
            "EcResidency": {
                "local": _ec_residency_summary(),
                "nodes": {nid: blob.get("residency") for nid, blob in tele.items()
                          if blob.get("residency")},
            },
        }

    def _handler_class(self):
        master = self

        from ..utils.request_id import RequestTracingMixin

        class Handler(RequestTracingMixin, BaseHTTPRequestHandler):
            trace_server_kind = "master"

            def log_message(self, *a):
                pass

            def _json(self, code: int, obj: dict) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                if handle_debug_endpoint(self, u):
                    return
                if self.serve_slo_endpoint(u.path):
                    return
                if u.path == "/dir/assign":
                    resp = master.service.Assign(pb.AssignRequest(
                        count=int(q.get("count", ["1"])[0]),
                        collection=q.get("collection", [""])[0],
                        replication=q.get("replication", [""])[0],
                        ttl=q.get("ttl", [""])[0],
                        disk_type=q.get("disk", [""])[0]), None)
                    if resp.error:
                        self._json(500, {"error": resp.error})
                    else:
                        out = {"fid": resp.fid, "count": resp.count, "url": resp.location.url,
                               "publicUrl": resp.location.public_url}
                        if resp.jwt:
                            out["auth"] = resp.jwt
                        self._json(200, out)
                elif u.path == "/dir/lookup":
                    vid = int(q.get("volumeId", ["0"])[0].split(",")[0])
                    vl = master.service.LookupVolume(
                        pb.LookupVolumeRequest(volume_ids=[vid]), None).volume_locations[0]
                    if vl.error:
                        self._json(404, {"error": vl.error})
                    else:
                        self._json(200, {"volumeId": str(vid), "locations": [
                            {"url": loc.url, "publicUrl": loc.public_url} for loc in vl.locations]})
                elif u.path == "/metrics":
                    from ..utils.metrics import REGISTRY

                    body = REGISTRY.render()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path in ("/", "/ui"):
                    self._ui()
                elif u.path in ("/cluster/status", "/dir/status"):
                    self._json(200, master.cluster_status())
                else:
                    self._json(404, {"error": "not found"})

            def _ui(self):
                """Minimal status page (reference weed/admin dash, server
                rendered). Every interpolated string is escaped: collection,
                replication and ttl arrive from clients."""
                import html as _html

                esc = _html.escape
                topo = master.topo.to_proto()
                stats = master.topo.statistics()
                rows = []
                for n in topo.nodes:
                    vols = "".join(
                        f"<tr><td>{v.id}</td><td>{esc(v.collection) or '-'}</td>"
                        f"<td>{v.size:,}</td><td>{v.file_count}</td>"
                        f"<td>{v.deleted_count}</td>"
                        f"<td>{'RO' if v.read_only else 'RW'}</td>"
                        f"<td>{esc(v.replica_placement)}</td><td>{esc(v.ttl) or '-'}</td></tr>"
                        for v in sorted(n.volumes, key=lambda v: v.id))
                    ecs = "".join(
                        f"<tr><td>ec {e.id}</td><td>{esc(e.collection) or '-'}</td>"
                        f"<td colspan=2>shards {[i for i in range(32) if e.shard_bits & (1 << i)]}</td>"
                        f"<td colspan=4>{e.data_shards}+{e.parity_shards} gen {e.generation}</td></tr>"
                        for e in sorted(n.ec_shards, key=lambda e: e.id))
                    rows.append(
                        f"<h3>{esc(n.id)} <small>rack={esc(n.rack) or '-'} dc={esc(n.data_center) or '-'}"
                        f" slots={n.max_volume_count}</small></h3>"
                        f"<table border=1 cellpadding=4 cellspacing=0>"
                        f"<tr><th>vol</th><th>coll</th><th>size</th><th>files</th>"
                        f"<th>del</th><th>mode</th><th>rp</th><th>ttl</th></tr>"
                        f"{vols}{ecs}</table>")
                # the maintenance fleet's tables, from the public snapshot
                worker_rows, task_rows = master.worker_control.snapshot()
                workers = [
                    f"<tr><td>{esc(w['worker_id'])}</td>"
                    f"<td>{esc(','.join(w['capabilities']))}</td>"
                    f"<td>{esc(w['backend'])}</td>"
                    f"<td>{w['active']}/{w['max_concurrent']}</td></tr>"
                    for w in worker_rows]
                tasks = [
                    f"<tr><td>{esc(t['task_id'])}</td><td>{esc(t['kind'])}</td>"
                    f"<td>{t['volume_id']}</td><td>{esc(t['state'])}</td>"
                    f"<td>{t['progress']:.0%}</td>"
                    f"<td>{esc(t['worker_id']) or '-'}</td>"
                    f"<td>{esc(t['error']) or '-'}</td></tr>"
                    for t in sorted(task_rows, key=lambda t: -t["created"])[:50]]
                fleet = (
                    "<h2>maintenance fleet</h2>"
                    "<table border=1 cellpadding=4 cellspacing=0>"
                    "<tr><th>worker</th><th>capabilities</th><th>backend</th>"
                    "<th>active</th></tr>"
                    + ("".join(workers) or "<tr><td colspan=4>no workers</td></tr>")
                    + "</table><br>"
                    "<table border=1 cellpadding=4 cellspacing=0>"
                    "<tr><th>task</th><th>kind</th><th>vol</th><th>state</th>"
                    "<th>progress</th><th>worker</th><th>error</th></tr>"
                    + ("".join(tasks) or "<tr><td colspan=7>no tasks</td></tr>")
                    + "</table>")
                body = (
                    "<html><head><title>seaweed-tpu master</title></head><body>"
                    f"<h1>seaweed-tpu cluster</h1>"
                    f"<p>nodes: {stats.node_count} &middot; volumes: "
                    f"{stats.volume_count} &middot; ec volumes: {stats.ec_volume_count}"
                    f" &middot; files: {stats.file_count} &middot; used: "
                    f"{stats.used_size:,} bytes &middot; max volume id: "
                    f"{topo.max_volume_id}</p>"
                    + "".join(rows)
                    + fleet
                    + "</body></html>").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_POST = do_GET

        return Handler

    # ------------------------------------------------- maintenance config

    def _maintenance_config(self) -> dict:
        return {
            "ec_auto_fullness": self.ec_auto_fullness,
            "ec_quiet_seconds": self.ec_quiet_seconds,
            "garbage_threshold": self.garbage_threshold,
            "vacuum_interval_seconds": self.vacuum_interval,
            "balance_spread": self.balance_spread,
            "lifecycle_interval_seconds": self.lifecycle_interval,
            "lifecycle_filer": self.lifecycle_filer,
            "ec_balance_interval_seconds": self.ec_balance_interval,
            "ec_scrub_interval_seconds": self.ec_scrub_interval,
            "ec_rebalance_interval_seconds": self.ec_rebalance_interval,
        }

    def _apply_maintenance_config(self, cfg: dict) -> None:
        """Apply a tuned policy live: the loop re-reads every knob each
        tick. A value out of range fails the whole update: a half-applied
        policy is worse than none."""
        import math

        # isfinite first: NaN passes every comparison-based range check
        # ('quiet < 0' is False for NaN), and a NaN vacuum interval turns
        # _vacuum_loop into a busy spin
        for key in ("ec_auto_fullness", "ec_quiet_seconds", "garbage_threshold",
                    "vacuum_interval_seconds", "balance_spread", "lifecycle_interval_seconds",
                    "ec_balance_interval_seconds", "ec_scrub_interval_seconds",
                    "ec_rebalance_interval_seconds"):
            if not math.isfinite(cfg.get(key, 0.0)):
                raise ValueError(f"{key} must be finite, got {cfg.get(key)}")
        full = cfg.get("ec_auto_fullness", 0.0)
        if not (0.0 <= full <= 1.0):
            raise ValueError(f"ec_auto_fullness must be in [0,1], got {full}")
        thresh = cfg.get("garbage_threshold", 0.0)
        if not (0.0 < thresh <= 1.0):
            raise ValueError(f"garbage_threshold must be in (0,1], got {thresh}")
        quiet = cfg.get("ec_quiet_seconds", 0.0)
        interval = cfg.get("vacuum_interval_seconds", 0.0)
        if quiet < 0 or interval <= 0:
            raise ValueError("ec_quiet_seconds must be >=0 and "
                             f"vacuum_interval_seconds >0 (got {quiet}, {interval})")
        spread = cfg.get("balance_spread", 0.0)
        lc_interval = cfg.get("lifecycle_interval_seconds", 0.0)
        ecb_interval = cfg.get("ec_balance_interval_seconds", 0.0)
        scrub_interval = cfg.get("ec_scrub_interval_seconds", 0.0)
        rebal_interval = cfg.get("ec_rebalance_interval_seconds", 0.0)
        if (spread < 0 or lc_interval < 0 or ecb_interval < 0 or scrub_interval < 0
                or rebal_interval < 0):
            raise ValueError(
                "balance_spread, lifecycle_interval_seconds, "
                "ec_balance_interval_seconds, ec_scrub_interval_seconds "
                "and ec_rebalance_interval_seconds "
                f"must be >=0 (got {spread}, {lc_interval}, "
                f"{ecb_interval}, {scrub_interval}, {rebal_interval})")
        self.ec_auto_fullness = full
        self.ec_quiet_seconds = quiet
        self.garbage_threshold = thresh
        self.vacuum_interval = interval
        self.balance_spread = spread
        self.lifecycle_interval = lc_interval
        self.lifecycle_filer = str(cfg.get("lifecycle_filer", "") or "")
        self.ec_balance_interval = ecb_interval
        self.ec_scrub_interval = scrub_interval
        self.ec_rebalance_interval = rebal_interval

    # ----------------------------------------------------------- vacuum

    def _vacuum_loop(self) -> None:
        """Periodic garbage sweep (reference topology_vacuum.go): every
        holder of a garbage-heavy volume compacts it. Also the dead-node
        sweeper for heartbeat streams that hang without breaking, and the
        tick of every maintenance scanner (worker/control.py): a live
        config change takes effect after the wait under way."""
        wc = self.worker_control
        while not self._vacuum_stop.wait(self.vacuum_interval):
            # one bad tick must not kill the thread that is the garbage
            # sweep, the dead-node pruner and every scanner's clock
            try:
                self.topo.prune_dead()
                self.vacuum_once()
                if self.ec_auto_fullness > 0:
                    wc.scan_for_ec_candidates(self.topo, self.ec_auto_fullness,
                                              self.topo.volume_size_limit,
                                              quiet_seconds=self.ec_quiet_seconds)
                if self.balance_spread > 0:
                    wc.scan_for_balance_candidates(self.topo, int(self.balance_spread))
                if self.lifecycle_interval > 0 and self.lifecycle_filer:
                    now = time.time()
                    if now - self._lifecycle_last >= self.lifecycle_interval:
                        self._lifecycle_last = now
                        wc.scan_for_lifecycle(self.lifecycle_filer)
                if self.ec_balance_interval > 0:
                    now = time.time()
                    if now - self._ec_balance_last >= self.ec_balance_interval:
                        self._ec_balance_last = now
                        wc.scan_for_ec_balance(self.topo)
                if self.ec_scrub_interval > 0:
                    # per-volume due-ness lives in the scanner: a call per
                    # tick staggers volumes across the period
                    wc.scan_for_ec_scrub(self.topo, self.ec_scrub_interval)
                if self.ec_rebalance_interval > 0:
                    now = time.time()
                    if now - self._ec_rebalance_last >= self.ec_rebalance_interval:
                        self._ec_rebalance_last = now
                        wc.scan_for_ec_rebalance(self.topo)
            except Exception as e:  # noqa: BLE001
                log.error("maintenance tick failed (%s: %s); loop continues", type(e).__name__, e)

    def vacuum_once(self) -> list[int]:
        vacuumed = []
        for vid, ip, gport in self.topo.garbage_candidates(self.garbage_threshold):
            try:
                with grpc.insecure_channel(f"{ip}:{gport}") as ch:
                    rpc.volume_stub(ch).VacuumVolume(pb.VacuumRequest(
                        volume_id=vid, garbage_threshold=self.garbage_threshold), timeout=3600)
                vacuumed.append(vid)
            except grpc.RpcError:
                continue
        return vacuumed

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._grpc.start()
        self.raft.start()
        self._http_thread.start()
        self._vacuum_thread.start()
        self.telemetry.start()

    def stop(self) -> None:
        self.telemetry.stop()
        self.worker_control.stop()
        if self.service.dlm is not None:
            self.service.dlm.close()
        self.raft.stop()
        self._vacuum_stop.set()
        self._grpc.stop(grace=0.5)
        self._http.shutdown()
        self._http.server_close()

    def wait(self) -> None:
        self._grpc.wait_for_termination()
