"""Client-side master session: volume and EC shard lookups with a
streaming vid map.

Port of seaweedfs_tpu/client/master_client.py (reference weed/wdclient: MasterClient
.KeepConnectedToMaster, masterclient.go:483, feeds a vidMap, vid_map.go:35,
with location deltas so lookups are local; leader redirect,
masterclient.go:223, re-homes the session when masters fail over):

- the channels and leader resolution over `RaftStatus`, and the retried
  leader call (`utils/retry.py`);
- the `KeepConnected` session and `_apply_update`;
- `assign`, `grow`, `lookup`, `lookup_ec`, `topology`, `statistics`,
  `raft_status`, `collections`, `collection_delete`, the cluster locks
  (`lock`, `unlock`, `lock_status`; a held lock raises `LockHeldError`
  naming its holder) and `close`;
- `grpc_addr`, the master's gRPC address, which the heartbeat stream
  dials too, and the client's `grpc_addr`, the leader's as far as the
  client knows, and `volume_channel`, a channel to a volume server's gRPC
  port from its master-listed location.

Unary lookups stay the fallback while the stream (re)connects, and serve
EC shard-level locations (the stream carries vid-level EC presence only).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass

import grpc

from ..pb import cluster_pb2 as pb
from ..pb import rpc
from ..utils.retry import RetryError, RetryPolicy, retry_call

_CACHE_TTL = 10.0

# Leader chasing: quick retries with mild backoff, so a persistent
# partition is not hammered at a fixed cadence.
_LEADER_POLICY = RetryPolicy(max_attempts=4, base_delay=0.05, max_delay=0.5, multiplier=2.0,
                             jitter=0.2)


@dataclass
class AssignResult:
    fid: str
    url: str
    public_url: str
    grpc_port: int
    replicas: list
    jwt: str = ""


def grpc_addr(master: str) -> str:
    """A master's gRPC address: its HTTP port + 10000."""
    host, _, port = master.partition(":")
    return f"{host}:{int(port) + 10000}"


class NotLeaderError(Exception):
    pass


class LockHeldError(Exception):
    def __init__(self, name: str, holder: str):
        super().__init__(f"cluster lock {name!r} is held by {holder}")
        self.name = name
        self.holder = holder


class MasterClient:
    def __init__(self, master: str = "localhost:9333"):
        """`master` may be a comma-separated HA group
        ("h1:9333,h2:9334,..."): HTTP addresses, the gRPC port is +10000."""
        self.masters = [m.strip() for m in master.split(",") if m.strip()]
        self.http_addr = self.masters[0]
        self._lock = threading.Lock()
        self._channels: dict[str, grpc.Channel] = {}
        self._leader = self.masters[0]
        # unary fallback caches (TTL'd)
        self._vid_cache: dict[int, tuple[float, list[pb.Location]]] = {}
        self._ec_cache: dict[int, tuple[float, dict[int, list[pb.Location]]]] = {}
        # stream-fed vid map: authoritative while the session is synced
        self._vidmap: dict[int, dict[str, pb.Location]] = {}
        self._ec_present: dict[int, set[str]] = {}
        self._by_url: dict[str, set[int]] = {}
        self._session_thread: threading.Thread | None = None
        self._synced = threading.Event()
        self._stop = threading.Event()

    @property
    def grpc_addr(self) -> str:
        """The gRPC address of the master this client takes for the leader
        (the shell's `task.*` and the worker's stream dial it)."""
        return grpc_addr(self._leader)

    # ------------------------------------------------------ connections

    def _channel(self, master: str) -> grpc.Channel:
        with self._lock:
            ch = self._channels.get(master)
            if ch is None:
                ch = grpc.insecure_channel(grpc_addr(master))
                self._channels[master] = ch
            return ch

    def _raft_status(self, master: str) -> pb.RaftStatusResponse | None:
        try:
            return rpc.Stub(self._channel(master), rpc.RAFT_SERVICE).RaftStatus(
                pb.RaftStatusRequest(), timeout=2
            )
        except grpc.RpcError:
            return None

    def _resolve_leader(self, skip: str | None = None) -> str:
        hint: str | None = None
        for m in self.masters:
            if m == skip and len(self.masters) > 1:
                continue
            st = self._raft_status(m)
            if st is None:
                continue
            if st.role == "leader":
                self._leader = m
                return m
            if st.leader and hint is None:
                hint = st.leader
        # a follower's hint may name a dead ex-leader: trust it only if
        # that node itself claims leadership
        if hint and hint != skip:
            st = self._raft_status(hint)
            if st is not None and st.role == "leader":
                self._leader = hint
                return hint
        return self._leader

    def _note_leader_hint(self, error: str) -> bool:
        """Follow a 'not leader; leader=X' answer, else re-resolve; True
        (the next attempt goes to the new choice), as the JAX client."""
        if "leader=" in error:
            hint = error.split("leader=", 1)[1].strip()
            if hint:
                self._leader = hint
                return True
        self._resolve_leader(skip=self._leader)
        return True

    def _leader_stub(self):
        return rpc.master_stub(self._channel(self._leader))

    def _with_leader(self, call):
        """Run `call(stub)`; on a transport failure or a not-leader answer,
        re-resolve the leader and retry under `_LEADER_POLICY`."""
        policy = _LEADER_POLICY

        def on_retry(e: BaseException, attempt: int) -> None:
            # a not-leader answer carries a redirect hint; a transport
            # error means the node itself is sick and is skipped
            if isinstance(e, NotLeaderError):
                self._note_leader_hint(str(e))
            else:
                self._resolve_leader(skip=self._leader)

        try:
            return retry_call(
                lambda: call(self._leader_stub()),
                policy,
                retry_on=(NotLeaderError, grpc.RpcError),
                on_retry=on_retry,
                describe="master RPC",
            )
        except RetryError as e:
            # recover once more after the last failure too, so the next
            # call does not start at a leader already known dead; callers
            # see the underlying grpc or leader error
            on_retry(e.__cause__, policy.max_attempts)
            raise e.__cause__ from None

    # ---------------------------------------------------- keepconnected

    def _ensure_session(self) -> None:
        if self._session_thread is not None:
            return
        with self._lock:
            if self._session_thread is not None or self._stop.is_set():
                return
            self._session_thread = threading.Thread(target=self._session_loop, daemon=True)
            self._session_thread.start()

    def _session_loop(self) -> None:
        client_id = f"wdclient-{uuid.uuid4().hex[:8]}"
        while not self._stop.is_set():
            target = self._leader
            try:
                stream = rpc.master_stub(self._channel(target)).KeepConnected(
                    pb.KeepConnectedRequest(client_id=client_id), timeout=None
                )
                with self._lock:
                    self._vidmap.clear()
                    self._ec_present.clear()
                    self._by_url.clear()
                for u in stream:
                    if self._stop.is_set():
                        return
                    if u.leader:
                        if u.leader == target:
                            # the leader's snapshot-complete marker
                            self._synced.set()
                            continue
                        self._synced.clear()
                        self._leader = u.leader
                        break
                    self._apply_update(u)
                else:
                    # the stream ended without a redirect: re-resolve
                    self._synced.clear()
                    self._resolve_leader(skip=target)
            except (grpc.RpcError, ValueError):
                # ValueError: "cannot invoke RPC on closed channel" during
                # close(); RpcError: a broken stream
                self._synced.clear()
                if self._stop.is_set():
                    return
                self._resolve_leader(skip=target)
            if self._stop.wait(0.3):
                return

    def _apply_update(self, u: pb.VolumeLocationUpdate) -> None:
        with self._lock:
            if u.server_gone:
                for vid in self._by_url.pop(u.url, set()):
                    held = self._vidmap.get(vid)
                    if held:
                        held.pop(u.url, None)
                        if not held:
                            del self._vidmap[vid]
                    ec = self._ec_present.get(vid)
                    if ec:
                        ec.discard(u.url)
                        if not ec:
                            del self._ec_present[vid]
                return
            loc = pb.Location(url=u.url, public_url=u.public_url, grpc_port=u.grpc_port)
            held = self._by_url.setdefault(u.url, set())
            for vid in u.new_vids:
                self._vidmap.setdefault(vid, {})[u.url] = loc
                held.add(vid)
            for vid in u.deleted_vids:
                m = self._vidmap.get(vid)
                if m:
                    m.pop(u.url, None)
                    if not m:
                        del self._vidmap[vid]
                held.discard(vid)
            for vid in u.new_ec_vids:
                self._ec_present.setdefault(vid, set()).add(u.url)
                held.add(vid)
            for vid in u.deleted_ec_vids:
                ec = self._ec_present.get(vid)
                if ec:
                    ec.discard(u.url)
                    if not ec:
                        del self._ec_present[vid]

    # ------------------------------------------------------------ assign

    def assign(self, count: int = 1, collection: str = "", replication: str = "", ttl: str = "",
               disk_type: str = "") -> AssignResult:
        self._ensure_session()

        def call(stub):
            resp = stub.Assign(pb.AssignRequest(count=count, collection=collection,
                                                replication=replication, ttl=ttl,
                                                disk_type=disk_type), timeout=30)
            if resp.error:
                if resp.error.startswith("not leader"):
                    raise NotLeaderError(resp.error)
                raise RuntimeError(f"assign: {resp.error}")
            return resp

        resp = self._with_leader(call)
        return AssignResult(fid=resp.fid, url=resp.location.url,
                            public_url=resp.location.public_url,
                            grpc_port=resp.location.grpc_port, replicas=list(resp.replicas),
                            jwt=resp.jwt)

    # ------------------------------------------------------------ lookup

    def lookup(self, vid: int, refresh: bool = False) -> list[pb.Location]:
        self._ensure_session()
        if self._synced.is_set() and not refresh:
            with self._lock:
                held = self._vidmap.get(vid)
                if held:
                    return list(held.values())
            # fall through: a just-grown volume's delta may not have
            # arrived yet; ask the master
        now = time.time()
        with self._lock:
            hit = self._vid_cache.get(vid)
            if hit and not refresh and now - hit[0] < _CACHE_TTL:
                return hit[1]

        def call(stub):
            resp = stub.LookupVolume(pb.LookupVolumeRequest(volume_ids=[vid]), timeout=30)
            vl = resp.volume_locations[0]
            if vl.error:
                if vl.error.startswith("not leader"):
                    raise NotLeaderError(vl.error)
                raise LookupError(vl.error)
            return list(vl.locations)

        locs = self._with_leader(call)
        with self._lock:
            self._vid_cache[vid] = (now, locs)
        return locs

    def lookup_ec(self, vid: int, refresh: bool = False) -> dict[int, list[pb.Location]]:
        now = time.time()
        with self._lock:
            hit = self._ec_cache.get(vid)
            if hit and not refresh and now - hit[0] < _CACHE_TTL:
                return hit[1]

        def call(stub):
            resp = stub.LookupEcVolume(pb.LookupEcVolumeRequest(volume_id=vid), timeout=30)
            if resp.error:
                if resp.error.startswith("not leader"):
                    raise NotLeaderError(resp.error)
                raise LookupError(resp.error)
            return {sl.shard_id: list(sl.locations) for sl in resp.shard_locations}

        out = self._with_leader(call)
        with self._lock:
            self._ec_cache[vid] = (now, out)
        return out

    # ------------------------------------------------------------- misc

    def topology(self) -> pb.TopologyResponse:
        return self._with_leader(lambda s: s.Topology(pb.TopologyRequest(), timeout=30))

    def statistics(self) -> pb.StatisticsResponse:
        return self._with_leader(lambda s: s.Statistics(pb.StatisticsRequest(), timeout=30))

    def raft_status(self) -> pb.RaftStatusResponse:
        """Status of the master this client takes for the leader."""
        return rpc.Stub(self._channel(self._leader), rpc.RAFT_SERVICE).RaftStatus(
            pb.RaftStatusRequest(), timeout=5)

    def grow(self, count: int = 1, collection: str = "", replication: str = "") -> list[int]:
        resp = self._with_leader(lambda s: s.VolumeGrow(pb.VolumeGrowRequest(
            count=count, collection=collection, replication=replication), timeout=60))
        return list(resp.volume_ids)

    def collections(self) -> list[str]:
        return list(self._with_leader(
            lambda s: s.CollectionList(pb.CollectionListRequest(), timeout=30)).collections)

    def collection_delete(self, name: str) -> list[int]:
        """Drop every volume of a collection (the fast bucket delete)."""

        def call(stub):
            resp = stub.CollectionDelete(pb.CollectionDeleteRequest(name=name), timeout=120)
            if resp.error.startswith("not leader"):
                raise NotLeaderError(resp.error)
            return resp

        resp = self._with_leader(call)
        if resp.error:
            raise RuntimeError(resp.error)
        return list(resp.deleted_volume_ids)

    # ------------------------------------------------------------- locks

    def lock(self, name: str, owner: str, ttl: float = 60.0, token: str = "",
             wait: float = 0.0) -> str:
        """Acquire (or renew with `token`) the named cluster lease; returns
        the token. Waits up to `wait` seconds for a busy lock, then raises
        LockHeldError."""

        def call(stub):
            resp = stub.AdminLock(pb.LockRequest(name=name, owner=owner, ttl_seconds=ttl,
                                                 token=token), timeout=10)
            if resp.error.startswith("not leader"):
                raise NotLeaderError(resp.error)
            return resp

        def attempt() -> str:
            resp = self._with_leader(call)
            if not resp.ok:
                raise LockHeldError(name, resp.holder)
            return resp.token

        if wait <= 0:
            return attempt()
        # short, nearly flat delays (a lease can free at any moment) within
        # a total budget of `wait`
        policy = RetryPolicy(max_attempts=max(2, int(wait / 0.05) + 1), base_delay=0.05,
                             max_delay=0.2, multiplier=1.5, jitter=0.2, deadline=wait)
        try:
            return retry_call(attempt, policy, retry_on=(LockHeldError,), describe=f"lock {name!r}")
        except RetryError as e:
            raise e.__cause__ from None

    def unlock(self, name: str, token: str) -> bool:
        def call(stub):
            resp = stub.AdminUnlock(pb.UnlockRequest(name=name, token=token), timeout=10)
            if resp.error.startswith("not leader"):
                raise NotLeaderError(resp.error)
            return resp

        try:
            return self._with_leader(call).ok
        except grpc.RpcError:
            return False  # the lease's expiry cleans up regardless

    def lock_status(self) -> list[tuple[str, str, float]]:
        resp = self._with_leader(lambda s: s.AdminLockStatus(pb.LockStatusRequest(), timeout=10))
        return [(r.name, r.owner, r.expires_ns / 1e9) for r in resp.locks]

    def close(self) -> None:
        self._stop.set()
        # break any blocking stream first so the session thread exits,
        # then clear the dict, or the loop could re-create channels
        with self._lock:
            for ch in self._channels.values():
                ch.close()
        t = self._session_thread
        if t is not None:
            t.join(timeout=2)
        with self._lock:
            for ch in self._channels.values():
                ch.close()
            self._channels.clear()


def volume_channel(loc: pb.Location) -> grpc.Channel:
    host = loc.url.split(":")[0]
    return grpc.insecure_channel(f"{host}:{loc.grpc_port}")
