"""Distributed lock ring across filers.

Port of seaweedfs_tpu/filer/lock_ring.py, whole (reference
weed/cluster/lock_manager/ and filer_pb DistributedLock): the ring names
exclusive leases across the live filers and moves them when membership
changes, so no single filer's death takes the lock service down. Both
packages speak the one verbatim filer_pb2, so a `DlmClient` of either
package drives a ring of the other.

Rendezvous (HRW) hashing assigns each lock name to the highest-scoring
LIVE filer; every filer serves the DistributedLock RPC and forwards (one
hop, loop-guarded) when it is not the owner. Lease semantics are the
master's `LockManager` (token renewal, never-shorten, TTL expiry). Two
things make locks SURVIVE membership changes:

- transfer on change: a mover thread pushes held leases whose slot
  moved (a new filer joined, or a dead one was noticed) to the new
  owner with their token and remaining TTL;
- renewal re-creation: a client renewing with its token after the
  owning filer DIED reaches the successor, which has no lease for the
  name and re-creates it under the presented token, so the holder keeps
  mutual exclusion as long as it renews within its TTL.
"""

from __future__ import annotations

import hashlib
import threading
import time

import grpc

from ..pb import filer_pb2 as fpb
from ..pb import rpc
from ..server.cluster_lock import LockManager
from ..utils.glog import logger

log = logger("dlm")


def _score(member: str, name: str) -> int:
    return int.from_bytes(hashlib.sha1(f"{member}|{name}".encode()).digest()[:8], "big")


class LockRing:
    """Membership, liveness view and request routing for one filer.

    `self_addr`/`members` are filer gRPC host:port addresses. Liveness
    is probed with cheap no-forward status RPCs; a member is dead after
    a failed probe/forward and alive again after a successful one.
    """

    # After a member dies, FRESH acquires of names it owned are denied
    # for this long: the dead filer's lease table died with it, and a
    # new owner granted immediately could coexist with the original
    # holder (who keeps renewing into the successor). Renewals with a
    # token pass: that is the survival path. Keep TTLs <= the grace.
    FAILOVER_GRACE = 15.0

    def __init__(self, self_addr: str, peers: list[str], locks: LockManager | None = None,
                 probe_interval: float = 1.0):
        # self_addr must be spelled EXACTLY as the peers list it
        # (localhost vs 127.0.0.1 vs hostname): HRW hashes the strings,
        # and a spelling mismatch silently splits the ring.
        self.self_addr = self_addr
        self.members = sorted({self_addr, *peers})
        self.locks = locks or LockManager()
        self.probe_interval = probe_interval
        self._alive: dict[str, bool] = {m: True for m in self.members}
        self._died_at: dict[str, float] = {}
        # names explicitly RELEASED here: a clean unlock proves the name
        # free, so the failover grace need not hold it
        self._released_at: dict[str, float] = {}
        self._channels: dict[str, grpc.Channel] = {}
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ routing

    def live_members(self) -> list[str]:
        with self._lock:
            return [m for m in self.members if self._alive.get(m, False)]

    def candidates(self, name: str) -> list[str]:
        """ALL members by HRW score (owner first): the serving fallback
        order when owners are unreachable."""
        return sorted(self.members, key=lambda m: _score(m, name), reverse=True)

    def owner_for(self, name: str) -> str:
        """Highest-scoring LIVE member (self counts as live)."""
        live = set(self.live_members()) | {self.self_addr}
        for m in self.candidates(name):
            if m in live:
                return m
        return self.self_addr

    def _stub(self, member: str):
        with self._lock:
            ch = self._channels.get(member)
            if ch is None:
                ch = grpc.insecure_channel(member)
                self._channels[member] = ch
        return rpc.filer_stub(ch)

    def mark(self, member: str, alive: bool) -> None:
        with self._lock:
            was = self._alive.get(member)
            self._alive[member] = alive
            if not alive and was:
                self._died_at[member] = time.monotonic()
        if was is not None and was != alive:
            log.info(f"dlm {self.self_addr}: member {member} {'alive' if alive else 'DEAD'}")

    def _in_failover_grace(self, member: str) -> bool:
        with self._lock:
            if self._alive.get(member, False):
                return False
            died = self._died_at.get(member)
        return died is None or time.monotonic() - died < self.FAILOVER_GRACE

    # ----------------------------------------------------------- serving

    def handle(self, request: fpb.DlmRequest) -> fpb.DlmResponse:
        """Serve or forward one DLM op."""
        if request.op == "status":
            return fpb.DlmResponse(ok=True, locks=[
                fpb.DlmLockRow(name=n, owner=o, remaining=r) for n, o, r in self.locks.status()])
        owner = self.owner_for(request.name)
        if owner != self.self_addr and not request.no_forward:
            # one-hop forward: LIVE candidates in HRW order first, then
            # dead ones as a last resort (a hard-down top member must not
            # cost every op a connect timeout)
            cands_all = self.candidates(request.name)
            above = cands_all[: cands_all.index(self.self_addr)]
            live = set(self.live_members())
            ordered = [c for c in above if c in live] + [c for c in above if c not in live]
            for member in ordered:
                fwd = fpb.DlmRequest()
                fwd.CopyFrom(request)
                fwd.no_forward = True
                try:
                    resp = self._stub(member).DistributedLock(fwd, timeout=5)
                    self.mark(member, True)
                    return resp
                except grpc.RpcError:
                    self.mark(member, False)
                    continue
        return self._serve_local(request)

    def _serve_local(self, request: fpb.DlmRequest) -> fpb.DlmResponse:
        op = request.op
        if op == "lock" and not request.token:
            # a FRESH acquire served as the failover successor: the dead
            # owner's lease table died with it, and granting at once could
            # seat a second owner next to a holder who is still renewing.
            # New grants wait out the grace unless the name was released
            # here (a clean unlock proves it free) or a live lease exists
            # (then "held by" is the right answer)
            top = self.candidates(request.name)[0]
            if (top != self.self_addr and self._in_failover_grace(top)
                    and request.name not in self.locks._leases  # noqa: SLF001
                    and time.monotonic() - self._released_at.get(request.name, -1e9)
                    > self.FAILOVER_GRACE):
                return fpb.DlmResponse(error=f"ring owner {top} in failover grace; retry")
        if op in ("lock", "renew", "transfer"):
            ok, token, holder, remaining = self.locks.acquire(
                request.name, request.owner, request.ttl_seconds or 60.0, request.token)
            return fpb.DlmResponse(ok=ok, token=token, holder=holder, remaining=remaining,
                                   error="" if ok else f"held by {holder}")
        if op == "unlock":
            ok = self.locks.release(request.name, request.token)
            if ok:
                self._released_at[request.name] = time.monotonic()
            return fpb.DlmResponse(ok=ok, error="" if ok else "not held by this token")
        return fpb.DlmResponse(error=f"bad op {op!r}")

    # ------------------------------------------- liveness + lock movement

    def start(self) -> None:
        t = threading.Thread(target=self._probe_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        # join before closing channels: an RPC issued on a channel closed
        # mid-flight raises ValueError out of the probe thread
        for t in self._threads:
            t.join(timeout=3)
        with self._lock:
            for ch in self._channels.values():
                ch.close()
            self._channels.clear()

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval):
            for m in self.members:
                if m == self.self_addr:
                    continue
                try:
                    self._stub(m).DistributedLock(
                        fpb.DlmRequest(op="status", no_forward=True), timeout=2)
                    self.mark(m, True)
                except (grpc.RpcError, ValueError):
                    # ValueError: channel closed by a concurrent stop()
                    if self._stop.is_set():
                        return
                    self.mark(m, False)
            try:
                self._move_misplaced()
            except Exception as e:  # noqa: BLE001 — movement is best-effort
                log.warning(f"dlm lock move failed: {e!r}")

    def _move_misplaced(self) -> None:
        """Transfer held leases whose ring slot is no longer ours
        (reference lock_manager transfer-on-membership-change)."""
        for name, owner, remaining in self.locks.status():
            target = self.owner_for(name)
            if target == self.self_addr:
                continue
            lease = self.locks._leases.get(name)  # noqa: SLF001 — same package
            if lease is None:
                continue
            try:
                resp = self._stub(target).DistributedLock(fpb.DlmRequest(
                    op="transfer", name=name, owner=owner, ttl_seconds=max(remaining, 1.0),
                    token=lease.token, no_forward=True), timeout=5)
            except grpc.RpcError:
                self.mark(target, False)
                continue
            if resp.ok:
                self.locks.release(name, lease.token)
                log.v(1, f"dlm: moved lock {name!r} -> {target}")


class DlmClient:
    """Client-side router: computes the ring owner, falls through dead
    members, and renews held locks (DistributedLockClient analog)."""

    def __init__(self, filers: list[str]):
        self.members = sorted(set(filers))
        self._channels: dict[str, grpc.Channel] = {}
        self._lock = threading.Lock()  # shared across gRPC handler threads

    def close(self) -> None:
        with self._lock:
            for ch in self._channels.values():
                ch.close()
            self._channels.clear()

    def _stub(self, member: str):
        with self._lock:
            ch = self._channels.get(member)
            if ch is None:
                ch = grpc.insecure_channel(member)
                self._channels[member] = ch
        return rpc.filer_stub(ch)

    def _call(self, req: fpb.DlmRequest) -> fpb.DlmResponse:
        order = sorted(self.members, key=lambda m: _score(m, req.name), reverse=True)
        last: Exception | None = None
        for member in order:
            try:
                return self._stub(member).DistributedLock(req, timeout=5)
            except grpc.RpcError as e:
                last = e
                continue
        raise ConnectionError(f"no filer reachable for {req.name!r}: {last}")

    def lock(self, name: str, owner: str, ttl: float = 60.0, token: str = "") -> fpb.DlmResponse:
        return self._call(fpb.DlmRequest(op="lock", name=name, owner=owner, ttl_seconds=ttl,
                                         token=token))

    def renew(self, name: str, owner: str, token: str, ttl: float = 60.0):
        return self._call(fpb.DlmRequest(op="renew", name=name, owner=owner, ttl_seconds=ttl,
                                         token=token))

    def unlock(self, name: str, token: str) -> fpb.DlmResponse:
        return self._call(fpb.DlmRequest(op="unlock", name=name, token=token))

    def status(self) -> list[tuple[str, str, float]]:
        """Union of live leases across every reachable filer (short
        per-member timeout: this rides admin RPCs and must not stall for
        seconds per dead filer)."""
        rows: dict[str, tuple[str, str, float]] = {}
        for member in self.members:
            try:
                resp = self._stub(member).DistributedLock(
                    fpb.DlmRequest(op="status", no_forward=True), timeout=1.5)
            except grpc.RpcError:
                continue
            for r in resp.locks:
                rows[r.name] = (r.name, r.owner, r.remaining)
        return sorted(rows.values())
