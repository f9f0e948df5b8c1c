"""Raft consensus for master HA. Port of seaweedfs_tpu/server/raft.py,
whole; its `raft.jsonl` is the JAX one record for record, so a state
directory written by either package loads in the other. One repair: a
peer call on a channel that `stop()` closed is a `TransportError` here,
where the JAX transport lets the ValueError end the replication thread.

Reference: weed/server/raft_hashicorp.go + raft_server.go — the
reference replicates the max-volume-id/sequencer allocation state across
masters and derives leadership for the topology (`Topo.IsLeader`,
topology.go:245). This is an original, compact Raft (leader election,
log replication, majority commit, durable term/vote/log) specialised to
that small state machine; topology itself is NOT replicated — it is
rebuilt from volume-server heartbeats on whichever master leads, exactly
like the reference.

State machine commands:
  alloc_volume_id(value=hint) -> applied result max(state, hint) + 1
  noop                        -> leader barrier entry on election

Persistence: one JSON-lines file per node (term/vote records and log
entries), fsynced on every durable mutation before any RPC response
that promises it — the same discipline the storage engine uses.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time

import grpc

from ..pb import cluster_pb2 as pb
from ..pb import rpc
from ..utils.glog import logger

log = logger("raft")

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class TransportError(Exception):
    """A peer RPC failed (network, timeout, dead peer). The raft code
    treats it exactly like the gRPC error it wraps; the injectable
    fault transport in tests raises it directly."""


class GrpcTransport:
    """Default peer transport: gRPC to host:port+10000 (the service
    port convention every component uses)."""

    def __init__(self, node: "RaftNode"):
        self._node = node

    def call(self, peer: str, method: str, request, timeout: float):
        try:
            return getattr(self._node._peer_stub(peer), method)(
                request, timeout=timeout
            )
        except grpc.RpcError as e:
            raise TransportError(str(e)) from None
        except ValueError as e:
            # "Cannot invoke RPC on closed channel": stop() closed the
            # channels under a replication thread still in flight
            raise TransportError(str(e)) from None


class RaftNode:
    """One master's raft participant.

    `node_id` / `peers` are the masters' HTTP host:port addresses (the
    cluster-wide names); RPCs go to port+10000 like every other service.
    `apply_fn(kind, value) -> result` runs under the node lock in log
    order exactly once per committed entry.
    """

    def __init__(
        self,
        node_id: str,
        peers: list[str],
        state_dir: str | None = None,
        apply_fn=None,
        election_timeout: tuple[float, float] = (0.4, 0.8),
        heartbeat_interval: float = 0.1,
        snapshot_fn=None,
        restore_fn=None,
        compact_threshold: int = 1024,
        transport_factory=None,
    ):
        """transport_factory(node) -> object with
        call(peer, method, request, timeout); None = gRPC. The seam the
        deterministic fault harness injects drops/delays/partitions
        through (tests/raft_sim.py)."""
        self.node_id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.apply_fn = apply_fn or (lambda kind, value: 0)
        # snapshot_fn() -> JSON-able dict of the state machine;
        # restore_fn(dict) reloads it. Both run under the node lock.
        self.snapshot_fn = snapshot_fn or (lambda: {})
        self.restore_fn = restore_fn or (lambda state: None)
        self.compact_threshold = max(compact_threshold, 8)
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval

        self._lock = threading.RLock()
        self._applied_cv = threading.Condition(self._lock)
        self.role = FOLLOWER
        self.current_term = 0
        self.voted_for: str | None = None
        # log entries with ABSOLUTE index > snap_index (compaction drops
        # the applied prefix into the snapshot)
        self.log: list[pb.RaftEntry] = []
        self.snap_index = 0
        self.snap_term = 0
        self._snap_state: dict = {}
        self.commit_index = 0
        self.last_applied = 0
        self.leader_id: str | None = None
        self.removed = False  # True once a config change drops this node
        self._membership_lock = threading.Lock()  # one change at a time
        # index -> (term, result): the term pins ownership so a deposed
        # leader can never return a foreign entry's result
        self._apply_results: dict[int, tuple[int, int]] = {}
        # indices a propose() call is still waiting on — eviction of
        # _apply_results must never cross the smallest of these, or a
        # slow proposer's committed (term, result) can vanish before it
        # wakes (spurious NotLeader for a committed write => retry
        # double-apply).
        self._propose_waiting: set[int] = set()
        # leader volatile state
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}

        self._state_path = (
            os.path.join(state_dir, "raft.jsonl") if state_dir else None
        )
        self._state_file = None
        self._load_state()

        self._stop = threading.Event()
        self._last_heard = time.monotonic()
        self._last_broadcast = 0.0
        self._repl_inflight: set[str] = set()
        self._channels: dict[str, grpc.Channel] = {}
        self.transport = (
            transport_factory(self) if transport_factory else GrpcTransport(self)
        )
        self._threads: list[threading.Thread] = []
        # hook(leader_addr) fired whenever the known leader changes
        # (election won, or a valid leader's first append) — the master
        # uses it to notify KeepConnected sessions
        self.on_leader_change = None

    # ------------------------------------------------- index arithmetic

    def _last_index(self) -> int:
        return self.snap_index + len(self.log)

    def _entry_at(self, idx: int) -> pb.RaftEntry:
        """Entry at ABSOLUTE index idx (> snap_index)."""
        return self.log[idx - self.snap_index - 1]

    def _term_at(self, idx: int) -> int:
        if idx == 0:
            return 0
        if idx == self.snap_index:
            return self.snap_term
        if idx < self.snap_index:
            return -1  # compacted away: only InstallSnapshot can help
        return self.log[idx - self.snap_index - 1].term

    def _truncate_from(self, idx: int) -> None:
        """Drop entries at absolute index >= idx."""
        del self.log[max(idx - self.snap_index - 1, 0) :]

    # ------------------------------------------------------- persistence

    def _load_state(self) -> None:
        if not self._state_path or not os.path.exists(self._state_path):
            return
        with open(self._state_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail from a crash: ignore the partial record
                if rec["t"] == "term":
                    self.current_term = rec["term"]
                    self.voted_for = rec.get("voted_for")
                elif rec["t"] == "snapshot":
                    self.snap_index = rec["index"]
                    self.snap_term = rec["term"]
                    self._snap_state = rec.get("state", {})
                    members = rec.get("members")
                    if members:
                        self.peers = [m for m in members if m != self.node_id]
                    self.log = []
                    self.commit_index = self.snap_index
                    self.last_applied = self.snap_index
                    self.restore_fn(self._snap_state)
                elif rec["t"] == "entry":
                    e = pb.RaftEntry(
                        term=rec["term"],
                        index=rec["index"],
                        kind=rec["kind"],
                        value=rec.get("value", 0),
                        data=rec.get("data", ""),
                    )
                    if e.index <= self.snap_index:
                        continue  # already folded into the snapshot
                    # replace any conflicting suffix, then append
                    self._truncate_from(e.index)
                    self.log.append(e)
                elif rec["t"] == "truncate":
                    self._truncate_from(rec["index"])

    def _persist(self, rec: dict) -> None:
        if not self._state_path:
            return
        if self._state_file is None:
            self._state_file = open(self._state_path, "a", encoding="utf-8")
        self._state_file.write(json.dumps(rec) + "\n")
        self._state_file.flush()
        os.fsync(self._state_file.fileno())

    def _persist_term(self) -> None:
        self._persist(
            {"t": "term", "term": self.current_term, "voted_for": self.voted_for}
        )

    def _persist_entry(self, e: pb.RaftEntry) -> None:
        rec = {
            "t": "entry",
            "term": e.term,
            "index": e.index,
            "kind": e.kind,
            "value": e.value,
        }
        if e.data:
            rec["data"] = e.data
        self._persist(rec)

    def _rewrite_state_file_locked(self) -> None:
        """Atomic rewrite: snapshot + current term + surviving entries.
        This is what bounds the on-disk log: without it the JSONL grows
        forever."""
        if not self._state_path:
            return
        tmp = self._state_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            members = sorted({self.node_id, *self.peers})
            f.write(
                json.dumps(
                    {
                        "t": "snapshot",
                        "index": self.snap_index,
                        "term": self.snap_term,
                        "state": self._snap_state,
                        "members": members,
                    }
                )
                + "\n"
            )
            f.write(
                json.dumps(
                    {
                        "t": "term",
                        "term": self.current_term,
                        "voted_for": self.voted_for,
                    }
                )
                + "\n"
            )
            for e in self.log:
                rec = {
                    "t": "entry",
                    "term": e.term,
                    "index": e.index,
                    "kind": e.kind,
                    "value": e.value,
                }
                if e.data:
                    rec["data"] = e.data
                f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        if self._state_file:
            self._state_file.close()
        os.replace(tmp, self._state_path)
        self._state_file = open(self._state_path, "a", encoding="utf-8")

    def _maybe_compact_locked(self) -> None:
        """Fold the applied prefix into a snapshot once the log exceeds
        the threshold. The snapshot is taken EXACTLY at last_applied
        (snapshot_fn reflects every applied entry and nothing more);
        followers behind it are caught up via InstallSnapshot."""
        if (
            len(self.log) <= self.compact_threshold
            or self.last_applied <= self.snap_index
        ):
            return
        new_snap = self.last_applied
        self.snap_term = self._term_at(new_snap)
        self._snap_state = dict(self.snapshot_fn())
        del self.log[: new_snap - self.snap_index]
        self.snap_index = new_snap
        self._rewrite_state_file_locked()
        log.v(
            1,
            f"{self.node_id}: compacted log through {new_snap} "
            f"({len(self.log)} entries kept)",
        )

    # ------------------------------------------------------------ timers

    def start(self) -> None:
        if not self.peers:
            # single-master deployment: degenerate raft, instant leader
            with self._lock:
                self.current_term += 1
                self._become_leader_locked()
        t = threading.Thread(target=self._ticker, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for ch in self._channels.values():
            ch.close()
        if self._state_file:
            self._state_file.close()
            self._state_file = None

    def _election_deadline(self) -> float:
        lo, hi = self.election_timeout
        return random.uniform(lo, hi)

    def _ticker(self) -> None:
        deadline = self._election_deadline()
        while not self._stop.wait(0.02):
            with self._lock:
                role = self.role
            if role == LEADER:
                if (
                    time.monotonic() - self._last_broadcast
                    >= self.heartbeat_interval
                ):
                    self._broadcast_append()
            else:
                if (
                    not self.removed
                    and time.monotonic() - self._last_heard > deadline
                ):
                    deadline = self._election_deadline()
                    self._run_election()

    # ---------------------------------------------------------- election

    def _run_election(self) -> None:
        with self._lock:
            if not self.peers:
                return
            self.role = CANDIDATE
            self.current_term += 1
            self.voted_for = self.node_id
            self._set_leader_locked(None)  # the old leader timed out
            self._persist_term()
            term = self.current_term
            last_idx = self._last_index()
            last_term = self._term_at(last_idx)
        self._last_heard = time.monotonic()
        log.v(1, f"{self.node_id}: starting election term {term}")
        votes = 1
        req = pb.RaftVoteRequest(
            term=term,
            candidate_id=self.node_id,
            last_log_index=last_idx,
            last_log_term=last_term,
        )
        lock = threading.Lock()
        done = threading.Event()
        answered = 0

        def ask(peer: str):
            nonlocal votes, answered
            granted = False
            resp = None
            try:
                resp = self.transport.call(peer, "RaftRequestVote", req, 2)
            except TransportError:
                pass
            if resp is not None:
                with self._lock:
                    if resp.term > self.current_term:
                        self._step_down_locked(resp.term)
                        done.set()
                        return
                    granted = bool(
                        resp.granted
                        and self.role == CANDIDATE
                        and self.current_term == term
                    )
            with lock:
                answered += 1
                if granted:
                    votes += 1
                all_in = answered == len(self.peers)
                won = votes > (len(self.peers) + 1) // 2
            if won:
                with self._lock:
                    if self.role == CANDIDATE and self.current_term == term:
                        self._become_leader_locked()
                done.set()
            elif all_in:
                # Every reply (or failure) is in and there is no
                # majority: conclude NOW. Blocking the full RPC timeout
                # here re-synchronizes split-vote candidates — with
                # fast-failing peers both retry on the same 2s beat and
                # can split forever; an instant exit lets the
                # randomized election timeout actually desynchronize.
                done.set()

        threads = [
            threading.Thread(target=ask, args=(p,), daemon=True)
            for p in self.peers
        ]
        for t in threads:
            t.start()
        done.wait(timeout=2)

    def _set_leader_locked(self, leader: str | None) -> None:
        if leader == self.leader_id:
            return
        self.leader_id = leader
        if self.on_leader_change and leader:
            try:
                self.on_leader_change(leader)
            except Exception:  # noqa: BLE001 — a hook must not kill raft
                pass

    def _become_leader_locked(self) -> None:
        if self.role == LEADER:
            return
        self.role = LEADER
        self._set_leader_locked(self.node_id)
        next_idx = self._last_index() + 1
        for p in self.peers:
            self._next_index[p] = next_idx
            self._match_index[p] = 0
        log.info(f"{self.node_id}: leader for term {self.current_term}")
        # commit barrier: an entry from the current term must commit
        # before earlier-term entries count as committed (Raft §5.4.2)
        self._append_locked("noop", 0)
        if not self.peers:
            self._advance_commit_locked(self._last_index())

    def _step_down_locked(self, term: int) -> None:
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._persist_term()
        if self.role != FOLLOWER:
            log.info(f"{self.node_id}: stepping down (term {term})")
        self.role = FOLLOWER
        # whoever led before is no longer known-good; advertising a
        # stale leader would bounce clients at a dead address
        self._set_leader_locked(None)
        self._last_heard = time.monotonic()

    # --------------------------------------------------------------- log

    def _append_locked(self, kind: str, value: int, data: str = "") -> int:
        e = pb.RaftEntry(
            term=self.current_term,
            index=self._last_index() + 1,
            kind=kind,
            value=value,
            data=data,
        )
        self.log.append(e)
        self._persist_entry(e)
        if kind == "config":
            # membership takes effect when APPENDED (hashicorp/raft
            # semantics): a 2-node group can remove its dead member —
            # the quorum for the config entry is counted against the
            # NEW set, not the unreachable old one
            self._apply_config_locked(e, at_append=True)
        return e.index

    def propose(
        self, kind: str, value: int = 0, timeout: float = 10.0, data: str = ""
    ) -> int:
        """Leader-only: append, replicate, wait for apply; returns the
        state machine's result for the entry."""
        with self._lock:
            if self.role != LEADER:
                raise NotLeader(self.leader_id)
            term = self.current_term
            idx = self._append_locked(kind, value, data)
            # register the waiter BEFORE dropping the lock for the
            # broadcast: the eviction floor must already see idx, or a
            # descheduled proposer's committed result can be evicted
            # during the unlocked window
            self._propose_waiting.add(idx)
        try:
            self._broadcast_append()
            deadline = time.monotonic() + timeout
            with self._applied_cv:
                while self.last_applied < idx:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"raft commit timeout at index {idx}"
                        )
                    self._applied_cv.wait(remaining)
                # the entry at idx must still be OURS (a competing
                # leader may have overwritten the uncommitted suffix,
                # or an installed snapshot may have advanced
                # last_applied past an index we never applied). The
                # recorded (term, result) pins ownership even after
                # compaction.
                got = self._apply_results.get(idx)
                if got is None or got[0] != term:
                    raise NotLeader(self.leader_id)
                return got[1]
        finally:
            # covers the broadcast too: a leaked waiter would pin the
            # eviction floor for the life of the process
            with self._lock:
                self._propose_waiting.discard(idx)

    def _apply_config_locked(self, e: pb.RaftEntry, at_append: bool = False) -> None:
        try:
            members = json.loads(e.data)
        except json.JSONDecodeError:
            return
        old = sorted({self.node_id, *self.peers})
        self.peers = [m for m in members if m != self.node_id]
        for p in self.peers:
            self._next_index.setdefault(p, self._last_index() + 1)
            self._match_index.setdefault(p, 0)
        if self.node_id in members:
            self.removed = False  # a re-add must restore campaigning
        elif not at_append:
            # committed removal: stop campaigning/serving. A leader
            # removing ITSELF keeps leading until this commits (it must
            # replicate the entry first), then steps down.
            self.removed = True
            if self.role == LEADER:
                self._step_down_locked(self.current_term)
        if sorted(members) != old:
            log.info(
                f"{self.node_id}: membership {old} -> {sorted(members)}"
            )

    def _advance_commit_locked(self, new_commit: int) -> None:
        new_commit = min(new_commit, self._last_index())
        if new_commit <= self.commit_index:
            return
        self.commit_index = new_commit
        while self.last_applied < self.commit_index:
            e = self._entry_at(self.last_applied + 1)
            self.last_applied += 1
            if e.kind == "config":
                self._apply_config_locked(e)
                result = 0
            else:
                result = self.apply_fn(e.kind, e.value)
            self._apply_results[e.index] = (e.term, int(result or 0))
            if len(self._apply_results) > 4096:
                # never evict an index a propose() call still waits on
                floor = min(self._propose_waiting, default=e.index + 1)
                for k in sorted(self._apply_results)[:2048]:
                    if k >= floor:
                        break
                    del self._apply_results[k]
        self._applied_cv.notify_all()
        self._maybe_compact_locked()

    # ------------------------------------------------------- replication

    def _peer_stub(self, peer: str):
        ch = self._channels.get(peer)
        if ch is None:
            host, _, port = peer.partition(":")
            ch = grpc.insecure_channel(f"{host}:{int(port) + 10000}")
            self._channels[peer] = ch
        return rpc.Stub(ch, rpc.RAFT_SERVICE)

    def _broadcast_append(self) -> None:
        self._last_broadcast = time.monotonic()
        if not self.peers:
            # single-node group: a majority of one is the leader itself
            with self._lock:
                if self.role == LEADER:
                    self._advance_commit_locked(self._last_index())
            return
        # one replication in flight per peer: a slow/dead peer must not
        # accumulate a new blocked thread per tick. Snapshot the peer
        # list under the lock — config changes mutate it live.
        with self._lock:
            targets = [p for p in self.peers if p not in self._repl_inflight]
            self._repl_inflight.update(targets)
        for p in targets:
            threading.Thread(
                target=self._replicate_guarded, args=(p,), daemon=True
            ).start()

    def _replicate_guarded(self, peer: str) -> None:
        try:
            self._replicate_to(peer)
        finally:
            with self._lock:
                self._repl_inflight.discard(peer)

    def _replicate_to(self, peer: str) -> None:
        with self._lock:
            if self.role != LEADER:
                return
            term = self.current_term
            next_idx = self._next_index.get(peer, self._last_index() + 1)
            if next_idx <= self.snap_index:
                # the entries this follower needs were compacted away:
                # ship the snapshot instead
                snap_req = pb.RaftInstallSnapshotRequest(
                    term=term,
                    leader_id=self.node_id,
                    last_included_index=self.snap_index,
                    last_included_term=self.snap_term,
                    state=json.dumps(self._snap_state).encode(),
                    members=sorted({self.node_id, *self.peers}),
                )
            else:
                snap_req = None
                prev_idx = next_idx - 1
                prev_term = self._term_at(prev_idx)
                entries = self.log[next_idx - self.snap_index - 1 :]
                req = pb.RaftAppendRequest(
                    term=term,
                    leader_id=self.node_id,
                    prev_log_index=prev_idx,
                    prev_log_term=prev_term,
                    entries=entries,
                    leader_commit=self.commit_index,
                )
        if snap_req is not None:
            try:
                sresp = self.transport.call(
                    peer, "RaftInstallSnapshot", snap_req, 5
                )
            except TransportError:
                return
            with self._lock:
                if sresp.term > self.current_term:
                    self._step_down_locked(sresp.term)
                elif sresp.success:
                    self._match_index[peer] = snap_req.last_included_index
                    self._next_index[peer] = snap_req.last_included_index + 1
            return
        try:
            resp = self.transport.call(peer, "RaftAppendEntries", req, 2)
        except TransportError:
            return
        with self._lock:
            if resp.term > self.current_term:
                self._step_down_locked(resp.term)
                return
            if self.role != LEADER or self.current_term != term:
                return
            if resp.success:
                self._match_index[peer] = max(
                    self._match_index.get(peer, 0), resp.match_index
                )
                self._next_index[peer] = self._match_index[peer] + 1
                # majority commit (count self)
                for n in range(self._last_index(), self.commit_index, -1):
                    if self._term_at(n) != self.current_term:
                        break  # only current-term entries commit by counting
                    acks = 1 + sum(
                        1 for p in self.peers if self._match_index.get(p, 0) >= n
                    )
                    if acks > (len(self.peers) + 1) // 2:
                        self._advance_commit_locked(n)
                        break
            else:
                # fast back-up using the follower's conflict hint
                self._next_index[peer] = max(
                    1,
                    min(
                        resp.conflict_index or (next_idx - 1),
                        self._last_index() + 1,
                    ),
                )

    # ------------------------------------------------------ RPC handlers

    def RaftRequestVote(self, request: pb.RaftVoteRequest, context) -> pb.RaftVoteResponse:
        with self._lock:
            # Disruption guard (Raft thesis §4.2.3): a server REMOVED
            # from the cluster never learns it (the leader stops
            # replicating to it at the config append) and will campaign
            # with ever-higher terms forever. Deny votes — WITHOUT
            # adopting the term — while we believe a leader is alive:
            # a live leader denies always (a genuinely new leader will
            # depose it via AppendEntries), a follower denies within the
            # minimum election timeout of last leader contact.
            if request.term > self.current_term:
                if self.role == LEADER or (
                    self.leader_id is not None
                    and time.monotonic() - self._last_heard
                    < self.election_timeout[0]
                ):
                    return pb.RaftVoteResponse(
                        term=self.current_term, granted=False
                    )
                self._step_down_locked(request.term)
            granted = False
            if request.term == self.current_term and self.voted_for in (
                None,
                request.candidate_id,
            ):
                last_idx = self._last_index()
                last_term = self._term_at(last_idx)
                up_to_date = request.last_log_term > last_term or (
                    request.last_log_term == last_term
                    and request.last_log_index >= last_idx
                )
                if up_to_date:
                    granted = True
                    self.voted_for = request.candidate_id
                    self._persist_term()
                    self._last_heard = time.monotonic()
            return pb.RaftVoteResponse(term=self.current_term, granted=granted)

    def RaftAppendEntries(self, request: pb.RaftAppendRequest, context) -> pb.RaftAppendResponse:
        with self._lock:
            if request.term > self.current_term:
                self._step_down_locked(request.term)
            if request.term < self.current_term:
                return pb.RaftAppendResponse(
                    term=self.current_term, success=False
                )
            # valid leader for our term
            self.role = FOLLOWER
            self._set_leader_locked(request.leader_id)
            self._last_heard = time.monotonic()
            # log consistency check (indexes are absolute; anything at
            # or below our snapshot is already committed here)
            if request.prev_log_index > self._last_index():
                return pb.RaftAppendResponse(
                    term=self.current_term,
                    success=False,
                    conflict_index=self._last_index() + 1,
                )
            if (
                request.prev_log_index > self.snap_index
                and self._term_at(request.prev_log_index)
                != request.prev_log_term
            ):
                bad_term = self._term_at(request.prev_log_index)
                ci = request.prev_log_index
                while (
                    ci > self.snap_index + 1
                    and self._term_at(ci - 1) == bad_term
                ):
                    ci -= 1
                return pb.RaftAppendResponse(
                    term=self.current_term, success=False, conflict_index=ci
                )
            # append / overwrite conflicts
            for e in request.entries:
                if e.index <= self.snap_index:
                    continue  # folded into our snapshot already
                if e.index <= self._last_index():
                    if self._term_at(e.index) == e.term:
                        continue  # already have it
                    self._truncate_from(e.index)
                    self._persist({"t": "truncate", "index": e.index})
                self.log.append(e)
                self._persist_entry(e)
                if e.kind == "config":
                    # follower adopts the membership at append, like
                    # the leader (at_append: no step-down until commit)
                    self._apply_config_locked(e, at_append=True)
            if request.leader_commit > self.commit_index:
                self._advance_commit_locked(request.leader_commit)
            return pb.RaftAppendResponse(
                term=self.current_term,
                success=True,
                match_index=request.prev_log_index + len(request.entries),
            )

    def RaftInstallSnapshot(
        self, request: pb.RaftInstallSnapshotRequest, context
    ) -> pb.RaftInstallSnapshotResponse:
        with self._lock:
            if request.term > self.current_term:
                self._step_down_locked(request.term)
            if request.term < self.current_term:
                return pb.RaftInstallSnapshotResponse(
                    term=self.current_term, success=False
                )
            self.role = FOLLOWER
            self._set_leader_locked(request.leader_id)
            self._last_heard = time.monotonic()
            if request.last_included_index <= max(
                self.snap_index, self.last_applied
            ):
                # Stale snapshot: the state machine has already applied
                # past last_included_index (a leader conflict-hint walk
                # can back next_index below a follower's applied point).
                # Restoring would roll the state machine back while
                # last_applied stays ahead, silently losing the entries
                # in (lii, last_applied] — acknowledge without acting.
                return pb.RaftInstallSnapshotResponse(
                    term=self.current_term, success=True
                )
            try:
                state = json.loads(request.state or b"{}")
            except json.JSONDecodeError:
                state = {}
            # keep any log suffix newer than the snapshot; drop the rest
            if (
                self._last_index() > request.last_included_index
                and self._term_at(request.last_included_index)
                == request.last_included_term
            ):
                del self.log[
                    : request.last_included_index - self.snap_index
                ]
            else:
                self.log = []
            self.snap_index = request.last_included_index
            self.snap_term = request.last_included_term
            self._snap_state = state
            self.restore_fn(state)
            if request.members:
                self.peers = [
                    m for m in request.members if m != self.node_id
                ]
            self.commit_index = max(self.commit_index, self.snap_index)
            self.last_applied = max(self.last_applied, self.snap_index)
            self._rewrite_state_file_locked()
            self._applied_cv.notify_all()
            return pb.RaftInstallSnapshotResponse(
                term=self.current_term, success=True
            )

    # -------------------------------------------------------- membership

    def add_server(self, server: str) -> list[str]:
        return self._change_membership("add", server)

    def remove_server(self, server: str) -> list[str]:
        return self._change_membership("remove", server)

    def _change_membership(self, op: str, server: str) -> list[str]:
        """Sequential single-server change (Raft §6 one-at-a-time rule:
        any two consecutive memberships differing by one server always
        share a majority, so joint consensus is unnecessary). The
        membership lock serializes concurrent admin calls end-to-end —
        without it two changes could both base off the same set and the
        second would silently undo the first."""
        with self._membership_lock:
            with self._lock:
                if self.role != LEADER:
                    raise NotLeader(self.leader_id)
                for e in self.log[self.commit_index - self.snap_index :]:
                    if e.kind == "config":
                        raise RuntimeError(
                            "a membership change is already in flight"
                        )
                members = sorted({self.node_id, *self.peers})
                if op == "add":
                    if server in members:
                        return members
                    members = sorted({*members, server})
                else:
                    if server not in members:
                        return members
                    members = sorted(m for m in members if m != server)
                    if not members:
                        raise RuntimeError("cannot remove the last member")
            self.propose("config", data=json.dumps(members), timeout=10.0)
            return members

    def RaftChangeMembership(
        self, request: pb.RaftChangeRequest, context
    ) -> pb.RaftChangeResponse:
        try:
            if request.op == "add":
                members = self.add_server(request.server)
            elif request.op == "remove":
                members = self.remove_server(request.server)
            else:
                return pb.RaftChangeResponse(error=f"bad op {request.op!r}")
        except NotLeader as e:
            return pb.RaftChangeResponse(
                error="not the leader", leader=e.leader or ""
            )
        except (RuntimeError, TimeoutError) as e:
            return pb.RaftChangeResponse(error=str(e))
        return pb.RaftChangeResponse(
            members=members, leader=self.leader_id or ""
        )

    def RaftStatus(self, request, context) -> pb.RaftStatusResponse:
        with self._lock:
            return pb.RaftStatusResponse(
                node_id=self.node_id,
                leader=self.leader_id or "",
                term=self.current_term,
                role=self.role,
                peers=list(self.peers),
                commit_index=self.commit_index,
                applied_index=self.last_applied,
            )

    # ----------------------------------------------------------- queries

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self.role == LEADER

    @property
    def leader(self) -> str | None:
        with self._lock:
            return self.leader_id


class NotLeader(Exception):
    def __init__(self, leader: str | None):
        super().__init__(f"not the leader (try {leader or 'unknown'})")
        self.leader = leader
