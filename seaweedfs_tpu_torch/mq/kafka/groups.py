"""Classic Kafka consumer-group coordination (client-side assignment).

Port of seaweedfs_tpu/mq/kafka/groups.py, whole: `GroupCoordinator`.

Reference: weed/mq/kafka/consumer — the JoinGroup/SyncGroup protocol:
the coordinator only herds members through a rebalance and relays the
leader-computed assignment; it never parses the embedded protocol
metadata. States per group: Empty → PreparingRebalance →
CompletingRebalance → Stable (same names as Kafka's GroupCoordinator).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field

from . import protocol as kp

EMPTY = "Empty"
PREPARING = "PreparingRebalance"
COMPLETING = "CompletingRebalance"
STABLE = "Stable"

# how long a rebalance waits for the rest of the herd after the first
# join (the broker's group.initial.rebalance.delay.ms analog)
JOIN_SETTLE_SECONDS = 0.3


@dataclass
class Member:
    member_id: str
    client_id: str
    session_timeout: float
    protocols: list[tuple[str, bytes]]
    last_seen: float = field(default_factory=time.monotonic)
    assignment: bytes = b""
    joined_generation: int = -1


class Group:
    def __init__(self, group_id: str):
        self.group_id = group_id
        self.lock = threading.Condition()
        self.state = EMPTY
        self.generation = 0
        self.protocol_type = ""
        self.protocol_name = ""
        self.leader = ""
        self.members: dict[str, Member] = {}
        self._join_deadline = 0.0

    # ----------------------------------------------------------- joining

    def join(
        self,
        member_id: str,
        client_id: str,
        protocol_type: str,
        protocols: list[tuple[str, bytes]],
        session_timeout: float,
        rebalance_timeout: float,
    ) -> dict:
        """Blocks until the rebalance completes; returns the JoinGroup
        response fields."""
        with self.lock:
            if self.protocol_type and protocol_type != self.protocol_type:
                return {"error": kp.INCONSISTENT_GROUP_PROTOCOL}
            self.protocol_type = protocol_type
            if not member_id:
                member_id = f"{client_id or 'member'}-{uuid.uuid4().hex[:12]}"
            m = self.members.get(member_id)
            if m is None:
                m = Member(member_id, client_id, session_timeout, protocols)
                self.members[member_id] = m
            else:
                m.protocols = protocols
                m.session_timeout = session_timeout
            m.last_seen = time.monotonic()
            # any (re)join forces a new round
            if self.state in (EMPTY, STABLE, COMPLETING):
                self.state = PREPARING
                self._join_deadline = time.monotonic() + JOIN_SETTLE_SECONDS
                self.lock.notify_all()
            else:
                # extend the settle window for stragglers
                self._join_deadline = max(
                    self._join_deadline,
                    time.monotonic() + JOIN_SETTLE_SECONDS,
                )
            target_gen = self.generation + 1
            deadline = time.monotonic() + max(rebalance_timeout, 1.0)
            while True:
                if self.state == PREPARING:
                    now = time.monotonic()
                    if now >= self._join_deadline and all(
                        mm.last_seen >= now - mm.session_timeout
                        for mm in self.members.values()
                    ):
                        self._complete_join_locked()
                if (
                    self.state in (COMPLETING, STABLE)
                    and self.generation >= target_gen
                ):
                    break
                if time.monotonic() > deadline:
                    return {"error": kp.REBALANCE_IN_PROGRESS}
                self.lock.wait(timeout=0.05)
            m.joined_generation = self.generation
            resp = {
                "error": kp.NONE,
                "generation": self.generation,
                "protocol": self.protocol_name,
                "leader": self.leader,
                "member_id": member_id,
                "members": [],
            }
            if member_id == self.leader:
                resp["members"] = [
                    (mm.member_id, self._metadata_for(mm))
                    for mm in self.members.values()
                ]
            return resp

    def _metadata_for(self, m: Member) -> bytes:
        for name, meta in m.protocols:
            if name == self.protocol_name:
                return meta
        return m.protocols[0][1] if m.protocols else b""

    def _complete_join_locked(self) -> None:
        # drop members that never re-joined this round
        now = time.monotonic()
        self.members = {
            mid: m
            for mid, m in self.members.items()
            if m.last_seen >= now - m.session_timeout
        }
        if not self.members:
            self.state = EMPTY
            return
        # choose the protocol every member supports (first of leader's)
        common = None
        for m in self.members.values():
            names = [n for n, _ in m.protocols]
            common = names if common is None else [
                n for n in common if n in names
            ]
        self.protocol_name = common[0] if common else ""
        self.generation += 1
        self.leader = next(iter(self.members))
        self.state = COMPLETING
        self.lock.notify_all()

    # ------------------------------------------------------------ syncing

    def sync(
        self,
        member_id: str,
        generation: int,
        assignments: list[tuple[str, bytes]],
    ) -> tuple[int, bytes]:
        with self.lock:
            m = self.members.get(member_id)
            if m is None:
                return kp.UNKNOWN_MEMBER_ID, b""
            if generation != self.generation:
                return kp.ILLEGAL_GENERATION, b""
            if member_id == self.leader and assignments:
                for mid, blob in assignments:
                    if mid in self.members:
                        self.members[mid].assignment = blob
                self.state = STABLE
                self.lock.notify_all()
            deadline = time.monotonic() + 30.0
            while self.state == COMPLETING and self.generation == generation:
                if time.monotonic() > deadline:
                    return kp.REBALANCE_IN_PROGRESS, b""
                self.lock.wait(timeout=0.05)
            if self.generation != generation:
                return kp.REBALANCE_IN_PROGRESS, b""
            m.last_seen = time.monotonic()
            return kp.NONE, m.assignment

    # --------------------------------------------------------- liveness

    def heartbeat(self, member_id: str, generation: int) -> int:
        with self.lock:
            m = self.members.get(member_id)
            if m is None:
                return kp.UNKNOWN_MEMBER_ID
            m.last_seen = time.monotonic()
            if generation != self.generation:
                return kp.ILLEGAL_GENERATION
            if self.state in (PREPARING,):
                return kp.REBALANCE_IN_PROGRESS
            return kp.NONE

    def leave(self, member_id: str) -> int:
        with self.lock:
            if self.members.pop(member_id, None) is None:
                return kp.UNKNOWN_MEMBER_ID
            if self.state == STABLE and self.members:
                self.state = PREPARING
                self._join_deadline = (
                    time.monotonic() + JOIN_SETTLE_SECONDS
                )
            elif not self.members:
                self.state = EMPTY
            self.lock.notify_all()
            return kp.NONE

    def expire_dead_members(self) -> None:
        with self.lock:
            now = time.monotonic()
            dead = [
                mid
                for mid, m in self.members.items()
                if m.last_seen < now - m.session_timeout
            ]
            if not dead or self.state == PREPARING:
                return
            for mid in dead:
                del self.members[mid]
            if self.members:
                self.state = PREPARING
                self._join_deadline = now + JOIN_SETTLE_SECONDS
            else:
                self.state = EMPTY
            self.lock.notify_all()


class GroupCoordinator:
    def __init__(self):
        self._lock = threading.Lock()
        self.groups: dict[str, Group] = {}
        self._stop = threading.Event()
        self._reaper = threading.Thread(target=self._reap, daemon=True)
        self._reaper.start()

    def group(self, group_id: str) -> Group:
        """Get-or-create: only JoinGroup may instantiate a group."""
        with self._lock:
            g = self.groups.get(group_id)
            if g is None:
                g = Group(group_id)
                self.groups[group_id] = g
            return g

    def lookup(self, group_id: str) -> Group | None:
        """Non-creating lookup for heartbeat/sync/leave/describe — an
        unknown group must not leak a Group object per probe."""
        with self._lock:
            return self.groups.get(group_id)

    def list_groups(self) -> list[tuple[str, str]]:
        with self._lock:
            return [
                (g.group_id, g.protocol_type)
                for g in self.groups.values()
                if g.members
            ]

    def stop(self) -> None:
        self._stop.set()

    def _reap(self) -> None:
        while not self._stop.wait(1.0):
            with self._lock:
                groups = list(self.groups.values())
            for g in groups:
                g.expire_dead_members()
            # drop long-empty groups so probes/one-shot consumers don't
            # grow the dict for the life of the process
            with self._lock:
                for gid in [
                    gid
                    for gid, g in self.groups.items()
                    if g.state == EMPTY and not g.members
                ]:
                    del self.groups[gid]
