"""POSIX advisory byte-range locks with leases.

Port of seaweedfs_tpu/filer/locks.py, whole (reference
weed/filer/filer_grpc_server_posix_lock.go + the cluster lock manager):
FUSE mounts and multi-writer clients coordinate through the filer:
shared/exclusive ranges keyed by path, owned by a client identity,
auto-expiring on a lease so a dead client can never wedge a file."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

MAX_END = 2**63 - 1


@dataclass
class LockRange:
    owner: str
    start: int
    end: int  # exclusive
    exclusive: bool
    expires_at: float


class PosixLockManager:
    def __init__(self, default_lease: float = 30.0):
        self._lock = threading.Lock()
        self._by_path: dict[str, list[LockRange]] = {}
        self.default_lease = default_lease

    def _alive(self, path: str) -> list[LockRange]:
        now = time.monotonic()
        ranges = [
            r for r in self._by_path.get(path, []) if r.expires_at > now
        ]
        if ranges:
            self._by_path[path] = ranges
        else:
            self._by_path.pop(path, None)
        return ranges

    @staticmethod
    def _overlaps(a_start: int, a_end: int, b: LockRange) -> bool:
        return a_start < b.end and b.start < a_end

    def lock(
        self,
        path: str,
        owner: str,
        start: int = 0,
        end: int = 0,
        exclusive: bool = True,
        lease: float = 0.0,
    ) -> tuple[bool, str]:
        """(granted, conflicting_owner). end=0 means to-EOF. Re-locking
        by the same owner replaces its overlapping ranges (POSIX
        F_SETLK semantics: lock upgrade/downgrade in place)."""
        end = end or MAX_END
        if end <= start:
            return False, ""
        lease = lease or self.default_lease
        with self._lock:
            ranges = self._alive(path)
            for r in ranges:
                if r.owner == owner:
                    continue
                if not self._overlaps(start, end, r):
                    continue
                if exclusive or r.exclusive:
                    return False, r.owner
            # same-owner overlapping ranges are replaced
            kept = [
                r
                for r in ranges
                if r.owner != owner or not self._overlaps(start, end, r)
            ]
            kept.append(
                LockRange(
                    owner=owner,
                    start=start,
                    end=end,
                    exclusive=exclusive,
                    expires_at=time.monotonic() + lease,
                )
            )
            self._by_path[path] = kept
            return True, ""

    def unlock(
        self, path: str, owner: str, start: int = 0, end: int = 0
    ) -> int:
        """Release the owner's locks overlapping [start, end); returns
        how many ranges were dropped (POSIX splits are simplified to
        whole-range release, like the reference's per-fh unlock)."""
        end = end or MAX_END
        with self._lock:
            ranges = self._alive(path)
            kept = [
                r
                for r in ranges
                if r.owner != owner or not self._overlaps(start, end, r)
            ]
            dropped = len(ranges) - len(kept)
            if kept:
                self._by_path[path] = kept
            else:
                self._by_path.pop(path, None)
            return dropped

    def renew(self, path: str, owner: str, lease: float = 0.0) -> int:
        """Extend the owner's leases on a path; returns ranges renewed."""
        lease = lease or self.default_lease
        with self._lock:
            n = 0
            for r in self._alive(path):
                if r.owner == owner:
                    r.expires_at = time.monotonic() + lease
                    n += 1
            return n

    def test(
        self,
        path: str,
        start: int = 0,
        end: int = 0,
        exclusive: bool = True,
        owner: str = "",
    ) -> str:
        """First conflicting owner for a hypothetical lock ('' = none) —
        F_GETLK. The caller's OWN locks never conflict (POSIX: a
        process testing a range it holds must see it as lockable)."""
        end = end or MAX_END
        with self._lock:
            for r in self._alive(path):
                if r.owner == owner:
                    continue
                if self._overlaps(start, end, r) and (exclusive or r.exclusive):
                    return r.owner
            return ""

    def holders(self, path: str) -> list[LockRange]:
        with self._lock:
            return list(self._alive(path))
