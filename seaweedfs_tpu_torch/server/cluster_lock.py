"""Cluster lock manager: exclusive named leases on the master leader.
Port of seaweedfs_tpu/server/cluster_lock.py, whole.

Reference: weed/cluster/lock_manager/lock_manager.go — the reference
gates every mutating shell command on an exclusive cluster lock
(`confirmIsLocked`) and expires stale holders by lease. Locks live in
the leader's memory only: a failover drops them, which is safe because
holders renew within their TTL and discover the loss as a failed
renewal (same model as the reference's distributed lock ring falling
back to the new lock host).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass


@dataclass
class _Lease:
    owner: str
    token: str
    expires: float  # time.monotonic deadline


class LockManager:
    MAX_TTL = 3600.0

    def __init__(self):
        self._lock = threading.Lock()
        self._leases: dict[str, _Lease] = {}

    def acquire(
        self, name: str, owner: str, ttl: float, token: str = ""
    ) -> tuple[bool, str, str, float]:
        """Returns (ok, token, holder, remaining_ttl).

        Empty `token` = fresh acquire; matching token = renewal
        (re-entrant for the same session)."""
        ttl = min(max(ttl, 1.0), self.MAX_TTL)
        now = time.monotonic()
        with self._lock:
            lease = self._leases.get(name)
            if lease is not None and lease.expires <= now:
                lease = None  # expired: holder lost it
            if lease is None:
                tok = token or uuid.uuid4().hex
                self._leases[name] = _Lease(owner, tok, now + ttl)
                return True, tok, owner, ttl
            if token and lease.token == token:
                # renewal never SHORTENS a lease: a nested guard's
                # smaller ttl must not clobber a session `lock -ttl N`
                lease.expires = max(lease.expires, now + ttl)
                lease.owner = owner or lease.owner
                return True, lease.token, lease.owner, lease.expires - now
            return False, "", lease.owner, lease.expires - now

    def release(self, name: str, token: str) -> bool:
        with self._lock:
            lease = self._leases.get(name)
            if lease is None or lease.token != token:
                return False
            del self._leases[name]
            return True

    def status(self) -> list[tuple[str, str, float]]:
        """(name, owner, remaining_seconds) for live leases."""
        now = time.monotonic()
        with self._lock:
            out = []
            for name, lease in list(self._leases.items()):
                if lease.expires <= now:
                    del self._leases[name]
                    continue
                out.append((name, lease.owner, lease.expires - now))
            return sorted(out)
