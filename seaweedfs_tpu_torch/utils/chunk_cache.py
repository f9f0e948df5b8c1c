"""Byte-bounded LRU cache with read-through singleflight collapse.

Port of seaweedfs_tpu/utils/chunk_cache.py (reference
weed/util/chunk_cache, the memory tier): N
concurrent misses on one key collapse to ONE loader call, so under
concurrent degraded reads an extent is reconstructed exactly once and
everyone else waits for the leader's bytes. The EC reconstructed-interval
cache keys entries ``<vol>:<shard>:<gen>:<lo>:<hi>``: remount and
unmount invalidate by bumping the generation (a stale in-flight load
parks its result under the old key where no new reader looks). The filer
keeps two more: its fid-keyed chunk cache (immutable bytes, so eviction
only) and its path-keyed entry cache (`drop` on every mutation).

A cache built with a `tier` ("ec_interval" for the EC volume's own
cache, "filer_chunk" and "filer_entry" for the filer's) counts its hits, misses and singleflight waits in
``sw_gateway_hot_cache_{hits,misses,singleflight_waits}_total{tier}``
(utils/metrics.py).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from . import metrics


class _Flight:
    """One in-progress load: the leader computes, followers wait.
    ``doomed`` is the invalidation fence — set (under the CACHE's
    lock) when a drop superseded this flight: its result still goes to
    the callers that joined before the invalidation, but it must not
    be admitted, and new callers must not join it."""

    __slots__ = ("done", "value", "exc", "doomed")

    def __init__(self):
        self.done = threading.Event()
        self.value = None
        self.exc: BaseException | None = None
        self.doomed = False


class SingleFlight:
    """Per-key call collapsing (golang.org/x/sync/singleflight): while
    one ``do(key, fn)`` is in progress, other callers with the same key
    block and receive the leader's result (or its exception) instead of
    re-running ``fn``. Keys are independent; distinct keys run
    concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: dict = {}

    def do(self, key, fn):
        """Returns ``(value, waited)`` — ``waited`` is True when this
        call joined another caller's in-progress load instead of
        running ``fn`` itself. The leader's ``fn`` receives the flight
        object (its ``doomed`` flag is the admission fence); the
        leader's exception propagates to every joined caller."""
        with self._lock:
            fl = self._flights.get(key)
            if fl is not None:
                lead = False
            else:
                fl = self._flights[key] = _Flight()
                lead = True
        if not lead:
            fl.done.wait()
            if fl.exc is not None:
                raise fl.exc
            return fl.value, True
        try:
            fl.value = fn(fl)
        except BaseException as e:
            fl.exc = e
            raise
        finally:
            with self._lock:
                # a doomed flight was already detached (and the key may
                # now belong to a FRESH post-invalidation flight): only
                # remove our own entry
                if self._flights.get(key) is fl:
                    del self._flights[key]
            fl.done.set()
        return fl.value, False

    def active_keys(self) -> list:
        """Keys with a load currently in flight (invalidation fencing
        enumerates these to doom matching flights)."""
        with self._lock:
            return list(self._flights)

    def doom(self, key) -> "_Flight | None":
        """Detach and fence the in-flight load for `key` (if any):
        callers already joined still receive its result, but new
        ``do`` calls for the key start a FRESH load, and the flight's
        ``doomed`` flag tells its leader not to admit. The caller must
        hold whatever lock serializes admission against invalidation
        (the ChunkCache holds its own lock across both)."""
        with self._lock:
            fl = self._flights.pop(key, None)
        if fl is not None:
            fl.doomed = True
        return fl


class ChunkCache:
    def __init__(self, capacity_bytes: int = 64 * 1024 * 1024, tier: str = ""):
        """`tier` labels this cache's counters in the
        ``sw_gateway_hot_cache_*`` metrics ("" = not exported)."""
        self.capacity = capacity_bytes
        self.tier = tier
        self._lock = threading.Lock()
        self._data: "OrderedDict[str, bytes]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.singleflight_waits = 0
        self.loads = 0
        self._sf = SingleFlight()

    def get(self, key: str) -> bytes | None:
        with self._lock:
            val = self._data.get(key)
            if val is None:
                self.misses += 1
            else:
                self._data.move_to_end(key)
                self.hits += 1
        # the metric outside the cache lock: every cache of a tier shares
        # one counter, whose lock must not serialize their hits
        self._count("misses" if val is None else "hits")
        return val

    def _count(self, kind: str) -> None:
        if self.tier:
            counter = {
                "hits": metrics.gateway_hot_cache_hits_total,
                "misses": metrics.gateway_hot_cache_misses_total,
                "singleflight_waits": metrics.gateway_hot_cache_singleflight_waits_total,
            }[kind]
            counter.inc(tier=self.tier)

    def get_or_load(self, key: str, loader, admit=None):
        """Read-through with singleflight collapse: a hit returns the
        cached bytes; concurrent misses on `key` run `loader()` exactly
        ONCE (everyone receives the leader's bytes — or its exception).
        The leader's result is admitted into the cache unless `admit`
        (bytes -> bool) rejects it (the filer's "one streaming chunk must
        not flush the hot set" rule).

        Returns ``(data, source)`` with source one of ``"hit"`` (cache),
        ``"load"`` (this caller ran the loader), ``"wait"`` (joined
        another caller's in-flight load).

        A zero-capacity cache (the cache-off/naive configuration) is a
        pure pass-through: no storage, no collapsing — every caller
        pays its own loader call.
        """
        if self.capacity <= 0:
            with self._lock:
                self.misses += 1
                self.loads += 1
            self._count("misses")
            return loader(), "load"
        val = self.get(key)
        if val is not None:
            return val, "hit"

        def lead(fl):
            data = loader()
            admit_ok = admit is None or admit(data)
            # doomed-check + admission are ONE critical section: an
            # invalidation (which removes entries, detaches this
            # flight, and sets fl.doomed — all under this same lock,
            # see drop_*) either ran before — we see the doom and skip
            # the put — or runs after and removes what we just
            # inserted; there is no window to admit stale bytes.
            with self._lock:
                self.loads += 1
                if not fl.doomed and admit_ok:
                    self._put_locked(key, data)
            return data

        data, waited = self._sf.do(key, lead)
        if waited:
            with self._lock:
                self.singleflight_waits += 1
            self._count("singleflight_waits")
            return data, "wait"
        return data, "load"

    def _put_locked(self, key: str, data: bytes) -> None:
        if len(data) > self.capacity:
            return  # never let one chunk flush the whole cache
        old = self._data.pop(key, None)
        if old is not None:
            self._bytes -= len(old)
        self._data[key] = data
        self._bytes += len(data)
        while self._bytes > self.capacity and self._data:
            _, evicted = self._data.popitem(last=False)
            self._bytes -= len(evicted)

    def drop(self, key: str) -> None:
        """Drop one key. A load already in flight for it is fenced as in
        drop_prefix: its result goes to the callers that joined, but it
        is never admitted, so an invalidation racing a read-through (the
        filer entry cache's write-vs-lookup race) cannot be repopulated
        by the pre-invalidation load."""
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._sf.doom(key)

    def _doom_inflight_locked(self, match) -> None:
        """Fence in-flight loads whose key satisfies `match`: each
        matching flight is DETACHED (new readers start a fresh
        post-invalidation load instead of joining it — a reader that
        begins after a leaf patch must never receive the pre-patch
        reconstruction) and marked doomed (its result goes to the
        callers that already joined, but is never admitted). Caller
        holds self._lock — entry removal, flight detach/doom, and
        lead()'s doomed-check+put all serialize on it, so a leader can
        never slip a stale put past an invalidation. (Lock order
        cache._lock -> SingleFlight._lock; the reverse is never
        taken.)"""
        for k in self._sf.active_keys():
            if match(k):
                self._sf.doom(k)

    def drop_prefix(self, prefix: str) -> int:
        """Drop every entry whose key starts with `prefix` (targeted
        invalidation — e.g. one shard's extents in the EC interval
        cache); returns how many were dropped. O(n) over keys, fine for
        a byte-bounded cache of large values. A matching load already
        in flight is fenced: it completes for its callers but is not
        admitted."""
        with self._lock:
            doomed = [k for k in self._data if k.startswith(prefix)]
            for k in doomed:
                self._bytes -= len(self._data.pop(k))
            self._doom_inflight_locked(lambda k: k.startswith(prefix))
            return len(doomed)

    def drop_matching(self, prefix: str, pred) -> int:
        """Drop entries whose key starts with `prefix` AND satisfies
        `pred(key)` — finer than drop_prefix when only part of a
        namespace went stale (e.g. the byte ranges a leaf repair just
        patched, leaving the shard's other cached extents hot). A
        matching load already in flight is fenced (returned to its
        callers, never admitted), so a reconstruction started over the
        pre-patch bytes cannot repopulate the just-dropped range."""
        with self._lock:
            doomed = [
                k for k in self._data if k.startswith(prefix) and pred(k)
            ]
            for k in doomed:
                self._bytes -= len(self._data.pop(k))
            self._doom_inflight_locked(
                lambda k: k.startswith(prefix) and pred(k)
            )
            return len(doomed)

    def clear(self) -> None:
        """Drop every entry (bulk invalidation). Hit/miss counters are
        deliberately kept: they describe the cache's lifetime, not one
        population of it. In-flight loads are fenced like drop_*."""
        with self._lock:
            self._data.clear()
            self._bytes = 0
            self._doom_inflight_locked(lambda k: True)

    def stats(self) -> dict:
        """Lifetime counters."""
        with self._lock:
            return {
                "capacity_bytes": self.capacity,
                "size_bytes": self._bytes,
                "entries": len(self._data),
                "hits": self.hits,
                "misses": self.misses,
                "loads": self.loads,
                "singleflight_waits": self.singleflight_waits,
            }

    @property
    def size_bytes(self) -> int:
        return self._bytes
