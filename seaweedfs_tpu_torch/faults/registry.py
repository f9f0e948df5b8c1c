"""Deterministic, seedable fault-injection registry.

Port of seaweedfs_tpu/faults/registry.py, whole (standard library only).
The port has its own module-level REGISTRY: a point armed in one package
never fires in the other. The same trigger and action, armed with the
same seed, fire on the same arrivals and corrupt the same bytes in both.

Production code declares *named fault points* at the seams that guard
durability (disk reads, shard publishes, device encodes, peer RPCs):

    faults.fire("ec.rebuild.before_rename", base=base)      # may raise
    data = faults.mutate("storage.disk.read_at", data, ...) # may corrupt

Both are a single module-level bool check when nothing is injected —
the registry being empty means the fast path does no dict lookup, no
lock, no allocation, and cannot change behavior.

Tests arm points with a *trigger* (nth-call, every-nth,
probability-with-seed, always) and an *action* (raise an IOError,
inject latency, flip seeded bits, tear a write/read short, crash):

    with faults.injected("storage.disk.read_at",
                         faults.bit_flip(seed=7), when=faults.nth_call(3)):
        ...

Determinism: every probabilistic trigger and every byte-corrupting
action owns a private `random.Random(seed)`, so a fault schedule replays
bit-identically from its seed — the property the chaos harness's
"recovers bit-exact or refuses fail-closed" assertions rest on.

Crash semantics: `crash()` raises InjectedCrash (a BaseException — an
ordinary `except Exception` recovery path cannot swallow a simulated
process death), while `hard_exit()` calls os._exit so not even cleanup
handlers run — the faithful model of power loss inside a publish
window, used in a child process.
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator


class InjectedFault(Exception):
    """Base for injected non-crash failures."""


class InjectedIOError(InjectedFault, IOError):
    """Injected I/O failure; inherits IOError so production handlers
    classify it exactly like a real disk error."""


class InjectedCrash(BaseException):
    """Simulated process death. Deliberately NOT an Exception: recovery
    code that catches Exception must not be able to 'survive' a crash."""


# --------------------------------------------------------------- triggers
#
# A trigger is a zero-arg callable evaluated once per arrival at the
# fault point; True means the action fires for this call. Each factory
# returns a fresh stateful closure, so one trigger instance must not be
# shared across faults.


def always() -> Callable[[], bool]:
    return lambda: True


def nth_call(n: int) -> Callable[[], bool]:
    """Fire on exactly the nth arrival (1-based), never again."""
    state = {"calls": 0}

    def check() -> bool:
        state["calls"] += 1
        return state["calls"] == n

    return check


def every(n: int) -> Callable[[], bool]:
    """Fire on every nth arrival."""
    state = {"calls": 0}

    def check() -> bool:
        state["calls"] += 1
        return state["calls"] % n == 0

    return check


def probability(p: float, seed: int = 0) -> Callable[[], bool]:
    """Fire with probability p per arrival, deterministically from seed."""
    rng = random.Random(seed)
    return lambda: rng.random() < p


# ---------------------------------------------------------------- actions
#
# Fire-actions take the call context dict and either return None or
# raise. Mutate-actions additionally take the byte payload and return
# the (possibly corrupted) replacement.


def io_error(msg: str = "injected I/O error") -> Callable[[dict], None]:
    def act(ctx: dict) -> None:
        raise InjectedIOError(f"{msg} at {ctx.get('point', '?')}")

    return act


def latency(seconds: float, sleep: Callable[[float], None] = time.sleep):
    def act(ctx: dict) -> None:
        sleep(seconds)

    return act


def crash(msg: str = "injected crash") -> Callable[[dict], None]:
    def act(ctx: dict) -> None:
        raise InjectedCrash(f"{msg} at {ctx.get('point', '?')}")

    return act


def hard_exit(code: int = 137) -> Callable[[dict], None]:
    """Immediate process death: no finally blocks, no atexit — the
    publish-window crash model. Only sane inside a child process."""

    def act(ctx: dict) -> None:
        os._exit(code)

    return act


def bit_flip(seed: int = 0, flips: int = 1) -> Callable[[dict, bytes], bytes]:
    """Flip `flips` seeded-random bits of the payload (no-op on empty)."""
    rng = random.Random(seed)

    def act(ctx: dict, data: bytes) -> bytes:
        if not data:
            return data
        buf = bytearray(data)
        for _ in range(flips):
            i = rng.randrange(len(buf))
            buf[i] ^= 1 << rng.randrange(8)
        return bytes(buf)

    return act


def truncate(keep_fraction: float = 0.5) -> Callable[[dict, bytes], bytes]:
    """Torn read/write: keep only a prefix of the payload."""

    def act(ctx: dict, data: bytes) -> bytes:
        return data[: int(len(data) * keep_fraction)]

    return act


def zero_fill() -> Callable[[dict, bytes], bytes]:
    """Return an all-zero payload of the same length (dropped DMA)."""

    def act(ctx: dict, data: bytes) -> bytes:
        return b"\x00" * len(data)

    return act


# --------------------------------------------------------------- registry


@dataclass
class _Fault:
    point: str
    action: Callable
    trigger: Callable[[], bool]
    count: int | None  # max fires; None = unlimited
    mutates: bool
    fired: int = 0
    hits: int = 0  # arrivals while armed (trigger evaluated)


@dataclass
class FaultHandle:
    """Returned by inject(); usable to remove the fault and observe it."""

    _registry: "FaultRegistry"
    _fault: _Fault = field(repr=False)

    @property
    def fired(self) -> int:
        return self._fault.fired

    @property
    def hits(self) -> int:
        return self._fault.hits

    def remove(self) -> None:
        self._registry.remove(self)


class FaultRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._faults: dict[str, list[_Fault]] = {}
        # Plain-bool fast-path flag, read unlocked in fire()/mutate().
        # inject() flips it under the lock after the fault is stored, so
        # an armed fault is never missed; a racing reader at worst takes
        # one extra locked lookup against an already-empty table.
        self.armed = False

    def inject(
        self,
        point: str,
        action: Callable,
        when: Callable[[], bool] | None = None,
        count: int | None = None,
        mutates: bool | None = None,
    ) -> FaultHandle:
        """Arm `action` at `point`. `when` defaults to always();
        `count` caps total fires. Mutation is auto-detected from the
        action arity unless `mutates` is passed."""
        if mutates is None:
            import inspect

            try:
                mutates = len(inspect.signature(action).parameters) >= 2
            except (TypeError, ValueError):
                mutates = False
        f = _Fault(
            point=point,
            action=action,
            trigger=when or always(),
            count=count,
            mutates=bool(mutates),
        )
        with self._lock:
            self._faults.setdefault(point, []).append(f)
            self.armed = True
        return FaultHandle(self, f)

    def remove(self, handle: FaultHandle) -> None:
        with self._lock:
            lst = self._faults.get(handle._fault.point)
            if lst and handle._fault in lst:
                lst.remove(handle._fault)
                if not lst:
                    del self._faults[handle._fault.point]
            self.armed = bool(self._faults)

    def clear(self) -> None:
        with self._lock:
            self._faults.clear()
            self.armed = False

    def _due(self, point: str, mutating: bool) -> list[_Fault]:
        """Trigger-evaluate every fault at `point`; return those firing
        now. Runs under the lock: triggers are cheap and stateful."""
        due = []
        with self._lock:
            for f in self._faults.get(point, ()):
                if f.mutates != mutating:
                    continue
                f.hits += 1
                if f.count is not None and f.fired >= f.count:
                    continue
                if f.trigger():
                    f.fired += 1
                    due.append(f)
        return due

    def fire(self, point: str, **ctx: Any) -> None:
        """Evaluate non-mutating faults at `point` (may raise/sleep)."""
        for f in self._due(point, mutating=False):
            ctx["point"] = point
            f.action(ctx)

    def mutate(self, point: str, data: bytes, **ctx: Any) -> bytes:
        """Run mutating faults at `point` over `data`."""
        for f in self._due(point, mutating=True):
            ctx["point"] = point
            data = f.action(ctx, data)
        return data

    def counters(self) -> dict[str, int]:
        """point -> total fires, for assertions and ops introspection."""
        with self._lock:
            out: dict[str, int] = {}
            for point, lst in self._faults.items():
                out[point] = sum(f.fired for f in lst)
            return out

    def armed_points(self) -> frozenset[str]:
        """The point names currently armed. Lets transport routers make
        NAMESPACE decisions instead of the all-or-nothing `armed` bool:
        the net plane refuses service while chaos targets storage-layer
        points (the Python fallback carries those), but keeps serving
        when the armed points live on the plane's own seams — otherwise
        its crash windows could never be exercised."""
        with self._lock:
            return frozenset(self._faults)


# Module-level singleton + free functions: the production call sites use
# these, so the disabled fast path is one global-bool check deep.

REGISTRY = FaultRegistry()


def fire(point: str, **ctx: Any) -> None:
    if not REGISTRY.armed:
        return
    REGISTRY.fire(point, **ctx)


def mutate(point: str, data: bytes, **ctx: Any) -> bytes:
    if not REGISTRY.armed:
        return data
    return REGISTRY.mutate(point, data, **ctx)


def inject(
    point: str,
    action: Callable,
    when: Callable[[], bool] | None = None,
    count: int | None = None,
    mutates: bool | None = None,
) -> FaultHandle:
    return REGISTRY.inject(point, action, when=when, count=count, mutates=mutates)


def clear() -> None:
    REGISTRY.clear()


def active() -> bool:
    return REGISTRY.armed


def armed_points() -> frozenset[str]:
    if not REGISTRY.armed:
        return frozenset()
    return REGISTRY.armed_points()


@contextmanager
def injected(
    point: str,
    action: Callable,
    when: Callable[[], bool] | None = None,
    count: int | None = None,
    mutates: bool | None = None,
) -> Iterator[FaultHandle]:
    h = inject(point, action, when=when, count=count, mutates=mutates)
    try:
        yield h
    finally:
        h.remove()
