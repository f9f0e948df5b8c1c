"""Pod-level stream placement: route EC streams to chips, not slices.

Port of seaweedfs_tpu/ec/chip_pool.py. When concurrent EC streams
outnumber chips, whole streams are placed on single chips, and a
column-mesh backend keeps the lone wide stream. Outputs are identical
either way (parity is columnwise-independent), so placement is purely a
scheduling decision.

Pieces
------

- :class:`ChipBackend` — a `TorchBackend` pinned to one card,
  ``cuda:i``, with ``chip_label = "cuda:i"``.
- :class:`ChipPool` — one per multi-device backend: per-chip backends
  built lazily, least-loaded routing over a `_PodLedger` shared per
  physical device set. The routing core is plain Python.
- :func:`place_stream` — the policy: route each new stream to the chip
  with the least outstanding cost (ledger charge plus the live queue
  load, plus `BREAKER_OPEN_PENALTY` for a chip whose breaker is open),
  keeping the mesh for a `wide` stream on an idle pod ("auto"), always
  ("mesh") or never ("chip"), per `QueueScope.placement`.

`pool_for` returns a pool only for a multi-device (column-mesh) backend.
The port has none until its `MeshRS` lands, so for every backend of the
port `pool_for` returns None and `place_stream` takes its single-device
branches: the original backend and its scope's queue. The pool itself
is process-wide (chips are physical), while each scope gets its own
per-chip `DeviceQueue`s (ec/device_queue.py).
"""

from __future__ import annotations

import threading
import weakref

import numpy as np

from ..utils import metrics as _M
from ..utils.retry import CircuitBreaker
from .backend import CpuBackend, FallbackBackend, TorchBackend, _BackendBase
from .device_queue import QueueScope, resolve_scope

# An open breaker means this chip's streams are failing over to the
# CPU: routing treats it as carrying this much extra outstanding cost,
# so a healthy sibling wins any close call while a pod with every
# breaker open still degrades instead of refusing.
BREAKER_OPEN_PENALTY = 1 << 40

_placement_decisions = _M.REGISTRY.counter(
    "sw_ec_placement_decisions_total",
    "EC stream placement decisions by the load signal that drove them "
    "(live = per-chip DeviceQueue.load() moved the pick, ledger = "
    "static stream cost hints alone, mesh = column-sliced)",
    ("signal",),
)


class ChipBackend(TorchBackend):
    """A `TorchBackend` pinned to one card ("cuda:i"): its staged
    copies and launches run on that device's streams, and its
    `chip_label` names the chip to the queue, the residency ledger and
    the flight recorder."""

    def __init__(self, ctx, device, impl: str = "cuda"):
        super().__init__(ctx, device=device, impl=impl)
        self.chip_label = str(self.device)


class _PodLedger:
    """Shared load/stream accounting for one physical pod: two backends
    over the same devices (other shard ratios) see each other's placed
    streams. `pool_for` shares one ledger per device set."""

    def __init__(self, n: int):
        self.lock = threading.Lock()
        self.load: list[int] = [0] * n
        self.streams: list[int] = [0] * n


class ChipPool:
    """Per-chip backends + least-loaded stream routing for one pod.

    `devices` is any sequence of placement targets and `make_chip(dev)`
    builds the backend for one of them. Load accounting is per placed
    stream: `acquire(cost_hint)` charges the stream's estimated total
    cost to the chosen chip until the returned release fires. Routing is
    deterministic given the arrival order: least outstanding cost, ties
    to the lowest chip index."""

    def __init__(self, devices, make_chip, labels=None, ledger=None):
        self.devices = list(devices)
        self._make_chip = make_chip
        self.labels = (
            list(labels) if labels is not None else [str(d) for d in self.devices]
        )
        self._ledger = ledger if ledger is not None else _PodLedger(len(self.devices))
        self._lock = self._ledger.lock
        self._chips: list = [None] * len(self.devices)

    @property
    def n_chips(self) -> int:
        return len(self.devices)

    def chip_backend(self, i: int):
        """The backend for chip `i`, built lazily outside the pod lock;
        two racers may both build, and the insert keeps one."""
        with self._lock:
            be = self._chips[i]
        if be is None:
            built = self._make_chip(self.devices[i])
            with self._lock:
                be = self._chips[i]
                if be is None:
                    be = self._chips[i] = built
        return be

    def loads(self) -> list[int]:
        with self._lock:
            return list(self._ledger.load)

    def idle(self) -> bool:
        """True when no stream is placed on any chip of the pod (any
        pool sharing this ledger counts)."""
        with self._lock:
            return not any(self._ledger.streams)

    def _release_fn(self, indices, hint):
        done = [False]
        led = self._ledger

        def release() -> None:
            with led.lock:
                if done[0]:
                    return
                done[0] = True
                for j in indices:
                    led.load[j] -= hint
                    led.streams[j] -= 1

        return release

    def acquire(
        self,
        cost_hint: int = 0,
        prefer_mesh: bool = False,
        force_mesh: bool = False,
        live_loads: "list[int] | None" = None,
    ):
        """Place one stream: returns (chip_index, backend, release).
        `release()` is idempotent and must fire when the stream closes.

        `live_loads` (per chip index) is added to the ledger's static
        charges when ranking chips. `prefer_mesh` takes the whole pod
        when it is idle, decided under the same lock as the charge
        (chip_index and backend come back None and every chip is
        charged); `force_mesh` charges the whole pod unconditionally."""
        hint = max(int(cost_hint), 1)
        led = self._ledger
        live = live_loads if live_loads is not None else [0] * len(self.devices)
        with self._lock:
            if force_mesh or (prefer_mesh and not any(led.streams)):
                indices = range(len(led.load))
                i = None
            else:
                i = min(range(len(led.load)), key=lambda j: (led.load[j] + live[j], j))
                indices = (i,)
            for j in indices:
                led.load[j] += hint
                led.streams[j] += 1
            release = self._release_fn(indices, hint)
        if i is None:
            return None, None, release
        try:
            be = self.chip_backend(i)
        except BaseException:
            # the charge landed before the lazy build: a failed build
            # must not leave phantom load on the pod ledger
            release()
            raise
        return i, be, release


# One pool per multi-device backend instance, the load ledger shared per
# physical device set.
_pools_lock = threading.Lock()
_pools: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_ledgers: dict = {}


def pool_for(backend) -> ChipPool | None:
    """The chip pool behind `backend`, or None when it is not a
    multi-device (column-mesh) backend. The port has no such backend
    yet, so this is None for every backend it builds; the devices of a
    pool come from the backend's own mesh, never from a fresh probe."""
    if backend is None:
        return None
    primary = getattr(backend, "primary", backend)
    mesh_rs = getattr(primary, "_mesh_rs", None)
    if mesh_rs is None or mesh_rs.n_devices < 2:
        return None
    with _pools_lock:
        pool = _pools.get(backend)
        if pool is None:
            devices = list(np.ravel(mesh_rs.mesh.devices))
            ctx = backend.ctx
            impl = getattr(primary, "impl", "cuda")
            wrap = isinstance(backend, FallbackBackend)
            cpu = CpuBackend(ctx) if wrap else None
            # plain values only: capturing `backend` would pin the weak
            # key through its own pool value
            brk_threshold = backend.breaker.failure_threshold if wrap else 0
            brk_timeout = backend.breaker.reset_timeout if wrap else 0.0

            def make_chip(dev):
                chip = ChipBackend(ctx, dev, impl=impl)
                if not wrap:
                    return chip
                # one breaker per chip, with the pooled backend's
                # thresholds: one chip's failures demote only its streams
                return FallbackBackend(chip, cpu, breaker=CircuitBreaker(
                    failure_threshold=brk_threshold, reset_timeout=brk_timeout,
                ))

            labels = [str(d) for d in devices]
            led_key = tuple(labels)
            ledger = _ledgers.get(led_key)
            if ledger is None:
                ledger = _ledgers[led_key] = _PodLedger(len(devices))
            pool = ChipPool(devices, make_chip, labels=labels, ledger=ledger)
            _pools[backend] = pool
    return pool


class Placement:
    """One stream's resolved (backend, queue) pair. `chip` is the chip
    index (None = the original backend: mesh slicing, or no pool).
    close() releases the chip-load charge; idempotent."""

    __slots__ = ("backend", "queue", "chip", "_release")

    def __init__(self, backend, queue, chip=None, release=None):
        self.backend = backend
        self.queue = queue
        self.chip = chip
        self._release = release

    def close(self) -> None:
        if self._release is not None:
            rel, self._release = self._release, None
            rel()

    def __enter__(self) -> "Placement":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def chip_load_hint(scope: QueueScope | None = None) -> dict[str, dict]:
    """Read-only per-chip load/breaker hint: {chip_label: {"load":
    outstanding cost units queued+in-flight, "breaker": state}}. Reads
    only the scope's existing queues; creates none."""
    return resolve_scope(scope).queue_loads()


def _live_loads_for(pool: ChipPool, scope: QueueScope) -> list[int]:
    """Per-chip-index live load aligned with `pool.labels`: the scope's
    own DeviceQueue.load() plus the residency ledger's cross-scope share
    (the scope's own in-flight cost subtracted, so it counts once) plus
    the breaker penalty. A chip with no state anywhere reads 0."""
    hint = scope.queue_loads()
    shared = scope.residency_loads()
    out = []
    for label in pool.labels:
        h = hint.get(label)
        load = 0
        own_inflight = 0
        if h is not None:
            load = int(h.get("load", 0))
            own_inflight = int(h.get("inflight_cost", 0))
        load += max(int(shared.get(label, 0)) - own_inflight, 0)
        if h is not None and h.get("breaker") == "open":
            load += BREAKER_OPEN_PENALTY
        out.append(load)
    return out


def place_stream(
    backend: _BackendBase | None,
    priority: str,
    *,
    scope: QueueScope | None = None,
    cost_hint: int = 0,
    wide: bool = False,
    span=None,
) -> Placement:
    """Resolve where one new EC stream runs.

    Returns a Placement whose `.backend` the producer uses for
    to_device / ..._staged / to_host and whose `.queue` its DeviceStream
    opens on (None = scheduler disabled: the stream dispatches
    directly). The caller must close() the placement when the stream
    ends.

    Policy (the scope's `placement`): "mesh" keeps the original backend;
    "chip" routes to the least-loaded chip of the pool; "auto" (default)
    routes to a chip except an explicitly `wide` stream on an idle pod.
    No pool (every backend of the port today) gives the original backend
    and its scope's queue. `priority` does not influence routing.

    `span` (utils/trace.py; None = disarmed) records a routing decision
    as a "placement" event with the loads it saw."""
    scope = resolve_scope(scope)
    if backend is None or not scope.enabled:
        return Placement(backend, None)
    mode = scope.placement
    pool = pool_for(backend)
    if mode == "mesh":
        if pool is None:
            return Placement(backend, scope.for_backend(backend))
        if span is not None:
            span.event(
                "placement", mode=mode, chip="mesh", signal="mesh",
                loads=pool.loads(), cost_hint=cost_hint, wide=wide,
                queue_load_hint=chip_load_hint(scope),
            )
        _placement_decisions.inc(signal="mesh")
        _, _, release = pool.acquire(cost_hint, force_mesh=True)
        return Placement(backend, scope.for_backend(backend), None, release)
    if pool is None or pool.n_chips < 2:
        return Placement(backend, scope.for_backend(backend))
    live = _live_loads_for(pool, scope)
    signal = "live" if any(live) else "ledger"
    loads_seen = pool.loads() if span is not None else None
    idx, chip_be, release = pool.acquire(
        cost_hint, prefer_mesh=(wide and mode == "auto"), live_loads=live,
    )
    if span is not None:
        span.event(
            "placement", mode=mode,
            chip=("mesh" if idx is None else pool.labels[idx]),
            signal=("mesh" if idx is None else signal),
            loads=loads_seen, live_loads=live, cost_hint=cost_hint, wide=wide,
            queue_load_hint=chip_load_hint(scope),
        )
    _placement_decisions.inc(signal=("mesh" if idx is None else signal))
    if idx is None:
        return Placement(backend, scope.for_backend(backend), None, release)
    try:
        chip_queue = scope.for_backend(chip_be)
    except BaseException:
        release()
        raise
    return Placement(chip_be, chip_queue, idx, release)
