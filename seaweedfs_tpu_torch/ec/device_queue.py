"""Shared per-chip device-queue scheduler for the EC compute pipeline.

Port of seaweedfs_tpu/ec/device_queue.py, whole: the priority classes,
`batch_cost`, `DeviceStream` and `DeviceQueue` (class shares, credit
cap, admission timeout), the process-wide `ResidencyLedger` (slot
budget per physical chip, tenant window, shed levels, breaker feed,
starvation bound), `QueueScope` and the module functions, with the
JAX package's 12 `sw_ec_queue_*` / `sw_ec_residency_*` families (HELP
and TYPE text identical). It imports no device code: every decision is
host-side Python.

Model
-----

One `DeviceQueue` per (scope, backend). A single-device backend is one
chip (`TorchBackend` has no `chip_label`, so its queue label is its
class name, shard ratio and an instance tag, as a single-device
`JaxBackend`'s is); a pool's chip (ec/chip_pool.py `ChipBackend`) is
labeled "cuda:i". Producers open a `DeviceStream` tagged with a priority
class and submit batches through it; the queue admits batch dispatches
(the H2D copy + kernel launch) one at a time under a policy, and bounds
the total number of in-flight device batches across all streams
(`window`). With the scheduler disabled there is no queue, and
:func:`open_stream` gives a `DirectStream` (the same surface, no
admission) and :func:`admission` a context that admits at once, so each
call site keeps one path; the port's addition, the JAX call sites keep
two.

Priority classes, highest first:

- ``foreground`` — encode, degraded reads, streams (serving traffic);
- ``recovery``  — rebuild, decode self-heal (restore redundancy);
- ``scrub``     — scrub-initiated repair (background hygiene).

Admission is denominated in cost units: one unit is one output
row-byte (``out_rows x batch_width``, :func:`batch_cost`). It is strict
priority with a weighted-deficit minimum share for the background
classes: every cost unit admitted for a higher class banks
``share/(1-share)`` units of credit for each lower class that has work
waiting; a lower class whose credit covers its head batch is admitted
ahead of the higher class. ``share=0`` is strict priority for that class.

Fault semantics are per stream: the queue never touches batch payloads
or results, so a `FallbackBackend` device failure between dispatch and
drain replays only the failing stream's batches on the CPU, and a
stream that dies releases its window slots (`DeviceStream.close`).

Scopes and residency
--------------------

Knobs live in a :class:`QueueScope` with its own queue registry; the
module functions operate on the process-wide default scope. Under the
scopes, ONE process-wide :class:`ResidencyLedger` charges a slot per
physical chip key in a second admission phase, so per-scope windows are
sub-budgets of the chip's bound; it orders contended grants by
(starvation bound, priority class, the tenant's windowed cost), raises
a per-chip shed level under sustained saturation (an open breaker one
level more: scrub deferred at 1, recovery at 2, over-share tenants shed
by :func:`shed_advice` at 3), and surfaces its state through
:func:`residency_snapshot` and ``sw_ec_residency_*``.

Env knobs (read as in the JAX package): ``SEAWEED_EC_RESIDENCY_WINDOW``
(per-chip slot budget, default 4; 0 disables the ledger),
``SEAWEED_EC_TENANT_STARVE_S`` (30), ``SEAWEED_EC_SHED_AFTER_S`` (5),
``SEAWEED_EC_SHED_RETRY_S`` (2), ``SEAWEED_EC_TENANT_WINDOW_S`` (10).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import weakref
from collections import deque

from .. import faults
from ..utils import metrics as _M
from .context import ECError

# Highest priority first; admission prefers earlier classes.
PRIORITIES = ("foreground", "recovery", "scrub")

# Minimum admitted-cost share per background class under saturation.
# Small on purpose: this is a SERVING store — repair proceeds, but
# foreground keeps ~90% of the chip when it wants it (the JAX bench's
# acceptance bar is foreground >= 85% of isolated throughput with a
# concurrent rebuild stream still making progress).
DEFAULT_SHARES = {"recovery": 0.10, "scrub": 0.02}

# Default bound on in-flight device batches across ALL streams of one
# chip. The per-call-site windows allowed ~2*queue_size = 4 staged
# batches each; the shared window keeps the same residency for the chip
# as one saturated call site used to claim.
DEFAULT_WINDOW = 4

# Stream placement policy for multi-chip (mesh-capable) backends — see
# ec/chip_pool.py. "auto" routes each new stream to the least-loaded
# chip unless the stream is explicitly wide and the pod is idle;
# "chip" always routes; "mesh" always column-slices.
PLACEMENT_MODES = ("auto", "mesh", "chip")
DEFAULT_PLACEMENT = "auto"

# Credit never banks more than this many cost units per class: a
# background class idle through a long foreground burst must not repay
# itself with an equally long background burst afterwards.
CREDIT_CAP_COST = 1 << 30

# Admission liveness bound. Window slots are freed by OTHER streams'
# drain threads; a stream wedged in to_host against a hung device holds
# its slots and (unlike the pre-scheduler private windows) would freeze
# every other stream's dispatch on the chip, silently and forever —
# run_pipeline's join_timeout can never fire for a thread stuck INSIDE
# the transform stage. Past this deadline admission raises instead:
# a loud per-stream ECError (callers fail/retry/fall back) beats a
# chip-wide freeze with no error. Generous on purpose — only a truly
# wedged chip waits minutes for a slot.
DEFAULT_ADMIT_TIMEOUT = 300.0

_queue_depth = _M.REGISTRY.gauge(
    "sw_ec_queue_depth", "EC device-queue waiting batches", ("cls", "chip")
)
_queue_inflight = _M.REGISTRY.gauge(
    "sw_ec_queue_inflight", "EC device-queue in-flight batches", ("cls", "chip")
)
_queue_admitted = _M.REGISTRY.counter(
    "sw_ec_queue_admitted_total",
    "EC device-queue admitted batches", ("cls", "chip"),
)
_queue_admitted_cost = _M.REGISTRY.counter(
    "sw_ec_queue_admitted_cost_total",
    "EC device-queue admitted cost units (output rows x batch width)",
    ("cls", "chip"),
)
_queue_wait_seconds = _M.REGISTRY.counter(
    "sw_ec_queue_wait_seconds_total",
    "EC device-queue admission wait", ("cls", "chip"),
)

# ---- residency defaults (env-tunable; see README env-knob registry) ----

# Per-physical-chip in-flight slot budget of the process-wide ledger.
# Defaults to DEFAULT_WINDOW so a single scope per chip behaves exactly
# as before — the ledger only binds once a SECOND scope (or a mesh-wide
# stream) shows up on the chip. 0 disables the global ledger.
DEFAULT_RESIDENCY_BUDGET = DEFAULT_WINDOW

# Starvation bound: a waiter older than this goes ahead of every
# fairness/shed consideration — the hard ceiling on how long tenant
# weighting or background deferral may hold anyone back.
DEFAULT_STARVE_S = 30.0

# Sustained-saturation threshold: a chip full with waiters queued for
# this long enters shed level 1 (scrub deferred); 3x = level 2
# (recovery deferred too); 6x = level 3 (over-share tenants shed at
# the front ends).
DEFAULT_SHED_AFTER_S = 5.0

# Base Retry-After (seconds) handed to shed tenants.
DEFAULT_SHED_RETRY_S = 2.0

# Tenant fairness accounting window: admitted cost is summed over a
# sliding ~2x this span (two rotating buckets) — recent behavior, not
# lifetime totals, decides who the storm tenant is.
DEFAULT_TENANT_WINDOW_S = 10.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


_res_budget_g = _M.REGISTRY.gauge(
    "sw_ec_residency_budget",
    "EC residency-ledger in-flight slot budget per physical chip",
    ("chip",),
)
_res_inflight_g = _M.REGISTRY.gauge(
    "sw_ec_residency_inflight",
    "EC residency-ledger in-flight batches per physical chip "
    "(all scopes + mesh streams combined)",
    ("chip",),
)
_res_pressure_g = _M.REGISTRY.gauge(
    "sw_ec_residency_pressure",
    "EC residency shed level per chip (0 ok, 1 scrub deferred, "
    "2 recovery deferred, 3 over-share tenants shed)",
    ("chip",),
)
_res_admitted = _M.REGISTRY.counter(
    "sw_ec_residency_admitted_total",
    "EC residency-ledger admitted batches", ("tenant", "chip"),
)
_res_admitted_cost = _M.REGISTRY.counter(
    "sw_ec_residency_admitted_cost_total",
    "EC residency-ledger admitted cost units", ("tenant", "chip"),
)
_res_wait_seconds = _M.REGISTRY.counter(
    "sw_ec_residency_wait_seconds_total",
    "EC residency-ledger acquire wait (the second admission phase, "
    "charged on top of the scope queue's own wait)",
    ("tenant", "chip"),
)
_res_shed = _M.REGISTRY.counter(
    "sw_ec_residency_shed_total",
    "front-end requests shed (503 SlowDown) per tenant by the "
    "residency pressure policy",
    ("tenant",),
)


def batch_cost(out_rows: int, width: int) -> int:
    """Admission cost of one batch: output rows x batch width (bytes per
    row). Tracks device time — a GF(256) apply computes out_rows x k x
    width byte-products, and k is fixed per volume — so a 1-row
    reconstruction is ~1/m the cost of a parity encode at equal width."""
    return max(int(out_rows), 1) * max(int(width), 1)


class _Waiter:
    __slots__ = ("priority", "cost", "t_submit")

    def __init__(self, priority: str, cost: int, t_submit: float):
        self.priority = priority
        self.cost = cost
        self.t_submit = t_submit


class Ticket:
    """One admitted (in-flight) batch; released after to_host drains it
    (or the stream dies). Idempotent release — close() may race a drain
    thread's finally. `wait_s` is the admission wait this batch paid
    (the flight recorder's "admission_wait" stage)."""

    __slots__ = ("priority", "cost", "released", "wait_s", "res")

    def __init__(self, priority: str, cost: int, wait_s: float = 0.0):
        self.priority = priority
        self.cost = cost
        self.released = False
        self.wait_s = wait_s
        # (ledger, _ResTicket) once the residency phase charged the
        # physical chip; None for ledger-less queues
        self.res = None


class ClassStats:
    __slots__ = (
        "submitted", "admitted", "admitted_cost", "drained",
        "drained_cost", "wait_s_total", "wait_s_max", "inflight",
    )

    def __init__(self):
        self.submitted = 0
        self.admitted = 0
        self.admitted_cost = 0
        self.drained = 0
        self.drained_cost = 0
        self.wait_s_total = 0.0
        self.wait_s_max = 0.0
        self.inflight = 0

    def as_dict(self, depth: int) -> dict:
        return {
            "depth": depth,
            "inflight": self.inflight,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "admitted_cost": self.admitted_cost,
            "drained": self.drained,
            "drained_cost": self.drained_cost,
            "wait_s_total": round(self.wait_s_total, 6),
            "wait_s_max": round(self.wait_s_max, 6),
        }


class DeviceStream:
    """One producer's tagged batch stream into a DeviceQueue. Not
    thread-safe for concurrent dispatch (each pipeline dispatches from
    one thread), but release/close may run from the drain thread.
    `span` (utils/trace.py, None = tracer disarmed) gets per-batch
    "admission_wait" and "h2d_dispatch" stages labeled with this
    queue's chip."""

    def __init__(
        self,
        queue: "DeviceQueue",
        priority: str,
        label: str = "",
        span=None,
    ):
        self.queue = queue
        self.priority = priority
        self.label = label
        self.span = span
        self._outstanding: set[Ticket] = set()
        self._lock = threading.Lock()

    def dispatch(self, fn, cost: int):
        """Block until this stream's batch is admitted under the queue
        policy, then run `fn()` (the caller's H2D upload + non-blocking
        device dispatch) and return ``(ticket, handle)``. `cost` is the
        batch's admission weight in cost units (see :func:`batch_cost`).
        The window slot is held until :meth:`release` — call it after
        `to_host` completes (success OR failure). If `fn` itself raises
        (device refused the dispatch; FallbackBackend turns that into a
        CPU handle instead, so this is the raw-backend path), the slot
        is released before the exception propagates."""
        ticket = self.queue._admit(self.priority, cost)
        span = self.span
        if span is not None:
            span.add_stage(
                "admission_wait", ticket.wait_s, self.queue.label
            )
        with self._lock:
            self._outstanding.add(ticket)
        ok = False
        t0 = time.perf_counter() if span is not None else 0.0
        try:
            handle = fn()
            ok = True
        finally:
            if span is not None:
                span.add_stage(
                    "h2d_dispatch",
                    time.perf_counter() - t0,
                    self.queue.label,
                )
            if not ok:
                self.release(ticket)
        return ticket, handle

    def release(self, ticket: Ticket) -> None:
        with self._lock:
            self._outstanding.discard(ticket)
        self.queue._release(ticket)

    def close(self) -> None:
        """Release any slots this stream still holds — the leak-proofing
        for a pipeline that aborted with batches parked in its write
        queue (whose drain stage will never run)."""
        with self._lock:
            leftover = list(self._outstanding)
            self._outstanding.clear()
        for t in leftover:
            self.queue._release(t)

    def __enter__(self) -> "DeviceStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class DirectStream:
    """A stream with no queue behind it (the scheduler disabled):
    DeviceStream's surface, so a call site keeps one path whether the
    scope is enabled or not. `dispatch` runs `fn()` at once and returns
    a ticket that waited 0 s, recording "h2d_dispatch" on `span` labeled
    `chip`, as the unscheduled call sites of the JAX package label it;
    `release` and `close` have nothing to free."""

    def __init__(self, priority: str, chip: str = "", span=None):
        self.priority = priority
        self.chip = chip
        self.span = span

    def dispatch(self, fn, cost: int):
        t0 = time.perf_counter()
        try:
            return Ticket(self.priority, cost), fn()
        finally:
            if self.span is not None:
                self.span.add_stage("h2d_dispatch", time.perf_counter() - t0, self.chip)

    def release(self, ticket: Ticket) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "DirectStream":
        return self

    def __exit__(self, *exc) -> None:
        pass


def open_stream(queue, priority: str, label: str = "", span=None, chip: str = ""):
    """`queue`'s DeviceStream, or with no queue (the scheduler disabled)
    a DirectStream whose stages carry `chip`."""
    if queue is None:
        return DirectStream(priority, chip, span)
    return queue.stream(priority, label=label, span=span)


def admission(queue, priority: str, cost: int, span=None):
    """`queue.admission(...)`, or with no queue a context that admits at
    once and records nothing."""
    if queue is None:
        return contextlib.nullcontext()
    return queue.admission(priority, cost, span=span)


class DeviceQueue:
    """Priority-multiplexed admission scheduler for one chip. See the
    module docstring for the policy. `label` identifies the chip in
    stats and metrics (device id for pool chips)."""

    def __init__(
        self,
        window: int = DEFAULT_WINDOW,
        shares: dict[str, float] | None = None,
        clock=time.monotonic,
        admit_timeout: float = DEFAULT_ADMIT_TIMEOUT,
        label: str = "",
        residency: "ResidencyLedger | None" = None,
        res_keys: tuple[str, ...] = (),
        tenant: str = "default",
    ):
        self.window = max(1, int(window))
        self.admit_timeout = float(admit_timeout)
        self.label = label
        # Second admission phase: the process-wide physical ledger this
        # queue charges per batch (None = logical window only), the
        # chip keys one batch occupies, and the tenant the charge is
        # accounted to (QueueScope wiring).
        self.residency = residency
        self.res_keys = tuple(res_keys) or (label or "unlabeled",)
        self.tenant = tenant
        self.shares = dict(DEFAULT_SHARES)
        if shares:
            for cls, s in shares.items():
                if cls not in PRIORITIES:
                    raise ECError(f"unknown priority class {cls!r}")
                self.shares[cls] = min(max(float(s), 0.0), 0.9)
        self._cond = threading.Condition()
        self._waiters: dict[str, deque[_Waiter]] = {
            c: deque() for c in PRIORITIES
        }
        self._credit: dict[str, float] = {c: 0.0 for c in PRIORITIES}
        self._inflight = 0
        # Total un-drained cost (waiting + in-flight): live-load
        # introspection and chip_pool's live routing signal
        # (QueueScope.queue_loads).
        self._pending_cost = 0
        # In-flight cost alone (no queued waiters): lets chip_pool
        # subtract THIS scope's share from the shared ledger's per-chip
        # cost so cross-scope load is added exactly once.
        self._inflight_cost = 0
        self._stats: dict[str, ClassStats] = {c: ClassStats() for c in PRIORITIES}
        self._clock = clock
        # Liveness signal for the admission deadline: bumped on every
        # admit AND release. A waiter past its deadline while this keeps
        # moving is merely bypassed (e.g. share=0 strict priority under
        # sustained foreground) — that is the configured behavior, not a
        # wedge; only a chip with NO progress for the whole window
        # raises.
        self._last_progress = clock()

    # ------------------------------------------------------------ public

    def stream(
        self, priority: str, label: str = "", span=None
    ) -> DeviceStream:
        if priority not in PRIORITIES:
            raise ECError(
                f"unknown priority class {priority!r} (want one of {PRIORITIES})"
            )
        return DeviceStream(self, priority, label, span=span)

    @contextlib.contextmanager
    def admission(self, priority: str, cost: int, span=None):
        """One-shot admission for work that is not a staged batch
        stream — e.g. a single-shot degraded-read reconstruction on the
        gateway serving path. Blocks until this queue admits `cost`
        units in `priority`'s class, holds ONE window slot for the body
        of the ``with``, and releases it on exit (success or raise).
        The admission wait is recorded on `span` as the
        "admission_wait" stage labeled with this queue's chip, exactly
        like the staged path's, so per-stage attribution shows where a
        scheduled read waited."""
        if priority not in PRIORITIES:
            raise ECError(
                f"unknown priority class {priority!r} (want one of {PRIORITIES})"
            )
        ticket = self._admit(priority, cost)
        if span is not None:
            span.add_stage("admission_wait", ticket.wait_s, self.label)
        try:
            yield ticket
        finally:
            self._release(ticket)

    def stats(self) -> dict:
        with self._cond:
            return {
                c: self._stats[c].as_dict(len(self._waiters[c]))
                for c in PRIORITIES
            }

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    def load(self) -> int:
        """Queued + in-flight cost units not yet drained."""
        with self._cond:
            return self._pending_cost

    # ------------------------------------------------------------ policy

    def _pick(self) -> _Waiter | None:
        """Next admissible waiter (under self._cond). Only head-of-class
        waiters are eligible, so per-stream FIFO order is preserved by
        construction."""
        if self._inflight >= self.window:
            return None
        nonempty = [c for c in PRIORITIES if self._waiters[c]]
        if not nonempty:
            return None
        # A lower class whose banked credit covers its head batch is due
        # ahead of the best class — the minimum-share guarantee. Among
        # due classes, the higher-priority one wins (recovery > scrub).
        for c in nonempty[1:]:
            if self._credit[c] >= self._waiters[c][0].cost:
                return self._waiters[c][0]
        return self._waiters[nonempty[0]][0]

    def _admit(self, priority: str, cost: int) -> Ticket:
        cost = max(int(cost), 1)
        w = _Waiter(priority, cost, self._clock())
        with self._cond:
            self._waiters[priority].append(w)
            self._pending_cost += cost
            st = self._stats[priority]
            st.submitted += 1
            _queue_depth.inc(cls=priority, chip=self.label)
            while self._pick() is not w:
                deadline = (
                    max(w.t_submit, self._last_progress) + self.admit_timeout
                )
                left = deadline - self._clock()
                if left <= 0 or not self._cond.wait(timeout=left):
                    if self._pick() is w:  # admitted at the wire
                        break
                    if self._clock() - self._last_progress < self.admit_timeout:
                        continue  # bypassed, not wedged: keep waiting
                    # Liveness escape: window slots are freed by other
                    # streams' drains; a full deadline with NO admit or
                    # release anywhere means the chip is wedged (e.g. a
                    # stream stuck in to_host against a hung device
                    # holding every slot). Fail THIS stream loudly
                    # instead of freezing the whole chip's dispatch
                    # silently forever.
                    self._waiters[priority].remove(w)
                    self._pending_cost -= cost
                    _queue_depth.dec(cls=priority, chip=self.label)
                    self._cond.notify_all()
                    raise ECError(
                        f"device queue admission timed out after "
                        f"{self.admit_timeout:.0f}s without progress "
                        f"({priority}, inflight="
                        f"{self._inflight}/{self.window}): chip wedged?"
                    )
            popped = self._waiters[priority].popleft()
            assert popped is w  # only heads are ever picked
            _queue_depth.dec(cls=priority, chip=self.label)
            # Bank minimum-share credit for every lower class with work
            # waiting; spend this class's own credit (floored at 0 so a
            # work-conserving free ride never becomes debt).
            idx = PRIORITIES.index(priority)
            for lower in PRIORITIES[idx + 1 :]:
                if self._waiters[lower]:
                    s = self.shares.get(lower, 0.0)
                    if s > 0.0:
                        self._credit[lower] = min(
                            self._credit[lower] + cost * s / (1.0 - s),
                            float(CREDIT_CAP_COST),
                        )
            self._credit[priority] = max(self._credit[priority] - cost, 0.0)
            self._inflight += 1
            self._last_progress = self._clock()
            wait_s = max(self._clock() - w.t_submit, 0.0)
            st.admitted += 1
            st.admitted_cost += cost
            st.inflight += 1
            st.wait_s_total += wait_s
            st.wait_s_max = max(st.wait_s_max, wait_s)
            _queue_inflight.inc(cls=priority, chip=self.label)
            _queue_admitted.inc(cls=priority, chip=self.label)
            _queue_admitted_cost.inc(cost, cls=priority, chip=self.label)
            _queue_wait_seconds.inc(wait_s, cls=priority, chip=self.label)
            self._inflight_cost += cost
            # Another slot may still be free for the next waiter.
            self._cond.notify_all()
        ticket = Ticket(priority, cost, wait_s)
        # Phase 2, OUTSIDE self._cond (the ledger has its own lock —
        # never nested): charge the physical chip(s). The local slot is
        # held while we wait here, which is exactly the sub-budget
        # semantics — this scope's window counts against the chip's
        # physical bound, it does not add to it. On failure the local
        # slot is returned before the error propagates.
        if self.residency is not None:
            t0 = self._clock()
            try:
                res = self.residency.acquire(
                    self.res_keys, self.tenant, priority, cost,
                    timeout=self.admit_timeout,
                )
            except BaseException:
                self._release(ticket)
                raise
            ticket.res = (self.residency, res)
            rwait = max(self._clock() - t0, 0.0)
            if rwait > 0.0:
                # the residency wait is part of this batch's admission
                # wait: fold it into the ticket (span stage) and stats
                ticket.wait_s += rwait
                with self._cond:
                    st = self._stats[priority]
                    st.wait_s_total += rwait
                    st.wait_s_max = max(st.wait_s_max, ticket.wait_s)
                _queue_wait_seconds.inc(rwait, cls=priority, chip=self.label)
        return ticket

    def _release(self, ticket: Ticket) -> None:
        res = None
        with self._cond:
            if ticket.released:
                return
            ticket.released = True
            res, ticket.res = ticket.res, None
            self._inflight -= 1
            self._pending_cost -= ticket.cost
            self._inflight_cost -= ticket.cost
            self._last_progress = self._clock()
            st = self._stats[ticket.priority]
            st.inflight -= 1
            st.drained += 1
            st.drained_cost += ticket.cost
            _queue_inflight.dec(cls=ticket.priority, chip=self.label)
            self._cond.notify_all()
        if res is not None:
            ledger, rt = res
            ledger.release(rt)


# --------------------------------------------------------------------------
# Residency: the physical admission layer under the scopes. ONE ledger
# per process (or one injected per test/bench), ONE lock for all chips
# — a mesh-wide stream acquires every chip it spans atomically, with no
# per-chip lock ordering to deadlock on.
# --------------------------------------------------------------------------


class _ResTicket:
    """One granted residency charge: `keys` are the physical chips
    holding a slot each until release. Idempotent release."""

    __slots__ = ("keys", "tenant", "priority", "cost", "released", "wait_s")

    def __init__(self, keys, tenant, priority, cost, wait_s):
        self.keys = keys
        self.tenant = tenant
        self.priority = priority
        self.cost = cost
        self.released = False
        self.wait_s = wait_s


class _ResWaiter:
    __slots__ = ("keys", "tenant", "priority", "cost", "t_submit", "seq")

    def __init__(self, keys, tenant, priority, cost, t_submit, seq):
        self.keys = keys
        self.tenant = tenant
        self.priority = priority
        self.cost = cost
        self.t_submit = t_submit
        self.seq = seq


class _ChipState:
    __slots__ = (
        "key", "budget", "inflight", "inflight_cost", "max_inflight",
        "max_inflight_cost", "admitted", "admitted_cost", "over_since",
        "breakers",
    )

    def __init__(self, key: str, budget: int):
        self.key = key
        self.budget = budget
        self.inflight = 0
        self.inflight_cost = 0
        # Watermarks are the chaos tests' GROUND TRUTH for the
        # invariant "N scopes on one chip never exceed the budget":
        # they record the worst concurrency the ledger ever granted,
        # not a sample that a racing reader could miss.
        self.max_inflight = 0
        self.max_inflight_cost = 0
        self.admitted = 0
        self.admitted_cost = 0
        # Wall time when the chip went full WITH waiters queued; None
        # while it has headroom. Sustained over_since drives the shed
        # level.
        self.over_since = None
        # weakrefs to this chip's fallback breakers (chip_pool wires
        # one per chip): an OPEN breaker means the chip's streams run
        # on CPU — degraded capacity feeds the shed level directly.
        self.breakers: list = []

    def breaker_open(self) -> bool:
        alive = []
        opened = False
        for ref in self.breakers:
            brk = ref()
            if brk is None:
                continue
            alive.append(ref)
            if getattr(brk, "state", "") == "open":
                opened = True
        self.breakers = alive
        return opened


class ResidencyLedger:
    """Process-wide per-physical-chip slot budget + tenant fairness +
    shed policy. Every DeviceQueue charges it in a second admission
    phase (after its own scope window), so the per-scope windows become
    sub-budgets of the chip's physical bound. See the module docstring
    for the policy; `budget`/`clock` are injectable for tests/bench."""

    def __init__(
        self,
        budget: int | None = None,
        starve_s: float | None = None,
        shed_after_s: float | None = None,
        shed_retry_s: float | None = None,
        tenant_window_s: float | None = None,
        clock=time.monotonic,
    ):
        if budget is None:
            budget = int(_env_float(
                "SEAWEED_EC_RESIDENCY_WINDOW", DEFAULT_RESIDENCY_BUDGET
            ))
        self.budget = max(1, int(budget))
        self.starve_s = float(
            starve_s if starve_s is not None
            else _env_float("SEAWEED_EC_TENANT_STARVE_S", DEFAULT_STARVE_S)
        )
        self.shed_after_s = float(
            shed_after_s if shed_after_s is not None
            else _env_float("SEAWEED_EC_SHED_AFTER_S", DEFAULT_SHED_AFTER_S)
        )
        self.shed_retry_s = float(
            shed_retry_s if shed_retry_s is not None
            else _env_float("SEAWEED_EC_SHED_RETRY_S", DEFAULT_SHED_RETRY_S)
        )
        self.tenant_window_s = max(float(
            tenant_window_s if tenant_window_s is not None
            else _env_float(
                "SEAWEED_EC_TENANT_WINDOW_S", DEFAULT_TENANT_WINDOW_S
            )
        ), 0.001)
        self._clock = clock
        self._cond = threading.Condition()
        self._chips: dict[str, _ChipState] = {}
        self._waiters: list[_ResWaiter] = []
        self._seq = itertools.count()
        self._last_progress = clock()
        # Tenant fairness accounting: admitted cost in two rotating
        # buckets (~2x tenant_window_s of history) — the virtual-time
        # signal that ranks a storm tenant behind a quiet one.
        self._tcost_cur: dict[str, float] = {}
        self._tcost_prev: dict[str, float] = {}
        self._bucket_start = clock()
        self._shed_counts: dict[str, int] = {}

    # ------------------------------------------------------------ internals

    def _chip(self, key: str) -> _ChipState:
        ch = self._chips.get(key)
        if ch is None:
            ch = self._chips[key] = _ChipState(key, self.budget)
            _res_budget_g.set(ch.budget, chip=key)
        return ch

    def _rotate_buckets(self, now: float) -> None:
        if now - self._bucket_start >= self.tenant_window_s:
            if now - self._bucket_start >= 2 * self.tenant_window_s:
                self._tcost_prev = {}
            else:
                self._tcost_prev = self._tcost_cur
            self._tcost_cur = {}
            self._bucket_start = now

    def _tenant_cost(self, tenant: str) -> float:
        return self._tcost_cur.get(tenant, 0.0) + self._tcost_prev.get(
            tenant, 0.0
        )

    def _update_pressure(self, now: float) -> None:
        waiting = set()
        for w in self._waiters:
            waiting.update(w.keys)
        for key, ch in self._chips.items():
            if ch.inflight >= ch.budget and key in waiting:
                if ch.over_since is None:
                    ch.over_since = now
            else:
                ch.over_since = None

    def _level(self, ch: _ChipState, now: float) -> int:
        lvl = 0
        if ch.over_since is not None:
            dur = now - ch.over_since
            if dur >= self.shed_after_s:
                lvl = 1
            if dur >= 3 * self.shed_after_s:
                lvl = 2
            if dur >= 6 * self.shed_after_s:
                lvl = 3
        if ch.breakers and ch.breaker_open():
            # a breaker-open chip is already degraded to CPU fallback:
            # escalate one level so background work yields sooner
            lvl = min(lvl + 1, 3)
        return lvl

    def _deferred(self, w: _ResWaiter, now: float) -> bool:
        """Graceful shedding, background first: scrub yields at level
        1+, recovery at level 2+. Foreground is never deferred here —
        its relief valve is shed_advice at the front ends. The
        starvation bound trumps deferral so a background class is
        slowed, never starved."""
        if w.priority == "foreground":
            return False
        if now - w.t_submit > self.starve_s:
            return False
        threshold = 1 if w.priority == "scrub" else 2
        return any(
            self._level(self._chip(k), now) >= threshold for k in w.keys
        )

    def _rank(self, w: _ResWaiter, now: float):
        starving = 0 if (now - w.t_submit > self.starve_s) else 1
        return (
            starving,
            PRIORITIES.index(w.priority),
            self._tenant_cost(w.tenant),
            w.seq,
        )

    def _fits(self, w: _ResWaiter) -> bool:
        return all(
            self._chip(k).inflight < self._chip(k).budget for k in w.keys
        )

    def _grantable(self, w: _ResWaiter, now: float) -> bool:
        if not self._fits(w) or self._deferred(w, now):
            return False
        # No better-ranked live contender on any shared chip: a wide
        # mesh waiter spanning this chip blocks a chip-local grant (it
        # must win eventually — head-of-line by design, so wide streams
        # cannot be starved by a trickle of single-chip admits).
        mine = self._rank(w, now)
        keys = set(w.keys)
        for other in self._waiters:
            if other is w or not (keys & set(other.keys)):
                continue
            if self._deferred(other, now):
                continue
            if self._rank(other, now) < mine:
                return False
        return True

    # ------------------------------------------------------------ public

    def acquire(
        self,
        keys,
        tenant: str,
        priority: str,
        cost: int,
        timeout: float = DEFAULT_ADMIT_TIMEOUT,
    ) -> _ResTicket:
        """Block until every chip in `keys` has a free slot AND this
        waiter is first under the fairness policy, then charge one slot
        per chip. Multi-chip acquire is atomic (one lock). Raises
        ECError past `timeout` with NO ledger progress anywhere (the
        same liveness contract as DeviceQueue._admit: merely being
        bypassed by the policy keeps waiting)."""
        faults.fire(
            "ec.residency.acquire", tenant=tenant, priority=priority,
        )
        keys = tuple(dict.fromkeys(keys))
        if not keys:
            raise ECError("residency acquire with no chip keys")
        cost = max(int(cost), 1)
        with self._cond:
            now = self._clock()
            self._rotate_buckets(now)
            w = _ResWaiter(keys, tenant, priority, cost, now, next(self._seq))
            self._waiters.append(w)
            try:
                self._update_pressure(now)
                while not self._grantable(w, self._clock()):
                    now = self._clock()
                    self._update_pressure(now)
                    deadline = (
                        max(w.t_submit, self._last_progress) + timeout
                    )
                    left = deadline - now
                    if left <= 0 or not self._cond.wait(
                        timeout=min(left, 1.0)
                    ):
                        now = self._clock()
                        if self._grantable(w, now):
                            break
                        if now - self._last_progress < timeout:
                            # bypassed (fairness/deferral), not wedged:
                            # pressure levels and starvation age change
                            # with TIME, so re-check at least once a
                            # second even with no release to notify us
                            continue
                        raise ECError(
                            f"residency acquire timed out after "
                            f"{timeout:.0f}s without progress "
                            f"(tenant={tenant}, {priority}, "
                            f"chips={','.join(keys)}): pod wedged?"
                        )
            finally:
                self._waiters.remove(w)
                # grant or abort, the next waiter may now be eligible
                self._cond.notify_all()
            now = self._clock()
            self._rotate_buckets(now)
            for k in keys:
                ch = self._chip(k)
                ch.inflight += 1
                ch.inflight_cost += cost
                ch.max_inflight = max(ch.max_inflight, ch.inflight)
                ch.max_inflight_cost = max(
                    ch.max_inflight_cost, ch.inflight_cost
                )
                ch.admitted += 1
                ch.admitted_cost += cost
                _res_inflight_g.set(ch.inflight, chip=k)
                _res_admitted.inc(tenant=tenant, chip=k)
                _res_admitted_cost.inc(cost, tenant=tenant, chip=k)
            # fairness is denominated in WORK, charged once per batch
            # (a wide stream does one batch of work, not one per chip)
            self._tcost_cur[tenant] = (
                self._tcost_cur.get(tenant, 0.0) + cost
            )
            self._last_progress = now
            self._update_pressure(now)
            wait_s = max(now - w.t_submit, 0.0)
            _res_wait_seconds.inc(wait_s, tenant=tenant, chip=keys[0])
        return _ResTicket(keys, tenant, priority, cost, wait_s)

    def release(self, ticket: _ResTicket) -> None:
        with self._cond:
            if ticket.released:
                return
            ticket.released = True
            for k in ticket.keys:
                ch = self._chip(k)
                ch.inflight -= 1
                ch.inflight_cost -= ticket.cost
                _res_inflight_g.set(ch.inflight, chip=k)
            now = self._clock()
            self._last_progress = now
            self._update_pressure(now)
            self._cond.notify_all()

    def register_breaker(self, key: str, breaker) -> None:
        """Attach a chip's fallback breaker so its OPEN state feeds the
        shed level. Weakly held; duplicates are fine."""
        if breaker is None:
            return
        with self._cond:
            ch = self._chip(key)
            if not any(ref() is breaker for ref in ch.breakers):
                try:
                    ch.breakers.append(weakref.ref(breaker))
                except TypeError:
                    pass  # unweakrefable test double: skip the feed

    def loads(self) -> dict[str, int]:
        """Per-chip in-flight COST across every scope — the cross-scope
        live-load signal chip_pool routing adds to each scope's own
        queue view."""
        with self._cond:
            return {
                k: ch.inflight_cost for k, ch in self._chips.items()
            }

    def shed_level(self) -> int:
        """Worst per-chip shed level right now (0 = no pressure)."""
        with self._cond:
            now = self._clock()
            self._update_pressure(now)
            return max(
                (self._level(ch, now) for ch in self._chips.values()),
                default=0,
            )

    def shed_advice(self, tenant: str) -> float | None:
        """Should the front ends 503 this tenant right now? Returns the
        Retry-After seconds to send, or None to serve. Only tenants
        whose windowed admitted-cost share EXCEEDS their fair share are
        shed (per-tenant, never per-server): the storm pays, the
        well-behaved tenant keeps serving through the overload."""
        with self._cond:
            now = self._clock()
            self._rotate_buckets(now)
            self._update_pressure(now)
            worst = max(
                (self._level(ch, now) for ch in self._chips.values()),
                default=0,
            )
            if worst < 3:
                return None
            mine = self._tenant_cost(tenant)
            if mine <= 0.0:
                return None  # no recent device work: not the storm
            # Fair share is over every tenant CONTENDING — admitted
            # cost or queued waiters. A storm tenant holding 100% while
            # the victim is still stuck waiting must read as over-share
            # even though the victim has no admitted cost yet.
            tenants = set(self._tcost_cur) | set(self._tcost_prev)
            tenants.update(w.tenant for w in self._waiters)
            total = sum(self._tenant_cost(t) for t in tenants)
            fair = total / max(len(tenants), 1)
            if mine <= fair * 1.05:  # hysteresis: at-share is served
                return None
            self._shed_counts[tenant] = self._shed_counts.get(tenant, 0) + 1
            _res_shed.inc(tenant=tenant)
            return self.shed_retry_s

    def snapshot(self) -> dict:
        """Full observable state: per-chip budget/inflight/watermarks/
        pressure and per-tenant windowed cost + shed counts. The chaos
        tests' ground truth and the telemetry/status payload."""
        with self._cond:
            now = self._clock()
            self._rotate_buckets(now)
            self._update_pressure(now)
            chips = {}
            for k, ch in self._chips.items():
                lvl = self._level(ch, now)
                _res_pressure_g.set(lvl, chip=k)
                chips[k] = {
                    "budget": ch.budget,
                    "inflight": ch.inflight,
                    "inflight_cost": ch.inflight_cost,
                    "max_inflight": ch.max_inflight,
                    "max_inflight_cost": ch.max_inflight_cost,
                    "admitted": ch.admitted,
                    "admitted_cost": ch.admitted_cost,
                    "pressure": lvl,
                    "over_s": (
                        round(now - ch.over_since, 3)
                        if ch.over_since is not None
                        else 0.0
                    ),
                    "breaker_open": (
                        ch.breaker_open() if ch.breakers else False
                    ),
                }
            tenants = {
                t: {
                    "windowed_cost": round(self._tenant_cost(t), 1),
                    "shed": self._shed_counts.get(t, 0),
                }
                for t in (
                    set(self._tcost_cur)
                    | set(self._tcost_prev)
                    | set(self._shed_counts)
                )
            }
            return {
                "budget": self.budget,
                "chips": chips,
                "tenants": tenants,
                "waiters": len(self._waiters),
            }


def _residency_keys(backend) -> tuple[str, ...]:
    """The physical chip identities one batch of `backend` occupies.
    A (possibly fallback-wrapped) pinned chip is one key; a MESH
    backend dispatches one batch across EVERY device it spans, so it
    charges them all — this is exactly how the wide-stream path stops
    admitting past the per-chip queues. Backends with no device
    identity (pure NumPy) get their synthetic queue label: a private
    chip nobody else can collide with."""
    label = getattr(backend, "chip_label", "") or getattr(
        getattr(backend, "primary", None), "chip_label", ""
    )
    if label:
        return (label,)
    for obj in (backend, getattr(backend, "primary", None)):
        mesh_rs = getattr(obj, "_mesh_rs", None)
        if mesh_rs is None:
            continue
        labels = getattr(mesh_rs, "device_labels", None)
        if callable(labels):
            try:
                keys = tuple(labels())
            except Exception:
                keys = ()
            if keys:
                return keys
    return (_queue_label(backend),)


_residency_lock = threading.Lock()
_residency_default: "ResidencyLedger | None" = None
_residency_init = False


def default_residency() -> ResidencyLedger | None:
    """The process-wide ledger (lazily built from the SEAWEED_EC_*
    knobs), or None when SEAWEED_EC_RESIDENCY_WINDOW=0 disabled it."""
    global _residency_default, _residency_init
    with _residency_lock:
        if not _residency_init:
            budget = int(_env_float(
                "SEAWEED_EC_RESIDENCY_WINDOW", DEFAULT_RESIDENCY_BUDGET
            ))
            _residency_default = (
                ResidencyLedger(budget=budget) if budget > 0 else None
            )
            _residency_init = True
        return _residency_default


def shed_advice(tenant: str) -> float | None:
    """Front-end hook: Retry-After seconds if `tenant` should be shed
    under current pod pressure, else None. Never raises."""
    try:
        led = default_residency()
        return led.shed_advice(tenant) if led is not None else None
    except Exception:
        return None


def shed_level() -> int:
    """Worst chip shed level of the process ledger (0 when off/idle) —
    background daemons (e.g. the MQ parity flusher) stretch their
    cadence by this."""
    try:
        led = default_residency()
        return led.shed_level() if led is not None else 0
    except Exception:
        return 0


def residency_snapshot() -> dict:
    """The process ledger's snapshot() for /status, heartbeats and
    /debug/gateway; {} when the ledger is disabled."""
    try:
        led = default_residency()
        return led.snapshot() if led is not None else {}
    except Exception:
        return {}


# --------------------------------------------------------------------------
# Scopes: one scheduler/placement config domain + its queue registry.
# The process-wide default scope backs the module-level functions; a
# Store may carry a private scope (multi-tenant embedding) so one
# tenant's configure() stops clobbering another's.
# --------------------------------------------------------------------------


_label_lock = threading.Lock()
_label_seq: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_label_next = itertools.count()


def _queue_label(backend) -> str:
    """Chip identity for stats/metrics: the pool chip's device id when
    the backend is (or wraps) a pinned ChipBackend, else the backend
    class name qualified by its shard ratio and an instance tag (one
    single-device/mesh backend = one chip) — two same-class backends
    (e.g. volumes at 10+4 and 5+2) must not merge into one label set.
    The tag is a process-wide monotonic sequence number (id() bits can
    collide after allocator reuse, silently summing two backends'
    gauges into one series)."""
    label = getattr(backend, "chip_label", "")
    if not label:
        label = getattr(getattr(backend, "primary", None), "chip_label", "")
    if label:
        return label
    ctx = getattr(backend, "ctx", None)
    ratio = (
        f":{ctx.data_shards}+{ctx.parity_shards}"
        if ctx is not None
        else ""
    )
    with _label_lock:
        seq = _label_seq.get(backend)
        if seq is None:
            seq = _label_seq[backend] = next(_label_next)
    return f"{type(backend).__name__}{ratio}@{seq}"


class QueueScope:
    """One scheduler/placement configuration domain.

    Holds the enable flag, window, per-class shares, and the stream
    placement mode (`auto|mesh|chip`, consumed by ec/chip_pool.py),
    plus the registry of live DeviceQueues created under this scope.
    Queues are per (scope, backend): two scopes sharing a chip each get
    their own admission policy — the multi-tenant contract is isolation
    of CONFIG, while the physical chip pool (ec/chip_pool.py) stays
    process-wide so placement still sees total chip load.

    `tenant` names this scope's fairness/shed accounting domain on the
    shared ResidencyLedger (default "default": unnamed scopes pool
    their accounting, named Stores get per-tenant QoS). `residency`
    selects the physical ledger the scope's queues charge: None = the
    process-wide default (env-gated), False = no physical ledger (the
    logical-window-only behavior), or an injected
    ResidencyLedger (tests/bench)."""

    def __init__(
        self,
        enabled: bool = True,
        window: int = DEFAULT_WINDOW,
        shares: dict[str, float] | None = None,
        placement: str = DEFAULT_PLACEMENT,
        tenant: str | None = None,
        residency: "ResidencyLedger | None | bool" = None,
    ):
        self.tenant = tenant or "default"
        self._residency_cfg = residency
        self._lock = threading.Lock()
        self._queues: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._config: dict = {
            "enabled": True,
            "window": DEFAULT_WINDOW,
            "shares": dict(DEFAULT_SHARES),
            "placement": DEFAULT_PLACEMENT,
        }
        self.configure(
            enabled=enabled, window=window, shares=shares or {},
            placement=placement,
        )

    def configure(
        self,
        enabled: bool | None = None,
        window: int | None = None,
        shares: dict[str, float] | None = None,
        placement: str | None = None,
    ) -> dict:
        """Update this scope's scheduler knobs; the LAST caller wins
        WITHIN the scope. A `shares` dict (even empty) REPLACES the
        whole share map — classes it omits return to DEFAULT_SHARES, so
        one caller's override can never stick invisibly to the next
        caller's config; None leaves the current map untouched.
        `placement` selects the chip-pool routing mode (auto|mesh|chip).
        Live queues pick the new values up immediately; `enabled=False`
        makes `for_backend` return None so every producer falls back to
        its private window. Returns the effective config.

        Multi-tenant embedders should configure a per-Store scope
        (`Store(ec_queue_window=...)`) instead of the process-wide
        default this module's bare `configure()` mutates."""
        # Validate EVERY input before mutating anything: a rejected
        # call must not leave the scope half-configured (live queues on
        # the old window while later-created queues get the new one).
        merged = None
        if shares is not None:
            merged = dict(DEFAULT_SHARES)
            for cls, s in shares.items():
                if cls not in PRIORITIES:
                    raise ECError(f"unknown priority class {cls!r}")
                merged[cls] = min(max(float(s), 0.0), 0.9)
        if placement is not None and placement not in PLACEMENT_MODES:
            raise ECError(
                f"unknown ec_placement {placement!r} "
                f"(want one of {PLACEMENT_MODES})"
            )
        if window is not None:
            window = max(1, int(window))
        with self._lock:
            if enabled is not None:
                self._config["enabled"] = bool(enabled)
            if window is not None:
                self._config["window"] = window
            if merged is not None:
                self._config["shares"] = merged
            if placement is not None:
                self._config["placement"] = placement
            live = list(self._queues.values())
            cfg = {
                "enabled": self._config["enabled"],
                "window": self._config["window"],
                "shares": dict(self._config["shares"]),
                "placement": self._config["placement"],
            }
        for q in live:
            with q._cond:
                q.window = cfg["window"]
                q.shares = dict(cfg["shares"])
                q._cond.notify_all()
        return cfg

    @property
    def enabled(self) -> bool:
        with self._lock:
            return self._config["enabled"]

    @property
    def placement(self) -> str:
        with self._lock:
            return self._config["placement"]

    def residency(self) -> "ResidencyLedger | None":
        """This scope's physical ledger (None = logical windows only)."""
        cfg = self._residency_cfg
        if cfg is False:
            return None
        if cfg is None:
            return default_residency()
        return cfg

    def for_backend(self, backend) -> DeviceQueue | None:
        """The shared queue for `backend`'s chip under this scope, or
        None when the scheduler is disabled (or there is no backend —
        the pass-through pipeline)."""
        if backend is None:
            return None
        with self._lock:
            if not self._config["enabled"]:
                return None
            q = self._queues.get(backend)
            if q is None:
                ledger = self.residency()
                keys = _residency_keys(backend)
                q = DeviceQueue(
                    window=self._config["window"],
                    shares=self._config["shares"],
                    label=_queue_label(backend),
                    residency=ledger,
                    res_keys=keys,
                    tenant=self.tenant,
                )
                self._queues[backend] = q
                if ledger is not None:
                    # breaker-state feed for the shed policy: a pinned
                    # chip's fallback breaker flapping open escalates
                    # that chip's pressure level
                    brk = getattr(backend, "breaker", None)
                    if brk is not None and len(keys) == 1:
                        ledger.register_breaker(keys[0], brk)
            return q

    def stats_snapshot(self) -> list[dict]:
        """Per-queue per-class counters for /status and ops tooling,
        keyed per chip (`chip` = device id for pool chips). `breaker`
        carries the chip's fallback-breaker state ("open" = this chip's
        streams are failing over to CPU; "" = the backend has no
        breaker) so the server can surface pod health."""
        with self._lock:
            items = [
                (type(b).__name__, getattr(b, "breaker", None), q)
                for b, q in self._queues.items()
            ]
        return [
            {
                "backend": name,
                "chip": q.label,
                "window": q.window,
                "breaker": brk.state if brk is not None else "",
                "load": q.load(),
                "classes": q.stats(),
            }
            for name, brk, q in items
        ]

    def queue_loads(self) -> dict[str, dict]:
        """Read-only per-chip load view: {chip_label: {"load": cost
        units queued+in-flight, "breaker": state}} — the cheap form of
        stats_snapshot for routing hints and heartbeat telemetry."""
        with self._lock:
            items = [
                (getattr(b, "breaker", None), q)
                for b, q in self._queues.items()
            ]
        out = {}
        for brk, q in items:
            with q._cond:
                load, infl = q._pending_cost, q._inflight_cost
            out[q.label] = {
                "load": load,
                "inflight_cost": infl,
                "breaker": brk.state if brk is not None else "",
            }
        return out

    def residency_loads(self) -> dict[str, int]:
        """Per-chip in-flight cost on this scope's PHYSICAL ledger —
        all scopes combined ({} when the ledger is off). chip_pool adds
        the cross-scope share of this on top of queue_loads()."""
        ledger = self.residency()
        return ledger.loads() if ledger is not None else {}


_DEFAULT_SCOPE = QueueScope()


def default_scope() -> QueueScope:
    """The process-wide scope backing the module-level functions."""
    return _DEFAULT_SCOPE


def resolve_scope(scope: QueueScope | None) -> QueueScope:
    return scope if scope is not None else _DEFAULT_SCOPE


def configure(
    enabled: bool | None = None,
    window: int | None = None,
    shares: dict[str, float] | None = None,
    placement: str | None = None,
) -> dict:
    """Process-wide DEFAULT-scope scheduler knobs; the LAST caller wins
    wholesale within that scope. See QueueScope.configure for the
    semantics; per-chip stats surface through `stats_snapshot` keyed by
    the queue's `chip` label (device id once a chip pool exists).
    Multi-tenant embedders should thread a per-Store scope through
    `Store(...)` instead of calling this."""
    return _DEFAULT_SCOPE.configure(
        enabled=enabled, window=window, shares=shares, placement=placement
    )


def for_backend(backend, scope: QueueScope | None = None) -> DeviceQueue | None:
    """The shared queue for `backend`'s chip (in `scope`, default the
    process-wide scope), or None when the scheduler is disabled."""
    return resolve_scope(scope).for_backend(backend)


def stats_snapshot(scope: QueueScope | None = None) -> list[dict]:
    """Per-queue per-class counters for /status and ops tooling."""
    return resolve_scope(scope).stats_snapshot()
