"""Unified retry policy: exponential backoff + jitter, deadlines, and a
circuit breaker.

Port of seaweedfs_tpu/utils/retry.py (standard library only). The port's
scrub runs its rebuild attempts under it (ec/scrub.py), the remote S3
client its requests (remote/s3_client.py), and the replication loops
their tails (`Backoff`). The reference
scatters equivalent loops across weed/wdclient and weed/operation;
keeping one here means backoff behavior, deadline math, and give-up
semantics are tested once.

Everything time-related is injectable (sleep/clock/rng) so tests run
deterministic schedules in zero wall time.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, TypeVar

T = TypeVar("T")


class RetryError(Exception):
    """All attempts exhausted; __cause__ is the last underlying error."""

    def __init__(self, msg: str, attempts: int, elapsed: float):
        super().__init__(msg)
        self.attempts = attempts
        self.elapsed = elapsed


class CircuitOpenError(Exception):
    """Call rejected without being attempted: the breaker is open."""


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule + give-up rules.

    delay(attempt) for attempt = 1.. is
        min(base_delay * multiplier**(attempt-1), max_delay)
    ± a uniform jitter fraction. `deadline` bounds TOTAL elapsed time
    across attempts: a backoff that would overshoot it is CLAMPED so a
    final attempt lands exactly at the deadline (the caller asked for
    the full budget — a lease freed late is still won); only once the
    deadline is fully spent do retries stop.
    """

    max_attempts: int = 4
    base_delay: float = 0.1
    max_delay: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.2  # fraction of the delay randomized symmetrically
    deadline: float | None = None  # seconds of total budget, None = no cap
    retry_on: tuple[type[BaseException], ...] = (Exception,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        d = min(self.base_delay * self.multiplier ** (attempt - 1), self.max_delay)
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)


# A conservative default for cluster RPCs: quick first retry, bounded tail.
DEFAULT_POLICY = RetryPolicy()


def retry_call(
    fn: Callable[[], T],
    policy: RetryPolicy = DEFAULT_POLICY,
    *,
    retry_on: tuple[type[BaseException], ...] | None = None,
    on_retry: Callable[[BaseException, int], None] | None = None,
    sleep: Callable[[float], None] | None = None,
    clock: Callable[[], float] | None = None,
    rng: random.Random | None = None,
    describe: str = "operation",
) -> T:
    """Run fn() under `policy`. `on_retry(exc, attempt)` runs between
    attempts (leader re-resolution, cache invalidation, ...); an
    exception it raises propagates immediately (it is part of recovery,
    not the retried operation). sleep/clock default to time.sleep /
    time.monotonic, resolved at call time so they stay patchable."""
    kinds = retry_on if retry_on is not None else policy.retry_on
    if sleep is None:
        sleep = time.sleep
    if clock is None:
        clock = time.monotonic
    if rng is None:
        rng = random.Random()
    start = clock()
    last: BaseException | None = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn()
        except kinds as e:
            last = e
        elapsed = clock() - start
        if attempt >= policy.max_attempts:
            break
        d = policy.delay(attempt, rng)
        if policy.deadline is not None:
            remaining = policy.deadline - elapsed
            if remaining <= 0:
                break
            # clamp instead of dropping: the caller asked for the FULL
            # budget, so the last backoff shrinks to land a final
            # attempt at the deadline (a lease freed late is still won)
            d = min(d, remaining)
        if on_retry is not None:
            on_retry(last, attempt)
        sleep(d)
    elapsed = clock() - start
    raise RetryError(
        f"{describe} failed after {attempt} attempts in {elapsed:.2f}s: {last}",
        attempts=attempt,
        elapsed=elapsed,
    ) from last


class Backoff:
    """Consecutive-failure backoff for never-give-up daemon loops.

    retry_call() is for bounded operations; a tail/sync daemon instead
    loops forever and only needs the POLICY'S SCHEDULE: next_delay()
    walks the policy's backoff curve one failure at a time (saturating
    at the tail so delay stops growing), reset() snaps back to the
    first-retry delay after any success. The replication loops
    (replication/) run on it."""

    def __init__(self, policy: RetryPolicy, rng: random.Random | None = None):
        self.policy = policy
        self._rng = rng if rng is not None else random.Random()
        self._failures = 0

    @property
    def failures(self) -> int:
        return self._failures

    def reset(self) -> None:
        self._failures = 0

    def next_delay(self) -> float:
        self._failures = min(self._failures + 1, self.policy.max_attempts)
        return self.policy.delay(self._failures, self._rng)


class CircuitBreaker:
    """Three-state (closed / open / half-open) failure gate.

    closed: calls flow; `failure_threshold` consecutive failures open it.
    open: allows() is False until `reset_timeout` elapses.
    half-open: one probe call is allowed; success closes the breaker,
    failure re-opens it (with the full timeout again).

    Thread-safe enough for the GIL'd call patterns here: transitions are
    single attribute writes and the worst race admits one extra probe.
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._failures = 0
        self._opened_at: float | None = None
        self._probe_started: float | None = None

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.reset_timeout:
            return "half-open"
        return "open"

    def allows(self) -> bool:
        st = self.state
        if st == "closed":
            return True
        if st == "half-open":
            now = self._clock()
            # One probe per half-open window — but an ABANDONED probe
            # (caller died between allows() and record_*) must not
            # wedge the breaker half-open forever; after a further
            # reset_timeout the probe slot reopens.
            if (
                self._probe_started is None
                or now - self._probe_started >= self.reset_timeout
            ):
                self._probe_started = now
                return True
        return False

    def record_success(self) -> None:
        self._failures = 0
        self._opened_at = None
        self._probe_started = None

    def record_failure(self) -> None:
        self._failures += 1
        self._probe_started = None
        if self._opened_at is not None or self._failures >= self.failure_threshold:
            self._opened_at = self._clock()

    def call(self, fn: Callable[[], T]) -> T:
        """Guarded invocation: raises CircuitOpenError without calling
        fn when the breaker rejects; records the outcome otherwise."""
        if not self.allows():
            raise CircuitOpenError(
                f"circuit open ({self._failures} consecutive failures)"
            )
        try:
            out = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out
