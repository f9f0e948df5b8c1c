"""Broker-side group commit for durable produce (mirrors the volume
server's group committer).

Port of seaweedfs_tpu/mq/group_commit.py, whole: `MqGroupCommitter` and
`group_commit_window_s`, with the fault point `mq.produce.before_flush`.

A Kafka produce against a durable-parity topic is acked only once its
records are replayable from the parity stream. Flushing the stream per
produce would serialize every producer behind an fsync; this committer
amortizes it over a bounded window: producers append (which feeds the
partition's ``PartitionParity`` buffer via the log's ``on_append``
observer), mark the parity stream dirty, take a WINDOW TICKET, and
block until one flush pass covering their window completes — N
producers inside one window cost one parity flush per dirty partition
instead of N.

Ordering argument (why a ticket-w producer's records are always
covered by window w's flush): the ticket is read under the condition
lock BEFORE the committer bumps ``_open_window`` (also under it), and
the bump happens-before the flush starts — so any append that took
ticket w had already landed in its parity buffer before window w's
flush began, and ``PartitionParity.flush`` drains everything buffered.

A failed flush fails EVERY producer waiting on that window — none of
the cohort's records are certified durable, and the gateway maps the
failure to a per-partition ``KAFKA_STORAGE_ERROR``.

``SEAWEED_MQ_GROUP_COMMIT_MS`` is read live per produce (0 disables
group commit: acks rely on the parity sweeper's lag bound instead of a
synchronous flush), so bench phases flip it without restarting the
broker.
"""

from __future__ import annotations

import os
import threading
import time

from ..faults import registry as faults


def group_commit_window_s() -> float:
    """SEAWEED_MQ_GROUP_COMMIT_MS as seconds (0 = no synchronous
    produce durability, the default). Read live per produce."""
    try:
        ms = float(os.environ.get("SEAWEED_MQ_GROUP_COMMIT_MS", "0"))
    except ValueError:
        ms = 0.0
    return max(0.0, ms) / 1000.0


class MqGroupCommitter:
    """One per broker; covers every durable-parity partition. See the
    module docstring for the protocol and ordering argument."""

    def __init__(self, window_s: float, name: str = "mq"):
        self._window_s = window_s
        self._cv = threading.Condition()
        self._open_window = 0
        self._completed = -1
        self._error_upto = -1
        self._last_error: BaseException | None = None
        self._pending = 0
        self._dirty: set = set()
        self._stop = False
        self.windows_committed = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"mq-group-commit-{name}"
        )
        self._thread.start()

    @property
    def window_s(self) -> float:
        return self._window_s

    def mark_dirty(self, parity) -> None:
        """Register a parity stream that buffered records this window."""
        with self._cv:
            self._dirty.add(parity)

    def wait_durable(self) -> None:
        """Block the calling producer (which has already appended, so
        its records sit in a dirty parity buffer) until a flush pass
        covering its window completes; raise if that pass failed."""
        with self._cv:
            w = self._open_window
            self._pending += 1
            self._cv.notify_all()
            while self._completed < w:
                if self._stop and not self._thread.is_alive():
                    raise OSError(
                        "mq group committer stopped with produces in flight"
                    )
                self._cv.wait(timeout=0.5)
            failed = self._error_upto >= w
            err = self._last_error if failed else None
        if failed:
            raise OSError(f"mq group commit flush failed: {err!r}") from err

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending == 0 and not self._stop:
                    self._cv.wait(timeout=0.5)
                if self._pending == 0 and self._stop:
                    return
                stopping = self._stop
            # accumulate the window OUTSIDE any lock: produces keep
            # landing and taking tickets for this window meanwhile
            if not stopping and self._window_s > 0:
                time.sleep(self._window_s)
            with self._cv:
                w = self._open_window
                self._open_window += 1
                self._pending = 0
                dirty = list(self._dirty)
                self._dirty.clear()
            err: BaseException | None = None
            try:
                faults.fire("mq.produce.before_flush", window=w)
                for parity in dirty:
                    parity.flush()
            except OSError as e:
                err = e
            from ..utils import metrics

            metrics.mq_group_commit_windows_total.inc()
            with self._cv:
                self._completed = w
                self.windows_committed += 1
                if err is not None:
                    self._error_upto = w
                    self._last_error = err
                    # a failed window's streams are still dirty
                    self._dirty.update(dirty)
                self._cv.notify_all()

    def stop(self) -> None:
        """Drain pending producers with a final commit, then exit."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
