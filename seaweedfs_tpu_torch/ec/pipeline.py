"""Bounded-queue pipeline shared by encode, rebuild, wide degraded reads
and decode's de-stripe, and the shard sink.

Port of seaweedfs_tpu/ec/pipeline.py: `run_pipeline` (disk reads in a
reader thread / H2D + kernel launch in the calling thread / D2H + shard
writes with CRCs rolled in a writer thread), `run_staged_apply` without
the per-chip scheduler, and `PyShardSink`. The flight recorder and the
native fused sink are not part of this slice.

Shutdown discipline: both worker threads are JOINED before any
caller-owned fd may be closed; on error the abort event stops the
producer (its queue put is abort-aware), the consumer always drains to
the None sentinel, and a thread that refuses to die raises — truncated
output with self-consistent CRCs must never be reported as success.
"""

from __future__ import annotations

import queue as _queue
import threading as _threading
import time as _time
from typing import Callable, Iterator, Sequence

import numpy as np

from .bitrot import BitrotProtection, ShardChecksumBuilder
from .context import BITROT_BLOCK_SIZE, ECContext, ECError


def _timed_produce(record, produce):
    """Wrap a producer generator so the time spent INSIDE it (disk reads)
    is recorded per batch as "disk_read"; time blocked handing batches
    downstream is not."""

    def wrapped():
        it = produce()
        while True:
            t0 = _time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            record("disk_read", _time.perf_counter() - t0)
            yield item

    return wrapped


def run_pipeline(
    produce: Callable[[], Iterator],
    transform: Callable,
    consume: Callable,
    *,
    queue_size: int = 2,
    join_timeout: float = 120.0,
    describe: str = "ec pipeline",
    record: Callable[[str, float], None] | None = None,
) -> None:
    """Run `produce()` items through `transform` then `consume` as three
    overlapped stages.

    - `produce()` is a generator, iterated in a reader thread (disk
      reads happen here, overlapping everything downstream).
    - `transform(item)` runs in the calling thread: the place for
      non-blocking device dispatch (H2D + kernel launch).
    - `consume(result)` runs in a writer thread: the place that may
      BLOCK on device results (to_host) and disk writes, while the
      calling thread keeps dispatching the batches queued behind it.

    Up to `2*queue_size` items are alive at once (one per stage plus the
    queues); callers sizing device memory must budget accordingly.

    `record(stage, seconds)`, when given, receives the producer's time
    per batch as "disk_read"; the caller times the other stages inside
    its own closures.
    """
    if record is not None:
        produce = _timed_produce(record, produce)
    read_q: "_queue.Queue" = _queue.Queue(maxsize=queue_size)
    write_q: "_queue.Queue" = _queue.Queue(maxsize=queue_size)
    abort = _threading.Event()
    errors: list[BaseException] = []

    def _put(q, item) -> bool:
        """Abort-aware put: never blocks forever on a full queue whose
        consumer has stopped."""
        while True:
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                if abort.is_set():
                    return False

    def reader():
        try:
            for item in produce():
                if abort.is_set():
                    return
                if not _put(read_q, item):
                    return
        except BaseException as e:  # disk errors surface in the caller
            errors.append(e)
            abort.set()
        finally:
            _put(read_q, None)

    def writer():
        try:
            while True:
                item = write_q.get()
                if item is None:
                    return
                consume(item)
        except BaseException as e:  # device/disk errors surface in the caller
            errors.append(e)
            abort.set()
            while write_q.get() is not None:
                pass

    rt = _threading.Thread(target=reader, daemon=True)
    wt = _threading.Thread(target=writer, daemon=True)
    rt.start()
    wt.start()
    try:
        while True:
            item = read_q.get()
            if item is None or abort.is_set():
                break
            if not _put(write_q, transform(item)):
                break
    except BaseException as e:
        errors.append(e)
    finally:
        # JOIN both threads before the caller may close any fd. The
        # writer always drains write_q until the None sentinel, so a
        # blocking put(None) never deadlocks.
        if errors:
            abort.set()
            try:
                while True:
                    read_q.get_nowait()
            except _queue.Empty:
                pass
        write_q.put(None)
        rt.join(timeout=join_timeout)
        wt.join(timeout=join_timeout)
        if rt.is_alive() or wt.is_alive():
            # A stuck thread means the output files are TRUNCATED while
            # any CRC builders are self-consistent with the truncation:
            # returning success would publish undetectable data loss.
            abort.set()
            raise ECError(
                f"{describe} thread did not finish (producer alive="
                f"{rt.is_alive()}, consumer alive={wt.is_alive()}); "
                f"output is incomplete"
            ) from (errors[0] if errors else None)
    if errors:
        raise errors[0]


def run_staged_apply(
    backend,
    coeffs,
    produce: Callable[[], Iterator],
    consume: Callable,
    *,
    queue_size: int = 2,
    join_timeout: float = 120.0,
    describe: str = "ec staged apply",
) -> None:
    """The staged device `apply` driver of rebuild: run_pipeline where
    the transform stage is `backend.apply_staged(coeffs,
    backend.to_device(batch))` (non-blocking H2D + kernel launch) and the
    writer stage forces the result with `backend.to_host` before handing
    the host uint8 matrix to `consume`. Batch N computes on the device
    while batch N+1 uploads and batch N-1 drains.

    `produce()` yields `(tag, batch)` pairs; `consume(tag, out)` gets the
    tag back untouched. The backend's `add_stage` receives the wall time
    of the produce ("disk_read") and consume ("write") stages.
    """
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)

    def transform(item):
        tag, batch = item
        return tag, backend.apply_staged(coeffs, backend.to_device(batch))

    def drain(item):
        tag, handle = item
        # Blocks until the device result is ready; meanwhile the calling
        # thread keeps dispatching the batches queued behind it.
        out = np.ascontiguousarray(backend.to_host(handle), dtype=np.uint8)
        t0 = _time.perf_counter()
        consume(tag, out)
        backend.add_stage("write", _time.perf_counter() - t0)

    run_pipeline(
        produce,
        transform,
        drain,
        queue_size=queue_size,
        join_timeout=join_timeout,
        describe=describe,
        record=backend.add_stage,
    )


class PyShardSink:
    """Write stage: N parallel shard streams, each rolling its sidecar
    CRCs over the same bytes it writes."""

    def __init__(
        self,
        files: list,
        block_size: int = BITROT_BLOCK_SIZE,
        leaf_size: int = 0,
    ):
        self.files = files
        self.block_size = block_size
        self.leaf_size = leaf_size
        self.builders = [
            ShardChecksumBuilder(block_size, leaf_size) for _ in files
        ]

    @property
    def sizes(self) -> list[int]:
        return [b.total for b in self.builders]

    def append_rows(self, rows: Sequence) -> None:
        if len(rows) != len(self.files):
            raise ECError(f"expected {len(self.files)} rows, got {len(rows)}")
        for f, row, builder in zip(self.files, rows, self.builders):
            if not isinstance(row, (bytes, bytearray)):
                row = np.ascontiguousarray(row, dtype=np.uint8)
            mv = memoryview(row).cast("B")
            while mv:  # raw FileIO may short-write
                mv = mv[f.write(mv) :]
            builder.write(row)

    def block_crcs(self) -> list[list[int]]:
        return [b.finish() for b in self.builders]

    def leaf_crcs(self) -> list[list[int]]:
        if not self.leaf_size:
            return []
        return [b.finish_leaves() for b in self.builders]

    def to_protection(self, ctx: ECContext) -> BitrotProtection:
        return BitrotProtection.from_builders(ctx, self.builders)
