"""Bounded-queue pipeline shared by encode, rebuild, wide degraded reads
and decode's de-stripe, and the shard sinks.

Port of seaweedfs_tpu/ec/pipeline.py: `run_pipeline` (disk reads in a
reader thread / H2D + kernel launch in the calling thread / D2H + shard
writes with CRCs rolled in a writer thread), `run_staged_apply` as a
client of the per-chip scheduler (ec/device_queue.py, placement by
ec/chip_pool.py), `FusedShardSink` (the native sink), `PyShardSink`
and `make_shard_sink`. The flight recorder (utils/trace.py) tags each
stage of a traced op's span, as in the JAX package.

Shutdown discipline: both worker threads are JOINED before any
caller-owned fd may be closed; on error the abort event stops the
producer (its queue put is abort-aware), the consumer always drains to
the None sentinel, and a thread that refuses to die raises — truncated
output with self-consistent CRCs must never be reported as success.
"""

from __future__ import annotations

import os
import queue as _queue
import threading as _threading
import time as _time
import uuid
from typing import Callable, Iterator, Sequence

import numpy as np

from .. import faults
from ..utils import native, trace
from . import native_io
from .bitrot import BitrotProtection, ShardChecksumBuilder
from .context import BITROT_BLOCK_SIZE, ECContext, ECError


def _timed_produce(recorders, produce):
    """Wrap a producer generator so the time spent INSIDE it (disk reads)
    goes to each `recorders` callable per batch; time blocked handing
    batches downstream is not."""

    def wrapped():
        it = produce()
        while True:
            t0 = _time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            dt = _time.perf_counter() - t0
            for rec in recorders:
                rec(dt)
            yield item

    return wrapped


def _traced_call(span, stage: str, fn):
    def wrapped(item):
        t0 = _time.perf_counter()
        try:
            return fn(item)
        finally:
            span.add_stage(stage, _time.perf_counter() - t0)

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
    span=None,
    stage_names: tuple = (None, None, None),
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

    `span` + `stage_names` attribute wall time to the flight recorder
    (utils/trace.py): stage_names is (produce, transform, consume), and
    a None name leaves that stage to the caller's own tags. Time blocked
    on a FULL bounded queue is tagged "queue_wait", measured only when
    the put actually blocks. span=None (the disarmed tracer) leaves
    every closure untouched.
    """
    recorders = []
    if record is not None:
        recorders.append(lambda dt: record("disk_read", dt))
    if span is not None:
        if stage_names[0]:
            recorders.append(lambda dt: span.add_stage(stage_names[0], dt))
        if stage_names[1]:
            transform = _traced_call(span, stage_names[1], transform)
        if stage_names[2]:
            consume = _traced_call(span, stage_names[2], consume)
    if recorders:
        produce = _timed_produce(recorders, produce)
    read_q: "_queue.Queue" = _queue.Queue(maxsize=queue_size)
    write_q: "_queue.Queue" = _queue.Queue(maxsize=queue_size)
    abort = _threading.Event()
    errors: list[BaseException] = []

    def _put(q, item) -> bool:
        """Abort-aware put: never blocks forever on a full queue whose
        consumer has stopped."""
        try:
            q.put_nowait(item)
            return True
        except _queue.Full:
            pass
        t0 = _time.perf_counter() if span is not None else 0.0
        try:
            while True:
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    if abort.is_set():
                        return False
        finally:
            if span is not None:
                span.add_stage("queue_wait", _time.perf_counter() - t0)

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
    priority: str = "recovery",
    device_queue="auto",
    scheduler=None,
    cost_hint: int = 0,
    wide: bool = False,
    span=None,
    read_stage: str = "disk_read",
) -> None:
    """The staged device `apply` driver of rebuild, decode's self-heal
    and wide degraded reads: run_pipeline where the transform stage is
    `backend.apply_staged(coeffs, backend.to_device(batch))`
    (non-blocking H2D + kernel launch) and the writer stage forces the
    result with `backend.to_host` before handing the host uint8 matrix
    to `consume`. Batch N computes on the device while batch N+1 uploads
    and batch N-1 drains.

    `produce()` yields `(tag, batch)` pairs; `consume(tag, out)` gets the
    tag back untouched. The backend's `add_stage` receives the wall time
    of the produce ("disk_read") and consume ("write") stages.

    The dispatch is a client of the shared per-chip scheduler
    (ec/device_queue.py): `priority` tags the stream's class
    (foreground | recovery | scrub) and `device_queue` selects the queue:
    "auto" resolves the stream's placement (ec/chip_pool.py
    `place_stream` under `scheduler`, the QueueScope; None = the
    process-wide default scope, which is enabled), an explicit
    DeviceQueue pins one, None dispatches without admission. `cost_hint`
    is the stream's estimated total cost for least-loaded routing and
    `wide` lets a lone stream keep a mesh; per-batch admission costs
    `batch_cost(out_rows, width)`.

    `span` is the op's flight-recorder span (utils/trace.py; None =
    disarmed): the produce stage is tagged `read_stage` per batch, the
    H2D upload + kernel launch "h2d_dispatch", the blocking to_host
    "device_drain", the consume callback "write_sink", bounded-queue
    backpressure "queue_wait" and, on the scheduled path, the admission
    wait "admission_wait", labeled as in the JAX package (the chip, or
    on the scheduled path the queue's label).
    """
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
    placement = None
    if device_queue == "auto":
        from .chip_pool import place_stream

        placement = place_stream(
            backend, priority, scope=scheduler, cost_hint=cost_hint, wide=wide, span=span,
        )
        backend = placement.backend
        device_queue = placement.queue

    def write(tag, out):
        t0 = _time.perf_counter()
        with trace.stage(span, "write_sink"):
            consume(tag, out)
        backend.add_stage("write", _time.perf_counter() - t0)

    from .device_queue import batch_cost, open_stream

    out_rows = int(coeffs.shape[0])
    # with no queue (the scheduler disabled) a DirectStream dispatches at
    # once, and the device stages carry the chip as the JAX package's
    # unscheduled path labels them
    chip = getattr(backend, "chip_label", "") if device_queue is None else device_queue.label
    stream = open_stream(device_queue, priority, label=describe, span=span, chip=chip)

    def transform(item):
        tag, batch = item
        width = (
            int(batch.shape[-1])
            if getattr(batch, "ndim", 1) > 1
            else int(getattr(batch, "nbytes", len(batch)))
        )
        ticket, handle = stream.dispatch(
            lambda: backend.apply_staged(coeffs, backend.to_device(batch)),
            batch_cost(out_rows, width),
        )
        return tag, ticket, handle

    def drain(item):
        tag, ticket, handle = item
        # Blocks until the device result is ready; meanwhile the calling
        # thread keeps dispatching the batches queued behind it.
        try:
            with trace.stage(span, "device_drain", chip):
                out = np.ascontiguousarray(backend.to_host(handle), dtype=np.uint8)
        finally:
            # success or failure, the window slot frees: a dying stream
            # must not wedge the chip for the other streams
            stream.release(ticket)
        write(tag, out)

    try:
        run_pipeline(
            produce,
            transform,
            drain,
            queue_size=queue_size,
            join_timeout=join_timeout,
            describe=describe,
            record=backend.add_stage,
            span=span,
            stage_names=(read_stage, None, None),
        )
    finally:
        # batches parked in an aborted pipeline's write queue never reach
        # drain: their slots are released here, and the placement's
        # charge drains with the stream
        stream.close()
        if placement is not None:
            placement.close()


# --------------------------------------------------------------------------
# Shard sinks: the write stage shared by encode and rebuild. Both write N
# parallel byte streams (one per shard file) and roll the bitrot CRCs in
# the same pass, while the bytes are cache-hot.
# --------------------------------------------------------------------------


class FusedShardSink:
    """Write stage backed by the stateful native sink (sn_sink_*): one
    GIL-releasing C++ call per batch, one task per shard on the host
    library's worker pool that rolls the shard's CRCs and then pwrites
    at offsets the sink tracks, straight from the source rows: no
    tobytes() or slice copies, and the Python file objects' positions
    never move.

    With `leaf_size` set, both sidecar CRC levels come out of one byte
    pass on the C++ side: leaves are rolled, and the block level is
    folded from completed leaf CRCs with the CRC shift operator.

    `early_writeback` starts background writeback of each written extent
    (sync_file_range), so the publish-time fsync drains a range already
    in flight; it defaults to SEAWEED_EC_EARLY_WB (off unless "1").
    `direct` writes the shard fds O_DIRECT while every append stays
    4096-aligned (pooled matrices are), and drops a shard back to
    buffered writes at the ragged tail or where the filesystem refuses,
    with the same bytes; it defaults to SEAWEED_EC_ODIRECT (off unless
    "1").
    """

    def __init__(
        self,
        files: list,
        block_size: int = BITROT_BLOCK_SIZE,
        leaf_size: int = 0,
        early_writeback: bool | None = None,
        direct: bool | None = None,
    ):
        if early_writeback is None:
            early_writeback = os.environ.get("SEAWEED_EC_EARLY_WB", "0") == "1"
        if direct is None:
            direct = os.environ.get("SEAWEED_EC_ODIRECT", "0") == "1"
        if leaf_size and block_size % leaf_size != 0:
            raise ECError(f"leaf size {leaf_size} does not divide block size {block_size}")
        self.fds = [f.fileno() for f in files]
        n = len(files)
        self.block_size = block_size
        self.leaf_size = leaf_size
        self._sink = native.NativeSink(
            self.fds, block_size, leaf_size, early_writeback=early_writeback, direct=direct,
        )
        self.crcs: list[list[int]] = [[] for _ in range(n)]
        self._leaf_crcs: list[list[int]] = [[] for _ in range(n)]
        self.sizes = [0] * n
        self._out: tuple | None = None
        self._finished = False
        self._direct_flags = None

    def direct_flags(self) -> np.ndarray:
        """Per-shard O_DIRECT state (u8[n], 1: still direct), taken at
        finish once the native handle is gone."""
        if self._direct_flags is not None:
            return self._direct_flags
        return self._sink.direct_flags()

    def append_rows(self, rows: Sequence[np.ndarray]) -> None:
        """Append one equal-width batch to every shard stream; rows[i]
        goes to shard i. Rows must be 1-D C-contiguous uint8 (row views
        of a contiguous matrix are; nothing is copied) and stay alive
        until this returns. A failed write raises OSError."""
        n = len(self.fds)
        if len(rows) != n:
            raise ECError(f"expected {n} rows, got {len(rows)}")
        if self._finished:
            raise ECError("shard sink already finished")
        width = len(rows[0])
        if any(len(r) != width for r in rows):
            raise ECError("shard sink rows have unequal widths")
        ptrs = []
        for r in rows:
            if not (isinstance(r, np.ndarray) and r.flags.c_contiguous and r.dtype == np.uint8):
                raise ECError("shard sink rows must be contiguous uint8 arrays")
            ptrs.append(r.ctypes.data)
        max_out = width // (self.leaf_size or self.block_size) + 2
        if self._out is None or self._out[0].shape[1] < max_out:
            self._out = (
                np.empty((n, max_out), np.uint32),  # block CRCs
                np.empty(n, np.int32),
                np.empty((n, max_out), np.uint32),  # leaf CRCs
                np.empty(n, np.int32),
            )
        obc, obn, olc, oln = self._out
        # an overflow (count -1) cannot get here: the C side fails the
        # shard and append raises first
        self._sink.append(ptrs, width, obc, obn, olc, oln)
        native_io.count("sink_append")
        for i in range(n):
            self.crcs[i].extend(int(x) for x in obc[i, : int(obn[i])])
            if self.leaf_size:
                self._leaf_crcs[i].extend(int(x) for x in olc[i, : int(oln[i])])
            self.sizes[i] += width

    def _finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        self._direct_flags = self._sink.direct_flags()
        tb, tbv, tl, tlv, _sizes = self._sink.finish()
        for i in range(len(self.fds)):
            if tbv[i]:
                self.crcs[i].append(int(tb[i]))
            if self.leaf_size and tlv[i]:
                self._leaf_crcs[i].append(int(tl[i]))
        self._sink.destroy()

    def block_crcs(self) -> list[list[int]]:
        self._finish()
        return [list(c) for c in self.crcs]

    def leaf_crcs(self) -> list[list[int]]:
        self._finish()
        return [list(c) for c in self._leaf_crcs] if self.leaf_size else []

    def to_protection(self, ctx: ECContext) -> BitrotProtection:
        return BitrotProtection(
            ctx=ctx,
            block_size=self.block_size,
            uuid=uuid.uuid4().bytes,
            shard_sizes=list(self.sizes),
            shard_crcs=self.block_crcs(),
            leaf_size=self.leaf_size,
            shard_leaf_crcs=self.leaf_crcs(),
        )


class PyShardSink:
    """Python write stage: N shard streams, each rolling its sidecar CRCs
    over the same bytes it writes. Taken where SEAWEED_EC_NATIVE=0 or an
    armed fault registry (byte-mutating fault points need materialized
    bytes) asks for the Python plane."""

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


def make_shard_sink(
    files: list,
    block_size: int = BITROT_BLOCK_SIZE,
    leaf_size: int = 0,
    prefer_fused: bool = True,
) -> FusedShardSink | PyShardSink:
    """The fused native sink, or `PyShardSink` when the caller asks for
    it (`prefer_fused=False`), SEAWEED_EC_NATIVE=0 is set, or the fault
    registry is armed. A native sink that fails to build or load raises:
    there is no quiet fallback."""
    if prefer_fused and native_io.enabled() and not faults.active():
        return FusedShardSink(files, block_size, leaf_size)
    return PyShardSink(files, block_size, leaf_size)
