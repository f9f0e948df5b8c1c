"""Streaming EC: encode-on-write with incremental parity (online RS).

Port of seaweedfs_tpu/ec/stream_encode.py. An :class:`EcStreamEncoder`
accepts appends of unknown total length and keeps parity trailing the
append head by a bounded lag, so redundancy exists while the object is
still being written (the MQ broker's durable-parity log segments,
`mq/stream_parity.py`).

RS over GF(2^8) is linear. With generator rows ``G = matrix[k:]``
(m x k), parity of a stripe is ``P = G @ D``; when a row-batch lands in
data row ``i`` columns ``[c0,c1)``, the parity of the zero-extended
stripe updates in place::

    P[:, c0:c1] ^= G[:, i:i+1] @ new_bytes      (GF add == XOR)

so a partial stripe always carries valid parity for its zero-extension,
and every flush point is a crash-consistent redundancy point. Each delta
is one `gf2_apply` launch at (m, 1) over the chunk's width, through the
backend's staged hooks (`to_device` -> `apply_staged` -> `to_host`), one
synchronous round trip per chunk.

Layout: the stream uses `write_ec_files`'s striping (greedy large
stripes of ``k x block_size``; at :meth:`close` with ``finalize=True``
the ragged tail is re-striped with ``small_block_size`` rows,
zero-padded), so N appends give shard files and sidecar CRCs
byte-identical to one `write_ec_files` over the concatenation with the
same block parameters, and to the JAX package's stream.

Durability (the stripe-cursor journal, `<base>.stream`, the JAX
package's format byte for byte): :meth:`flush` processes the buffer
(parity deltas, data rows pwritten at their final offsets, full
stripes sealed), fsyncs every touched shard, then advances the journal.
:func:`recover_stream` reads the journal, bounds the head by on-disk row
extents, lets the embedder frame-scan the linear bytes, and rewrites any
parity that disagrees with the data.

Placement and admission: the stream is placed once at construction
(ec/chip_pool.py `place_stream` under `scheduler`, the QueueScope; None =
the process-wide default) and every parity delta is admitted to the
chip's `DeviceQueue` as a foreground batch at `batch_cost(m, width)`
(ec/device_queue.py); a disabled scope dispatches directly.

Observability: each encoder is one `ec.stream_encode` span of the flight
recorder (utils/trace.py) from construction to close, with the stages
of its `stage_seconds` dict (`write_sink`, `parity_update`,
`h2d_dispatch`, `device_drain`, `fsync_publish`) and, on the scheduled
path, the queue's `admission_wait`; appends, sealed
stripes, recovery outcomes, time-to-durable-parity and open streams are
the registry's `sw_ec_stream_*` metrics (utils/metrics.py), read by
:func:`stream_summary`. The port also counts the parity batches that
every encoder of the process dispatches (:func:`dispatch_count`), so a
status plane can hold the kernels' launches to the work that caused
them (the MQ broker's `/debug/kernels`).

With no backend, the encoder and :func:`recover_stream` take the card
(`get_backend("cuda", k, m)`) and raise where there is none.

Env knobs: ``SEAWEED_EC_STREAM_BLOCK_KB`` (large-stripe row block,
default 1024) and ``SEAWEED_EC_STREAM_SMALL_KB`` (tail re-stripe block,
default 64).
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import uuid as _uuid
import weakref
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

from .. import faults
from ..utils import metrics as M
from ..utils import trace
from ..utils.crc import crc32c
from ..utils.fs import atomic_write, fsync_dir
from .backend import get_backend
from .chip_pool import place_stream
from .device_queue import batch_cost, open_stream
from .bitrot import BitrotProtection, ShardChecksumBuilder
from .context import (
    BITROT_BLOCK_SIZE,
    BITROT_LEAF_SIZE,
    DEFAULT_EC_CONTEXT,
    ECContext,
    ECError,
)

log = logging.getLogger(__name__)

JOURNAL_SUFFIX = ".stream"

MAGIC = 0x53575354  # "SWST"
FORMAT_VERSION = 1
# magic u32 BE | version u16 | k u8 | m u8 | block u32 | small u32 |
# uuid 16s | meta u64 | durable u64 | sealed u64 | head u64 | crc u32
_JOURNAL = struct.Struct(">I")
_JOURNAL_BODY = struct.Struct("<HBBII16sQQQQ")

STAGES = ("write_sink", "parity_update", "h2d_dispatch", "device_drain", "fsync_publish")


def _env_kib(name: str, default_kib: int) -> int:
    try:
        v = int(os.environ.get(name, str(default_kib)))
    except ValueError:
        v = default_kib
    return max(v, 1) << 10


def stream_block_size() -> int:
    """Large-stripe row block (bytes): SEAWEED_EC_STREAM_BLOCK_KB."""
    return _env_kib("SEAWEED_EC_STREAM_BLOCK_KB", 1024)


def stream_small_block_size() -> int:
    """Tail re-stripe block (bytes): SEAWEED_EC_STREAM_SMALL_KB."""
    return _env_kib("SEAWEED_EC_STREAM_SMALL_KB", 64)


# -- the sw_ec_stream_* metrics (utils/metrics.py), the JAX package's -----------

parity_lag = M.REGISTRY.histogram(
    "sw_ec_stream_parity_lag_seconds",
    "per-append wall time from append() to durable parity "
    "(time-to-durable-parity, the streaming-EC first-class metric)",
    buckets=(
        0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
        10.0, 30.0,
    ),
)
_appended_bytes = M.REGISTRY.counter(
    "sw_ec_stream_appended_bytes_total",
    "bytes appended to EC stream encoders",
)
_stripes_sealed = M.REGISTRY.counter(
    "sw_ec_stream_stripes_sealed_total",
    "EC stream stripes sealed (final parity published)",
)
_recovered = M.REGISTRY.counter(
    "sw_ec_stream_recovered_total",
    "EC stream recovery events by outcome",
    ("outcome",),
)

# Parity batches dispatched by every encoder of this process
# (`_dispatch_apply`); recovery's per-stripe applies are not among them.
_dispatches = 0
_dispatch_lock = threading.Lock()


def dispatch_count() -> int:
    """Parity batches this process's encoders have dispatched."""
    return _dispatches


# Live encoders for the open-streams gauge and stream_summary(): weak, so
# a dropped encoder is not kept alive by the roll-up.
_live_streams: "weakref.WeakSet[EcStreamEncoder]" = weakref.WeakSet()


def _open_stream_samples():
    yield {}, float(sum(1 for e in list(_live_streams) if not e.closed))


M.REGISTRY.gauge(
    "sw_ec_stream_open",
    "EC stream encoders currently open",
    fn=_open_stream_samples,
)


def stream_summary() -> dict:
    """Process-local streaming-EC roll-up (the JAX package's keys): open
    streams with their live parity lag, plus the lifetime counters."""
    streams = []
    for enc in list(_live_streams):
        if enc.closed:
            continue
        streams.append(
            {
                "base": os.path.basename(enc.base),
                "head_bytes": enc.head,
                "durable_bytes": enc.durable,
                "sealed_stripes": enc.sealed_stripes,
                "parity_lag_ms": round(enc.parity_lag_s() * 1000.0, 3),
                "chip": enc.chip_label,
            }
        )
    return {
        "open": len(streams),
        "streams": sorted(streams, key=lambda s: s["base"]),
        "appended_bytes": sum(_appended_bytes.snapshot().values()),
        "stripes_sealed": sum(_stripes_sealed.snapshot().values()),
        # label tuples -> plain strings: this dict rides JSON surfaces
        "recovered": {(k[0] if k else ""): v for k, v in _recovered.snapshot().items()},
    }


# --------------------------------------------------------------------------
# Stripe-cursor journal
# --------------------------------------------------------------------------


@dataclass
class StreamJournal:
    """Decoded `<base>.stream` cursor: everything recovery needs to
    trust the on-disk stream prefix."""

    uuid: bytes
    meta: int  # embedder cookie (MQ: base record offset of this stream)
    durable: int  # linear bytes with durable data AND parity
    sealed: int  # stripes whose final parity is published
    head: int  # advisory: bytes appended at journal time (>= durable)
    block_size: int = 0
    small_block_size: int = 0
    data_shards: int = 0
    parity_shards: int = 0

    def to_bytes(self) -> bytes:
        body = _JOURNAL_BODY.pack(
            FORMAT_VERSION,
            self.data_shards,
            self.parity_shards,
            self.block_size,
            self.small_block_size,
            self.uuid,
            self.meta,
            self.durable,
            self.sealed,
            self.head,
        )
        raw = _JOURNAL.pack(MAGIC) + body
        return raw + struct.pack("<I", crc32c(raw))


def load_stream_journal(base: str) -> StreamJournal | None:
    """The stream's cursor, or None when absent or torn: the journal is
    written after the fsync it describes, so a torn cursor means nothing
    past the previous one was durable."""
    path = base + JOURNAL_SUFFIX
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    if len(raw) != _JOURNAL.size + _JOURNAL_BODY.size + 4:
        return None
    if crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        return None
    if _JOURNAL.unpack_from(raw)[0] != MAGIC:
        return None
    (
        version, k, m, block, small, uid, meta, durable, sealed, head,
    ) = _JOURNAL_BODY.unpack_from(raw, _JOURNAL.size)
    if version != FORMAT_VERSION:
        return None
    return StreamJournal(
        uuid=uid, meta=meta, durable=durable, sealed=sealed, head=head,
        block_size=block, small_block_size=small,
        data_shards=k, parity_shards=m,
    )


# --------------------------------------------------------------------------
# The encoder
# --------------------------------------------------------------------------


class EcStreamEncoder:
    """Online EC encoder for one append stream of unknown length.

    append, flush and close serialize on internal locks, so a broker's
    append path and its background parity flusher may race freely.
    `scheduler` is the QueueScope whose placement and admission the
    stream runs under (None = the process-wide default). `meta` is an
    opaque embedder cookie persisted in the journal (the MQ glue stores
    the partition's base record offset)."""

    def __init__(
        self,
        base: str,
        ctx: ECContext = DEFAULT_EC_CONTEXT,
        backend=None,
        block_size: int | None = None,
        small_block_size: int | None = None,
        leaf_size: int = BITROT_LEAF_SIZE,
        scheduler=None,
        meta: int = 0,
        fsync: bool = True,
    ):
        if backend is None:
            backend = get_backend("cuda", ctx.data_shards, ctx.parity_shards)
        self.base = base
        self.ctx = ctx
        self.block_size = int(block_size or stream_block_size())
        self.small_block_size = int(small_block_size or stream_small_block_size())
        if self.small_block_size > self.block_size:
            raise ECError(
                f"small block {self.small_block_size} exceeds block {self.block_size}"
            )
        self.leaf_size = leaf_size
        self.meta = int(meta)
        self.uuid = _uuid.uuid4().bytes
        self._fsync = fsync
        k, m, total = ctx.data_shards, ctx.parity_shards, ctx.total
        self._k, self._m = k, m
        self._stripe_row = self.block_size * k
        # parity generator rows of the RS matrix (m x k): the linearity
        # identity needs exactly these coefficients
        self._gen = np.ascontiguousarray(
            np.asarray(backend.matrix, dtype=np.uint8)[k : k + m, :]
        )
        # Two locks so the append path never waits on parity math or
        # fsync: `_buf_lock` guards only the pending buffer, head and lag
        # queue; `_lock` serializes process/flush/close (stripe state,
        # fds, journal). Lock order where both are held: _lock outer,
        # _buf_lock inner.
        self._lock = threading.RLock()
        self._buf_lock = threading.Lock()
        self._fds: list[int] = []
        try:
            for i in range(total):
                self._fds.append(
                    os.open(base + ctx.to_ext(i), os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
                )
        except BaseException:
            for fd in self._fds:
                os.close(fd)
            raise
        self._builders = [ShardChecksumBuilder(BITROT_BLOCK_SIZE, leaf_size) for _ in range(total)]
        # open-stripe state: data rows and incremental parity in memory;
        # `filled` is the linear byte count within the stripe
        self._data = np.zeros((k, self.block_size), dtype=np.uint8)
        self._parity = np.zeros((m, self.block_size), dtype=np.uint8)
        self._filled = 0
        self.sealed_stripes = 0
        # appended-but-unprocessed bytes (parity not yet computed)
        self._pending: list[bytes] = []
        self._pending_bytes = 0
        # (linear end offset, append wall time) for lag attribution
        self._lag_q: list[tuple[int, float]] = []
        self.head = 0  # bytes appended
        self._processed = 0  # bytes run through the parity math
        self.durable = 0  # bytes with durable data+parity (journaled)
        self._touched: set[int] = set()
        self.closed = False
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        # the flight recorder's span: one long-lived op, closed at close();
        # one long-lived foreground stream, placed once
        self._span = trace.start(
            "ec.stream_encode", name=os.path.basename(base), base=base,
            block_size=self.block_size,
        )
        self._placement = place_stream(
            backend, "foreground",
            scope=scheduler,
            cost_hint=batch_cost(m, self.block_size),
            span=self._span,
        )
        self._backend = self._placement.backend
        self.chip_label = getattr(self._backend, "chip_label", "")
        self._stream = open_stream(
            self._placement.queue, "foreground", label="ec stream encode", span=self._span,
            chip=self.chip_label,
        )
        self._write_journal()
        _live_streams.add(self)

    @contextmanager
    def _stage(self, name: str):
        """Time the block into stage_seconds[name] and the span's stage
        (device stages labeled with the chip)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stage_seconds[name] += dt
            if self._span is not None:
                chip = self.chip_label if name in trace.DEVICE_STAGES else ""
                self._span.add_stage(name, dt, chip)

    # ------------------------------------------------------------ append

    def append(self, data: bytes) -> int:
        """Buffer `data` at the stream head; returns the linear byte
        offset it starts at. Takes only the buffer lock (one copy).
        Parity is computed at the next :meth:`process`/:meth:`flush`;
        durability comes from flush."""
        if not data:
            return self.head
        with self._buf_lock:
            if self.closed:
                raise ECError(f"stream encoder {self.base} is closed")
            off = self.head
            self._pending.append(bytes(data))
            self._pending_bytes += len(data)
            self.head += len(data)
            self._lag_q.append((self.head, time.monotonic()))
            _appended_bytes.inc(len(data))
            return off

    @property
    def pending_bytes(self) -> int:
        with self._buf_lock:
            return self.head - self.durable

    def parity_lag_s(self) -> float:
        """Age of the oldest append whose parity is not yet durable
        (0.0 when fully flushed)."""
        with self._buf_lock:
            if not self._lag_q:
                return 0.0
            return max(time.monotonic() - self._lag_q[0][1], 0.0)

    # ----------------------------------------------------------- process

    def _dispatch_apply(self, coeffs: np.ndarray, batch: np.ndarray) -> np.ndarray:
        """One parity-delta batch through the placed device stream
        (DeviceQueue admission at `batch_cost(m, width)`, or a
        DirectStream when the scheduler is disabled); returns the
        m x width host delta."""
        global _dispatches
        with _dispatch_lock:
            _dispatches += 1
        be = self._backend
        # the stream records "admission_wait" and "h2d_dispatch" on the
        # span itself; the stage table gets the dispatch's wall here
        t0 = time.perf_counter()
        ticket, handle = self._stream.dispatch(
            lambda: be.apply_staged(coeffs, be.to_device(batch)),
            batch_cost(coeffs.shape[0], batch.shape[-1]),
        )
        self.stage_seconds["h2d_dispatch"] += max(time.perf_counter() - t0 - ticket.wait_s, 0.0)
        try:
            with self._stage("device_drain"):
                return np.ascontiguousarray(be.to_host(handle), np.uint8)
        finally:
            self._stream.release(ticket)

    def _seal_stripe(self) -> None:
        """The open stripe is full: publish its final parity rows, roll
        every shard's CRCs, reset the stripe buffers."""
        faults.fire("ec.stream.seal", base=self.base, stripe=self.sealed_stripes)
        base_off = self.sealed_stripes * self.block_size
        k, m = self._k, self._m
        with self._stage("write_sink"):
            for j in range(m):
                os.pwrite(self._fds[k + j], self._parity[j], base_off)
                self._touched.add(k + j)
        for i in range(k):
            self._builders[i].write(self._data[i])
        for j in range(m):
            self._builders[k + j].write(self._parity[j])
        self._data[:] = 0
        self._parity[:] = 0
        self._filled = 0
        self.sealed_stripes += 1
        _stripes_sealed.inc()

    def process(self) -> None:
        """Drain the append buffer through the parity math: data rows
        pwritten at their final offsets, parity updated in place (RS
        linearity), full stripes sealed. Does not fsync or journal."""
        with self._lock:
            self._process_locked()

    def _process_locked(self) -> None:
        with self._buf_lock:
            if not self._pending:
                return
            buf = b"".join(self._pending)
            self._pending = []
            self._pending_bytes = 0
        self._processed += len(buf)
        block, row_bytes = self.block_size, self._stripe_row
        pos = 0
        while pos < len(buf):
            row, col = divmod(self._filled, block)
            take = min(len(buf) - pos, block - col)
            # the open-stripe row takes the chunk; its slice (writable,
            # contiguous, the same bytes) is what goes to the backend
            chunk = self._data[row, col : col + take]
            chunk[:] = np.frombuffer(buf, dtype=np.uint8, count=take, offset=pos)
            with self._stage("write_sink"):
                os.pwrite(self._fds[row], chunk, self.sealed_stripes * block + col)
            self._touched.add(row)
            # incremental parity: P[:, col:col+take] ^= G[:, row] @ chunk
            with self._stage("parity_update"):
                delta = self._dispatch_apply(self._gen[:, row : row + 1], chunk.reshape(1, take))
                self._parity[:, col : col + take] ^= delta
            pos += take
            self._filled += take
            if self._filled == row_bytes:
                self._seal_stripe()

    # ------------------------------------------------------------- flush

    def flush(self) -> int:
        """Make every appended byte durable with its parity: process the
        buffer, fsync touched shards, advance the journal, observe each
        covered append's time-to-durable-parity. Returns the durable
        head."""
        with self._lock:
            if self.closed:
                return self.durable
            self._process_locked()
            # partial-flush parity for the open stripe: its whole
            # covered column range
            if self._filled and self._processed > self.durable:
                block, k = self.block_size, self._k
                hi = block if self._filled >= block else self._filled
                base_off = self.sealed_stripes * block
                with self._stage("write_sink"):
                    for j in range(self._m):
                        os.pwrite(self._fds[k + j], self._parity[j, :hi], base_off)
                        self._touched.add(k + j)
            faults.fire("ec.stream.before_fsync", base=self.base)
            if self._fsync and self._touched:
                with self._stage("fsync_publish"):
                    for i in sorted(self._touched):
                        os.fsync(self._fds[i])
                self._touched.clear()
            faults.fire("ec.stream.before_journal", base=self.base)
            # durable = bytes processed and fsynced this cycle; appends
            # racing this flush stay pending for the next one
            self.durable = self._processed
            self._write_journal()
            now = time.monotonic()
            with self._buf_lock:
                while self._lag_q and self._lag_q[0][0] <= self.durable:
                    _, t0 = self._lag_q.pop(0)
                    parity_lag.observe(max(now - t0, 0.0))
            return self.durable

    def _write_journal(self) -> None:
        j = StreamJournal(
            uuid=self.uuid,
            meta=self.meta,
            durable=self.durable,
            sealed=self.sealed_stripes,
            head=self.head,
            block_size=self.block_size,
            small_block_size=self.small_block_size,
            data_shards=self._k,
            parity_shards=self._m,
        )
        atomic_write(self.base + JOURNAL_SUFFIX, j.to_bytes())

    # ------------------------------------------------------------- close

    def close(self, finalize: bool = True) -> BitrotProtection | None:
        """End the stream. ``finalize=True`` re-stripes the ragged tail
        with small blocks (bit-identical to `write_ec_files` over the
        concatenation), publishes the `.ecsum` sidecar and retires the
        journal. ``finalize=False`` (broker stream rotation) flushes and
        closes: the large layout and journal stay recoverable."""
        with self._lock:
            if self.closed:
                return None
            prot: BitrotProtection | None = None
            try:
                self.flush()
                if finalize:
                    prot = self._finalize_locked()
            finally:
                # refuse further appends before the fds go away
                with self._buf_lock:
                    self.closed = True
                for fd in self._fds:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
                self._fds = []
                self._stream.close()
                self._placement.close()
                trace.finish(self._span)
            return prot

    def _finalize_locked(self) -> BitrotProtection:
        ctx = self.ctx
        k, m, block = self._k, self._m, self.block_size
        small = self.small_block_size
        tail_len = self._filled
        if tail_len:
            # the open stripe was written in the large layout for crash
            # recovery; the batch encoder stripes a sub-stripe tail with
            # small rows: rewrite it identically
            base_off = self.sealed_stripes * block
            for fd in self._fds:
                os.ftruncate(fd, base_off)
            tail = self._data.reshape(-1)[:tail_len]  # the rows in linear order
            off = 0
            t = 0
            small_row = small * k
            while off < tail_len:
                seg = tail[off : off + small_row]
                mat = np.zeros((k, small), dtype=np.uint8)
                mat.reshape(-1)[: len(seg)] = seg
                parity = self._dispatch_apply(self._gen, mat)
                woff = base_off + t * small
                rows = [mat[i] for i in range(k)] + [parity[j] for j in range(m)]
                with self._stage("write_sink"):
                    for i, row in enumerate(rows):
                        os.pwrite(self._fds[i], row, woff)
                        self._builders[i].write(row)
                        self._touched.add(i)
                off += small_row
                t += 1
            self._data[:] = 0
            self._parity[:] = 0
            self._filled = 0
        faults.fire("ec.stream.before_seal_publish", base=self.base)
        if self._fsync:
            with self._stage("fsync_publish"):
                for fd in self._fds:
                    os.fsync(fd)
            fsync_dir(self.base + ctx.to_ext(0))
        prot = BitrotProtection.from_builders(ctx, self._builders)
        prot.save(self.base + ".ecsum")
        try:
            os.unlink(self.base + JOURNAL_SUFFIX)
            fsync_dir(self.base + JOURNAL_SUFFIX)
        except OSError:
            pass
        return prot

    def __enter__(self) -> "EcStreamEncoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close(finalize=not any(exc))


# --------------------------------------------------------------------------
# Recovery (non-finalized streams: the broker's rotating generations)
# --------------------------------------------------------------------------


def _data_extent_head(base: str, ctx: ECContext, block_size: int) -> int:
    """Largest contiguous linear head the on-disk data-row extents can
    support (large-stripe layout): an upper bound on what a frame scan
    may trust."""
    k = ctx.data_shards
    sizes = []
    for i in range(k):
        try:
            sizes.append(os.path.getsize(base + ctx.to_ext(i)))
        except OSError:
            sizes.append(0)
    head = 0
    s = 0
    while True:
        stripe_head = 0
        for sz in sizes:
            e = min(max(sz - s * block_size, 0), block_size)
            stripe_head += e
            if e < block_size:
                break
        head += stripe_head
        if stripe_head < block_size * k:
            return head
        s += 1


def read_stream_data(base: str, ctx: ECContext, block_size: int, lo: int, hi: int) -> bytes:
    """Linear bytes [lo, hi) of a non-finalized stream from its on-disk
    data rows (large-stripe layout; absent extents read as zeros)."""
    if hi <= lo:
        return b""
    row_bytes = block_size * ctx.data_shards
    out = bytearray(hi - lo)
    fds: dict[int, int] = {}
    try:
        pos = lo
        while pos < hi:
            s, rem = divmod(pos, row_bytes)
            row, col = divmod(rem, block_size)
            take = min(hi - pos, block_size - col)
            fd = fds.get(row)
            if fd is None:
                try:
                    fd = os.open(base + ctx.to_ext(row), os.O_RDONLY)
                except OSError:
                    fd = -1
                fds[row] = fd
            if fd >= 0:
                got = os.pread(fd, take, s * block_size + col)
                out[pos - lo : pos - lo + len(got)] = got
            pos += take
    finally:
        for fd in fds.values():
            if fd >= 0:
                os.close(fd)
    return bytes(out)


@dataclass
class StreamRecovery:
    """What :func:`recover_stream` established about one stream."""

    journal: StreamJournal
    head: int  # verified linear head (embedder-framed, parity-repaired)
    data: bytes  # linear bytes [0, head)
    parity_rewritten: int  # stripes whose parity was re-derived
    rolled_back: int  # bytes past `head` discarded


def recover_stream(
    base: str,
    ctx: ECContext | None = None,
    backend=None,
    frame_scan=None,
) -> StreamRecovery | None:
    """Crash-recover a non-finalized stream.

    Reads the journal (absent or torn: None), bounds the head by the
    on-disk data extents, lets `frame_scan(data) -> head_bytes` trim to
    the embedder's record framing (None accepts the full extent), then
    re-derives parity for every covered stripe (one (m, k) apply per
    stripe) and rewrites any that disagrees with the data. Bytes past
    the verified head are rolled back (truncated). With no backend it
    takes the card, `get_backend("cuda", k, m)`."""
    j = load_stream_journal(base)
    if j is None:
        _recovered.inc(outcome="no_journal")
        return None
    if ctx is None:
        ctx = ECContext(j.data_shards, j.parity_shards)
    if (j.data_shards, j.parity_shards) != (ctx.data_shards, ctx.parity_shards):
        _recovered.inc(outcome="config_mismatch")
        return None
    block = j.block_size
    k, m = ctx.data_shards, ctx.parity_shards
    row_bytes = block * k
    hmax = _data_extent_head(base, ctx, block)
    data = read_stream_data(base, ctx, block, 0, hmax)
    head = hmax
    if frame_scan is not None:
        head = min(int(frame_scan(data)), hmax)
        data = data[:head]
    if head < j.durable:
        # fsync promised these bytes and the frames do not reach them
        log.warning("stream %s: durable cursor %d but only %d bytes recovered",
                    base, j.durable, head)
        _recovered.inc(outcome="data_lost")
    if backend is None:
        backend = get_backend("cuda", k, m)
    gen = np.ascontiguousarray(np.asarray(backend.matrix, dtype=np.uint8)[k : k + m, :])
    rewritten = 0
    n_stripes = -(-head // row_bytes) if head else 0
    pfds = [
        os.open(base + ctx.to_ext(k + jx), os.O_RDWR | os.O_CREAT, 0o644)
        for jx in range(m)
    ]
    try:
        for s in range(n_stripes):
            seg = data[s * row_bytes : (s + 1) * row_bytes]
            mat = np.zeros((k, block), dtype=np.uint8)
            mat.reshape(-1)[: len(seg)] = np.frombuffer(seg, dtype=np.uint8)
            want = np.ascontiguousarray(backend.apply(gen, mat), dtype=np.uint8)
            ok = True
            for jx in range(m):
                have = os.pread(pfds[jx], block, s * block)
                have = have + b"\0" * (block - len(have))
                if have != want[jx].tobytes():
                    ok = False
                    break
            if not ok:
                for jx in range(m):
                    os.pwrite(pfds[jx], want[jx], s * block)
                rewritten += 1
        for fd in pfds:
            os.fsync(fd)
        # roll back data extents past the verified head, so a partial
        # row beyond it never resurfaces on the next extent scan
        if hmax > head:
            s, rem = divmod(head, row_bytes)
            row, col = divmod(rem, block)
            for i in range(k):
                path = base + ctx.to_ext(i)
                try:
                    cur = os.path.getsize(path)
                except OSError:
                    continue
                keep = s * block + (block if i < row else (col if i == row else 0))
                if cur > keep:
                    with open(path, "rb+") as f:
                        f.truncate(keep)
    finally:
        for fd in pfds:
            os.close(fd)
    # the journal reflects the verified state going forward
    j2 = StreamJournal(
        uuid=j.uuid, meta=j.meta, durable=head,
        sealed=head // row_bytes, head=head,
        block_size=block, small_block_size=j.small_block_size,
        data_shards=k, parity_shards=m,
    )
    atomic_write(base + JOURNAL_SUFFIX, j2.to_bytes())
    if rewritten:
        _recovered.inc(rewritten, outcome="parity_rewritten")
    _recovered.inc(outcome="replayed" if head else "rolled_back")
    return StreamRecovery(
        journal=j, head=head, data=data,
        parity_rewritten=rewritten, rolled_back=max(hmax - head, 0),
    )
