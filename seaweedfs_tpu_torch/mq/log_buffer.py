"""Per-partition append log: in-memory ring + sealed segment spill.

Port of seaweedfs_tpu/mq/log_buffer.py, whole: the same records, the
same segments, byte for byte. Reference: weed/util/log_buffer (MQ's in-memory segmented log) +
weed/mq/logstore (filer-backed segment files). Segments spill through a
pluggable `spill(segment_index, records_bytes)` callback — the broker
wires it to filer-backed storage; None keeps everything in memory.

Record wire format inside a segment (LE): [len u32 | offset i64 |
ts_ns i64 | key_len u16 | key | value]. Offsets are dense per partition.
"""

from __future__ import annotations

import struct
import threading
from typing import Callable, Iterator, Optional

_REC = struct.Struct("<IqqH")


def encode_record(offset: int, ts_ns: int, key: bytes, value: bytes) -> bytes:
    body_len = _REC.size - 4 + len(key) + len(value)
    return _REC.pack(body_len, offset, ts_ns, len(key)) + key + value


def decode_records(raw: bytes) -> Iterator[tuple[int, int, bytes, bytes]]:
    pos = 0
    while pos + 4 <= len(raw):
        (body_len,) = struct.unpack_from("<I", raw, pos)
        end = pos + 4 + body_len
        if end > len(raw):
            return
        _, offset, ts_ns, key_len = _REC.unpack_from(raw, pos)
        p = pos + _REC.size
        key = raw[p : p + key_len]
        value = raw[p + key_len : end]
        yield offset, ts_ns, key, value
        pos = end


class PartitionLog:
    """Dense-offset append log for one partition."""

    def __init__(
        self,
        segment_records: int = 4096,
        spill: Optional[Callable[[int, bytes], None]] = None,
        load: Optional[Callable[[int], Optional[bytes]]] = None,
        next_offset: int = 0,
        earliest_offset: int = 0,
    ):
        self._lock = threading.Condition()
        self.segment_records = segment_records
        self._spill = spill
        self._load = load
        self.next_offset = next_offset
        self.earliest_offset = earliest_offset
        # live (unsealed) tail records: list of (offset, ts, key, value)
        self._tail: list[tuple[int, int, bytes, bytes]] = []
        self._tail_base = next_offset
        # observer fed every accepted append UNDER the partition lock
        # (offset order guaranteed) — the durable-parity stream
        # (mq/stream_parity.py) buffers the record's wire bytes here;
        # parity math/fsync run on the flusher's schedule, not the
        # append path. None = no parity for this partition.
        self.on_append: Optional[
            Callable[[int, int, bytes, bytes], None]
        ] = None

    # ------------------------------------------------------------ write

    def append(self, ts_ns: int, key: bytes, value: bytes) -> int:
        with self._lock:
            off = self.next_offset
            self._tail.append((off, ts_ns, key, value))
            self.next_offset = off + 1
            if self.on_append is not None:
                self.on_append(off, ts_ns, key, value)
            if len(self._tail) >= self.segment_records:
                self._seal_locked()
            self._lock.notify_all()
            return off

    def append_at(self, offset: int, ts_ns: int, key: bytes, value: bytes) -> int:
        """Follower-side append at a LEADER-assigned offset: replicas
        mirror the leader's dense numbering. Duplicates are ignored; a
        GAP is refused (returns the expected offset) so the leader can
        backfill — a silently-accepted gap would surface as lost acked
        records after a failover promotion."""
        with self._lock:
            if offset < self.next_offset:
                return self.next_offset  # duplicate of a held record
            if offset > self.next_offset:
                return self.next_offset  # refuse: leader must backfill
            self._tail.append((offset, ts_ns, key, value))
            self.next_offset = offset + 1
            if self.on_append is not None:
                self.on_append(offset, ts_ns, key, value)
            if len(self._tail) >= self.segment_records:
                self._seal_locked()
            self._lock.notify_all()
            return self.next_offset

    def append_batch(
        self, records: list[tuple[int, bytes, bytes]]
    ) -> int:
        """Append [(ts_ns, key, value), ...] with CONTIGUOUS offsets
        under one lock hold; returns the first offset. Kafka clients
        compute record offsets as baseOffset + index-in-batch, so a
        batch must never interleave with a concurrent producer's."""
        with self._lock:
            base = self.next_offset
            for i, (ts_ns, key, value) in enumerate(records):
                self._tail.append((base + i, ts_ns, key, value))
            self.next_offset = base + len(records)
            if self.on_append is not None:
                for i, (ts_ns, key, value) in enumerate(records):
                    self.on_append(base + i, ts_ns, key, value)
            if len(self._tail) >= self.segment_records:
                self._seal_locked()
            self._lock.notify_all()
            return base

    def _seal_locked(self) -> None:
        if not self._tail or self._spill is None:
            if self._spill is None and len(self._tail) > self.segment_records * 4:
                # memory-only mode: bound the tail by dropping the oldest
                drop = len(self._tail) - self.segment_records * 4
                self._tail = self._tail[drop:]
                self._tail_base = self._tail[0][0]
                self.earliest_offset = self._tail_base
            return
        # Spill runs under the partition lock: readers must never observe
        # a cleared tail whose records have not yet landed in a segment.
        # The cost (appends stall during a slow spill) is bounded by one
        # segment per segment_records appends; async double-buffered
        # spill is a later optimization.
        # Every record lands in its offset-aligned segment, merging with
        # previously spilled partial content — a flush mid-segment (e.g.
        # broker shutdown) followed by post-restart appends must never
        # overwrite earlier records in that slot.
        groups: dict[int, list] = {}
        for r in self._tail:
            groups.setdefault(r[0] // self.segment_records, []).append(r)
        for seg, recs in sorted(groups.items()):
            raw = b"".join(encode_record(*r) for r in recs)
            if recs[0][0] % self.segment_records != 0 and self._load is not None:
                prev = self._load(seg)
                if prev:
                    # keep only records below our first (idempotent merge)
                    kept = b"".join(
                        encode_record(*pr)
                        for pr in decode_records(prev)
                        if pr[0] < recs[0][0]
                    )
                    raw = kept + raw
            self._spill(seg, raw)
        self._tail_base = self.next_offset
        self._tail = []

    def fast_forward(self, offset: int) -> bool:
        """Advance an EMPTY log to start at `offset` (parity-stream
        recovery whose retention window begins past 0: the records
        below it fell out of a bounded tail and are gone by design).
        Refused on a log that holds or held records — dense numbering
        must never skip over live state."""
        with self._lock:
            if self._tail or self.next_offset != self.earliest_offset:
                return False
            if offset <= self.next_offset:
                return False
            self.next_offset = offset
            self.earliest_offset = offset
            self._tail_base = offset
            return True

    def flush(self) -> None:
        with self._lock:
            self._seal_locked()

    def truncate_before(self, offset: int) -> int:
        """Drop records below `offset` (-1 = everything): earliest
        advances, in-memory tail records below it are freed. Durable
        segment files are the broker's to delete (segment-granular);
        returns the new earliest offset."""
        with self._lock:
            boundary = self.next_offset if offset < 0 else min(
                offset, self.next_offset
            )
            self._tail = [r for r in self._tail if r[0] >= boundary]
            self._tail_base = (
                self._tail[0][0] if self._tail else self.next_offset
            )
            self.earliest_offset = max(self.earliest_offset, boundary)
            return self.earliest_offset

    # ------------------------------------------------------------- read

    def read_from(
        self, offset: int, max_records: int = 1024
    ) -> list[tuple[int, int, bytes, bytes]]:
        """Records with offset >= `offset` (up to max_records); pulls
        sealed segments through `load` when the tail has rotated past.
        Reads below earliest_offset clamp up to it: after a truncation
        the deleted whole segments would otherwise read as an
        empty-break and silently skip the retained partial segment."""
        offset = max(offset, self.earliest_offset)
        with self._lock:
            if offset >= self._tail_base:
                start = 0
                for i, r in enumerate(self._tail):
                    if r[0] >= offset:
                        start = i
                        break
                else:
                    return []
                return self._tail[start : start + max_records]
            tail_snapshot = list(self._tail)
        out: list[tuple[int, int, bytes, bytes]] = []
        if self._load is not None:
            seg = offset // self.segment_records
            while len(out) < max_records:
                raw = self._load(seg)
                if raw is None:
                    break
                for rec in decode_records(raw):
                    if rec[0] >= offset and len(out) < max_records:
                        out.append(rec)
                seg += 1
                if out and out[-1][0] + 1 >= self._tail_base:
                    break
        for rec in tail_snapshot:
            if rec[0] >= offset and len(out) < max_records:
                if not out or rec[0] > out[-1][0]:
                    out.append(rec)
        return out

    def wait_for(self, offset: int, timeout: float) -> bool:
        """Block until next_offset > offset (new data) or timeout."""
        with self._lock:
            return self._lock.wait_for(
                lambda: self.next_offset > offset, timeout=timeout
            )
