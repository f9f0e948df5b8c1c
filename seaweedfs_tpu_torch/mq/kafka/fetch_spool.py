"""Zero-copy catch-up fetch: sealed-segment batch spool.

Port of seaweedfs_tpu/mq/kafka/fetch_spool.py, whole.

A catch-up consumer reads offsets far behind the tail, i.e. out of
SEALED log segments that will never change again. The hot path used to
re-materialize those records through Python on every fetch: load the
segment, build Record objects, re-encode a Kafka record batch, copy it
into the response buffer — O(bytes) interpreter work per consumer per
pass.

The spool transcodes a sealed segment ONCE into its Kafka record-batch
v2 wire form, parks it in a local spool file, and hands fetches a
:class:`frame_pool.FileExtent` over it. Egress then goes
kernel-to-kernel via ``sn_send_file`` (native plane) or a plain
read+send (Python fallback) — the SAME bytes either way, so the two
planes are bit-identical by construction and the plane choice is
invisible to clients.

Serving a whole sealed segment as one batch is protocol-legal: Kafka
brokers may return batches that START BEFORE the fetch offset
(typically when serving from disk exactly like this); clients skip
records below their requested offset.

Entries are keyed by (topic, partition, segment) and pinned to the
PartitionLog instance they were built from — a deleted/recreated topic
gets fresh PartitionLog objects, which invalidates its spool entries
by identity. Total spool size is LRU-bounded by
``SEAWEED_MQ_FETCH_SPOOL_MB``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from collections import OrderedDict

from .frame_pool import FileExtent
from .records import Record, encode_batch


def spool_cap_bytes() -> int:
    return int(os.environ.get("SEAWEED_MQ_FETCH_SPOOL_MB", "64")) << 20


class _Entry:
    __slots__ = ("path", "length", "plog", "base_offset", "next_offset")

    def __init__(self, path, length, plog, base_offset, next_offset):
        self.path = path
        self.length = length
        self.plog = plog
        self.base_offset = base_offset
        self.next_offset = next_offset


class FetchSpool:
    def __init__(self, root: str | None = None):
        self._own_root = root is None
        self.root = root or tempfile.mkdtemp(prefix="kafka-spool-")
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.builds = 0

    # ------------------------------------------------------------- lookup

    def extent_for(
        self, topic: str, partition: int, plog, offset: int
    ) -> tuple[FileExtent, int, int] | None:
        """(extent, batch_base_offset, next_offset_after_batch) serving
        `offset` out of a sealed segment, or None when the offset's
        segment is not fully sealed (tail data, or partially truncated)
        — the caller then takes the ordinary in-memory path."""
        seg_size = getattr(plog, "segment_records", 0)
        tail_base = getattr(plog, "_tail_base", 0)
        if seg_size <= 0 or offset >= tail_base:
            return None
        seg = offset // seg_size
        seg_base = seg * seg_size
        seg_end = seg_base + seg_size
        if seg_end > tail_base or seg_base < plog.earliest_offset:
            return None
        key = (topic, partition, seg)
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.plog is plog:
                self._entries.move_to_end(key)
                self.hits += 1
                return (
                    FileExtent(e.path, 0, e.length),
                    e.base_offset,
                    e.next_offset,
                )
        e = self._build(key, plog, seg_base, seg_end)
        if e is None:
            return None
        return FileExtent(e.path, 0, e.length), e.base_offset, e.next_offset

    def _build(self, key, plog, seg_base: int, seg_end: int) -> _Entry | None:
        from .gateway import _unpack_null

        recs = plog.read_from(seg_base, max_records=seg_end - seg_base)
        recs = [r for r in recs if r[0] < seg_end]
        if not recs or recs[0][0] != seg_base:
            return None  # segment not intact on this path; don't cache
        batch = encode_batch(
            [
                Record(
                    key=_unpack_null(k),
                    value=_unpack_null(val),
                    timestamp_ms=ts // 1_000_000,
                    offset=o,
                )
                for o, ts, k, val in recs
            ],
            base_offset=seg_base,
        )
        topic, partition, seg = key
        path = os.path.join(self.root, f"{topic}-{partition}-{seg}.batch")
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(batch)
            os.replace(tmp, path)
        except OSError:
            return None
        e = _Entry(path, len(batch), plog, seg_base, recs[-1][0] + 1)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.length
            self._entries[key] = e
            self._bytes += e.length
            self.builds += 1
            self._evict_locked()
        return e

    def _evict_locked(self) -> None:
        cap = spool_cap_bytes()
        while self._bytes > cap and len(self._entries) > 1:
            _key, old = self._entries.popitem(last=False)
            self._bytes -= old.length
            try:
                os.unlink(old.path)
            except OSError:
                pass

    # ------------------------------------------------------------- status

    def status(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "cap_bytes": spool_cap_bytes(),
                "hits": self.hits,
                "builds": self.builds,
            }

    def close(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)
