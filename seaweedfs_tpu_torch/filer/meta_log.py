"""Persisted filer metadata log: every mutation appended as one JSON
line, replayable from any timestamp.

Port of seaweedfs_tpu/filer/meta_log.py, whole: the records are the JAX
ones field for field (reference weed/filer meta log, filer_notify*.go —
events appended to per-filer log files, consumed by SubscribeMetadata for
mount cache invalidation and filer.sync). NDJSON segments with size-based
rotation; readers tail from a ts_ns watermark.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterator, Optional

from ..pb import filer_pb2 as fpb
from .notification import event_to_json

SEGMENT_BYTES = 64 * 1024 * 1024
KEEP_SEGMENTS = 8


class MetaLog:
    """Append-only NDJSON event log with rotation."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Condition()
        self._current_path = os.path.join(directory, "meta.log")
        self._f = open(self._current_path, "ab")
        self.last_ts_ns = self._scan_last_ts()
        # newest tsNs among segments retention has DELETED: a subscriber
        # whose watermark is below this has an unrecoverable gap.
        # In-memory only — a filer restart resets it (subscribers then
        # rely on oldest_retained_ts staying ahead of their watermark).
        self.dropped_before_ts = 0

    def _scan_last_ts(self) -> int:
        last = 0
        for path in self._segments():
            try:
                with open(path, "rb") as f:
                    for line in f:
                        try:
                            last = max(last, json.loads(line).get("tsNs", 0))
                        except json.JSONDecodeError:
                            continue
            except FileNotFoundError:
                continue
        return last

    def oldest_retained_ts(self) -> int:
        """tsNs of the oldest record still on disk (0 = empty log).
        A subscriber whose watermark is older than this has a GAP —
        events were rotated away — and must full-resync."""
        for path in self._segments():
            try:
                with open(path, "rb") as f:
                    for line in f:
                        try:
                            return json.loads(line).get("tsNs", 0)
                        except json.JSONDecodeError:
                            continue
            except FileNotFoundError:
                continue
        return 0

    # ------------------------------------------------------------- write

    def __call__(self, ev: fpb.FullEventNotification) -> None:
        """Filer listener entry point."""
        record = event_to_json(ev)
        line = (json.dumps(record, separators=(",", ":")) + "\n").encode()
        with self._lock:
            self._f.write(line)
            self._f.flush()
            # max(): a non-monotonic record must never roll the
            # watermark (or sealed-segment name) backwards
            self.last_ts_ns = max(self.last_ts_ns, record["tsNs"])
            if self._f.tell() > SEGMENT_BYTES:
                self._rotate_locked()
            self._lock.notify_all()

    def _rotate_locked(self) -> None:
        self._f.close()
        # sealed name carries the segment's newest tsNs so readers can
        # skip whole segments below their watermark
        sealed = os.path.join(
            self.directory, f"meta-{self.last_ts_ns:020d}.log"
        )
        os.replace(self._current_path, sealed)
        self._f = open(self._current_path, "ab")
        # bounded retention
        sealed_all = sorted(
            f for f in os.listdir(self.directory) if f.startswith("meta-")
        )
        for old in sealed_all[:-KEEP_SEGMENTS]:
            try:
                self.dropped_before_ts = max(
                    self.dropped_before_ts, int(old[5:-4])
                )
            except ValueError:
                pass
            os.unlink(os.path.join(self.directory, old))

    # -------------------------------------------------------------- read

    def _segments(self) -> list[str]:
        sealed = sorted(
            os.path.join(self.directory, f)
            for f in os.listdir(self.directory)
            if f.startswith("meta-")
        )
        return sealed + [self._current_path]

    def read_since(self, since_ns: int, limit: int = 10_000) -> list[dict]:
        """Events with tsNs > since_ns, oldest first."""
        if since_ns >= self.last_ts_ns:
            return []
        out: list[dict] = []
        for path in self._segments():
            # sealed segment names embed their max tsNs: skip whole
            # segments below the watermark instead of re-parsing them
            name = os.path.basename(path)
            if name.startswith("meta-"):
                try:
                    if int(name[5:-4]) <= since_ns:
                        continue
                except ValueError:
                    pass
            try:
                with open(path, "rb") as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                        except json.JSONDecodeError:
                            continue  # torn tail line
                        if rec.get("tsNs", 0) > since_ns:
                            out.append(rec)
                            if len(out) >= limit:
                                return out
            except FileNotFoundError:
                continue
        return out

    def wait_for_events(self, since_ns: int, timeout: float) -> bool:
        with self._lock:
            return self._lock.wait_for(
                lambda: self.last_ts_ns > since_ns, timeout=timeout
            )

    def close(self) -> None:
        with self._lock:
            self._f.close()
