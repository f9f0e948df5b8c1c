"""Needle maps: needleId -> (offset, size) per volume.

Port of seaweedfs_tpu/storage/needle_map.py (the reference offers
in-memory, LevelDB and sorted-file mappers behind `NeedleMapper`,
weed/storage/needle_map.go:23):

- `MemoryNeedleMap`: dict-backed, rebuilt by replaying the .idx journal
  (the reference's default for hot volumes);
- `SqliteNeedleMap`: the LevelDB-class durable map on sqlite, an index
  of the .idx journal at `<idx>.ldb` with a replay watermark (O(delta)
  reopen); the same database the JAX package keeps;
- `SortedFileNeedleMap`: binary search over a sealed, sorted .ecx;
- `MemDb`: turns a write-ordered .idx into a sorted
  .ecx (reference ec_encoder.go:32-59).

All on-disk entries are the 16-byte big-endian format of storage/types.py.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from ..utils.fs import fsync_dir
from .types import NEEDLE_MAP_ENTRY_SIZE, TOMBSTONE_FILE_SIZE, NeedleValue


def walk_index_file(path: str, start: int = 0) -> Iterator[NeedleValue]:
    """Yield idx entries in write order, optionally from a byte offset
    (the watermark-tail replay)."""
    with open(path, "rb") as f:
        if start:
            f.seek(start)
        while True:
            chunk = f.read(NEEDLE_MAP_ENTRY_SIZE * 4096)
            if not chunk:
                return
            usable = len(chunk) - (len(chunk) % NEEDLE_MAP_ENTRY_SIZE)
            for i in range(0, usable, NEEDLE_MAP_ENTRY_SIZE):
                yield NeedleValue.from_bytes(chunk[i : i + NEEDLE_MAP_ENTRY_SIZE])


def heal_torn_tail(idx_path: str) -> None:
    """A crash can tear the trailing entry; appending after a torn tail
    would skew every later entry's alignment, so truncate to whole
    records before replay and reopen."""
    if not os.path.exists(idx_path):
        return
    size = os.path.getsize(idx_path)
    torn = size % NEEDLE_MAP_ENTRY_SIZE
    if torn:
        with open(idx_path, "r+b") as f:
            f.truncate(size - torn)


class MemoryNeedleMap:
    """Write-through needle map: dict in memory + append-only .idx file."""

    def __init__(self, idx_path: str):
        self.idx_path = idx_path
        self._map: dict[int, NeedleValue] = {}
        self.file_counter = 0
        self.deleted_counter = 0
        self.deleted_bytes = 0
        # journal appends since the last fsync: flush() is a no-op on a
        # clean map, so a group-commit window with no index traffic (or
        # back-to-back flushes) costs zero extra fsyncs
        self._dirty = False
        self._idx_file = None
        if os.path.exists(idx_path):
            heal_torn_tail(idx_path)
            for nv in walk_index_file(idx_path):
                self._replay(nv)
        self._idx_file = open(idx_path, "ab")

    def _replay(self, nv: NeedleValue) -> None:
        if nv.is_deleted:
            old = self._map.pop(nv.needle_id, None)
            if old is not None:
                self.deleted_counter += 1
                self.deleted_bytes += old.size
        else:
            self._log_put(nv)

    def _log_put(self, nv: NeedleValue) -> None:
        # Overwrites dead-record the previous copy in the .dat; count it
        # as garbage so vacuum triggers (reference needle_map_metric.go
        # logPut adds oldSize to the deletion counters).
        old = self._map.get(nv.needle_id)
        self._map[nv.needle_id] = nv
        self.file_counter += 1
        if old is not None and old.size > 0:
            self.deleted_counter += 1
            self.deleted_bytes += old.size

    def put(self, needle_id: int, offset: int, size: int) -> None:
        nv = NeedleValue(needle_id, offset, size)
        self._log_put(nv)
        self._idx_file.write(nv.to_bytes())
        # to the kernel with every journal append: an acked write's index
        # entry must survive SIGKILL (fsync is the caller's power-loss knob)
        self._idx_file.flush()
        self._dirty = True

    def delete(self, needle_id: int) -> int:
        """Append a tombstone; returns freed byte count (0 if absent)."""
        old = self._map.pop(needle_id, None)
        self._idx_file.write(
            NeedleValue(needle_id, 0, TOMBSTONE_FILE_SIZE).to_bytes()
        )
        self._idx_file.flush()
        self._dirty = True
        if old is None:
            return 0
        self.deleted_counter += 1
        self.deleted_bytes += old.size
        return old.size

    def get(self, needle_id: int) -> Optional[NeedleValue]:
        return self._map.get(needle_id)

    def __len__(self) -> int:
        return len(self._map)

    def ascending_visit(self) -> Iterator[NeedleValue]:
        for nid in sorted(self._map):
            yield self._map[nid]

    def flush(self) -> None:
        if self._idx_file and self._dirty:
            self._dirty = False
            self._idx_file.flush()
            os.fsync(self._idx_file.fileno())

    def close(self) -> None:
        if self._idx_file:
            self._idx_file.flush()
            self._idx_file.close()
            self._idx_file = None


class SqliteNeedleMap:
    """Durable B-tree needle map: the LevelDB-class mapper
    (reference weed/storage/needle_map_leveldb.go) on sqlite.

    The .idx journal stays authoritative (EC conversion, replication,
    crash recovery all read it); the sqlite DB at ``<idx>.ldb`` is an
    index OF the journal with a persisted replay watermark, so reopening
    a volume replays only the .idx tail written since the last flush —
    O(delta), not O(live needles) — and resident memory is a small
    pending-write buffer instead of the whole map."""

    FLUSH_EVERY = 2000  # pending ops before a sqlite transaction

    def __init__(self, idx_path: str, generation: int = 0):
        import sqlite3
        import threading

        self.idx_path = idx_path
        self.db_path = idx_path + ".ldb"
        self._pending: dict[int, Optional[NeedleValue]] = {}  # None = delete
        # guards _pending + db access: has_needle/scrub read the map
        # WITHOUT the volume lock (safe for the memory map's atomic
        # dict.get; sqlite needs explicit serialization)
        self._op_lock = threading.Lock()
        self.file_counter = 0
        self.deleted_counter = 0
        self.deleted_bytes = 0
        self._dirty = False  # journal appends since the last fsync
        self._generation = generation
        self._idx_file = None
        heal_torn_tail(idx_path)
        try:
            self._open_db()
        except sqlite3.DatabaseError:
            # synchronous=OFF can physically corrupt the .ldb on power
            # loss; the .idx journal is authoritative, so discard the
            # cache and rebuild rather than keeping the volume offline
            self._discard_db()
            self._open_db()
        watermark = self._meta("watermark")
        idx_size = os.path.getsize(idx_path) if os.path.exists(idx_path) else 0
        if watermark > idx_size or self._meta("generation") != generation:
            # the journal was replaced (vacuum commit) or shrank: the DB
            # indexes a different file — rebuild from scratch
            self._db.execute("DELETE FROM needles")
            self._db.execute("DELETE FROM meta")
            watermark = 0
        else:
            self.file_counter = self._meta("file_counter")
            self.deleted_counter = self._meta("deleted_counter")
            self.deleted_bytes = self._meta("deleted_bytes")
        # replay only the journal tail the DB hasn't absorbed yet
        if idx_size > watermark:
            for nv in walk_index_file(idx_path, start=watermark):
                if nv.is_deleted:
                    self._apply_delete(nv.needle_id)
                else:
                    self._apply_put(nv)
            with self._op_lock:
                self._commit_pending_locked()
        self._idx_file = open(idx_path, "ab")

    def _open_db(self) -> None:
        import sqlite3

        # autocommit connection; _commit_pending manages its own
        # BEGIN/COMMIT batches (implicit transactions would collide)
        self._db = sqlite3.connect(
            self.db_path, check_same_thread=False, isolation_level=None
        )
        self._db.execute("PRAGMA journal_mode=WAL")
        # the .idx journal is the durability story; sqlite may lose its
        # last transactions on power loss and recover from the watermark
        self._db.execute("PRAGMA synchronous=OFF")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS needles"
            " (id INTEGER PRIMARY KEY, offset INTEGER, size INTEGER)"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v INTEGER)"
        )

    def _discard_db(self) -> None:
        try:
            self._db.close()
        except Exception:
            pass
        for suffix in ("", "-wal", "-shm"):
            try:
                os.unlink(self.db_path + suffix)
            except OSError:
                pass

    def _meta(self, key: str) -> int:
        row = self._db.execute(
            "SELECT v FROM meta WHERE k = ?", (key,)
        ).fetchone()
        return int(row[0]) if row else 0

    # ---------------------------------------------------------- mutation

    def _apply_put(self, nv: NeedleValue) -> None:
        old = self.get(nv.needle_id)
        with self._op_lock:
            self._pending[nv.needle_id] = nv
        self.file_counter += 1
        if old is not None and old.size > 0:
            self.deleted_counter += 1
            self.deleted_bytes += old.size

    def _apply_delete(self, needle_id: int) -> int:
        old = self.get(needle_id)
        with self._op_lock:
            self._pending[needle_id] = None
        if old is None:
            return 0
        self.deleted_counter += 1
        self.deleted_bytes += old.size
        return old.size

    def put(self, needle_id: int, offset: int, size: int) -> None:
        self._apply_put(NeedleValue(needle_id, offset, size))
        self._idx_file.write(NeedleValue(needle_id, offset, size).to_bytes())
        self._idx_file.flush()
        self._dirty = True
        self._maybe_commit()

    def delete(self, needle_id: int) -> int:
        freed = self._apply_delete(needle_id)
        self._idx_file.write(
            NeedleValue(needle_id, 0, TOMBSTONE_FILE_SIZE).to_bytes()
        )
        self._idx_file.flush()
        self._dirty = True
        self._maybe_commit()
        return freed

    def _maybe_commit(self) -> None:
        if len(self._pending) >= self.FLUSH_EVERY:
            with self._op_lock:
                self._commit_pending_locked()

    def _commit_pending_locked(self) -> None:
        if not self._pending and self._meta("watermark") == self._idx_tell():
            return
        cur = self._db.cursor()
        cur.execute("BEGIN")
        for nid, nv in self._pending.items():
            if nv is None:
                cur.execute("DELETE FROM needles WHERE id = ?", (nid,))
            else:
                cur.execute(
                    "INSERT OR REPLACE INTO needles VALUES (?, ?, ?)",
                    (nid, nv.offset, nv.size),
                )
        for k, v in (
            ("watermark", self._idx_tell()),
            ("generation", self._generation),
            ("file_counter", self.file_counter),
            ("deleted_counter", self.deleted_counter),
            ("deleted_bytes", self.deleted_bytes),
        ):
            cur.execute("INSERT OR REPLACE INTO meta VALUES (?, ?)", (k, v))
        self._db.commit()
        self._pending.clear()

    def _idx_tell(self) -> int:
        if getattr(self, "_idx_file", None):
            return self._idx_file.tell()
        return os.path.getsize(self.idx_path) if os.path.exists(self.idx_path) else 0

    # ------------------------------------------------------------- reads

    def get(self, needle_id: int) -> Optional[NeedleValue]:
        with self._op_lock:
            if needle_id in self._pending:
                return self._pending[needle_id]
            row = self._db.execute(
                "SELECT offset, size FROM needles WHERE id = ?", (needle_id,)
            ).fetchone()
        if row is None:
            return None
        return NeedleValue(needle_id, int(row[0]), int(row[1]))

    def __len__(self) -> int:
        with self._op_lock:
            self._commit_pending_locked()
            return int(
                self._db.execute("SELECT COUNT(*) FROM needles").fetchone()[0]
            )

    def ascending_visit(self) -> Iterator[NeedleValue]:
        with self._op_lock:
            self._commit_pending_locked()
            rows = self._db.execute(
                "SELECT id, offset, size FROM needles ORDER BY id"
            ).fetchall()
        for nid, off, size in rows:
            yield NeedleValue(int(nid), int(off), int(size))

    def snapshot_batches(self, batch_size: int = 8192) -> Iterator[NeedleValue]:
        """Memory-bounded ascending scan via keyset pagination: each
        batch holds the op lock only briefly, so a live vacuum of a
        large volume never materializes the whole map (the point of
        this mapper). Rows added concurrently may appear (id > cursor)
        — harmless: vacuum's .idx-tail replay re-copies them."""
        last = -1
        while True:
            with self._op_lock:
                self._commit_pending_locked()
                rows = self._db.execute(
                    "SELECT id, offset, size FROM needles"
                    " WHERE id > ? ORDER BY id LIMIT ?",
                    (last, batch_size),
                ).fetchall()
            if not rows:
                return
            for nid, off, size in rows:
                yield NeedleValue(int(nid), int(off), int(size))
            last = int(rows[-1][0])

    def flush(self) -> None:
        # the .idx journal IS the durability contract; a sqlite commit
        # per fsync'd write would defeat the FLUSH_EVERY batching (a
        # crash before commit is the watermark-tail-replay case)
        if getattr(self, "_idx_file", None) and self._dirty:
            self._dirty = False
            self._idx_file.flush()
            os.fsync(self._idx_file.fileno())

    def close(self) -> None:
        if getattr(self, "_idx_file", None):
            with self._op_lock:
                self._commit_pending_locked()
            self._idx_file.flush()
            self._idx_file.close()
            self._idx_file = None
        # the sqlite connection stays open for lock-free straggler
        # readers (scrub/has_needle racing a vacuum's map swap); the
        # GC closes it when the last reference drops


class MemDb:
    """In-memory id->entry store for index conversions (.idx -> .ecx)."""

    def __init__(self):
        self._map: dict[int, NeedleValue] = {}

    def load_idx(self, idx_path: str) -> None:
        for nv in walk_index_file(idx_path):
            if nv.is_deleted:
                self._map.pop(nv.needle_id, None)
            else:
                self._map[nv.needle_id] = nv

    def ascending_visit(self) -> Iterator[NeedleValue]:
        for nid in sorted(self._map):
            yield self._map[nid]

    def write_sorted_file(self, path: str) -> None:
        """Write entries ascending by needleId, fsync'd (sealed .ecx)."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            for nv in self.ascending_visit():
                f.write(nv.to_bytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(path)


class SortedFileNeedleMap:
    """Binary search over a sealed sorted index file (.ecx semantics).

    A partial trailing record means corruption (reference
    ec_decoder.go:152-156 treats it as fatal). Only the 8-byte id column
    stays resident, in native byte order so `searchsorted` takes numpy's
    fast path; full entries are pread on demand.
    """

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        if size % NEEDLE_MAP_ENTRY_SIZE != 0:
            raise ValueError(f"{path}: corrupt sorted index (partial record)")
        self.count = size // NEEDLE_MAP_ENTRY_SIZE
        raw = np.fromfile(path, dtype=np.uint8).reshape(self.count, NEEDLE_MAP_ENTRY_SIZE)
        self._ids = np.ascontiguousarray(
            raw[:, :8].copy().view(">u8").reshape(self.count), dtype=np.uint64
        )
        self._fd = os.open(path, os.O_RDONLY)

    def _entry(self, i: int) -> NeedleValue:
        b = os.pread(self._fd, NEEDLE_MAP_ENTRY_SIZE, i * NEEDLE_MAP_ENTRY_SIZE)
        return NeedleValue.from_bytes(b)

    def get(self, needle_id: int) -> Optional[NeedleValue]:
        # a np.uint64 scalar, not a Python int: the typed comparison
        # stays on searchsorted's fast path
        i = int(np.searchsorted(self._ids, np.uint64(needle_id)))
        if i >= self.count or int(self._ids[i]) != needle_id:
            return None
        return self._entry(i)

    def ascending_visit(self) -> Iterator[NeedleValue]:
        for i in range(self.count):
            yield self._entry(i)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __len__(self) -> int:
        return self.count
