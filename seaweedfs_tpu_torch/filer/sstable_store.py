"""Embedded ordered-KV filer store: WAL + memtable + immutable SSTables.

Port of seaweedfs_tpu/filer/sstable_store.py, whole: a store directory is
the JAX one byte for byte (WAL records, segment files, compaction), so
either package opens the other's. The reference ships LevelDB-family
embedded stores (weed/filer/leveldb*); this is the same class of engine
built the immutable-segment way: every mutation is journaled to a CRC'd
WAL, absorbed into an in-memory table, and flushed as a sorted, immutable
segment file with a sparse index. Readers merge memtable + segments
newest-first; size-tiered compaction folds segments together and drops
tombstones.

Keyspace: entries are ``E<dir>\\x00<name>`` so a directory's children
are one contiguous key range (the reference's leveldb store uses the
same dir-prefix trick); KV pairs live under ``K``.
"""

from __future__ import annotations

import bisect
import os
import struct
import threading
from typing import Iterator, Optional

from ..utils.crc import crc32c
from ..utils.fs import fsync_dir
from .entry import Entry
from .filer_store import NotFound

_WAL_HDR = struct.Struct("<II")  # payload_len, crc32c(payload)
_SEG_MAGIC = b"SST1"
_SPARSE_EVERY = 16

_PUT, _DEL = 1, 0


def _entry_key(directory: str, name: str) -> bytes:
    return b"E" + directory.encode() + b"\x00" + name.encode()


def _kv_key(key: bytes) -> bytes:
    return b"K" + key


class _Segment:
    """One immutable sorted segment: records ``[klen u32][key][vlen i32]
    [value]`` (vlen -1 = tombstone), then a sparse index of every Nth
    key, then ``[index_offset u64][count u32][magic]``."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._f.seek(0, os.SEEK_END)
        file_end = self._f.tell()
        self._f.seek(file_end - 16)
        idx_off, count = struct.unpack("<QI", self._f.read(12))
        if self._f.read(4) != _SEG_MAGIC:
            raise OSError(f"bad segment magic in {path}")
        self._data_end = idx_off
        self._f.seek(idx_off)
        self.sparse_keys: list[bytes] = []
        self.sparse_offs: list[int] = []
        for _ in range(count):
            (klen,) = struct.unpack("<I", self._f.read(4))
            self.sparse_keys.append(self._f.read(klen))
            (off,) = struct.unpack("<Q", self._f.read(8))
            self.sparse_offs.append(off)
        self._lock = threading.Lock()

    @staticmethod
    def write(path: str, items: list[tuple[bytes, Optional[bytes]]]) -> None:
        """Persist sorted (key, value|None) pairs atomically."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            sparse: list[tuple[bytes, int]] = []
            for i, (k, v) in enumerate(items):
                if i % _SPARSE_EVERY == 0:
                    sparse.append((k, f.tell()))
                f.write(struct.pack("<I", len(k)) + k)
                if v is None:
                    f.write(struct.pack("<i", -1))
                else:
                    f.write(struct.pack("<i", len(v)) + v)
            idx_off = f.tell()
            for k, off in sparse:
                f.write(struct.pack("<I", len(k)) + k + struct.pack("<Q", off))
            f.write(struct.pack("<QI", idx_off, len(sparse)) + _SEG_MAGIC)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(path)

    def _records_from(self, off: int) -> Iterator[tuple[bytes, Optional[bytes], int]]:
        """Yield (key, value, next_offset) from `off`; caller holds lock."""
        f = self._f
        f.seek(off)
        while off < self._data_end:
            (klen,) = struct.unpack("<I", f.read(4))
            k = f.read(klen)
            (vlen,) = struct.unpack("<i", f.read(4))
            v = f.read(vlen) if vlen >= 0 else None
            off = f.tell()
            yield k, v, off

    def get(self, key: bytes) -> tuple[bool, Optional[bytes]]:
        """-> (found, value|None-for-tombstone)."""
        if not self.sparse_keys or key < self.sparse_keys[0]:
            return False, None
        i = bisect.bisect_right(self.sparse_keys, key) - 1
        with self._lock:
            for k, v, _nxt in self._records_from(self.sparse_offs[i]):
                if k == key:
                    return True, v
                if k > key:
                    return False, None
        return False, None

    def range(self, lo: bytes, hi: bytes) -> Iterator[tuple[bytes, Optional[bytes]]]:
        """All (key, value) with lo <= key < hi, ascending. Materializes
        the qualifying records under the lock (segments are immutable
        and block-local, so this is bounded by the range size)."""
        if not self.sparse_keys:
            return iter(())
        i = max(bisect.bisect_right(self.sparse_keys, lo) - 1, 0)
        out: list[tuple[bytes, Optional[bytes]]] = []
        with self._lock:
            for k, v, _nxt in self._records_from(self.sparse_offs[i]):
                if k >= hi:
                    break
                if k >= lo:
                    out.append((k, v))
        return iter(out)

    def items(self) -> list[tuple[bytes, Optional[bytes]]]:
        with self._lock:
            return [(k, v) for k, v, _ in self._records_from(0)]

    def close(self) -> None:
        self._f.close()


class SSTableStore:
    """FilerStore over the WAL + memtable + segment engine."""

    def __init__(
        self,
        directory: str,
        memtable_limit: int = 4 << 20,
        compact_at: int = 8,
        fsync: bool = False,
    ):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.memtable_limit = memtable_limit
        self.compact_at = compact_at
        self.fsync = fsync
        self._lock = threading.RLock()
        self._mem: dict[bytes, Optional[bytes]] = {}
        self._mem_bytes = 0
        self._segments: list[_Segment] = []  # oldest .. newest
        self._seq = 0
        for name in sorted(os.listdir(directory)):
            if name.startswith("seg-") and name.endswith(".sst"):
                self._segments.append(_Segment(os.path.join(directory, name)))
                self._seq = max(self._seq, int(name[4:-4]) + 1)
        self._wal_path = os.path.join(directory, "wal.log")
        self._replay_wal()
        self._wal = open(self._wal_path, "ab")

    # ------------------------------------------------------------- WAL

    def _replay_wal(self) -> None:
        if not os.path.exists(self._wal_path):
            return
        valid_end = 0
        with open(self._wal_path, "rb") as f:
            while True:
                hdr = f.read(_WAL_HDR.size)
                if len(hdr) < _WAL_HDR.size:
                    break
                ln, want = _WAL_HDR.unpack(hdr)
                payload = f.read(ln)
                if len(payload) < ln or crc32c(payload) != want:
                    break  # torn tail: everything before it is intact
                valid_end = f.tell()
                op = payload[0]
                (klen,) = struct.unpack_from("<I", payload, 1)
                k = payload[5 : 5 + klen]
                v = payload[5 + klen :] if op == _PUT else None
                self._mem_apply(k, v)
        if os.path.getsize(self._wal_path) > valid_end:
            # Truncate the torn record NOW: appending after it would
            # strand every post-crash write behind bytes the next
            # replay can never get past (acked writes would vanish on
            # the reopen after next).
            with open(self._wal_path, "r+b") as f:
                f.truncate(valid_end)
                f.flush()
                os.fsync(f.fileno())

    def _wal_append(self, key: bytes, value: Optional[bytes]) -> None:
        op = _PUT if value is not None else _DEL
        payload = (
            bytes([op]) + struct.pack("<I", len(key)) + key + (value or b"")
        )
        self._wal.write(_WAL_HDR.pack(len(payload), crc32c(payload)) + payload)
        self._wal.flush()
        if self.fsync:
            os.fsync(self._wal.fileno())

    # -------------------------------------------------------- memtable

    def _mem_apply(self, key: bytes, value: Optional[bytes]) -> None:
        if key not in self._mem:
            self._mem_bytes += len(key)
        else:
            self._mem_bytes -= len(self._mem[key] or b"")
        self._mem[key] = value
        self._mem_bytes += len(value or b"")

    def _write(self, key: bytes, value: Optional[bytes]) -> None:
        with self._lock:
            self._wal_append(key, value)
            self._mem_apply(key, value)
            if self._mem_bytes >= self.memtable_limit:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._mem:
            return
        path = os.path.join(self.dir, f"seg-{self._seq:08d}.sst")
        _Segment.write(path, sorted(self._mem.items()))
        self._seq += 1
        self._segments.append(_Segment(path))
        self._mem.clear()
        self._mem_bytes = 0
        self._wal.close()
        os.unlink(self._wal_path)
        self._wal = open(self._wal_path, "ab")
        fsync_dir(self._wal_path)
        if len(self._segments) > self.compact_at:
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Size-tiered-to-one: merge every segment, newest value wins,
        tombstones dropped (nothing older remains to resurrect)."""
        merged: dict[bytes, Optional[bytes]] = {}
        for seg in self._segments:  # oldest -> newest
            for k, v in seg.items():
                merged[k] = v
        live = sorted(
            (k, v) for k, v in merged.items() if v is not None
        )
        path = os.path.join(self.dir, f"seg-{self._seq:08d}.sst")
        _Segment.write(path, live)
        self._seq += 1
        old = self._segments
        self._segments = [_Segment(path)]
        for seg in old:
            seg.close()
            os.unlink(seg.path)
        fsync_dir(path)

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    # ----------------------------------------------------------- reads

    def _get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            if key in self._mem:
                return self._mem[key]
            for seg in reversed(self._segments):
                found, v = seg.get(key)
                if found:
                    return v
        return None

    def _range(self, lo: bytes, hi: bytes) -> Iterator[tuple[bytes, bytes]]:
        """Merged ascending scan of [lo, hi); newest layer wins,
        tombstones suppress."""
        with self._lock:
            layers: dict[bytes, Optional[bytes]] = {}
            for seg in self._segments:  # oldest first
                for k, v in seg.range(lo, hi):
                    layers[k] = v
            for k, v in self._mem.items():
                if lo <= k < hi:
                    layers[k] = v
        for k in sorted(layers):
            v = layers[k]
            if v is not None:
                yield k, v

    # ------------------------------------------------- FilerStore SPI

    def insert(self, entry: Entry) -> None:
        self._write(_entry_key(entry.directory, entry.name), entry.to_bytes())

    update = insert

    def find(self, directory: str, name: str) -> Entry:
        raw = self._get(_entry_key(directory, name))
        if raw is None:
            raise NotFound(f"{directory}/{name}")
        return Entry.from_bytes(directory, raw)

    def delete(self, directory: str, name: str) -> None:
        self._write(_entry_key(directory, name), None)

    def delete_folder_children(self, directory: str) -> None:
        prefix = directory if directory.endswith("/") else directory + "/"
        # children whose parent IS `directory`
        lo = b"E" + directory.encode() + b"\x00"
        for k, _v in list(self._range(lo, lo + b"\xff")):
            self._write(k, None)
        # children of every nested directory (dir string prefix match;
        # \xff exceeds any UTF-8 lead byte, so it is a safe upper bound)
        lo = b"E" + prefix.encode()
        for k, _v in list(self._range(lo, lo + b"\xff")):
            self._write(k, None)

    def list(
        self,
        directory: str,
        start_from: str = "",
        limit: int = 1024,
        prefix: str = "",
    ) -> Iterator[Entry]:
        base = b"E" + directory.encode() + b"\x00"
        # tighten the scan's lower bound with start_from so pagination
        # is O(page), not O(directory); the `name <= start_from` filter
        # below still enforces the exclusive boundary
        lo = base + max(prefix, start_from).encode()
        hi = base + (prefix.encode() + b"\xff" if prefix else b"\xff")
        n = 0
        for k, v in self._range(lo, hi):
            name = k[len(base):].decode()
            if start_from and name <= start_from:
                continue
            if n >= limit:
                return
            yield Entry.from_bytes(directory, v)
            n += 1

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._write(_kv_key(key), value)

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self._get(_kv_key(key))

    def kv_delete(self, key: bytes) -> None:
        self._write(_kv_key(key), None)

    def kv_put_if_absent(self, key: bytes, value: bytes) -> bytes:
        with self._lock:
            got = self._get(_kv_key(key))
            if got is not None:
                return got
            self._write(_kv_key(key), value)
            return value

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            self._wal.close()
            for seg in self._segments:
                seg.close()
