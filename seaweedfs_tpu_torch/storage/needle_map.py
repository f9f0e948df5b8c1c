"""Index conversion .idx -> sorted .ecx, and lookups in a sealed .ecx.

Port of the part of seaweedfs_tpu/storage/needle_map.py that sealing and
reading an EC volume need: `walk_index_file` and `MemDb` (reference
ec_encoder.go:32-59), and `SortedFileNeedleMap`. All on-disk entries are
the 16-byte big-endian format of storage/types.py.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from ..utils.fs import fsync_dir
from .types import NEEDLE_MAP_ENTRY_SIZE, NeedleValue


def walk_index_file(path: str) -> Iterator[NeedleValue]:
    """Yield idx entries in write order."""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(NEEDLE_MAP_ENTRY_SIZE * 4096)
            if not chunk:
                return
            usable = len(chunk) - (len(chunk) % NEEDLE_MAP_ENTRY_SIZE)
            for i in range(0, usable, NEEDLE_MAP_ENTRY_SIZE):
                yield NeedleValue.from_bytes(chunk[i : i + NEEDLE_MAP_ENTRY_SIZE])


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
