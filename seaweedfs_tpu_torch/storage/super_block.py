"""Volume superblock: the first 8 bytes of every .dat file.

Port of seaweedfs_tpu/storage/super_block.py (reference
weed/storage/super_block/super_block.go:13-23):
  [version(1) | replicaPlacement(1) | TTL(2) | compactionRevision(2) |
   reserved(2)]
The replica placement byte is kept as its raw XYZ code (100x + 10y + z).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

SUPER_BLOCK_SIZE = 8

_STRUCT = struct.Struct(">BB2sHxx")


@dataclass
class SuperBlock:
    version: int = 3
    replica_placement: int = 0  # XYZ code: other DCs, racks, servers
    ttl: bytes = b"\x00\x00"
    compaction_revision: int = 0

    def to_bytes(self) -> bytes:
        return _STRUCT.pack(
            self.version, self.replica_placement, self.ttl, self.compaction_revision
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "SuperBlock":
        if len(raw) < SUPER_BLOCK_SIZE:
            raise ValueError("superblock too short")
        version, rp, ttl, rev = _STRUCT.unpack(raw[:SUPER_BLOCK_SIZE])
        if version not in (2, 3):
            raise ValueError(f"unsupported volume version {version}")
        return cls(version, rp, ttl, rev)
