"""Volume superblock: the first 8 bytes of every .dat file.

Port of seaweedfs_tpu/storage/super_block.py (reference
weed/storage/super_block/super_block.go:13-23):
  [version(1) | replicaPlacement(1) | TTL(2) | compactionRevision(2) |
   reserved(2)]
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

SUPER_BLOCK_SIZE = 8

_STRUCT = struct.Struct(">BB2sHxx")


@dataclass(frozen=True)
class ReplicaPlacement:
    """Replica placement code XYZ: copies on other DCs / racks / servers
    (reference weed/storage/super_block/replica_placement.go)."""

    diff_data_centers: int = 0
    diff_racks: int = 0
    same_rack: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        if len(s) != 3 or not s.isdigit():
            raise ValueError(f"replica placement must be 3 digits, got {s!r}")
        return cls(int(s[0]), int(s[1]), int(s[2]))

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls(b // 100, (b // 10) % 10, b % 10)

    def to_byte(self) -> int:
        return self.diff_data_centers * 100 + self.diff_racks * 10 + self.same_rack

    @property
    def copy_count(self) -> int:
        return self.diff_data_centers + self.diff_racks + self.same_rack + 1

    def __str__(self) -> str:
        return f"{self.diff_data_centers}{self.diff_racks}{self.same_rack}"


@dataclass
class SuperBlock:
    version: int = 3
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: bytes = b"\x00\x00"
    compaction_revision: int = 0

    def to_bytes(self) -> bytes:
        return _STRUCT.pack(
            self.version, self.replica_placement.to_byte(), self.ttl, self.compaction_revision
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "SuperBlock":
        if len(raw) < SUPER_BLOCK_SIZE:
            raise ValueError("superblock too short")
        version, rp, ttl, rev = _STRUCT.unpack(raw[:SUPER_BLOCK_SIZE])
        if version not in (2, 3):
            raise ValueError(f"unsupported volume version {version}")
        return cls(version, ReplicaPlacement.from_byte(rp), ttl, rev)
