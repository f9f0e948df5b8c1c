"""EC layout constants and context (port of seaweedfs_tpu/ec/context.py).

Reference: weed/storage/erasure_coding/ec_encoder.go:21-28 — default 10+4,
max 32 shards, 1GB large blocks then 1MB small blocks, row-major striping
over the data shards.
"""

from __future__ import annotations

from dataclasses import dataclass

DATA_SHARDS = 10
PARITY_SHARDS = 4
MAX_SHARD_COUNT = 32  # ShardBits is a uint32 bitmap
LARGE_BLOCK_SIZE = 1024 * 1024 * 1024  # 1GB
SMALL_BLOCK_SIZE = 1024 * 1024  # 1MB

# Bitrot sidecar granularity (reference ec_bitrot.go BitrotBlockSize).
BITROT_BLOCK_SIZE = 16 * 1024 * 1024  # 16 MiB

# Sub-block leaf granularity for the v2 .ecsum sidecar: degraded reads
# verify and reconstruct only the leaves covering the requested extent,
# cutting the verified-degraded-read amplification by up to
# BITROT_BLOCK_SIZE / BITROT_LEAF_SIZE (256x at the defaults). 0
# disables leaves (writes a v1 sidecar).
BITROT_LEAF_SIZE = 64 * 1024  # 64 KiB

# Scrub quarantines a corrupt shard by renaming it to <shard>.bad.
QUARANTINE_SUFFIX = ".bad"


class ECError(Exception):
    pass


@dataclass(frozen=True)
class ECContext:
    """Shard-count configuration for one EC volume."""

    data_shards: int = DATA_SHARDS
    parity_shards: int = PARITY_SHARDS

    def __post_init__(self):
        if self.data_shards <= 0 or self.parity_shards <= 0:
            raise ECError(f"invalid EC config {self}")
        if self.total > MAX_SHARD_COUNT:
            raise ECError(f"{self}: total shards exceed {MAX_SHARD_COUNT}")

    @property
    def total(self) -> int:
        return self.data_shards + self.parity_shards

    def to_ext(self, shard_id: int) -> str:
        """Shard file extension (reference ToExt: '.ec00' .. '.ec31')."""
        if not 0 <= shard_id < self.total:
            raise ECError(f"shard id {shard_id} out of range for {self}")
        return f".ec{shard_id:02d}"

    def __str__(self) -> str:
        return f"{self.data_shards}+{self.parity_shards}"


DEFAULT_EC_CONTEXT = ECContext()
