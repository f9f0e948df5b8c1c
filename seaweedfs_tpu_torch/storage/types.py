"""On-disk scalar types: the 16-byte .idx/.ecx record and needle sizes.

Port of the part of seaweedfs_tpu/storage/types.py that sealing, reading
and decoding an EC volume need: [needleId(8) | offset(4) | size(4)],
big-endian (reference weed/storage/types/needle_types.go:59-64); offsets
in units of 8 bytes; size == 0xFFFFFFFF (int32 -1, TombstoneFileSize)
marks a deletion.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

NEEDLE_PADDING_SIZE = 8
# Body size is stored as int32 in the idx entry, so the hard cap is 2^31-1.
MAX_NEEDLE_BODY_SIZE = (1 << 31) - 1
NEEDLE_HEADER_SIZE = 16  # cookie(4) + id(8) + size(4)
NEEDLE_MAP_ENTRY_SIZE = 16
NEEDLE_CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8  # appendAtNs in the v3 footer
TOMBSTONE_FILE_SIZE = -1  # stored as 0xFFFFFFFF

_IDX_STRUCT = struct.Struct(">QIi")  # needleId, offset(units of 8), size


@dataclass(frozen=True)
class NeedleValue:
    """One index entry: where a needle lives inside a volume."""

    needle_id: int
    offset: int  # stored units (multiply by 8 for bytes)
    size: int  # payload size; TOMBSTONE_FILE_SIZE for deletions

    def to_bytes(self) -> bytes:
        return _IDX_STRUCT.pack(self.needle_id, self.offset, self.size)

    @classmethod
    def from_bytes(cls, b: bytes) -> "NeedleValue":
        nid, off, size = _IDX_STRUCT.unpack(b)
        return cls(nid, off, size)

    @property
    def is_deleted(self) -> bool:
        return self.size == TOMBSTONE_FILE_SIZE


def actual_offset(stored_offset: int) -> int:
    """Stored offset (8-byte units) -> byte offset in the .dat file."""
    return stored_offset * NEEDLE_PADDING_SIZE


def to_stored_offset(byte_offset: int) -> int:
    if byte_offset % NEEDLE_PADDING_SIZE != 0:
        raise ValueError(f"unaligned offset {byte_offset}")
    return byte_offset // NEEDLE_PADDING_SIZE


def padded_record_size(header_and_body: int) -> int:
    """Total bytes a record occupies on disk after 8-byte alignment."""
    return header_and_body + (-header_and_body) % NEEDLE_PADDING_SIZE
