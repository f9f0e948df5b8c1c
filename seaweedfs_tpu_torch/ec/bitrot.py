"""Bitrot-protection sidecar: <base>.ecsum.

Port of seaweedfs_tpu/ec/bitrot.py; byte-identical files, so a sidecar
written by either package verifies shards for the other.

Per shard, a CRC32C per 16 MiB block, computed in the same pass that
writes the shard bytes. Self-checksummed header so a corrupt sidecar is
detected rather than trusted (reference ec_bitrot.go:15-58; this build
uses its own deterministic little-endian payload instead of protobuf).

The magic is deliberately NOT the reference's 'ECSU': the payload is a
different (non-protobuf) format, and a foreign reader that matched
magic+version but failed to unmarshal would classify the generation
BitrotInvalid (fail-closed, integrity alarms) instead of cleanly
treating the sidecar as unknown. A distinct magic makes foreign readers
reject it as "not my file" rather than "my file, corrupted".

File layout:
  [magic 'SWTS'(4, BE) | format_version (u16 LE) | payload_len (u32 LE)
   | payload_crc32c (u32 LE)] [payload]

Payload v1 (all LE):
  block_size u32 | generation u64 | data_shards u8 | parity_shards u8
  | uuid (16 raw bytes)
  | per shard (total times): shard_size u64 | crc_count u32 | crcs u32...

Payload v2 extends v1 with a sub-block CRC level — a CRC32C per
`leaf_size` leaf (64 KiB default) under the existing blocks — so the
degraded-read path verifies and reconstructs only the leaves covering a
requested extent instead of whole 16 MiB blocks:
  ... v1 fields ... | leaf_size u32
  | per shard (total times): leaf_count u32 | leaf_crcs u32...

v1 sidecars keep today's behavior (block-granular verification);
writers emit v1 whenever no leaf CRCs are present, so the format only
upgrades when the new data exists.
"""

from __future__ import annotations

import os
import struct
import uuid as uuid_mod
from dataclasses import dataclass, field

from ..utils.crc import crc32c, crc32c_combine
from .context import BITROT_BLOCK_SIZE, ECContext, ECError

MAGIC = 0x53575453  # "SWTS" — distinct from the reference's "ECSU"
# Sidecars written by pre-rename builds of THIS codebase carry "ECSU"
# around the same (non-protobuf) payload; keep reading them.
_LEGACY_MAGIC = 0x45435355  # "ECSU"
FORMAT_VERSION = 1
FORMAT_VERSION_V2 = 2
_HEADER = struct.Struct(">I")  # magic, big-endian like the reference
_HEADER_REST = struct.Struct("<HII")  # version, payload_len, payload_crc


class BitrotError(ECError):
    pass


class ShardChecksumBuilder:
    """Rolling per-block CRC32C accumulator for one shard's byte stream.

    With `leaf_size` set, a second per-leaf CRC level is rolled in the
    same pass (the v2 sidecar's sub-block granularity). Leaves are
    independent CRCs (each starts from 0), blocks are rolled directly —
    both levels over the identical byte stream."""

    def __init__(
        self, block_size: int = BITROT_BLOCK_SIZE, leaf_size: int = 0
    ):
        if leaf_size and block_size % leaf_size != 0:
            raise BitrotError(
                f"leaf size {leaf_size} does not divide block size {block_size}"
            )
        self.block_size = block_size
        self.leaf_size = leaf_size
        self.crcs: list[int] = []
        self.leaf_crcs: list[int] = []
        self._crc = 0
        self._filled = 0
        self._leaf_crc = 0
        self._leaf_filled = 0
        self.total = 0

    def write(self, data) -> None:
        """Roll `data` (any contiguous byte buffer) into both levels.
        Slices are memoryviews: no byte is copied."""
        data = memoryview(data).cast("B")
        self.total += len(data)
        if self.leaf_size:
            d = data
            while len(d) > 0:
                take = min(self.leaf_size - self._leaf_filled, len(d))
                self._leaf_crc = crc32c(d[:take], self._leaf_crc)
                self._leaf_filled += take
                d = d[take:]
                if self._leaf_filled == self.leaf_size:
                    self.leaf_crcs.append(self._leaf_crc)
                    self._leaf_crc = 0
                    self._leaf_filled = 0
        while len(data) > 0:
            room = self.block_size - self._filled
            take = min(room, len(data))
            self._crc = crc32c(data[:take], self._crc)
            self._filled += take
            data = data[take:]
            if self._filled == self.block_size:
                self.crcs.append(self._crc)
                self._crc = 0
                self._filled = 0

    def finish(self) -> list[int]:
        if self._filled > 0:
            self.crcs.append(self._crc)
            self._crc = 0
            self._filled = 0
        if self._leaf_filled > 0:
            self.leaf_crcs.append(self._leaf_crc)
            self._leaf_crc = 0
            self._leaf_filled = 0
        return self.crcs

    def finish_leaves(self) -> list[int]:
        self.finish()
        return self.leaf_crcs


def fold_leaf_crcs(
    leaf_crcs: list[int], total: int, leaf_size: int, block_size: int
) -> list[int]:
    """Derive block-level CRCs from independent per-leaf CRCs via
    crc32c_combine — no byte re-reads. The inverse consistency property
    (folded == directly-rolled block CRCs) is what lets the fused
    native sink run at leaf granularity and still emit the v1-compatible
    block level."""
    if leaf_size <= 0 or block_size % leaf_size != 0:
        raise BitrotError(
            f"leaf size {leaf_size} does not divide block size {block_size}"
        )
    per_block = block_size // leaf_size
    out: list[int] = []
    remaining = total
    for bi in range(0, len(leaf_crcs), per_block):
        crc = 0
        for li, leaf in enumerate(leaf_crcs[bi : bi + per_block]):
            nbytes = min(leaf_size, remaining - li * leaf_size)
            crc = crc32c_combine(crc, leaf, nbytes)
        out.append(crc)
        remaining -= min(block_size, remaining)
    return out


@dataclass
class BitrotProtection:
    """Decoded .ecsum contents. `leaf_size`/`shard_leaf_crcs` are the
    v2 sub-block level; empty on v1 sidecars (block granularity only)."""

    ctx: ECContext
    block_size: int = BITROT_BLOCK_SIZE
    generation: int = 0  # EncodeTsNs generation stamp
    uuid: bytes = b"\x00" * 16
    shard_sizes: list[int] = field(default_factory=list)
    shard_crcs: list[list[int]] = field(default_factory=list)
    leaf_size: int = 0
    shard_leaf_crcs: list[list[int]] = field(default_factory=list)

    @property
    def has_leaves(self) -> bool:
        return self.leaf_size > 0 and bool(self.shard_leaf_crcs)

    def verify_granularity(self, shard_id: int) -> tuple[int, list[int]]:
        """(granule_bytes, crc_row) for extent verification: the finest
        level this sidecar records for `shard_id`. An out-of-range id
        gets an empty row (verification of it can only fail), never an
        IndexError."""
        if self.has_leaves and shard_id < len(self.shard_leaf_crcs):
            return self.leaf_size, self.shard_leaf_crcs[shard_id]
        if shard_id < len(self.shard_crcs):
            return self.block_size, self.shard_crcs[shard_id]
        return self.block_size, []

    def verify_range(self, shard_id: int, lo: int, data) -> bool:
        """Verify `data` as the bytes of shard `shard_id` at [lo,
        lo+len(data)) against the finest granule CRCs the sidecar
        records. `lo` must be granule-aligned; the final granule may be
        the shard's partial tail."""
        gsize, crcs = self.verify_granularity(shard_id)
        hi = lo + len(data)
        for gi in range(lo // gsize, -(-hi // gsize)):
            blk = data[gi * gsize - lo : min((gi + 1) * gsize, hi) - lo]
            if gi >= len(crcs) or crc32c(blk) != crcs[gi]:
                return False
        return True

    @classmethod
    def from_builders(
        cls,
        ctx: ECContext,
        builders: list[ShardChecksumBuilder],
        generation: int = 0,
    ) -> "BitrotProtection":
        if len(builders) != ctx.total:
            raise BitrotError(f"expected {ctx.total} builders, got {len(builders)}")
        leaf_size = builders[0].leaf_size
        return cls(
            ctx=ctx,
            block_size=builders[0].block_size,
            generation=generation,
            uuid=uuid_mod.uuid4().bytes,
            shard_sizes=[b.total for b in builders],
            shard_crcs=[b.finish() for b in builders],
            leaf_size=leaf_size,
            shard_leaf_crcs=(
                [b.finish_leaves() for b in builders] if leaf_size else []
            ),
        )

    # ---- serialization ----

    def to_bytes(self) -> bytes:
        parts = [
            struct.pack(
                "<IQBB",
                self.block_size,
                self.generation,
                self.ctx.data_shards,
                self.ctx.parity_shards,
            ),
            self.uuid,
        ]
        for size, crcs in zip(self.shard_sizes, self.shard_crcs):
            parts.append(struct.pack("<QI", size, len(crcs)))
            parts.append(struct.pack(f"<{len(crcs)}I", *crcs))
        version = FORMAT_VERSION
        if self.has_leaves:
            # v2 tail: leaf level appended after the v1 body, so the v1
            # parse of a v2 payload is exactly the v1 payload prefix.
            version = FORMAT_VERSION_V2
            parts.append(struct.pack("<I", self.leaf_size))
            for crcs in self.shard_leaf_crcs:
                parts.append(struct.pack("<I", len(crcs)))
                parts.append(struct.pack(f"<{len(crcs)}I", *crcs))
        payload = b"".join(parts)
        header = _HEADER.pack(MAGIC) + _HEADER_REST.pack(
            version, len(payload), crc32c(payload)
        )
        return header + payload

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BitrotProtection":
        hs = _HEADER.size + _HEADER_REST.size
        if len(raw) < hs:
            raise BitrotError("sidecar too short")
        (magic,) = _HEADER.unpack(raw[: _HEADER.size])
        version, plen, pcrc = _HEADER_REST.unpack(raw[_HEADER.size : hs])
        if magic not in (MAGIC, _LEGACY_MAGIC):
            raise BitrotError(f"bad magic {magic:08x}")
        if version not in (FORMAT_VERSION, FORMAT_VERSION_V2):
            raise BitrotError(f"unsupported sidecar version {version}")
        payload = raw[hs : hs + plen]
        if len(payload) != plen:
            raise BitrotError("truncated payload")
        if crc32c(payload) != pcrc:
            raise BitrotError("payload checksum mismatch")
        try:
            block_size, generation, k, m = struct.unpack("<IQBB", payload[:14])
            uid = payload[14:30]
            ctx = ECContext(k, m)
            p = 30
            sizes, crcs = [], []
            for _ in range(ctx.total):
                size, count = struct.unpack("<QI", payload[p : p + 12])
                p += 12
                row = list(struct.unpack(f"<{count}I", payload[p : p + 4 * count]))
                p += 4 * count
                sizes.append(size)
                crcs.append(row)
            leaf_size = 0
            leaf_crcs: list[list[int]] = []
            if version >= FORMAT_VERSION_V2:
                (leaf_size,) = struct.unpack("<I", payload[p : p + 4])
                p += 4
                if leaf_size <= 0 or block_size % leaf_size != 0:
                    raise BitrotError(
                        f"v2 leaf size {leaf_size} does not divide block "
                        f"size {block_size}"
                    )
                for _ in range(ctx.total):
                    (count,) = struct.unpack("<I", payload[p : p + 4])
                    p += 4
                    row = list(
                        struct.unpack(f"<{count}I", payload[p : p + 4 * count])
                    )
                    p += 4 * count
                    leaf_crcs.append(row)
            if p != plen:
                raise BitrotError("trailing bytes in payload")
        except struct.error as e:
            raise BitrotError(f"malformed payload: {e}") from None
        return cls(
            ctx, block_size, generation, uid, sizes, crcs, leaf_size, leaf_crcs
        )

    # ---- file io ----

    def save(self, path: str) -> None:
        from ..utils.fs import atomic_write

        atomic_write(path, self.to_bytes())

    @classmethod
    def load(cls, path: str) -> "BitrotProtection":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    # ---- verification ----

    def verify_shard_file(
        self,
        path: str,
        shard_id: int,
        on_block=None,
        stop_early: bool = False,
    ) -> list[int]:
        """-> list of mismatched block indices ([] = clean).

        A size mismatch counts as every expected block mismatching
        (truncation is corruption, reference fail-closed rule).
        `on_block(n_bytes)` is invoked per block read (rate-limiting
        hook for the scrubber); `stop_early` returns at the first
        mismatch when only a yes/no verdict is needed.
        """
        expected = self.shard_crcs[shard_id]
        if os.path.getsize(path) != self.shard_sizes[shard_id]:
            return list(range(max(len(expected), 1)))
        bad = []
        with open(path, "rb") as f:
            for i, want in enumerate(expected):
                block = f.read(self.block_size)
                if on_block is not None:
                    on_block(len(block))
                if crc32c(block) != want:
                    bad.append(i)
                    if stop_early:
                        break
        return bad
