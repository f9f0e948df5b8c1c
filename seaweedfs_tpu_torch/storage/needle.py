"""Needle: one stored blob inside a volume file.

Port of seaweedfs_tpu/storage/needle.py. Byte-precise v2/v3 record
layout (reference weed/storage/needle/needle.go:26, needle_write_v2.go,
needle_write_v3.go):

  header  [cookie(4) | needleId(8) | size(4)]            (big-endian)
  body    when size > 0:
          [dataSize(4) | data | flags(1)
           | nameSize(1)+name      if FLAG_HAS_NAME
           | mimeSize(1)+mime      if FLAG_HAS_MIME
           | lastModified(5)       if FLAG_HAS_LAST_MODIFIED
           | ttl(2)                if FLAG_HAS_TTL
           | pairsSize(2)+pairs    if FLAG_HAS_PAIRS]
  footer  v2: [crc32c(4)]   v3: [crc32c(4) | appendAtNs(8)]
  padding zero bytes to an 8-byte boundary

`size` counts dataSize..pairs (the body). Max needle size is 4GB.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass

from ..utils.crc import crc32c
from .types import (
    MAX_NEEDLE_BODY_SIZE,
    NEEDLE_CHECKSUM_SIZE,
    NEEDLE_HEADER_SIZE,
    TIMESTAMP_SIZE,
    padded_record_size,
)

VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
# 0x40: deletion tombstone record (this framework's own marker; the
# reference leaves the bit unused). Disambiguates a delete from a
# legitimate empty-body put on the tail/replica-sync path.
FLAG_IS_TOMBSTONE = 0x40
FLAG_IS_CHUNK_MANIFEST = 0x80

MAX_NEEDLE_SIZE = MAX_NEEDLE_BODY_SIZE
LAST_MODIFIED_BYTES = 5


def footer_size(version: int) -> int:
    """Footer bytes after the body: crc32c(4), plus appendAtNs(8) in v3."""
    return NEEDLE_CHECKSUM_SIZE + (TIMESTAMP_SIZE if version == VERSION3 else 0)


class NeedleError(Exception):
    pass


class CrcError(NeedleError):
    pass


@dataclass
class Needle:
    cookie: int = 0
    needle_id: int = 0
    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    last_modified: int = 0  # unix seconds, 5 bytes on disk
    ttl: bytes = b"\x00\x00"  # 2-byte TTL encoding (count + unit)
    pairs: bytes = b""  # serialized extended attributes
    append_at_ns: int = 0  # v3 footer
    checksum: int = 0

    # ---- flag helpers ----
    def _has(self, f: int) -> bool:
        return bool(self.flags & f)

    @property
    def is_compressed(self) -> bool:
        return self._has(FLAG_IS_COMPRESSED)

    @property
    def is_chunk_manifest(self) -> bool:
        return self._has(FLAG_IS_CHUNK_MANIFEST)

    @property
    def is_tombstone(self) -> bool:
        return self._has(FLAG_IS_TOMBSTONE)

    def set_name(self, name: bytes) -> None:
        self.name = name[:255]
        self.flags |= FLAG_HAS_NAME

    def set_mime(self, mime: bytes) -> None:
        self.mime = mime[:255]
        self.flags |= FLAG_HAS_MIME

    def set_last_modified(self, ts: int | None = None) -> None:
        self.last_modified = int(ts if ts is not None else time.time())
        self.flags |= FLAG_HAS_LAST_MODIFIED

    def set_ttl(self, ttl2: bytes) -> None:
        if len(ttl2) != 2:
            raise ValueError("ttl encoding is 2 bytes")
        self.ttl = ttl2
        if ttl2 != b"\x00\x00":
            self.flags |= FLAG_HAS_TTL

    def set_pairs(self, pairs: bytes) -> None:
        if len(pairs) > 0xFFFF:
            raise ValueError("pairs too large")
        self.pairs = pairs
        self.flags |= FLAG_HAS_PAIRS

    # ---- encode ----

    def _body(self) -> bytes:
        parts = [struct.pack(">I", len(self.data)), self.data, bytes([self.flags])]
        if self._has(FLAG_HAS_NAME):
            parts.append(bytes([len(self.name)]))
            parts.append(self.name)
        if self._has(FLAG_HAS_MIME):
            parts.append(bytes([len(self.mime)]))
            parts.append(self.mime)
        if self._has(FLAG_HAS_LAST_MODIFIED):
            parts.append(self.last_modified.to_bytes(LAST_MODIFIED_BYTES, "big"))
        if self._has(FLAG_HAS_TTL):
            parts.append(self.ttl)
        if self._has(FLAG_HAS_PAIRS):
            parts.append(struct.pack(">H", len(self.pairs)))
            parts.append(self.pairs)
        return b"".join(parts)

    def to_bytes(self, version: int = CURRENT_VERSION) -> bytes:
        """Full on-disk record including padding."""
        if version not in (VERSION2, VERSION3):
            raise NeedleError(f"unsupported needle version {version}")
        body = self._body() if (self.data or self.flags) else b""
        size = len(body)
        if size > MAX_NEEDLE_SIZE:
            raise NeedleError(f"needle body {size} exceeds {MAX_NEEDLE_SIZE} limit")
        header = struct.pack(">IQI", self.cookie, self.needle_id, size)
        self.checksum = crc32c(self.data)
        footer = struct.pack(">I", self.checksum)
        if version == VERSION3:
            if not self.append_at_ns:
                self.append_at_ns = time.time_ns()
            footer += struct.pack(">Q", self.append_at_ns)
        raw = header + body + footer
        return raw + b"\x00" * (padded_record_size(len(raw)) - len(raw))

    def disk_size(self, version: int = CURRENT_VERSION) -> int:
        body = len(self._body()) if (self.data or self.flags) else 0
        return padded_record_size(NEEDLE_HEADER_SIZE + body + footer_size(version))

    # ---- decode ----

    @classmethod
    def parse_header(cls, raw: bytes) -> tuple[int, int, int]:
        """-> (cookie, needle_id, size)."""
        if len(raw) < NEEDLE_HEADER_SIZE:
            raise NeedleError("short header")
        return struct.unpack(">IQI", raw[:NEEDLE_HEADER_SIZE])

    @classmethod
    def from_bytes(
        cls, raw: bytes, version: int = CURRENT_VERSION, verify: bool = True
    ) -> "Needle":
        """Parse a full record (header+body+footer, padding optional)."""
        cookie, nid, size = cls.parse_header(raw)
        n = cls(cookie=cookie, needle_id=nid)
        p = NEEDLE_HEADER_SIZE
        if size > 0:
            if len(raw) < p + size:
                raise NeedleError("truncated body")
            body_end = NEEDLE_HEADER_SIZE + size
            (data_size,) = struct.unpack(">I", raw[p : p + 4])
            p += 4
            # dataSize must leave room for at least the flags byte; a bad
            # length field is corruption and must surface as CrcError, not
            # IndexError from an out-of-range slice.
            if p + data_size + 1 > body_end:
                raise CrcError(
                    f"needle {nid:x} corrupt dataSize {data_size} (body size {size})"
                )
            n.data = raw[p : p + data_size]
            p += data_size
            n.flags = raw[p]
            p += 1
            try:
                if n._has(FLAG_HAS_NAME):
                    ln = raw[p]
                    n.name = raw[p + 1 : p + 1 + ln]
                    p += 1 + ln
                if n._has(FLAG_HAS_MIME):
                    lm = raw[p]
                    n.mime = raw[p + 1 : p + 1 + lm]
                    p += 1 + lm
                if n._has(FLAG_HAS_LAST_MODIFIED):
                    n.last_modified = int.from_bytes(
                        raw[p : p + LAST_MODIFIED_BYTES], "big"
                    )
                    p += LAST_MODIFIED_BYTES
                if n._has(FLAG_HAS_TTL):
                    n.ttl = raw[p : p + 2]
                    p += 2
                if n._has(FLAG_HAS_PAIRS):
                    (lp,) = struct.unpack(">H", raw[p : p + 2])
                    n.pairs = raw[p + 2 : p + 2 + lp]
                    p += 2 + lp
            except (IndexError, struct.error):
                raise CrcError(f"needle {nid:x} corrupt optional fields") from None
            if p != NEEDLE_HEADER_SIZE + size:
                raise NeedleError(
                    f"body length mismatch: parsed {p - NEEDLE_HEADER_SIZE}, size {size}"
                )
        if len(raw) < p + NEEDLE_CHECKSUM_SIZE:
            raise NeedleError("truncated footer")
        (n.checksum,) = struct.unpack(">I", raw[p : p + 4])
        p += 4
        if version == VERSION3 and len(raw) >= p + TIMESTAMP_SIZE:
            (n.append_at_ns,) = struct.unpack(">Q", raw[p : p + TIMESTAMP_SIZE])
            p += TIMESTAMP_SIZE
        if verify and crc32c(n.data) != n.checksum:
            raise CrcError(
                f"needle {nid:x} crc mismatch: stored {n.checksum:08x}"
            )
        return n
