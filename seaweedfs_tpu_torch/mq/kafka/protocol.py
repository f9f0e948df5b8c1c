"""Kafka protocol primitives (non-flexible encodings).

Port of seaweedfs_tpu/mq/kafka/protocol.py, whole: `Reader`, `Writer`,
the varints and the api keys and error codes, byte for byte.

Reference: weed/mq/kafka/protocol — the Kafka binary protocol's
big-endian primitives: INT8/16/32/64, STRING (i16 length), NULLABLE_
STRING, BYTES (i32 length), ARRAY (i32 count), the zigzag varints used
inside record batches, and the KIP-482 flexible (compact/tagged)
encodings used by Produce v9+ and ApiVersions v3+.
"""

from __future__ import annotations

import struct


class Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise EOFError(
                f"need {n} bytes at {self.pos}, have {len(self.buf)}"
            )
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def string(self) -> str:
        n = self.i16()
        if n < 0:
            raise ValueError("non-nullable string was null")
        return self._take(n).decode("utf-8")

    def nullable_string(self) -> str | None:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode("utf-8")

    def bytes_(self) -> bytes:
        n = self.i32()
        if n < 0:
            raise ValueError("non-nullable bytes was null")
        return self._take(n)

    def nullable_bytes(self) -> bytes | None:
        n = self.i32()
        if n < 0:
            return None
        return self._take(n)

    def array(self, fn) -> list:
        n = self.i32()
        if n < 0:
            return []
        return [fn() for _ in range(n)]

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    # record-batch varints (zigzag)
    def uvarint(self) -> int:
        shift = value = 0
        while True:
            b = self._take(1)[0]
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError("varint too long")

    def varint(self) -> int:
        u = self.uvarint()
        return (u >> 1) ^ -(u & 1)

    def varlong(self) -> int:
        return self.varint()

    # KIP-482 flexible (compact) encodings: length+1 as uvarint, 0=null
    def compact_string(self) -> str:
        n = self.uvarint()
        if n == 0:
            raise ValueError("non-nullable compact string was null")
        return self._take(n - 1).decode("utf-8")

    def compact_nullable_string(self) -> str | None:
        n = self.uvarint()
        if n == 0:
            return None
        return self._take(n - 1).decode("utf-8")

    def compact_bytes(self) -> bytes:
        n = self.uvarint()
        if n == 0:
            raise ValueError("non-nullable compact bytes was null")
        return self._take(n - 1)

    def compact_nullable_bytes(self) -> bytes | None:
        n = self.uvarint()
        if n == 0:
            return None
        return self._take(n - 1)

    def compact_array(self, fn) -> list:
        n = self.uvarint()
        if n == 0:
            return []
        return [fn() for _ in range(n - 1)]

    def tagged_fields(self) -> None:
        """Skip a tagged-field section (we define none)."""
        for _ in range(self.uvarint()):
            self.uvarint()  # tag
            size = self.uvarint()
            self._take(size)


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def raw(self, b: bytes) -> "Writer":
        self.parts.append(b)
        return self

    def i8(self, v: int) -> "Writer":
        return self.raw(struct.pack(">b", v))

    def i16(self, v: int) -> "Writer":
        return self.raw(struct.pack(">h", v))

    def i32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">i", v))

    def i64(self, v: int) -> "Writer":
        return self.raw(struct.pack(">q", v))

    def u32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">I", v))

    def string(self, s: str) -> "Writer":
        b = s.encode("utf-8")
        return self.i16(len(b)).raw(b)

    def nullable_string(self, s: str | None) -> "Writer":
        if s is None:
            return self.i16(-1)
        return self.string(s)

    def bytes_(self, b: bytes) -> "Writer":
        return self.i32(len(b)).raw(b)

    def nullable_bytes(self, b: bytes | None) -> "Writer":
        if b is None:
            return self.i32(-1)
        return self.bytes_(b)

    def array(self, items, fn) -> "Writer":
        self.i32(len(items))
        for it in items:
            fn(self, it)
        return self

    # KIP-482 flexible (compact) encodings
    def uvarint(self, v: int) -> "Writer":
        return self.raw(write_uvarint(v))

    def compact_string(self, s: str) -> "Writer":
        b = s.encode("utf-8")
        return self.uvarint(len(b) + 1).raw(b)

    def compact_nullable_string(self, s: str | None) -> "Writer":
        if s is None:
            return self.uvarint(0)
        return self.compact_string(s)

    def compact_bytes(self, b: bytes) -> "Writer":
        return self.uvarint(len(b) + 1).raw(b)

    def compact_nullable_bytes(self, b: bytes | None) -> "Writer":
        if b is None:
            return self.uvarint(0)
        return self.compact_bytes(b)

    def compact_array(self, items, fn) -> "Writer":
        self.uvarint(len(items) + 1)
        for it in items:
            fn(self, it)
        return self

    def tags(self) -> "Writer":
        """Empty tagged-field section."""
        return self.raw(b"\x00")

    def done(self) -> bytes:
        return b"".join(self.parts)


def write_uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def write_varint(v: int) -> bytes:
    return write_uvarint((v << 1) ^ (v >> 63) if v < 0 else (v << 1))


# api keys
PRODUCE = 0
FETCH = 1
LIST_OFFSETS = 2
METADATA = 3
OFFSET_COMMIT = 8
OFFSET_FETCH = 9
FIND_COORDINATOR = 10
JOIN_GROUP = 11
HEARTBEAT = 12
LEAVE_GROUP = 13
SYNC_GROUP = 14
DESCRIBE_GROUPS = 15
LIST_GROUPS = 16
API_VERSIONS = 18
CREATE_TOPICS = 19
DELETE_TOPICS = 20

API_NAMES = {
    PRODUCE: "Produce",
    FETCH: "Fetch",
    LIST_OFFSETS: "ListOffsets",
    METADATA: "Metadata",
    OFFSET_COMMIT: "OffsetCommit",
    OFFSET_FETCH: "OffsetFetch",
    FIND_COORDINATOR: "FindCoordinator",
    JOIN_GROUP: "JoinGroup",
    HEARTBEAT: "Heartbeat",
    LEAVE_GROUP: "LeaveGroup",
    SYNC_GROUP: "SyncGroup",
    DESCRIBE_GROUPS: "DescribeGroups",
    LIST_GROUPS: "ListGroups",
    API_VERSIONS: "ApiVersions",
    CREATE_TOPICS: "CreateTopics",
    DELETE_TOPICS: "DeleteTopics",
}

# error codes (kafka protocol)
NONE = 0
OFFSET_OUT_OF_RANGE = 1
CORRUPT_MESSAGE = 2
UNKNOWN_TOPIC_OR_PARTITION = 3
REQUEST_TIMED_OUT = 7  # retriable; the saturation-reject answer
KAFKA_STORAGE_ERROR = 56  # retriable; a failed group-commit window
COORDINATOR_NOT_AVAILABLE = 15
NOT_COORDINATOR = 16
INVALID_TOPIC_EXCEPTION = 17
ILLEGAL_GENERATION = 22
INCONSISTENT_GROUP_PROTOCOL = 23
UNKNOWN_MEMBER_ID = 25
INVALID_SESSION_TIMEOUT = 26
REBALANCE_IN_PROGRESS = 27
TOPIC_ALREADY_EXISTS = 36
INVALID_REQUEST = 42
UNSUPPORTED_VERSION = 35
UNSUPPORTED_COMPRESSION_TYPE = 76
INVALID_RECORD = 87
