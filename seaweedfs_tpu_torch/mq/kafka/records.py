"""Kafka record batch v2 (magic 2) codec.

Port of seaweedfs_tpu/mq/kafka/records.py, whole: the same batches,
byte for byte, with the CRC32C of the port's `utils.crc` (the host
library's).

Reference: weed/mq/kafka/protocol (record batch handling per the Kafka
protocol spec). Batch layout (big-endian):

  baseOffset           i64
  batchLength          i32   (bytes after this field)
  partitionLeaderEpoch i32
  magic                i8    (= 2)
  crc                  u32   (CRC32C of everything after this field)
  attributes           i16   (bits 0-2 compression: 0 none, 1 gzip)
  lastOffsetDelta      i32
  baseTimestamp        i64
  maxTimestamp         i64
  producerId           i64
  producerEpoch        i16
  baseSequence         i32
  recordCount          i32
  records…                   (possibly compressed as a unit)

Each record: length(varint) attributes(i8) timestampDelta(varlong)
offsetDelta(varint) keyLen(varint) key valueLen(varint) value
headerCount(varint) [headerKeyLen(varint) key valLen(varint) val]…
All varints are zigzag.
"""

from __future__ import annotations

import gzip
import struct
import time
from dataclasses import dataclass, field

from ...utils.crc import crc32c
from .protocol import Reader, write_varint

MAGIC_V2 = 2
_HEADER = struct.Struct(">qiib")  # baseOffset, batchLength, leaderEpoch, magic
_POST_CRC = struct.Struct(">hiqqqhii")

COMPRESSION_NONE = 0
COMPRESSION_GZIP = 1
COMPRESSION_SNAPPY = 2
COMPRESSION_LZ4 = 3
COMPRESSION_ZSTD = 4


@dataclass
class Record:
    key: bytes | None
    value: bytes | None
    timestamp_ms: int = 0
    offset: int = 0  # absolute, filled on decode / assigned on append
    headers: list[tuple[str, bytes | None]] = field(default_factory=list)


class UnsupportedCompression(ValueError):
    pass


def _encode_record(
    r: Record, offset_delta: int, ts_delta: int
) -> bytes:
    body = bytearray()
    body += b"\x00"  # attributes (unused)
    body += write_varint(ts_delta)
    body += write_varint(offset_delta)
    if r.key is None:
        body += write_varint(-1)
    else:
        body += write_varint(len(r.key)) + r.key
    if r.value is None:
        body += write_varint(-1)
    else:
        body += write_varint(len(r.value)) + r.value
    body += write_varint(len(r.headers))
    for hk, hv in r.headers:
        kb = hk.encode()
        body += write_varint(len(kb)) + kb
        if hv is None:
            body += write_varint(-1)
        else:
            body += write_varint(len(hv)) + hv
    return write_varint(len(body)) + bytes(body)


def encode_batch(
    records: list[Record], base_offset: int = 0, compression: int = 0
) -> bytes:
    """Record batch v2; `compression` is the attributes codec id
    (0 none, 1 gzip, 2 snappy, 3 lz4, 4 zstd)."""
    if not records:
        return b""
    base_ts = records[0].timestamp_ms or int(time.time() * 1000)
    max_ts = max(r.timestamp_ms or base_ts for r in records)
    recs = b"".join(
        _encode_record(
            r,
            offset_delta=(r.offset - base_offset),
            ts_delta=(r.timestamp_ms or base_ts) - base_ts,
        )
        for r in records
    )
    if compression != COMPRESSION_NONE:
        from . import codecs as _codecs

        recs = {
            COMPRESSION_GZIP: gzip.compress,
            COMPRESSION_SNAPPY: _codecs.snappy_compress,
            COMPRESSION_LZ4: _codecs.lz4_compress,
            COMPRESSION_ZSTD: _codecs.zstd_compress,
        }[compression](recs)
    last_delta = records[-1].offset - base_offset
    post_crc = (
        _POST_CRC.pack(
            compression,  # attributes bits 0-2
            last_delta,
            base_ts,
            max_ts,
            -1,  # producerId
            -1,  # producerEpoch
            -1,  # baseSequence
            len(records),
        )
        + recs
    )
    crc = crc32c(post_crc)
    batch_len = 4 + 1 + 4 + len(post_crc)  # leaderEpoch+magic+crc+rest
    return (
        _HEADER.pack(base_offset, batch_len, -1, MAGIC_V2)
        + struct.pack(">I", crc)
        + post_crc
    )


def decode_batches(raw: bytes) -> list[Record]:
    """All records from a (possibly multi-batch) records blob; absolute
    offsets and timestamps reconstructed. Raises UnsupportedCompression
    for unknown codec ids (none/gzip/snappy/lz4/zstd supported),
    ValueError on CRC mismatch or corrupt compressed payloads."""
    out: list[Record] = []
    pos = 0
    while pos + _HEADER.size <= len(raw):
        base_offset, batch_len, _epoch, magic = _HEADER.unpack_from(raw, pos)
        end = pos + 12 + batch_len  # baseOffset+batchLength prefix = 12
        if end > len(raw):
            break  # partial trailing batch (Kafka permits truncation)
        if magic != MAGIC_V2:
            raise ValueError(f"unsupported magic {magic} (only v2)")
        crc_stored = struct.unpack_from(">I", raw, pos + _HEADER.size)[0]
        post = raw[pos + _HEADER.size + 4 : end]
        if crc32c(post) != crc_stored:
            raise ValueError("record batch CRC mismatch")
        (
            attributes,
            _last_delta,
            base_ts,
            _max_ts,
            _pid,
            _pepoch,
            _bseq,
            count,
        ) = _POST_CRC.unpack_from(post, 0)
        payload = post[_POST_CRC.size :]
        codec = attributes & 0x07
        if codec != COMPRESSION_NONE:
            from . import codecs as _codecs

            try:
                decompress = {
                    COMPRESSION_GZIP: gzip.decompress,
                    COMPRESSION_SNAPPY: _codecs.snappy_decompress,
                    COMPRESSION_LZ4: _codecs.lz4_decompress,
                    COMPRESSION_ZSTD: _codecs.zstd_decompress,
                }[codec]
            except KeyError:
                raise UnsupportedCompression(
                    f"compression codec {codec}"
                ) from None
            try:
                payload = decompress(payload)
            except Exception as e:  # noqa: BLE001 — normalize decoder
                # errors (IndexError/ZstdError/...) to the ValueError
                # contract so one corrupt batch fails one partition,
                # not the connection
                raise ValueError(
                    f"batch decompression failed (codec {codec}): {e!r}"
                ) from None
        r = Reader(payload)
        for _ in range(count):
            _len = r.varint()
            rec_end = r.pos + _len
            r.i8()  # attributes
            ts_delta = r.varlong()
            off_delta = r.varint()
            klen = r.varint()
            key = bytes(r._take(klen)) if klen >= 0 else None
            vlen = r.varint()
            value = bytes(r._take(vlen)) if vlen >= 0 else None
            headers: list[tuple[str, bytes | None]] = []
            for _h in range(r.varint()):
                hklen = r.varint()
                hk = r._take(hklen).decode()
                hvlen = r.varint()
                hv = bytes(r._take(hvlen)) if hvlen >= 0 else None
                headers.append((hk, hv))
            r.pos = rec_end  # tolerate unknown trailing record fields
            out.append(
                Record(
                    key=key,
                    value=value,
                    timestamp_ms=base_ts + ts_delta,
                    offset=base_offset + off_delta,
                    headers=headers,
                )
            )
        pos = end
    return out
