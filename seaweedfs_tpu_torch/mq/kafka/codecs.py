"""Kafka record-batch compression codecs.

Port of seaweedfs_tpu/mq/kafka/codecs.py, whole: the same pure-Python
snappy, xxh32 and LZ4, and zstd through `zstandard`, imported where it
is used, as the JAX package imports it.

Reference: weed/mq/kafka record batch attributes bits 0-2 (none/gzip/
snappy/lz4/zstd). gzip and zstd ride the stdlib / the bundled
`zstandard` package; snappy (raw block + xerial framing) and the LZ4
frame format are implemented here in pure Python — full decoders, plus
minimal valid ENCODERS (snappy all-literals, LZ4 stored blocks) so
tests and the fetch path can produce well-formed streams without the
native libraries.
"""

from __future__ import annotations

import struct

# ---------------------------------------------------------------- snappy

_XERIAL_MAGIC = b"\x82SNAPPY\x00"


def _snappy_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("snappy: uvarint too long")


def _snappy_decompress_block(data: bytes) -> bytes:
    want, pos = _snappy_uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:
                extra = length - 59  # 1..4 length bytes, little-endian
                length = int.from_bytes(data[pos : pos + extra], "little")
                pos += extra
            length += 1
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = 4 + ((tag >> 2) & 0x07)
            offset = ((tag & 0xE0) << 3) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = 1 + (tag >> 2)
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = 1 + (tag >> 2)
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: bad copy offset")
        # overlapping copies are legal (RLE): copy byte-at-a-time when
        # the match overlaps the output tail
        start = len(out) - offset
        if offset >= length:
            out += out[start : start + length]
        else:
            for i in range(length):
                out.append(out[start + i])
    if len(out) != want:
        raise ValueError(
            f"snappy: declared {want} bytes, produced {len(out)}"
        )
    return bytes(out)


def snappy_decompress(data: bytes) -> bytes:
    """Raw snappy block, or the xerial-framed stream java/python
    clients emit (magic + concatenated [len|block] chunks)."""
    if data.startswith(_XERIAL_MAGIC):
        pos = len(_XERIAL_MAGIC) + 8  # magic + version + compat
        out = bytearray()
        while pos < len(data):
            (blen,) = struct.unpack_from(">i", data, pos)
            pos += 4
            out += _snappy_decompress_block(data[pos : pos + blen])
            pos += blen
        return bytes(out)
    return _snappy_decompress_block(data)


def snappy_compress(data: bytes) -> bytes:
    """Valid snappy stream using literal elements only (the format
    permits a compressor to emit any mix; correctness over ratio)."""
    from .protocol import write_uvarint

    out = bytearray(write_uvarint(len(data)))
    pos = 0
    while pos < len(data):
        chunk = data[pos : pos + (1 << 16)]
        pos += len(chunk)
        n = len(chunk) - 1
        if n < 60:
            out.append(n << 2)
        else:
            out.append(62 << 2)  # 3-byte extended literal length
            out += (n & 0xFFFFFF).to_bytes(3, "little")
        out += chunk
    return bytes(out)


# ------------------------------------------------------------------- lz4


def xxh32(data: bytes, seed: int = 0) -> int:
    """XXH32 (LZ4 frame header/content checksums)."""
    P1, P2, P3, P4, P5 = (
        2654435761,
        2246822519,
        3266489917,
        668265263,
        374761393,
    )
    mask = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & mask

    n = len(data)
    pos = 0
    if n >= 16:
        v1 = (seed + P1 + P2) & mask
        v2 = (seed + P2) & mask
        v3 = seed & mask
        v4 = (seed - P1) & mask
        while pos + 16 <= n:
            a, b, c, d = struct.unpack_from("<IIII", data, pos)
            v1 = (rotl((v1 + a * P2) & mask, 13) * P1) & mask
            v2 = (rotl((v2 + b * P2) & mask, 13) * P1) & mask
            v3 = (rotl((v3 + c * P2) & mask, 13) * P1) & mask
            v4 = (rotl((v4 + d * P2) & mask, 13) * P1) & mask
            pos += 16
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & mask
    else:
        h = (seed + P5) & mask
    h = (h + n) & mask
    while pos + 4 <= n:
        (k,) = struct.unpack_from("<I", data, pos)
        h = (rotl((h + k * P3) & mask, 17) * P4) & mask
        pos += 4
    while pos < n:
        h = (rotl((h + data[pos] * P5) & mask, 11) * P1) & mask
        pos += 1
    h ^= h >> 15
    h = (h * P2) & mask
    h ^= h >> 13
    h = (h * P3) & mask
    h ^= h >> 16
    return h


_LZ4_MAGIC = 0x184D2204


def _lz4_decompress_block(
    data: bytes, out: bytearray | None = None, window_base: int | None = None
) -> bytes | None:
    """Decode one LZ4 block, appending to `out` in place. Matches may
    reach back to out[window_base:] — 0 for block-LINKED frames
    (lz4.frame / librdkafka default), len(out)-at-entry for independent
    blocks. In-place append avoids re-copying the 64 KiB window per
    block on large messages."""
    external = out is not None
    if out is None:
        out = bytearray()
    base = len(out)  # where this block's output starts
    floor = base if window_base is None else window_base
    pos = 0
    n = len(data)
    while pos < n:
        token = data[pos]
        pos += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = data[pos]
                pos += 1
                lit_len += b
                if b != 255:
                    break
        out += data[pos : pos + lit_len]
        pos += lit_len
        if pos >= n:
            break  # last sequence: literals only
        offset = int.from_bytes(data[pos : pos + 2], "little")
        pos += 2
        if offset == 0:
            raise ValueError("lz4: zero match offset")
        match_len = token & 0x0F
        if match_len == 15:
            while True:
                b = data[pos]
                pos += 1
                match_len += b
                if b != 255:
                    break
        match_len += 4
        start = len(out) - offset
        if start < floor:
            raise ValueError("lz4: match offset before start")
        if offset >= match_len:
            out += out[start : start + match_len]
        else:  # overlapping (RLE) match
            for i in range(match_len):
                out.append(out[start + i])
    # frame-path callers read `out` in place; only standalone use gets
    # (and pays for) a materialized copy
    return None if external else bytes(out)


def lz4_decompress(data: bytes) -> bytes:
    """LZ4 FRAME format (what Kafka record batches carry for codec 3)."""
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != _LZ4_MAGIC:
        raise ValueError(f"lz4: bad frame magic {magic:#x}")
    flg = data[4]
    if (flg >> 6) != 0b01:
        raise ValueError("lz4: unsupported frame version")
    has_content_size = bool(flg & 0x08)
    has_content_checksum = bool(flg & 0x04)
    block_checksum = bool(flg & 0x10)
    block_independent = bool(flg & 0x20)
    has_dict = bool(flg & 0x01)
    pos = 6  # magic + FLG + BD
    if has_content_size:
        pos += 8
    if has_dict:
        pos += 4
    pos += 1  # HC byte (not verified: we tolerate legacy Kafka v1
    #           framing quirks the same way librdkafka does)
    out = bytearray()
    while True:
        (bsize,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if bsize == 0:
            break  # EndMark
        stored = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        block = data[pos : pos + bsize]
        pos += bsize
        if block_checksum:
            pos += 4
        if stored:
            out += block
        else:
            # linked frames: matches may reach back into previously
            # produced output (offsets are format-capped at 64 KiB, so
            # the whole buffer serves as the window with no slicing);
            # independent blocks may only reference themselves
            _lz4_decompress_block(
                block, out, 0 if not block_independent else len(out)
            )
    if has_content_checksum:
        pos += 4
    return bytes(out)


def lz4_compress(data: bytes) -> bytes:
    """Valid LZ4 frame using STORED (uncompressed) blocks — the frame
    format's escape hatch; every decoder must accept it."""
    flg = 0x60  # version 01, block-independent, no checksums/size/dict
    bd = 0x70  # 4 MiB max block size
    header = struct.pack("<I", _LZ4_MAGIC) + bytes([flg, bd])
    hc = (xxh32(bytes([flg, bd])) >> 8) & 0xFF
    parts = [header, bytes([hc])]
    pos = 0
    while pos < len(data):
        chunk = data[pos : pos + (4 << 20)]
        pos += len(chunk)
        parts.append(struct.pack("<I", 0x80000000 | len(chunk)))
        parts.append(chunk)
    parts.append(struct.pack("<I", 0))  # EndMark
    return b"".join(parts)


# ------------------------------------------------------------------ zstd


def zstd_decompress(data: bytes) -> bytes:
    import zstandard

    # decompressobj: no declared content size required in the frame
    return zstandard.ZstdDecompressor().decompressobj().decompress(data)


def zstd_compress(data: bytes) -> bytes:
    import zstandard

    return zstandard.ZstdCompressor().compress(data)
