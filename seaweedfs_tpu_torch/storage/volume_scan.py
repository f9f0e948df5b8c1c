"""Sequential .dat scanner: every record in append order.

Port of seaweedfs_tpu/storage/volume_scan.py (reference
weed/storage/volume_read_all.go ReadAllNeedles). The volume server's
ScrubVolume scans with the native `utils/native.scan_dat`; this walk is
the plain version the tests hold it against.
"""

from __future__ import annotations

import os
from typing import Iterator

from .needle import CrcError, Needle, NeedleError, footer_size
from .super_block import SUPER_BLOCK_SIZE, SuperBlock
from .types import NEEDLE_HEADER_SIZE, padded_record_size


class ScanItem:
    __slots__ = ("needle", "offset", "body_size", "crc_ok")

    def __init__(self, needle: Needle, offset: int, body_size: int, crc_ok: bool):
        self.needle = needle
        self.offset = offset
        self.body_size = body_size
        self.crc_ok = crc_ok


def scan_volume_file(dat_path: str) -> tuple[SuperBlock, Iterator[ScanItem]]:
    """-> (superblock, iterator over records in append order).

    A corrupt record yields crc_ok=False with whatever parsed; a record
    whose header does not parse ends the scan (a truncated tail)."""
    f = open(dat_path, "rb")
    sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
    size = os.path.getsize(dat_path)
    version = sb.version

    def it() -> Iterator[ScanItem]:
        try:
            offset = SUPER_BLOCK_SIZE
            while offset + NEEDLE_HEADER_SIZE <= size:
                f.seek(offset)
                header = f.read(NEEDLE_HEADER_SIZE)
                if len(header) < NEEDLE_HEADER_SIZE:
                    return
                try:
                    _, _, body_size = Needle.parse_header(header)
                except NeedleError:
                    return
                rec_len = padded_record_size(NEEDLE_HEADER_SIZE + body_size + footer_size(version))
                if offset + rec_len > size:
                    return  # a truncated tail
                f.seek(offset)
                raw = f.read(rec_len)
                crc_ok = True
                try:
                    n = Needle.from_bytes(raw, version)
                except CrcError:
                    crc_ok = False
                    try:
                        n = Needle.from_bytes(raw, version, verify=False)
                    except NeedleError:
                        return
                except NeedleError:
                    return
                yield ScanItem(n, offset, body_size, crc_ok)
                offset += rec_len
        finally:
            f.close()

    return sb, it()
