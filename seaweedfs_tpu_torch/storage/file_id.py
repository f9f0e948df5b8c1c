"""File id: "<volumeId>,<needleIdHex><cookieHex>" e.g. "3,01637037d6".

Port of seaweedfs_tpu/storage/file_id.py, whole (reference
weed/storage/needle/file_id.go) — needle id rendered as hex
without leading zeros (minimum one digit), cookie always 8 hex chars.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass


class FileIdError(ValueError):
    pass


@dataclass(frozen=True)
class FileId:
    volume_id: int
    needle_id: int
    cookie: int

    def __str__(self) -> str:
        return f"{self.volume_id},{self.needle_id:x}{self.cookie:08x}"

    @classmethod
    def parse(cls, fid: str) -> "FileId":
        try:
            vid_str, rest = fid.split(",", 1)
            volume_id = int(vid_str)
        except ValueError:
            raise FileIdError(f"malformed fid {fid!r}") from None
        # Allow the url-path form "<vid>/<fid>" to have stripped slashes already.
        if len(rest) <= 8:
            raise FileIdError(f"fid {fid!r} too short for cookie")
        try:
            needle_id = int(rest[:-8], 16)
            cookie = int(rest[-8:], 16)
        except ValueError:
            raise FileIdError(f"malformed fid {fid!r}") from None
        return cls(volume_id, needle_id, cookie)


def new_cookie() -> int:
    return secrets.randbits(32)
