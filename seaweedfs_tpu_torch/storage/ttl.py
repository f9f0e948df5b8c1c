"""TTL: the 2-byte on-disk encoding [count(1) | unit(1)].

Port of seaweedfs_tpu/storage/ttl.py (reference
weed/storage/needle/volume_ttl.go): units m/h/d/w/M/y; a TTL lives in
the superblock (the volume-level bucket) and per needle; reads of
expired needles 404 and fully expired volumes are reaped.
"""

from __future__ import annotations

from dataclasses import dataclass

_UNITS = {
    0: ("", 0),
    1: ("m", 60),
    2: ("h", 3600),
    3: ("d", 86400),
    4: ("w", 7 * 86400),
    5: ("M", 30 * 86400),
    6: ("y", 365 * 86400),
}
_BY_SUFFIX = {s: (u, secs) for u, (s, secs) in _UNITS.items() if s}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = 0

    @classmethod
    def parse(cls, s: str) -> "TTL":
        """'3m', '4h', '5d', '6w', '7M', '8y'; '' or '0' = no TTL."""
        s = (s or "").strip()
        if s in ("", "0"):
            return cls()
        suffix = s[-1]
        if suffix.isdigit():  # bare number = minutes (reference behavior)
            count = int(s)
            if not 0 < count < 256:
                raise ValueError(f"TTL count out of range in {s!r}")
            return cls(count, 1)
        if suffix not in _BY_SUFFIX:
            raise ValueError(f"unknown TTL unit {suffix!r} in {s!r}")
        unit, _ = _BY_SUFFIX[suffix]
        count = int(s[:-1])
        if not 0 < count < 256:
            raise ValueError(f"TTL count out of range in {s!r}")
        return cls(count, unit)

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if len(b) != 2:
            raise ValueError("TTL encoding is 2 bytes")
        return cls(b[0], b[1] if b[1] in _UNITS else 0)

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit])

    @property
    def seconds(self) -> int:
        return self.count * _UNITS.get(self.unit, ("", 0))[1]

    def __bool__(self) -> bool:
        return self.seconds > 0

    def __str__(self) -> str:
        if not self:
            return ""
        return f"{self.count}{_UNITS[self.unit][0]}"

    def expired(self, last_modified: int, now: float) -> bool:
        return bool(self) and last_modified + self.seconds < now
