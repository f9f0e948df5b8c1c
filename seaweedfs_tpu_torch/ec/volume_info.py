"""Volume info sidecar: <base>.vif (port of seaweedfs_tpu/ec/volume_info.py).

Carries what the reference's protobuf VolumeInfo carries (reference
weed/storage/volume_info/volume_info.go, written by
volume_grpc_erasure_coding.go:62-79): needle version, the EC shard
config (for custom ratios), the .dat size at encode time (authoritative
for the striping layout), and the EncodeTsNs generation stamp. Stored as
JSON — human-debuggable, schema-stable.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

from .context import ECContext


@dataclass
class VolumeInfo:
    version: int = 3
    ec_ctx: Optional[ECContext] = None
    dat_file_size: int = 0
    encode_ts_ns: int = 0
    # cold-tier placement (reference VolumeInfo.files tier info,
    # volume_tier.go): where the .dat lives when not on local disk
    tier_url: str = ""
    tier_size: int = 0

    def to_json(self) -> str:
        d: dict = {"version": self.version}
        if self.ec_ctx is not None:
            d["ecShardConfig"] = {
                "dataShards": self.ec_ctx.data_shards,
                "parityShards": self.ec_ctx.parity_shards,
            }
        if self.dat_file_size:
            d["datFileSize"] = self.dat_file_size
        if self.encode_ts_ns:
            d["encodeTsNs"] = self.encode_ts_ns
        if self.tier_url:
            d["tierUrl"] = self.tier_url
            d["tierSize"] = self.tier_size
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "VolumeInfo":
        d = json.loads(text)
        ec = d.get("ecShardConfig")
        return cls(
            version=int(d.get("version", 3)),
            ec_ctx=ECContext(int(ec["dataShards"]), int(ec["parityShards"]))
            if ec
            else None,
            dat_file_size=int(d.get("datFileSize", 0)),
            encode_ts_ns=int(d.get("encodeTsNs", 0)),
            tier_url=d.get("tierUrl", ""),
            tier_size=int(d.get("tierSize", 0)),
        )

    def save(self, path: str) -> None:
        from ..utils.fs import atomic_write

        atomic_write(path, self.to_json().encode())

    @classmethod
    def load(cls, path: str) -> "VolumeInfo":
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def maybe_load(cls, path: str) -> Optional["VolumeInfo"]:
        if not os.path.exists(path):
            return None
        return cls.load(path)
