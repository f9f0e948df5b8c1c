"""Erasure coding on the port: encode a sealed volume, rebuild shards,
serve needle reads from the shards (degraded reads reconstruct on the
fly), decode the shards back into a volume, and scrub a volume (patch
rotten leaves in place under a crash-safe journal, quarantine and
rebuild what that cannot fix). The byte path under all of it is the
native host plane: `native_io` (batched reads into pooled, page-locked
landing matrices) and `FusedShardSink` (`make_shard_sink`).

Port of the encode, rebuild, read, decode and scrub slices of
seaweedfs_tpu/ec; the files it reads and writes (.ec00.., .ecx, .ecj,
.ecsum, .vif, .repair, .scrubpos, and the decoded .dat and .idx) are the
JAX package's formats, byte for byte.
"""

from . import native_io
from .backend import TorchBackend, get_backend
from .bitrot import BitrotError, BitrotProtection
from .context import DEFAULT_EC_CONTEXT, ECContext, ECError
from .decoder import ec_decode_volume
from .ec_volume import EcCookieMismatch, EcNotFoundError, EcVolume
from .encoder import ec_encode_volume, write_ec_files, write_sorted_file_from_idx
from .pipeline import FusedShardSink, PyShardSink, make_shard_sink
from .rebuild import rebuild_ec_files
from .repair_journal import (
    JournalError,
    LeafPatch,
    RepairJournal,
    apply_leaf_repair,
    reconstruct_leaves,
    recover_volume_journals,
    sweep_stale_journals,
)
from .scrub import RateLimiter, ScrubCursor, ScrubReport, scrub_ec_volume
from .volume_info import VolumeInfo

__all__ = [
    "BitrotError",
    "BitrotProtection",
    "DEFAULT_EC_CONTEXT",
    "ECContext",
    "ECError",
    "EcCookieMismatch",
    "EcNotFoundError",
    "EcVolume",
    "FusedShardSink",
    "JournalError",
    "LeafPatch",
    "PyShardSink",
    "RateLimiter",
    "RepairJournal",
    "ScrubCursor",
    "ScrubReport",
    "TorchBackend",
    "VolumeInfo",
    "apply_leaf_repair",
    "ec_decode_volume",
    "ec_encode_volume",
    "get_backend",
    "make_shard_sink",
    "native_io",
    "rebuild_ec_files",
    "reconstruct_leaves",
    "recover_volume_journals",
    "scrub_ec_volume",
    "sweep_stale_journals",
    "write_ec_files",
    "write_sorted_file_from_idx",
]
