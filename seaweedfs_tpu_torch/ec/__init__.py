"""Erasure coding on the port: encode a sealed volume, rebuild shards,
serve needle reads from the shards (degraded reads reconstruct on the
fly), decode the shards back into a volume, and scrub a volume (patch
rotten leaves in place under a crash-safe journal, quarantine and
rebuild what that cannot fix; `ScrubDaemon` scrubs a `Store`'s EC
volumes), rebuild from shards fetched from peer holders
(`rebuild_from_peers`, over the shard net plane of `net_plane`), and
encode a stream while it is written
(`EcStreamEncoder`: incremental parity, the stripe-cursor journal,
`recover_stream`). Every staged path is a client of the per-chip device
scheduler (`DeviceQueue`, `QueueScope`, the residency ledger) and of
stream placement (`place_stream`); `FallbackBackend` fails over to the
native `CpuBackend` on a lost device, and `get_backend("auto")` resolves
to it where there is no card, both counted. The byte path of the volume
paths is the native host plane: `native_io` (batched reads into pooled, page-locked landing
matrices) and `FusedShardSink` (`make_shard_sink`).

Port of the encode, rebuild, read, decode, scrub, streaming and
peer-fetch slices of seaweedfs_tpu/ec; the files it reads and writes
(.ec00.., .ecx, .ecj, .ecsum, .vif, .repair, .scrubpos, .stream, and the
decoded .dat and .idx) are the JAX package's formats, byte for byte.
"""

from . import native_io
from .backend import CpuBackend, FallbackBackend, TorchBackend, get_backend
from .bitrot import BitrotError, BitrotProtection
from .chip_pool import ChipBackend, ChipPool, Placement, place_stream, pool_for
from .context import DEFAULT_EC_CONTEXT, ECContext, ECError
from .decoder import ec_decode_volume
from .device_queue import (
    DeviceQueue,
    DeviceStream,
    QueueScope,
    batch_cost,
)
from .device_queue import configure as configure_device_queue
from .device_queue import default_scope as default_device_queue_scope
from .device_queue import for_backend as device_queue_for_backend
from .ec_volume import EcCookieMismatch, EcNotFoundError, EcVolume
from .encoder import ec_encode_volume, write_ec_files, write_sorted_file_from_idx
from .peer_rebuild import (
    PeerCorruptError,
    PeerFetchTransient,
    PeerRebuildReport,
    rebuild_from_peers,
)
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
from .scrub import RateLimiter, ScrubCursor, ScrubDaemon, ScrubReport, scrub_ec_volume
from .stream_encode import (
    EcStreamEncoder,
    StreamJournal,
    StreamRecovery,
    load_stream_journal,
    read_stream_data,
    recover_stream,
    stream_summary,
)
from .volume_info import VolumeInfo

__all__ = [
    "BitrotError",
    "BitrotProtection",
    "ChipBackend",
    "ChipPool",
    "CpuBackend",
    "DEFAULT_EC_CONTEXT",
    "DeviceQueue",
    "DeviceStream",
    "ECContext",
    "ECError",
    "EcCookieMismatch",
    "EcNotFoundError",
    "EcStreamEncoder",
    "EcVolume",
    "FallbackBackend",
    "FusedShardSink",
    "JournalError",
    "LeafPatch",
    "PeerCorruptError",
    "PeerFetchTransient",
    "PeerRebuildReport",
    "Placement",
    "PyShardSink",
    "QueueScope",
    "RateLimiter",
    "RepairJournal",
    "ScrubCursor",
    "ScrubDaemon",
    "ScrubReport",
    "StreamJournal",
    "StreamRecovery",
    "TorchBackend",
    "VolumeInfo",
    "apply_leaf_repair",
    "batch_cost",
    "configure_device_queue",
    "default_device_queue_scope",
    "device_queue_for_backend",
    "ec_decode_volume",
    "ec_encode_volume",
    "get_backend",
    "load_stream_journal",
    "make_shard_sink",
    "native_io",
    "place_stream",
    "pool_for",
    "rebuild_ec_files",
    "read_stream_data",
    "rebuild_from_peers",
    "reconstruct_leaves",
    "recover_stream",
    "recover_volume_journals",
    "scrub_ec_volume",
    "stream_summary",
    "sweep_stale_journals",
    "write_ec_files",
    "write_sorted_file_from_idx",
]
