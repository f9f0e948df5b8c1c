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

The package loads its modules on first use (PEP 562 `__getattr__`):
`from ..ec import native_io` or `net_plane`, as the filer's client does,
imports no backend and so no torch.
"""

import importlib

# each exported name by the module that defines it
_MODULES = {
    "backend": ("CpuBackend", "FallbackBackend", "TorchBackend", "get_backend"),
    "bitrot": ("BitrotError", "BitrotProtection"),
    "chip_pool": ("ChipBackend", "ChipPool", "Placement", "place_stream", "pool_for"),
    "context": ("DEFAULT_EC_CONTEXT", "ECContext", "ECError"),
    "decoder": ("ec_decode_volume",),
    "device_queue": ("DeviceQueue", "DeviceStream", "QueueScope", "batch_cost"),
    "ec_volume": ("EcCookieMismatch", "EcNotFoundError", "EcVolume"),
    "encoder": ("ec_encode_volume", "write_ec_files", "write_sorted_file_from_idx"),
    "peer_rebuild": ("PeerCorruptError", "PeerFetchTransient", "PeerRebuildReport",
                     "rebuild_from_peers"),
    "pipeline": ("FusedShardSink", "PyShardSink", "make_shard_sink"),
    "rebuild": ("rebuild_ec_files",),
    "repair_journal": ("JournalError", "LeafPatch", "RepairJournal", "apply_leaf_repair",
                       "reconstruct_leaves", "recover_volume_journals", "sweep_stale_journals"),
    "scrub": ("RateLimiter", "ScrubCursor", "ScrubDaemon", "ScrubReport", "scrub_ec_volume"),
    "stream_encode": ("EcStreamEncoder", "StreamJournal", "StreamRecovery",
                      "load_stream_journal", "read_stream_data", "recover_stream",
                      "stream_summary"),
    "volume_info": ("VolumeInfo",),
}
_WHERE = {name: (mod, name) for mod, names in _MODULES.items() for name in names}
_WHERE.update({
    "configure_device_queue": ("device_queue", "configure"),
    "default_device_queue_scope": ("device_queue", "default_scope"),
    "device_queue_for_backend": ("device_queue", "for_backend"),
    "native_io": ("native_io", None),
})

__all__ = sorted(_WHERE)


def __getattr__(name: str):
    try:
        mod, attr = _WHERE[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    module = importlib.import_module(f".{mod}", __name__)
    value = module if attr is None else getattr(module, attr)
    globals()[name] = value
    return value

