"""Erasure coding on the port: encode a sealed volume, rebuild shards,
serve needle reads from the shards (degraded reads reconstruct on the
fly), and decode the shards back into a volume.

Port of the encode, rebuild, read and decode slices of seaweedfs_tpu/ec;
the files it reads and writes (.ec00.., .ecx, .ecj, .ecsum, .vif, and
the decoded .dat and .idx) are the JAX package's formats, byte for byte.
"""

from .backend import TorchBackend, get_backend
from .bitrot import BitrotError, BitrotProtection
from .context import DEFAULT_EC_CONTEXT, ECContext, ECError
from .decoder import ec_decode_volume
from .ec_volume import EcCookieMismatch, EcNotFoundError, EcVolume
from .encoder import ec_encode_volume, write_ec_files, write_sorted_file_from_idx
from .rebuild import rebuild_ec_files
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
    "TorchBackend",
    "VolumeInfo",
    "ec_decode_volume",
    "ec_encode_volume",
    "get_backend",
    "rebuild_ec_files",
    "write_ec_files",
    "write_sorted_file_from_idx",
]
