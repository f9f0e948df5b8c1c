"""Message queue on the port: the durable-parity partition stream
(`stream_parity.PartitionParity`), port of seaweedfs_tpu/mq/stream_parity.py.
The broker, its logs and its flusher are not ported yet."""

from .stream_parity import (
    GEN_PREFIX,
    PartitionParity,
    decode_dense,
    dense_frame_scan,
    encode_record,
    parity_context,
)

__all__ = [
    "GEN_PREFIX",
    "PartitionParity",
    "decode_dense",
    "dense_frame_scan",
    "encode_record",
    "parity_context",
]
