"""Message queue on the port (layer 7): the broker, its partition logs,
the pub/sub client, the durable-parity partition stream
(`stream_parity.PartitionParity`), the broker's group commit
(`group_commit`) and the Kafka gateway and client (`mq/kafka/`). Port of
seaweedfs_tpu/mq, whole; the filer's `KafkaNotifier` comes with ROADMAP
item 14b-2.

The package loads its modules on first use (PEP 562 `__getattr__`), as
`ec` does: `from ..mq import MqClient`, as the filer's notifier and the
shell do, imports no torch. Only `stream_parity` does, through the EC
stream's backend, and the broker imports it where a topic with durable
parity attaches its stream.
"""

import importlib

# each exported name by the module that defines it
_MODULES = {
    "broker": ("MqBroker", "MqBrokerServer", "MqService"),
    "client": ("MqClient",),
    "log_buffer": ("PartitionLog", "decode_records", "encode_record"),
    "stream_parity": ("GEN_PREFIX", "ParityFlusher", "PartitionParity", "decode_dense",
                      "dense_frame_scan", "parity_context"),
}
_WHERE = {name: (mod, name) for mod, names in _MODULES.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name: str):
    try:
        mod, attr = _WHERE[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(f".{mod}", __name__), attr)
    globals()[name] = value
    return value
