"""Kafka wire-protocol gateway over the MQ broker.

Port of seaweedfs_tpu/mq/kafka: the protocol codec (`protocol`,
`records`, `codecs`), the group coordinator (`groups`), the bounded
frame server (`frame_pool`), the sealed-segment fetch spool
(`fetch_spool`), the gateway (`gateway`) and the wire client (`client`).
Reference: weed/mq/kafka — ApiVersions, Metadata, Produce/Fetch (record
batches v2), ListOffsets, CreateTopics/DeleteTopics, FindCoordinator and
the classic consumer-group protocol (JoinGroup/SyncGroup/Heartbeat/
LeaveGroup/OffsetCommit/OffsetFetch), mapped onto the MqBroker
partition logs. None of it imports torch.
"""

from .gateway import KafkaGateway  # noqa: F401
