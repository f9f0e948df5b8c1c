"""MQ client: publisher + subscriber sessions (reference weed/mq/client
and the agent's session brokering, simplified to direct broker calls).

Port of seaweedfs_tpu/mq/client.py, whole, with its timeouts. It imports
gRPC and the MQ protocol only: a filer notifying a broker, the shell and
the agent load no torch through it."""

from __future__ import annotations

import time
from typing import Iterator, Optional

import grpc

from ..pb import mq_pb2 as mq
from ..pb import rpc


class MqClient:
    def __init__(self, broker: str):
        self._channel = grpc.insecure_channel(broker)
        self.stub = rpc.mq_stub(self._channel)

    def configure_topic(
        self,
        name: str,
        partitions: int = 4,
        namespace: str = "default",
        durable_parity: bool | None = None,
    ) -> None:
        """`durable_parity` mirrors the broker's Python API over the
        wire (tri-state int32 field 3: 0 = broker default, 1 = on,
        2 = off): a REMOTE client can now opt a topic's partitions in
        or out of the streaming-EC parity stream."""
        self.stub.ConfigureTopic(
            mq.ConfigureTopicRequest(
                topic=mq.Topic(namespace=namespace, name=name),
                partition_count=partitions,
                durable_parity=(
                    0 if durable_parity is None
                    else (1 if durable_parity else 2)
                ),
            ),
            timeout=30,
        )

    def topics(self) -> list[tuple[str, str, int]]:
        resp = self.stub.ListTopics(mq.ListTopicsRequest(), timeout=30)
        return [
            (t.topic.namespace, t.topic.name, t.partition_count)
            for t in resp.topics
        ]

    def publish(
        self,
        name: str,
        value: bytes,
        key: bytes = b"",
        namespace: str = "default",
        partition: int = -1,
    ) -> tuple[int, int]:
        """-> (partition, offset)."""
        resp = self.stub.Publish(
            mq.PublishRequest(
                topic=mq.Topic(namespace=namespace, name=name),
                partition=partition,
                message=mq.DataMessage(key=key, value=value, ts_ns=time.time_ns()),
            ),
            timeout=30,
        )
        if resp.error:
            raise RuntimeError(resp.error)
        return resp.partition, resp.offset

    def subscribe(
        self,
        name: str,
        partition: int,
        start_offset: int = -1,  # -1: committed group offset, else tail
        namespace: str = "default",
        consumer_group: str = "",
        follow: bool = False,
        timeout: Optional[float] = None,
    ) -> Iterator[mq.SubscribeRecord]:
        stream = self.stub.Subscribe(
            mq.SubscribeRequest(
                topic=mq.Topic(namespace=namespace, name=name),
                partition=partition,
                start_offset=start_offset,
                consumer_group=consumer_group,
                follow=follow,
            ),
            timeout=timeout,
        )
        for rec in stream:
            if rec.end_of_stream:
                return
            yield rec

    def commit(self, name: str, partition: int, group: str, offset: int, namespace: str = "default") -> None:
        self.stub.CommitOffset(
            mq.CommitOffsetRequest(
                topic=mq.Topic(namespace=namespace, name=name),
                partition=partition,
                consumer_group=group,
                offset=offset,
            ),
            timeout=30,
        )

    def committed(self, name: str, partition: int, group: str, namespace: str = "default") -> int:
        return self.stub.FetchOffset(
            mq.FetchOffsetRequest(
                topic=mq.Topic(namespace=namespace, name=name),
                partition=partition,
                consumer_group=group,
            ),
            timeout=30,
        ).offset

    def partition_info(self, name: str, namespace: str = "default"):
        return self.stub.PartitionInfo(
            mq.PartitionInfoRequest(topic=mq.Topic(namespace=namespace, name=name)),
            timeout=30,
        ).partitions

    def close(self) -> None:
        self._channel.close()
