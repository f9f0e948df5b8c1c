"""Filer event notification: the event codec and the sinks that publish
mutations to external systems.

Port of seaweedfs_tpu/filer/notification.py (reference weed/notification:
configuration.go, the webhook sink):

- the codec (`event_to_json`, `json_to_event`): the JSON record is the
  JAX one field for field, so a meta log written by either package
  replays through the other's SubscribeMetadata;
- `_AsyncNotifier`, the bounded queue with a delivery thread and retry
  under utils/retry.py, `WebhookNotifier`, which POSTs each event's
  JSON record to a URL, asynchronously, never blocking the mutation path,
  and `MqNotifier`, which publishes it to a topic of the MQ broker
  (`default/filer-events`, 4 partitions, keyed by the directory) through
  the port's `MqClient`, which loads no torch.

Where the port differs, on purpose: the JAX webhook posts through
`requests`, which the card's host does not have; the port's posts the
same JSON bytes (`json.dumps(payload, allow_nan=False)`, the body
`requests` builds from `json=`) over `http.client`, through
`utils/urls.connection` so an https URL takes the process's client
context. A 5xx answer or a connection error is retried, a 4xx is a
permanent rejection, as in the JAX package. `KafkaNotifier` is not
ported yet: it raises, naming ROADMAP item 14b-2, and so does
`make_notifier("kafka")`.
"""

from __future__ import annotations

import base64
import dataclasses
import http.client
import json
import queue
import threading
from typing import Optional
from urllib.parse import urlsplit

from ..pb import filer_pb2 as fpb
from ..utils import urls
from ..utils.retry import RetryError, RetryPolicy, retry_call

# Delivery backoff: quick first retry, bounded tail; sinks are remote
# HTTP/broker endpoints whose blips last milliseconds to seconds.
DELIVERY_POLICY = RetryPolicy(max_attempts=3, base_delay=0.5, max_delay=5.0)


def event_to_json(ev: fpb.FullEventNotification) -> dict:
    def entry(e):
        if not e.name and not e.is_directory:
            return None
        return {
            "name": e.name,
            "isDirectory": e.is_directory,
            "size": max(
                (c.offset + c.size for c in e.chunks), default=len(e.content)
            ),
            "chunks": len(e.chunks),
        }

    return {
        "directory": ev.directory,
        "tsNs": ev.ts_ns,
        "oldEntry": entry(ev.event.old_entry),
        "newEntry": entry(ev.event.new_entry),
        "deleteChunks": ev.event.delete_chunks,
        "remote": ev.event.is_from_other_cluster,
        # full-fidelity event for gRPC SubscribeMetadata + aggregation
        # (the summary fields above stay cheap for the HTTP tail/sinks)
        "pb": base64.b64encode(ev.SerializeToString()).decode(),
    }


def json_to_event(rec: dict) -> Optional[fpb.FullEventNotification]:
    """Rebuild the protobuf event from a meta-log record; None for
    legacy records without the pb field."""
    raw = rec.get("pb")
    if not raw:
        return None
    try:
        return fpb.FullEventNotification.FromString(base64.b64decode(raw))
    except Exception:
        return None


class DeliveryError(Exception):
    """A transient delivery failure (a 5xx answer): retried."""


class _AsyncNotifier:
    """Bounded queue + delivery thread: the mutation path only ever
    enqueues; a stalled sink can never block filer writes. Delivery
    retries run under the unified RetryPolicy (utils/retry.py), with the
    stop event as the sleep so close() aborts a backoff wait."""

    def __init__(self, max_queue: int = 10_000, retries: int = 3, policy: RetryPolicy | None = None):
        if policy is None:
            policy = dataclasses.replace(DELIVERY_POLICY, max_attempts=retries)
        self.policy = policy
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self.dropped = 0
        self.delivered = 0

    def __call__(self, ev: fpb.FullEventNotification) -> None:
        try:
            self._q.put_nowait(event_to_json(ev))
        except queue.Full:
            self.dropped += 1

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                payload = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            if self._deliver_with_retry(payload):
                self.delivered += 1
            else:
                self.dropped += 1

    def _deliver_with_retry(self, payload: dict) -> bool:
        # _deliver: True = delivered, False = PERMANENT rejection (no
        # retry: retry_call just returns it), exception = transient
        try:
            return bool(retry_call(lambda: self._deliver(payload), self.policy,
                                   sleep=self._stop.wait, describe="notification delivery"))
        except RetryError:
            return False

    def _deliver(self, payload: dict) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)


class WebhookNotifier(_AsyncNotifier):
    """POSTs each filer event to a URL."""

    def __init__(self, url: str, max_queue: int = 10_000, retries: int = 3):
        self.url = url
        parts = urlsplit(url)
        self._path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        self._conn: http.client.HTTPConnection | None = None  # keep-alive, delivery thread only
        super().__init__(max_queue, retries)

    def _deliver(self, payload: dict) -> bool:
        body = json.dumps(payload, allow_nan=False).encode("utf-8")
        headers = {"Content-Type": "application/json", "Content-Length": str(len(body))}
        try:
            if self._conn is None:
                self._conn = urls.connection(self.url, 10)
            self._conn.request("POST", self._path, body=body, headers=headers)
            r = self._conn.getresponse()
            r.read()
            if r.will_close:
                self._drop_conn()
        except (OSError, http.client.HTTPException):
            self._drop_conn()
            raise  # transient: retry on a fresh connection
        if r.status >= 500:
            raise DeliveryError(f"{r.status}")  # transient: retry
        return r.status < 400  # 4xx = permanent rejection

    def _drop_conn(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def close(self) -> None:
        super().close()
        self._drop_conn()


class MqNotifier(_AsyncNotifier):
    """Publishes events to a topic on the framework's MQ broker."""

    def __init__(self, broker: str, topic: str = "filer-events", namespace: str = "default"):
        from ..mq import MqClient

        self.client = MqClient(broker)
        self.topic = topic
        self.namespace = namespace
        try:
            self.client.configure_topic(topic, partitions=4, namespace=namespace)
        except Exception:
            pass
        super().__init__()

    def _deliver(self, payload: dict) -> bool:
        self.client.publish(
            self.topic,
            json.dumps(payload).encode(),
            key=(payload.get("directory") or "").encode(),
            namespace=self.namespace,
        )
        return True

    def close(self) -> None:
        super().close()
        self.client.close()


class KafkaNotifier(_AsyncNotifier):
    """Publishes events to a Kafka-wire-protocol broker: not served by
    the port yet."""

    def __init__(self, broker: str, topic: str = "seaweedfs_filer", partitions: int = 1):
        raise RuntimeError(
            f"Kafka notification to {broker}: the port has no Kafka notifier yet: it comes with "
            "ROADMAP.md item 14b-2")


def make_notifier(kind: str, target: str, **kw):
    """Config-driven sink construction (reference notification
    configuration.go): kind in webhook|mq|kafka|sqs|pubsub. SQS and
    Google Pub/Sub need their cloud SDKs, which this build does not ship:
    they are refused with an explicit error rather than silently absent."""
    if kind == "webhook":
        return WebhookNotifier(target, **kw)
    if kind == "mq":
        return MqNotifier(target, **kw)
    if kind == "kafka":
        return KafkaNotifier(target, **kw)
    if kind == "sqs":
        try:
            import boto3  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "SQS notification requires boto3, which is not installed "
                "in this build; use webhook/kafka/mq sinks instead") from e
        raise NotImplementedError("SQS sink: boto3 present but unwired")
    if kind == "pubsub":
        try:
            import google.cloud.pubsub_v1  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "Google Pub/Sub notification requires google-cloud-pubsub, "
                "which is not installed in this build; use webhook/kafka/mq") from e
        raise NotImplementedError("Pub/Sub sink: SDK present but unwired")
    raise ValueError(f"unknown notifier kind {kind!r}")
