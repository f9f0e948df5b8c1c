"""The filer's event codec: a meta-log record from an event and back.

Port of the codec half of seaweedfs_tpu/filer/notification.py
(`event_to_json`, `json_to_event`): the JSON record is the JAX one field
for field, so a meta log written by either package replays through the
other's SubscribeMetadata. The notifiers that publish these records to
external sinks (webhook, MQ, Kafka) come with the filer server (ROADMAP
items 12b, 14a and 14b).
"""

from __future__ import annotations

import base64
from typing import Optional

from ..pb import filer_pb2 as fpb


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
