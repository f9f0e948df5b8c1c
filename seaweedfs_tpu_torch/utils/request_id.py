"""X-Request-ID propagation.

Port of seaweedfs_tpu/utils/request_id.py (reference
weed/util/request_id): every HTTP hop carries the id; the first server
in the chain mints one. Stored in a contextvar so log lines, trace spans
(utils/trace.py) and downstream client calls inside one request see it
without threading it through signatures.

Not ported yet: `RequestTracingMixin`, the HTTP servers' end of the
flight recorder, with its `/debug/slo` and `/debug/gateway` endpoints;
it comes with the servers.
"""

from __future__ import annotations

import contextvars
import uuid

HEADER = "X-Request-ID"

_current: contextvars.ContextVar[str] = contextvars.ContextVar(
    "request_id", default=""
)


def get() -> str:
    return _current.get()


def ensure(incoming: str | None = None) -> str:
    """Adopt the caller's id or mint one; returns the active id."""
    rid = incoming or uuid.uuid4().hex[:16]
    _current.set(rid)
    return rid


def clear() -> None:
    _current.set("")


def inject(headers: dict) -> dict:
    """Add the active id to outgoing request headers (no-op outside a
    request context)."""
    rid = get()
    if rid:
        headers[HEADER] = rid
    return headers
