"""X-Request-ID propagation and per-request HTTP tracing.

Port of seaweedfs_tpu/utils/request_id.py (reference
weed/util/request_id): every HTTP hop carries the id; the first server
in the chain mints one. Stored in a contextvar so log lines, trace spans
(utils/trace.py) and downstream client calls inside one request see it
without threading it through signatures.

:class:`RequestTracingMixin` is the HTTP end of the flight recorder:
when the tracer is armed, every request gets a root span that adopts the
trace id and parent span of the ``X-Sw-Trace-Id`` / ``X-Sw-Parent-Span``
request headers (or starts a fresh trace), is the handler thread's
ambient span while the request runs, is echoed on the response, and
finishes with it. Armed or not, every request lands in the
``sw_request_seconds{server,op}`` histogram that ``/debug/slo`` serves.
"""

from __future__ import annotations

import contextvars
import time
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


class RequestTracingMixin:
    """Mix into a BaseHTTPRequestHandler (before it in the MRO): adopts
    or mints the request id when the headers are parsed and echoes it on
    every response, so one id follows a request across servers.

    ``parse_request`` opens (or adopts, through the ``X-Sw-*`` headers)
    the root span and makes it the thread's ambient span;
    ``handle_one_request`` finishes it after the response and records
    the request in ``sw_request_seconds{server,op}``. Subclasses set
    ``trace_server_kind`` ("volume", ...) and may name the op class of a
    request by assigning ``self._sw_op`` (default: the lowercased HTTP
    method)."""

    trace_server_kind = "http"

    def parse_request(self):  # type: ignore[override]
        ok = super().parse_request()
        if ok:
            ensure(self.headers.get(HEADER))
            self._sw_t0 = time.perf_counter()
            self._sw_code = 0
            self._sw_op = ""
            self._sw_span = None
            self._sw_token = None
            from . import trace

            if trace.armed:
                sp = trace.start_from_headers(
                    f"http.{self.trace_server_kind}",
                    self.headers,
                    name=f"{self.command} {self.path.split('?', 1)[0]}",
                    server=self.trace_server_kind,
                )
                self._sw_span = sp
                self._sw_token = trace.set_current(sp)
        return ok

    def send_response(self, code, message=None):  # type: ignore[override]
        super().send_response(code, message)
        rid = get()
        if rid:
            self.send_header(HEADER, rid)
        if not getattr(self, "_sw_code", 0):
            self._sw_code = code
        sp = getattr(self, "_sw_span", None)
        if sp is not None:
            from . import trace

            self.send_header(trace.TRACE_ID_HEADER, sp.trace_id)

    def handle_one_request(self):  # type: ignore[override]
        try:
            super().handle_one_request()
        finally:
            self._sw_finish_request()

    def _sw_finish_request(self) -> None:
        t0 = self.__dict__.pop("_sw_t0", None)
        if t0 is None:
            return  # the parse failed, or an idle keep-alive closed: no request
        from . import metrics
        from . import trace

        op = getattr(self, "_sw_op", "") or (self.command or "?").lower()
        dur = time.perf_counter() - t0
        metrics.request_seconds.observe(dur, server=self.trace_server_kind, op=op)
        metrics.request_total.inc(
            server=self.trace_server_kind, op=op, code=str(getattr(self, "_sw_code", 0) or 0),
        )
        sp = self.__dict__.pop("_sw_span", None)
        token = self.__dict__.pop("_sw_token", None)
        if sp is not None:
            sp.attrs["http_code"] = getattr(self, "_sw_code", 0)
            sp.attrs["op_class"] = op
            trace.finish(sp)
        trace.reset_current(token)

    def serve_slo_endpoint(self, path: str) -> bool:
        """Serve ``/debug/slo`` (this process's per-op-class p50/p99 from
        ``sw_request_seconds``) and ``/debug/gateway``; True when the
        request was handled. Open like /metrics: latency stats only."""
        if path == "/debug/gateway":
            return self._serve_debug_json(self._gateway_doc())
        if path != "/debug/slo":
            return False
        from . import metrics

        return self._serve_debug_json(metrics.slo_summary())

    def _gateway_doc(self) -> dict:
        """``/debug/gateway``: this server's HTTP front end (worker pool,
        accept budget, rejects) beside the process-wide hot-cache and
        inflight counters (sw_gateway_*)."""
        from . import metrics
        from .http_pool import status_of

        doc = metrics.gateway_summary()
        doc["front_end"] = status_of(self.server)
        return doc

    def _serve_debug_json(self, obj) -> bool:
        import json

        body = json.dumps(obj, sort_keys=True).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return True
