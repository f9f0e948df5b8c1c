"""Pipeline flight recorder: stage-attributed spans for the EC data path.

Port of seaweedfs_tpu/utils/trace.py, whole. In the port the `chip`
label of a device stage is the torch device string of the backend
(``cuda:0``, ``cpu``; "" for the native CPU backend), and the device
stages are host-clock time around the staged hooks: ``h2d_dispatch``
the wall of ``to_device`` + the kernel launch, ``device_drain`` the
wall blocked in ``to_host`` (the kernel's tail and the D2H copy). The
backend's CUDA-event spans (``TorchBackend.stage_seconds``: h2d,
kernel, d2h) measure device time and are not these.

The bench verdict (ROADMAP "bench reality check") is that e2e encode is
I/O-bound while the device kernel is effectively free — but the only
evidence is aggregate counters after the fact. This module attributes
wall time to every STAGE of an EC operation (admission wait, queue
wait, disk read, H2D dispatch, device drain, fused write+CRC sink,
verify, publish/rename) and stitches the stages into one span tree per
operation, across threads and — via gRPC metadata — across servers.

Model
-----

- A :class:`Span` is one timed node: a root per EC op (``ec.encode``,
  ``ec.rebuild``, ``ec.decode``, ``ec.degraded_read``,
  ``ec.peer_rebuild``, ``rpc.ec_shard_read`` …), children for sub-ops
  (per-peer fetches, the nested rebuild inside a decode). Spans carry
  per-stage ACCUMULATORS (total seconds + count per stage name) rather
  than one child span per pipeline batch — a 1 GiB encode is thousands
  of batches, and the interesting question is "where did the op's time
  go", not "what did batch #3817 do".
- Completed LOCAL ROOTS (spans with no local parent — including spans
  whose parent lives on another server) land in a bounded ring,
  dumpable as Chrome ``trace_event`` JSON (``/debug/traces``,
  ``bench.py --trace-out``; load the file in Perfetto / chrome://tracing).
- Trace identity crosses RPC hops in gRPC metadata
  (:data:`TRACE_ID_KEY` / :data:`PARENT_SPAN_KEY`) alongside
  ``X-Request-ID``, so a fleet-dispatched peer-fetch rebuild yields ONE
  trace id spanning master task → rebuilding holder → every peer's
  shard-read stream.

Canonical stage names (the Prometheus ``stage`` label of
``sw_ec_stage_seconds``):

=================  =====================================================
``admission_wait`` blocked in the device-queue scheduler before dispatch
``queue_wait``     blocked on a full bounded pipeline queue
                   (backpressure; accumulated from BOTH pipeline
                   threads, so its total may exceed the op wall)
``disk_read``      source reads (shards, .dat) in the reader thread
``sibling_read``   degraded-read sibling shard reads (local + remote)
``h2d_dispatch``   host→device upload + async kernel dispatch
``device_drain``   blocked in ``to_host`` (device compute not yet hidden
                   + D2H)
``write_sink``     fused write+CRC sink appends (or plain output writes)
``crc_verify``     sidecar CRC verification of streamed/reconstructed
                   bytes
``verify``         dedicated whole-shard sidecar verification passes
``reconstruct``    synchronous (non-staged) Reed-Solomon apply
``fsync_publish``  flush/fsync/rename publication windows
``stream``         server-side RPC response streaming
=================  =====================================================

Overlap efficiency
------------------

Per completed root, over the WHOLE span tree: let ``device`` be the
summed device-stage time (``h2d_dispatch`` + ``device_drain``),
``host`` the summed non-device stage time, and ``wall`` the root span
duration. Wall time not explained by host stages must have been spent
exposed to device work — and time measurably blocked in ``to_host``
(``device_drain``) is exposed by definition, which keeps the number
honest when host stages overlap EACH OTHER across pipeline threads
(their sum can exceed wall, zeroing the residue)::

    exposed = clamp(max(wall - host, drain), 0, device)
    overlap_efficiency = (device - exposed) / device

1.0 = every device second hid behind I/O (the staged pipeline is doing
its job on this host); 0.0 = fully serial. Exported per op class as
``sw_ec_overlap_efficiency`` — the single number that says whether the
staged pipeline actually overlaps.

Disarm discipline (same as ``faults/``): the tracer is OFF by default
and every production call site is a single module-bool (or is-None)
check when disarmed — no allocation, no lock, no contextvar read. Hot
per-batch helpers (:func:`stage`, :func:`add_stage`, :func:`current`)
take only positional arguments so the disarmed path cannot even box a
kwargs dict.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from contextvars import ContextVar

from . import metrics as _M
from . import request_id as _rid
from .glog import logger

_log = logger("trace")

# gRPC metadata keys (lowercase: gRPC normalizes ASCII keys).
TRACE_ID_KEY = "x-sw-trace-id"
PARENT_SPAN_KEY = "x-sw-parent-span"
REQUEST_ID_KEY = "x-request-id"

# The SAME trace identity over HTTP: the gateway hops (client → S3 →
# filer → volume) carry these beside X-Request-ID, so one S3 GET yields
# ONE trace id across every server it crosses. Canonical casing for
# send; HTTP header lookup is case-insensitive on receive.
TRACE_ID_HEADER = "X-Sw-Trace-Id"
PARENT_SPAN_HEADER = "X-Sw-Parent-Span"

DEFAULT_RING = 256
# Ring is additionally bounded by TOTAL SPAN COUNT across all retained
# trace docs: one span-heavy op class (a wide gateway fan-out op can
# carry hundreds of child spans) must not pin an unbounded share of
# memory behind a trace-count-only bound.
DEFAULT_RING_SPANS = 20_000

# Canonical stage names — the ONLY values legal as the `stage` label of
# ``sw_ec_stage_seconds``. tests/test_trace.py lints every stage literal
# in the package against this registry, so a typo'd label fails tier-1
# instead of silently forking a histogram series.
STAGES = frozenset({
    # device-queue / pipeline
    "admission_wait", "queue_wait", "disk_read", "stage_batch",
    "sibling_read", "h2d_dispatch", "device_drain", "write_sink",
    "crc_verify", "verify", "reconstruct", "fsync_publish", "stream",
    "index_sort", "peer_fetch",
    # leaf repair
    "repair_patch", "repair_fetch",
    # streaming EC: incremental parity math + delta pwrites
    "parity_update",
    # gateway read path: where a slow S3 GET burned its budget
    "s3.auth", "filer.lookup", "chunk.fetch", "volume.read",
})

# Stages that count as device time for the overlap-efficiency gauge.
DEVICE_STAGES = frozenset({"h2d_dispatch", "device_drain"})

_stage_seconds = _M.REGISTRY.histogram(
    "sw_ec_stage_seconds",
    "per-stage wall time of EC operations (tracer armed only)",
    ("op", "stage", "chip"),
)
_overlap_eff = _M.REGISTRY.gauge(
    "sw_ec_overlap_efficiency",
    "device time hidden behind I/O / total device time, per op class "
    "(latest completed trace)",
    ("op",),
)
_traces_total = _M.REGISTRY.counter(
    "sw_ec_traces_total", "completed root spans by op class", ("op",)
)
_slow_ops_total = _M.REGISTRY.counter(
    "sw_ec_slow_ops_total", "root spans exceeding the slow-op threshold",
    ("op",),
)

# Module-level fast-path flag, read unlocked by every instrumentation
# site. configure() flips it under _lock AFTER the ring/threshold are in
# place, so an armed reader never sees half-configured state; a racing
# reader at worst misses the first op after arming.
armed = False

_lock = threading.Lock()
_ring: deque = deque(maxlen=DEFAULT_RING)
_ring_spans = 0  # total span count across the retained docs
_max_ring_spans = DEFAULT_RING_SPANS
_slow_op_s = 0.0

# Per-(op, stage) exponentially-weighted moving averages of stage
# seconds (armed only — fed by Span.add_stage). These ride volume-server
# heartbeats to the master as part of the telemetry plane, giving the
# fleet a "where does this host's op time go" signal without shipping
# whole traces.
EWMA_ALPHA = 0.2
_ewma_lock = threading.Lock()
_stage_ewma: dict[tuple[str, str], float] = {}

_current: ContextVar["Span | None"] = ContextVar("sw_trace_span", default=None)


class _Noop:
    """Singleton no-op context manager: the disarmed fast path of
    :func:`stage` and :func:`activate` returns this, so span-enter/exit
    when disarmed is one is-None check and zero allocations."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _StageTimer:
    __slots__ = ("span", "name", "chip", "t0")

    def __init__(self, span: "Span", name: str, chip: str):
        self.span = span
        self.name = name
        self.chip = chip

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.span.add_stage(
            self.name, time.perf_counter() - self.t0, self.chip
        )
        return False


class _Activation:
    """Sets the ambient span contextvar for the with-block (children
    started inside pick it up as their parent; grpc_metadata() reads
    it for outgoing hops)."""

    __slots__ = ("span", "_token")

    def __init__(self, span: "Span"):
        self.span = span

    def __enter__(self):
        self._token = _current.set(self.span)
        return self.span

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False


class Span:
    """One timed node of a trace. Thread-safe for stage/event/child
    recording (pipeline stages run in reader/writer threads
    concurrently); start/finish happen in the owning thread."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "op", "name", "server",
        "request_id", "start_ts", "_t0", "duration_s", "attrs",
        "stages", "events", "children", "_lock", "_local_root",
        "_finished",
    )

    def __init__(
        self,
        op: str,
        name: str = "",
        trace_id: str = "",
        parent_id: str = "",
        server: str = "",
        attrs: dict | None = None,
        local_root: bool = True,
    ):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.op = op
        self.name = name or op
        self.server = server
        self.request_id = _rid.get()
        self.start_ts = time.time()
        self._t0 = time.perf_counter()
        self.duration_s = 0.0
        self.attrs = dict(attrs) if attrs else {}
        # stage -> [total_seconds, count, chip] (chip: last writer wins
        # — one stream runs on one chip; a mesh stream reports "")
        self.stages: dict[str, list] = {}
        self.events: list[dict] = []
        self.children: list["Span"] = []
        self._lock = threading.Lock()
        self._local_root = local_root
        self._finished = False

    # -------------------------------------------------------- recording

    def child(self, op: str, name: str = "", **attrs) -> "Span":
        c = Span(
            op,
            name=name,
            trace_id=self.trace_id,
            parent_id=self.span_id,
            server=self.server,
            attrs=attrs,
            local_root=False,
        )
        with self._lock:
            self.children.append(c)
        return c

    def add_stage(self, stage: str, seconds: float, chip: str = "") -> None:
        if seconds < 0.0:
            seconds = 0.0
        with self._lock:
            acc = self.stages.get(stage)
            if acc is None:
                self.stages[stage] = [seconds, 1, chip]
            else:
                acc[0] += seconds
                acc[1] += 1
                if chip:
                    acc[2] = chip
        _stage_seconds.observe(seconds, op=self.op, stage=stage, chip=chip)
        with _ewma_lock:
            key = (self.op, stage)
            prev = _stage_ewma.get(key)
            _stage_ewma[key] = (
                seconds
                if prev is None
                else prev + EWMA_ALPHA * (seconds - prev)
            )

    def stage(self, name: str, chip: str = "") -> _StageTimer:
        return _StageTimer(self, name, chip)

    def event(self, name: str, **attrs) -> None:
        with self._lock:
            self.events.append(
                {"ts": time.time(), "name": name, "attrs": attrs}
            )

    # --------------------------------------------------------- lifecycle

    def finish(self) -> None:
        with self._lock:
            if self._finished:
                return
            self._finished = True
            self.duration_s = time.perf_counter() - self._t0
        if self._local_root:
            _complete_root(self)

    # ------------------------------------------------------------ export

    def to_dict(self) -> dict:
        with self._lock:
            dur = (
                self.duration_s
                if self._finished
                else time.perf_counter() - self._t0
            )
            return {
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                "parent_span_id": self.parent_id,
                "op": self.op,
                "name": self.name,
                "server": self.server,
                "request_id": self.request_id,
                "start_ts": self.start_ts,
                "duration_s": dur,
                "attrs": dict(self.attrs),
                "stages": {
                    s: {"seconds": a[0], "count": a[1], "chip": a[2]}
                    for s, a in self.stages.items()
                },
                "events": [dict(e) for e in self.events],
                "children": [c.to_dict() for c in self.children],
            }


# --------------------------------------------------------------------------
# Root completion: ring + derived metrics + slow-op log.
# --------------------------------------------------------------------------


def _tree_stage_totals(doc: dict) -> dict[str, float]:
    totals: dict[str, float] = {}
    stack = [doc]
    while stack:
        d = stack.pop()
        for s, a in d["stages"].items():
            totals[s] = totals.get(s, 0.0) + a["seconds"]
        stack.extend(d["children"])
    return totals


def overlap_efficiency(doc: dict) -> float | None:
    """Device time hidden behind I/O / total device time for one root
    span dict (None when the op did no device work). See the module
    docstring for the derivation.

    Two estimators of exposed device time, combined by max:

    - wall residue ``wall - host``: host stages run in parallel
      threads (reader disk_read vs sink write_sink vs both sides'
      queue_wait), so their SUM can exceed wall and the residue alone
      would then read 0 ("fully hidden") no matter what the device did;
    - ``device_drain``: a DIRECT measurement — every second blocked in
      ``to_host`` is a second the device was not hidden.
    """
    totals = _tree_stage_totals(doc)
    device = sum(v for s, v in totals.items() if s in DEVICE_STAGES)
    if device <= 0.0:
        return None
    host = sum(v for s, v in totals.items() if s not in DEVICE_STAGES)
    residue = max(doc["duration_s"] - host, 0.0)
    exposed = min(max(residue, totals.get("device_drain", 0.0)), device)
    return (device - exposed) / device


def _doc_span_count(doc: dict) -> int:
    n = 0
    stack = [doc]
    while stack:
        d = stack.pop()
        n += 1
        stack.extend(d["children"])
    return n


def _complete_root(span: Span) -> None:
    global _ring_spans
    doc = span.to_dict()
    _traces_total.inc(op=span.op)
    eff = overlap_efficiency(doc)
    if eff is not None:
        doc["overlap_efficiency"] = round(eff, 4)
    # Gauge per op CLASS over each EC subtree, not just the local root:
    # behind an RPC adoption the root op is rpc.*, but the tuning
    # question — "is encode/rebuild staging actually overlapping on
    # this host?" — is asked per ec.* op.
    stack = [doc]
    while stack:
        d = stack.pop()
        if d is doc or d["op"].startswith("ec."):
            e = overlap_efficiency(d)
            if e is not None:
                _overlap_eff.set(e, op=d["op"])
        stack.extend(d["children"])
    doc["span_count"] = _doc_span_count(doc)
    with _lock:
        # manual maxlen handling so the span-count budget stays exact:
        # deque's own eviction on append would bypass the accounting
        while len(_ring) >= (_ring.maxlen or DEFAULT_RING):
            _ring_spans -= _ring.popleft().get("span_count", 1)
        _ring.append(doc)
        _ring_spans += doc["span_count"]
        # byte-bound analog: a span-heavy op class evicts oldest docs
        # beyond the trace-count bound too (always keep the newest)
        while _ring_spans > _max_ring_spans and len(_ring) > 1:
            _ring_spans -= _ring.popleft().get("span_count", 1)
        slow = _slow_op_s
    if 0.0 < slow <= doc["duration_s"]:
        _slow_ops_total.inc(op=span.op)
        _log.warning(
            "slow op %s (%.3fs > %.3fs) request_id=%s trace=%s\n%s",
            span.op, doc["duration_s"], slow,
            doc["request_id"] or "-", span.trace_id, format_tree(doc),
        )


def format_tree(doc: dict, indent: int = 0) -> str:
    """Human-readable span tree with per-stage durations (the slow-op
    log body). The root line carries the request id and root op so a
    logged tree can be joined against gateway access logs even when the
    surrounding log prefix is stripped."""
    pad = "  " * indent
    stages = " ".join(
        f"{s}={a['seconds'] * 1000:.1f}ms/{a['count']}"
        for s, a in sorted(doc["stages"].items())
    )
    line = (
        f"{pad}{doc['op']}"
        f"{' [' + doc['name'] + ']' if doc['name'] != doc['op'] else ''}"
        f" {doc['duration_s'] * 1000:.1f}ms"
    )
    if indent == 0:
        line += (
            f" root={doc['op']}"
            f" rid={doc.get('request_id') or '-'}"
            f" trace={doc.get('trace_id', '')}"
        )
    if doc.get("server"):
        line += f" @{doc['server']}"
    if stages:
        line += f" | {stages}"
    out = [line]
    for ev in doc["events"]:
        out.append(f"{pad}  * {ev['name']} {ev['attrs']}")
    for c in doc["children"]:
        out.append(format_tree(c, indent + 1))
    return "\n".join(out)


# --------------------------------------------------------------------------
# Module API (production call sites).
# --------------------------------------------------------------------------


def configure(
    enabled: bool | None = None,
    ring_size: int | None = None,
    slow_op_s: float | None = None,
    ring_spans: int | None = None,
) -> dict:
    """Arm/disarm the tracer and tune the ring / slow-op threshold.
    ``slow_op_s`` <= 0 disables the slow-op log. ``ring_spans`` bounds
    the TOTAL span count retained across the ring (memory bound for
    span-heavy op classes). Returns the effective config."""
    global armed, _ring, _ring_spans, _max_ring_spans, _slow_op_s
    with _lock:
        if ring_size is not None and ring_size > 0:
            if _ring.maxlen != ring_size:
                _ring = deque(_ring, maxlen=int(ring_size))
                _ring_spans = sum(
                    d.get("span_count", 1) for d in _ring
                )
        if ring_spans is not None and ring_spans > 0:
            _max_ring_spans = int(ring_spans)
            while _ring_spans > _max_ring_spans and len(_ring) > 1:
                _ring_spans -= _ring.popleft().get("span_count", 1)
        if slow_op_s is not None:
            _slow_op_s = max(float(slow_op_s), 0.0)
        if enabled is not None:
            armed = bool(enabled)
        return {
            "enabled": armed,
            "ring_size": _ring.maxlen,
            "ring_spans": _max_ring_spans,
            "slow_op_s": _slow_op_s,
        }


def reset() -> None:
    """Drop recorded traces (tests)."""
    global _ring_spans
    with _lock:
        _ring.clear()
        _ring_spans = 0
    with _ewma_lock:
        _stage_ewma.clear()


def stage_ewmas() -> dict[str, float]:
    """Per-``op/stage`` EWMA of stage seconds (armed runs only) — the
    heartbeat telemetry payload."""
    with _ewma_lock:
        return {f"{op}/{st}": v for (op, st), v in _stage_ewma.items()}


def start(op: str, name: str = "", parent: "Span | None" = None, **attrs):
    """Open a span (None when disarmed — every downstream helper
    accepts None). With no explicit ``parent`` the ambient span (set by
    :func:`activate`) is the parent; no ambient span = a new local
    root."""
    if not armed:
        return None
    p = parent if parent is not None else _current.get()
    if p is not None:
        return p.child(op, name, **attrs)
    return Span(op, name=name, attrs=attrs)


def start_from_metadata(
    op: str, md: dict, name: str = "", server: str = "", **attrs
):
    """Server-side span adoption: continue the trace carried in gRPC
    metadata (a LOCAL root here — its parent lives on the caller).
    None when disarmed."""
    if not armed:
        return None
    return Span(
        op,
        name=name,
        trace_id=md.get(TRACE_ID_KEY, ""),
        parent_id=md.get(PARENT_SPAN_KEY, ""),
        server=server,
        attrs=attrs,
    )


def start_from_headers(op: str, headers, name: str = "", server: str = "",
                       **attrs):
    """HTTP-side span adoption: continue the trace carried in request
    headers (a LOCAL root here — its parent span lives on the calling
    server/client). ``headers`` is any case-insensitive mapping with
    ``.get`` (http.client/BaseHTTPRequestHandler message objects
    qualify). None when disarmed."""
    if not armed:
        return None
    return Span(
        op,
        name=name,
        trace_id=headers.get(TRACE_ID_HEADER) or "",
        parent_id=headers.get(PARENT_SPAN_HEADER) or "",
        server=server,
        attrs=attrs,
    )


def http_headers(span=None, headers: dict | None = None) -> dict | None:
    """Outgoing HTTP headers carrying the trace context of ``span`` (or
    the ambient span). Returns ``headers`` with the two trace headers
    merged in, or None when there is nothing to carry (the request id
    rides separately via request_id.inject)."""
    sp = span
    if sp is None and armed:
        sp = _current.get()
    if sp is None:
        return headers
    h = headers if headers is not None else {}
    h[TRACE_ID_HEADER] = sp.trace_id
    h[PARENT_SPAN_HEADER] = sp.span_id
    return h


def set_current(span):
    """Install ``span`` as the ambient span; returns a token for
    :func:`reset_current` (the non-with-block form of :func:`activate`,
    for request handlers whose enter/exit live in different methods).
    None-safe: returns None when ``span`` is None."""
    if span is None:
        return None
    return _current.set(span)


def reset_current(token) -> None:
    if token is not None:
        _current.reset(token)


def current():
    """The ambient span, or None (always None when disarmed — the
    contextvar is not even read)."""
    if not armed:
        return None
    return _current.get()


def activate(span):
    """Context manager setting the ambient span for the with-block;
    no-op singleton when ``span`` is None."""
    if span is None:
        return _NOOP
    return _Activation(span)


def finish(span) -> None:
    if span is not None:
        span.finish()


def stage(span, name: str, chip: str = ""):
    """Per-batch stage timer: ``with trace.stage(sp, "disk_read"): …``.
    One is-None check and the singleton no-op when disarmed."""
    if span is None:
        return _NOOP
    return _StageTimer(span, name, chip)


def add_stage(span, name: str, seconds: float, chip: str = "") -> None:
    if span is not None:
        span.add_stage(name, seconds, chip)


def event(span, name: str, **attrs) -> None:
    if span is not None:
        span.event(name, **attrs)


def grpc_metadata(span=None, extra=None):
    """Outgoing gRPC metadata carrying the active request id and (when
    armed and a span is active) the trace context. Returns None when
    there is nothing to carry — ``grpc`` accepts ``metadata=None``.
    ``extra`` is an iterable of additional (key, value) pairs."""
    md = list(extra) if extra else []
    rid = _rid.get()
    if rid:
        md.append((REQUEST_ID_KEY, rid))
    sp = span
    if sp is None and armed:
        sp = _current.get()
    if sp is not None:
        md.append((TRACE_ID_KEY, sp.trace_id))
        md.append((PARENT_SPAN_KEY, sp.span_id))
    return tuple(md) if md else None


def metadata_dict(context) -> dict:
    """Lower-cased invocation metadata of a gRPC servicer context
    (empty for in-process calls passing context=None)."""
    md: dict = {}
    if context is None:
        return md
    try:
        for k, v in context.invocation_metadata():
            md[k.lower()] = v
    except Exception:
        pass
    return md


# --------------------------------------------------------------------------
# Ring export.
# --------------------------------------------------------------------------


def traces(
    trace_id: str = "", op: str = "", min_ms: float = 0.0
) -> list[dict]:
    """Completed root spans, oldest first. Filters: one trace id (a
    cross-server trace is several roots sharing it), a root ``op``
    class, and/or a minimum root duration in milliseconds — the
    ``/debug/traces?op=&min_ms=`` query surface."""
    with _lock:
        docs = list(_ring)
    if trace_id:
        docs = [d for d in docs if d["trace_id"] == trace_id]
    if op:
        docs = [d for d in docs if d["op"] == op]
    if min_ms > 0.0:
        docs = [d for d in docs if d["duration_s"] * 1000.0 >= min_ms]
    return docs


def chrome_trace(trace_id: str = "", docs: list[dict] | None = None) -> dict:
    """Chrome ``trace_event`` JSON (the dict; ``json.dump`` it) for the
    recorded traces — loadable in Perfetto / chrome://tracing. Each
    server becomes a process row, each root span a thread row; stages
    and attrs ride in ``args``."""
    if docs is None:
        docs = traces(trace_id)
    events: list[dict] = []
    pids: dict[str, int] = {}
    tid_next: dict[int, int] = {}

    def emit(doc: dict, pid: int, tid: int) -> None:
        args = {
            "trace_id": doc["trace_id"],
            "span_id": doc["span_id"],
            "request_id": doc["request_id"],
            "stages_ms": {
                s: round(a["seconds"] * 1000.0, 3)
                for s, a in doc["stages"].items()
            },
        }
        if doc.get("overlap_efficiency") is not None:
            args["overlap_efficiency"] = doc["overlap_efficiency"]
        args.update(doc["attrs"])
        events.append(
            {
                "name": doc["name"],
                "cat": doc["op"],
                "ph": "X",
                "ts": doc["start_ts"] * 1e6,
                "dur": max(doc["duration_s"], 1e-6) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
        for ev in doc["events"]:
            events.append(
                {
                    "name": ev["name"],
                    "cat": doc["op"],
                    "ph": "i",
                    "s": "t",
                    "ts": ev["ts"] * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "args": dict(ev["attrs"]),
                }
            )
        for c in doc["children"]:
            emit(c, pid, tid)

    for doc in docs:
        server = doc.get("server") or "proc"
        pid = pids.get(server)
        if pid is None:
            pid = pids[server] = len(pids) + 1
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": server},
                }
            )
        tid = tid_next.get(pid, 0) + 1
        tid_next[pid] = tid
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {
                    "name": f"{doc['op']} {doc['trace_id'][:8]}"
                },
            }
        )
        emit(doc, pid, tid)
    return {"traceEvents": events, "displayTimeUnit": "ms"}
