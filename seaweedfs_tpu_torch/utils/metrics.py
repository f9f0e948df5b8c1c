"""Minimal Prometheus-style metrics registry (text exposition format).

Port of seaweedfs_tpu/utils/metrics.py (reference weed/stats/metrics.go).
Stdlib-only: counters, gauges (callback gauges included), histograms
with labels, rendered in the text format Prometheus scrapes, byte for
byte as the JAX package renders them.

The registry holds the families the port's modules increment: requests
(`sw_request_*`), the volume server's gauges (`sw_volumes`,
`sw_volume_bytes`), EC operations and bytes, leaf repairs,
repair-journal actions, the network byte plane (`sw_net_*`), the
hot-cache tiers and the HTTP front end's inflight and rejected counts
(`sw_gateway_*`), the S3 auth path's verdict memo and the Kafka gateway's
produce and fetch bytes and the broker's group-commit windows
(`sw_mq_*`); the flight recorder (utils/trace.py), the stream encoder and
the device queue register their own.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable


class _Metric:
    def __init__(self, name: str, help_text: str, label_names: tuple[str, ...]):
        self.name = name
        self.help = help_text
        self.label_names = label_names
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        """{label_values_tuple: value} copy (status surfaces)."""
        with self._lock:
            return dict(self._values)


class Counter(_Metric):
    def __init__(self, name, help_text="", label_names=()):
        super().__init__(name, help_text, tuple(label_names))
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def collect(self):
        yield f"# HELP {self.name} {_escape_help(self.help)}"
        yield f"# TYPE {self.name} counter"
        with self._lock:
            for key, v in sorted(self._values.items()):
                yield f"{self.name}{_fmt_labels(self.label_names, key)} {_num(v)}"


class Gauge(_Metric):
    def __init__(self, name, help_text="", label_names=(), fn: Callable | None = None):
        super().__init__(name, help_text, tuple(label_names))
        self._values: dict[tuple, float] = {}
        self._fn = fn  # callback gauges sample at scrape time

    def set(self, value: float, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] = value

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def snapshot(self) -> dict:
        """Like _Metric.snapshot, but a callback gauge samples its fn
        (matching collect) instead of returning stale set() state."""
        if self._fn is not None:
            try:
                return {
                    tuple(labels.get(n, "") for n in self.label_names): v
                    for labels, v in self._fn()
                }
            except Exception:
                return {}
        return super().snapshot()

    def collect(self):
        yield f"# HELP {self.name} {_escape_help(self.help)}"
        yield f"# TYPE {self.name} gauge"
        if self._fn is not None:
            try:
                for labels, value in self._fn():
                    key = tuple(labels.get(n, "") for n in self.label_names)
                    yield f"{self.name}{_fmt_labels(self.label_names, key)} {_num(value)}"
            except Exception:
                pass
            return
        with self._lock:
            for key, v in sorted(self._values.items()):
                yield f"{self.name}{_fmt_labels(self.label_names, key)} {_num(v)}"


DEFAULT_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0
)


class Histogram(_Metric):
    def __init__(self, name, help_text="", label_names=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_text, tuple(label_names))
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def time(self, **labels):
        return _Timer(self, labels)

    def snapshot(self) -> dict:
        """{label_values_tuple: (cumulative_bucket_counts, total, sum)}
        — the quantile-derivation input (bucket counts are cumulative
        by construction of observe())."""
        with self._lock:
            return {
                key: (list(counts), self._totals[key], self._sums[key])
                for key, counts in self._counts.items()
            }

    def quantile(self, q: float, key: tuple) -> float:
        """Prometheus histogram_quantile-style estimate for one label
        set: linear interpolation inside the first bucket whose
        cumulative count covers rank q*total. Values beyond the last
        finite bucket clamp to it (same caveat as PromQL's +Inf)."""
        with self._lock:
            counts = list(self._counts.get(key) or ())
            total = self._totals.get(key, 0)
        if not counts or total <= 0:
            return 0.0
        return bucket_quantile(self.buckets, counts, total, q)

    def collect(self):
        yield f"# HELP {self.name} {_escape_help(self.help)}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            for key in sorted(self._counts):
                for i, b in enumerate(self.buckets):
                    lbl = _fmt_labels(
                        self.label_names + ("le",), key + (_num(b),)
                    )
                    yield f"{self.name}_bucket{lbl} {self._counts[key][i]}"
                lbl = _fmt_labels(self.label_names + ("le",), key + ("+Inf",))
                yield f"{self.name}_bucket{lbl} {self._totals[key]}"
                base = _fmt_labels(self.label_names, key)
                yield f"{self.name}_sum{base} {_num(self._sums[key])}"
                yield f"{self.name}_count{base} {self._totals[key]}"


class _Timer:
    def __init__(self, hist: Histogram, labels: dict):
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0, **self.labels)


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._names: set[str] = set()
        self._lock = threading.Lock()

    def register(self, metric):
        # Duplicate names invalidate the whole exposition (Prometheus
        # rejects a scrape with two metric families of one name), so a
        # second registration is a programming error worth a loud,
        # immediate failure — not a silently corrupt /metrics page.
        with self._lock:
            if metric.name in self._names:
                raise ValueError(
                    f"metric {metric.name!r} is already registered; "
                    f"re-use the existing collector instead of "
                    f"registering a second one"
                )
            self._names.add(metric.name)
            self._metrics.append(metric)
        return metric

    def counter(self, name, help_text="", label_names=()):
        return self.register(Counter(name, help_text, label_names))

    def gauge(self, name, help_text="", label_names=(), fn=None):
        return self.register(Gauge(name, help_text, label_names, fn))

    def histogram(self, name, help_text="", label_names=(), buckets=DEFAULT_BUCKETS):
        return self.register(Histogram(name, help_text, label_names, buckets))

    def render(self) -> bytes:
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.collect())
        return ("\n".join(lines) + "\n").encode()


def _fmt_labels(names: Iterable[str], values: Iterable[str]) -> str:
    pairs = [
        f'{n}="{_escape(str(v))}"' for n, v in zip(names, values)
    ]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _escape(v: str) -> str:
    """Label-value escaping per the text exposition format: backslash,
    double-quote, and line feed (in that order — escaping the escape
    character first keeps the transform reversible)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-text escaping: backslash and line feed only (quotes are
    legal in help text; a raw newline would terminate the comment line
    and corrupt the exposition)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def bucket_quantile(
    buckets: tuple, counts: list, total: int, q: float
) -> float:
    """Quantile from cumulative bucket counts (see Histogram.quantile).
    Pure function so the shell/SLO surfaces can derive p50/p99 from a
    scraped snapshot without a live Histogram."""
    q = min(max(q, 0.0), 1.0)
    rank = q * total
    prev_count = 0
    prev_le = 0.0
    for le, c in zip(buckets, counts):
        if c >= rank and c > prev_count:
            span = c - prev_count
            frac = (rank - prev_count) / span if span else 1.0
            return prev_le + (le - prev_le) * min(max(frac, 0.0), 1.0)
        # the interpolation base is the PREVIOUS bucket's bound even
        # when that bucket is empty (Prometheus histogram_quantile
        # semantics) — advancing only on non-empty buckets would bias
        # every quantile low when the low buckets are empty
        prev_count = c
        prev_le = le
    return buckets[-1] if buckets else 0.0


def slo_summary() -> dict:
    """Per-``server.op`` request-latency SLO snapshot derived from
    ``sw_request_seconds``: count, mean, p50/p90/p99 (ms). The payload
    of ``/debug/slo`` and the shell ``cluster.status`` SLO block."""
    out: dict[str, dict] = {}
    for key, (counts, total, s) in request_seconds.snapshot().items():
        labels = dict(zip(request_seconds.label_names, key))
        name = f"{labels.get('server', '')}.{labels.get('op', '')}"
        buckets = request_seconds.buckets
        out[name] = {
            "count": total,
            "mean_ms": round(s / total * 1000.0, 3) if total else 0.0,
            **{
                f"p{int(q * 100)}_ms": round(
                    bucket_quantile(buckets, counts, total, q) * 1000.0, 3
                )
                for q in (0.5, 0.9, 0.99)
            },
        }
    return out


def gateway_summary() -> dict:
    """Serving-path pressure snapshot for ``/debug/gateway``: per-tier
    hot-cache counters, per-server front-end inflight and rejected
    counts, and the chip residency ledger (ec/device_queue.py
    `residency_snapshot`)."""
    hot: dict[str, dict] = {}
    for counter, kind in (
        (gateway_hot_cache_hits_total, "hits"),
        (gateway_hot_cache_misses_total, "misses"),
        (gateway_hot_cache_singleflight_waits_total, "singleflight_waits"),
    ):
        for (tier,), v in counter.snapshot().items():
            hot.setdefault(tier, {})[kind] = int(v)
    try:
        # chip residency ledger (budget, inflight, shed per tenant); a
        # lazy import: metrics must not pull the EC package at startup
        from ..ec.device_queue import residency_snapshot

        residency = residency_snapshot()
    except Exception:  # advisory; the debug page must never fail
        residency = {}
    return {
        "hot_cache": hot,
        "inflight": {srv: int(v) for (srv,), v in gateway_inflight.snapshot().items()},
        "rejected": {srv: int(v) for (srv,), v in gateway_rejected_total.snapshot().items()},
        "residency": residency,
    }


def _num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# process-wide default registry (the reference's stats.Gather equivalent)
REGISTRY = Registry()

request_total = REGISTRY.counter(
    "sw_request_total", "requests by server/op/code", ("server", "op", "code")
)
request_seconds = REGISTRY.histogram(
    "sw_request_seconds", "request latency", ("server", "op")
)
volume_count = REGISTRY.gauge(
    "sw_volumes", "volumes on this server", ("kind", "addr")
)
volume_bytes = REGISTRY.gauge(
    "sw_volume_bytes", "bytes stored", ("kind", "addr")
)
ec_ops_total = REGISTRY.counter(
    "sw_ec_ops_total", "EC operations", ("op", "backend")
)
ec_bytes_total = REGISTRY.counter(
    "sw_ec_bytes_total", "bytes through the EC pipeline", ("op", "backend")
)
ec_leaf_repairs_total = REGISTRY.counter(
    "sw_ec_leaf_repairs_total",
    "leaf-granular in-place EC shard repairs by outcome "
    "(repaired/refused/failed)",
    ("outcome",),
)
ec_repair_journal_total = REGISTRY.counter(
    "sw_ec_repair_journal_total",
    "repair-journal recovery actions (replayed/rolled_back/kept/swept)",
    ("action",),
)

# Network byte plane: payload bytes over the wire per plane (native =
# sendfile/recv-into with the GIL released; python = the bit-identical
# fallback through Python buffers). The copied counter counts payload
# bytes materialized into Python-level buffers at the instrumented seams.
# `direction` splits the read-serving path from the write path. Help
# texts are the JAX package's, so the exposition text is byte-identical.
net_bytes_sent_total = REGISTRY.counter(
    "sw_net_bytes_sent_total",
    "payload bytes sent on the network byte path (shard net plane, "
    "EC shard-read RPC, gateway HTTP body egress, write-opcode egress)",
    ("plane", "direction"),
)
net_bytes_received_total = REGISTRY.counter(
    "sw_net_bytes_received_total",
    "payload bytes landed from the network byte path (peer-fetch "
    "ingress, write-opcode landing)",
    ("plane", "direction"),
)
net_bytes_copied_total = REGISTRY.counter(
    "sw_net_bytes_copied_total",
    "payload bytes materialized into Python-level buffers on the "
    "network byte path (the bytes-copied-per-byte-served numerator)",
    ("plane", "direction"),
)

# The Kafka gateway (mq/kafka/) and the broker's group commit
# (mq/group_commit.py).
mq_produce_bytes_total = REGISTRY.counter(
    "sw_mq_produce_bytes_total",
    "record-batch bytes accepted by the Kafka gateway produce path",
    ("plane",),
)
mq_fetch_bytes_total = REGISTRY.counter(
    "sw_mq_fetch_bytes_total",
    "fetch-response payload bytes served by the Kafka gateway, by "
    "egress plane (native = sn_sendv/sn_send_file, python = fallback)",
    ("plane",),
)
mq_group_commit_windows_total = REGISTRY.counter(
    "sw_mq_group_commit_windows_total",
    "broker group-commit flush windows completed",
)

# The serving path: the hot-object/chunk read-through cache tiers (tier =
# filer_chunk | filer_entry | ec_interval: the filer's chunk and entry
# caches and the EC interval cache) and the
# bounded worker-pool HTTP front ends (server = volume in the port).
gateway_hot_cache_hits_total = REGISTRY.counter(
    "sw_gateway_hot_cache_hits_total",
    "hot-cache hits on the gateway read path", ("tier",)
)
gateway_hot_cache_misses_total = REGISTRY.counter(
    "sw_gateway_hot_cache_misses_total",
    "hot-cache misses on the gateway read path", ("tier",)
)
gateway_hot_cache_singleflight_waits_total = REGISTRY.counter(
    "sw_gateway_hot_cache_singleflight_waits_total",
    "concurrent misses that joined another caller's in-flight load "
    "instead of re-running it",
    ("tier",),
)
gateway_inflight = REGISTRY.gauge(
    "sw_gateway_inflight",
    "HTTP requests currently being handled by the worker pool",
    ("server",),
)
gateway_rejected_total = REGISTRY.counter(
    "sw_gateway_rejected_total",
    "connections refused with 503 because the worker pool + accept "
    "queue were saturated",
    ("server",),
)

# The S3 auth path: SigV4 verdict-memo outcomes on header-auth requests
# (s3/auth.py). hit = the canonical request and its HMAC chain were
# skipped (freshness, identity and session token still re-checked);
# bypass = presigned or streaming auth, or the memo is off.
s3_auth_memo_total = REGISTRY.counter(
    "sw_s3_auth_memo_total",
    "SigV4 verdict-memo outcomes (hit/miss/bypass) on the S3 auth path",
    ("result",),
)
