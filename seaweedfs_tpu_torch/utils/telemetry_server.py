"""Telemetry collector server — the receiving end of the phone-home.

Port of seaweedfs_tpu/utils/telemetry_server.py, whole.

Reference: telemetry/server (the reference ships a collector storing
reports in Prometheus + a dashboard; `weed master -telemetry.url=...`
points at it). This one accepts the TelemetryCollector's POSTs,
keeps the latest report per cluster (bounded), persists them as JSONL
when a path is given, and exposes:

  POST /api/collect   report ingestion
  GET  /api/stats     summary JSON (clusters, aggregate counts)
  GET  /metrics       Prometheus text (per-cluster gauges + totals)
  GET  /healthz
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .glog import logger

log = logger("telemetry-server")

_NUMERIC_FIELDS = (
    "volume_count",
    "ec_volume_count",
    "server_count",
    "used_size",
    "file_count",
)


class TelemetryServer:
    MAX_CLUSTERS = 10_000  # bound memory against cluster-id churn

    def __init__(
        self,
        ip: str = "localhost",
        port: int = 9999,
        persist_path: str | None = None,
    ):
        self.ip = ip
        self._reports: dict[str, dict] = {}  # cluster_id -> latest
        self._lock = threading.Lock()
        self.persist_path = persist_path
        self._load()
        self._http = ThreadingHTTPServer((ip, port), self._handler_class())
        self.port = self._http.server_address[1]
        self._thread = threading.Thread(
            target=self._http.serve_forever, daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()

    # ------------------------------------------------------------ storage

    def _load(self) -> None:
        if not self.persist_path or not os.path.exists(self.persist_path):
            return
        with open(self.persist_path, encoding="utf-8") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    cid = rec.get("cluster_id")
                    if cid:
                        self._reports[cid] = rec
                except json.JSONDecodeError:
                    continue
        # the MAX_CLUSTERS bound applies on REPLAY too (append-only
        # file, months of cluster-id churn): keep the newest
        if len(self._reports) > self.MAX_CLUSTERS:
            keep = sorted(
                self._reports,
                key=lambda k: self._reports[k].get("received_at", 0),
                reverse=True,
            )[: self.MAX_CLUSTERS]
            self._reports = {k: self._reports[k] for k in keep}
        # compact: rewrite with only the retained latest-per-cluster
        # records so the JSONL stops growing without limit
        tmp = self.persist_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in self._reports.values():
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, self.persist_path)

    def ingest(self, report: dict) -> None:
        cid = str(report.get("cluster_id") or "unknown")
        report = dict(report)
        report["received_at"] = int(time.time())
        with self._lock:
            if (
                cid not in self._reports
                and len(self._reports) >= self.MAX_CLUSTERS
            ):
                # drop the stalest cluster, never the newest report
                oldest = min(
                    self._reports, key=lambda k: self._reports[k]["received_at"]
                )
                del self._reports[oldest]
            self._reports[cid] = report
        if self.persist_path:
            with open(self.persist_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(report) + "\n")

    # ------------------------------------------------------------- views

    def summary(self) -> dict:
        with self._lock:
            reports = list(self._reports.values())
        out = {
            "clusters": len(reports),
            "versions": {},
            "os": {},
        }
        for fld in _NUMERIC_FIELDS:
            out[f"total_{fld}"] = 0
        for r in reports:
            out["versions"][r.get("version", "?")] = (
                out["versions"].get(r.get("version", "?"), 0) + 1
            )
            out["os"][r.get("os", "?")] = out["os"].get(r.get("os", "?"), 0) + 1
            for fld in _NUMERIC_FIELDS:
                try:
                    out[f"total_{fld}"] += int(r.get(fld, 0) or 0)
                except (TypeError, ValueError):
                    pass
        return out

    def prometheus(self) -> str:
        s = self.summary()
        lines = [
            "# TYPE seaweed_telemetry_clusters gauge",
            f"seaweed_telemetry_clusters {s['clusters']}",
        ]
        for fld in _NUMERIC_FIELDS:
            lines.append(f"# TYPE seaweed_telemetry_total_{fld} gauge")
            lines.append(
                f"seaweed_telemetry_total_{fld} {s[f'total_{fld}']}"
            )
        def esc(label: str) -> str:
            """Prometheus label escaping: a client-supplied cluster_id
            with quotes/newlines must not corrupt the exposition."""
            return (
                label.replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n")
            )

        with self._lock:
            for cid, r in self._reports.items():
                for fld in _NUMERIC_FIELDS:
                    try:
                        v = int(r.get(fld, 0) or 0)
                    except (TypeError, ValueError):
                        continue
                    lines.append(
                        f'seaweed_telemetry_{fld}{{cluster="{esc(cid)}"}} {v}'
                    )
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------ handler

    def _handler_class(self):
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path.split("?")[0].rstrip("/") != "/api/collect":
                    return self._send(404, b"{}", "application/json")
                try:
                    n = int(self.headers.get("Content-Length", "0") or 0)
                    report = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(report, dict):
                        raise ValueError("report must be an object")
                except (ValueError, json.JSONDecodeError):
                    return self._send(
                        400, b'{"error": "bad report"}', "application/json"
                    )
                srv.ingest(report)
                self._send(200, b'{"ok": true}', "application/json")

            def do_GET(self):
                path = self.path.split("?")[0].rstrip("/") or "/"
                if path == "/healthz":
                    return self._send(200, b'{"ok": true}', "application/json")
                if path == "/api/stats":
                    return self._send(
                        200,
                        json.dumps(srv.summary()).encode(),
                        "application/json",
                    )
                if path == "/metrics":
                    return self._send(
                        200,
                        srv.prometheus().encode(),
                        "text/plain; version=0.0.4",
                    )
                self._send(404, b"not found", "text/plain")

        return Handler
