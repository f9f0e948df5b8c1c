"""Opt-in cluster telemetry phone-home. Port of
seaweedfs_tpu/utils/telemetry.py, whole: nothing is sent unless the
master is given a URL (`-telemetry.url`).

Reference: weed/telemetry/collector.go:14 — the leader master
periodically posts a small report {version, os, volume counts, enabled
features} to a configured telemetry endpoint. Off unless a URL is
given; report contents are size/count aggregates only, never names or
data.
"""

from __future__ import annotations

import json
import platform
import threading
import urllib.request
import uuid

from . import urls
from .glog import logger

log = logger("telemetry")

VERSION = "seaweedfs-tpu/0.2"


class TelemetryCollector:
    def __init__(
        self,
        url: str,
        stats_fn,
        interval: float = 24 * 3600.0,
        is_leader_fn=None,
    ):
        """stats_fn() -> dict of count aggregates merged into the
        report; is_leader_fn gates sending to the raft leader so an HA
        group phones home once."""
        self.url = url
        self.stats_fn = stats_fn
        self.interval = interval
        self.is_leader_fn = is_leader_fn or (lambda: True)
        self.cluster_id = str(uuid.uuid4())
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> None:
        if self.url:
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def report(self) -> dict:
        data = {
            "version": VERSION,
            "os": f"{platform.system()}/{platform.machine()}",
            "cluster_id": self.cluster_id,
        }
        try:
            data.update(self.stats_fn() or {})
        except Exception as e:  # stats must never break the loop
            log.warning("stats collection failed: %s", e)
        return data

    def send_once(self) -> bool:
        if not self.is_leader_fn():
            return False
        body = json.dumps(self.report()).encode()
        req = urllib.request.Request(
            self.url,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urls.urlopen(req, timeout=10) as r:
                return 200 <= r.status < 300
        except Exception as e:
            log.v(1, "telemetry post failed: %s", e)
            return False

    def _loop(self) -> None:
        # first report shortly after boot, then every interval
        if not self._stop.wait(60.0):
            self.send_once()
        while not self._stop.wait(self.interval):
            self.send_once()
