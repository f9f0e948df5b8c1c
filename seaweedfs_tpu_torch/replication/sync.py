"""Cross-cluster filer sync: replay one filer's namespace onto another.

Port of seaweedfs_tpu/replication/sync.py (reference
weed/command/filer_sync.go + weed/replication: replicator core +
filersink): event-driven continuous sync with an initial full copy.
Content is re-uploaded through the target filer (fids are cluster-local,
only bytes travel).

Where the two differ, on purpose: the JAX sync sends over a
`requests.Session`; the card's host has no `requests`, so the port sends
over `http.client` (`utils/urls.KeptConnections`, connections kept per
filer), and its listings go through the port's
`client/filer_client.list_dir`. A connection failure or an error status
is an `OSError` (`urls.HttpStatusError` for the status), where the JAX
loops catch `requests.RequestException`; a tail answer that is not JSON
is caught with them, as `requests`' own JSON error is one. The metadata
tail's long-poll runs on connections of its own, whose wait for an
answer `stop()` ends, so a stopped daemon (SIGTERM) ends within a
fraction of a second and not when its poll does.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
import urllib.parse

from ..utils.retry import Backoff, RetryPolicy
from ..utils.urls import KeptConnections, service_url

# Unified tail-retry schedule (utils/retry.py): quick first retry while
# a filer restarts, 30s tail so a long outage doesn't hammer it. Shared
# by FilerSync / FilerBackup / S3Sink.
TAIL_RETRY_POLICY = RetryPolicy(
    max_attempts=7, base_delay=0.5, max_delay=30.0
)

# what the daemons' tail loops take for a transient failure and retry
TAIL_ERRORS = (OSError, http.client.HTTPException, ValueError)

def meta_tail(http: KeptConnections, source: str, since_ns: int, wait_seconds: float) -> dict:
    """One long-poll of the source filer's `/~meta/tail`."""
    r = http.get(
        service_url(source, "/~meta/tail"),
        params={"sinceNs": str(since_ns), "waitSeconds": str(wait_seconds)},
        timeout=wait_seconds + 30,
    )
    r.raise_for_status()
    return r.json()


def source_now_ns(http: KeptConnections, source: str) -> int:
    """The SOURCE filer's clock (watermarks must never mix clocks —
    skew would skip events emitted during the full copy)."""
    return int(meta_tail(http, source, 1 << 62, 0).get("nowNs", 0)) or time.time_ns()


class FilerSync:
    def __init__(
        self,
        source: str,
        target: str,
        path_prefix: str = "/",
        state_file: str = "",
        exclude_prefixes: tuple = ("/topics",),
    ):
        self.source = source
        self.target = target
        self.prefix = path_prefix.rstrip("/") or "/"
        self.exclude = exclude_prefixes
        self.state_file = state_file
        self.watermark = 0
        if state_file and os.path.exists(state_file):
            try:
                with open(state_file) as f:
                    self.watermark = json.load(f)["sinceNs"]
            except (ValueError, KeyError, OSError):
                pass
        self._http = KeptConnections()
        self._tail = KeptConnections()
        self._stop = threading.Event()
        self.synced_files = 0
        self.deleted_files = 0

    # ------------------------------------------------------------ helpers

    def _src(self, path: str) -> str:
        return service_url(self.source, urllib.parse.quote(path))

    def _dst(self, path: str) -> str:
        return service_url(self.target, urllib.parse.quote(path))

    @staticmethod
    def _under(path: str, prefix: str) -> bool:
        """Subtree membership with a path boundary: '/docs' covers
        '/docs/x' but NOT '/docs-archive/x'."""
        return path == prefix or path.startswith(prefix.rstrip("/") + "/")

    def _in_scope(self, path: str) -> bool:
        if any(self._under(path, x) for x in self.exclude):
            return False
        return self.prefix == "/" or self._under(path, self.prefix)

    def _save_state(self) -> None:
        if self.state_file:
            with open(self.state_file, "w") as f:
                json.dump({"sinceNs": self.watermark}, f)

    # --------------------------------------------------------- full copy

    def full_sync(self) -> int:
        """Initial walk: copy every in-scope file source -> target."""
        from ..client.filer_client import list_dir

        copied = 0
        stack = [self.prefix if self.prefix != "/" else "/"]
        while stack:
            d = stack.pop()
            for e in list_dir(self.source, d):
                path = e["FullPath"]
                if not self._in_scope(path):
                    continue
                if e["IsDirectory"]:
                    self._http.post(self._dst(path) + "?mkdir=true", timeout=30)
                    stack.append(path)
                else:
                    if self._copy_file(path, e.get("Mime", "")):
                        copied += 1
        return copied

    def _copy_file(self, path: str, mime: str) -> bool:
        r = self._http.get(self._src(path), timeout=300)
        if r.status_code != 200:
            return False
        put = self._http.post(
            self._dst(path),
            data=r.content,
            headers={"Content-Type": mime or r.headers.get("Content-Type", "")},
            timeout=300,
        )
        if put.ok:
            self.synced_files += 1
            return True
        return False

    # -------------------------------------------------------------- tail

    def apply_event(self, ev: dict) -> None:
        directory = ev.get("directory", "")
        old, new = ev.get("oldEntry"), ev.get("newEntry")
        if new:
            path = f"{directory.rstrip('/')}/{new['name']}" if new["name"] else directory
            if not self._in_scope(path):
                return
            if new["isDirectory"]:
                self._http.post(self._dst(path) + "?mkdir=true", timeout=30)
            else:
                self._copy_file(path, "")
        elif old:
            path = f"{directory.rstrip('/')}/{old['name']}" if old["name"] else directory
            if not self._in_scope(path):
                return
            r = self._http.delete(self._dst(path) + "?recursive=true", timeout=60)
            if r.status_code in (200, 204):
                self.deleted_files += 1

    def _source_now_ns(self) -> int:
        return source_now_ns(self._http, self.source)

    def tail_once(self, wait_seconds: float = 10.0) -> int:
        body = meta_tail(self._tail, self.source, self.watermark, wait_seconds)
        dropped_before = int(body.get("droppedBeforeTsNs", 0))
        if 0 < self.watermark < dropped_before:
            # events up to dropped_before were rotated away: deletions in
            # the gap are unrecoverable from the log — full resync
            # (reference SubscribeMetadata errors for the same reason)
            print(
                f"meta log gap (watermark {self.watermark} < dropped-before "
                f"{dropped_before}); running full resync",
                flush=True,
            )
            self.watermark = self._source_now_ns() - 1
            self.full_sync()
            self._save_state()
            return 0
        for ev in body.get("events", []):
            self.apply_event(ev)
            self.watermark = max(self.watermark, ev.get("tsNs", 0))
        self._save_state()
        return len(body.get("events", []))

    def run(self) -> None:
        if self.watermark == 0:
            # watermark (in the SOURCE's clock) BEFORE the walk so events
            # racing the copy replay afterwards
            self.watermark = self._source_now_ns() - 1
            n = self.full_sync()
            print(f"initial sync: {n} files copied", flush=True)
            self._save_state()
        backoff = Backoff(TAIL_RETRY_POLICY)
        while not self._stop.is_set():
            try:
                self.tail_once()
                backoff.reset()
            except TAIL_ERRORS:
                self._stop.wait(backoff.next_delay())

    def stop(self) -> None:
        self._stop.set()
        self._tail.abort()
