"""Continuous filer -> local-directory backup (reference `weed
filer.backup`, weed/command/filer_backup.go): an initial full copy of
the watched path, then the filer meta-event tail applied to a local
tree — adds, updates, deletes, and directory ops — with a persisted
watermark so restarts resume instead of recopying.

Shares FilerSync's semantics (same tail endpoint, same
gap-means-full-resync rule); the sink is the local filesystem instead
of a second filer.

Port of seaweedfs_tpu/replication/backup.py, over
`utils/urls.KeptConnections` where the JAX backup uses `requests` (see
replication/sync.py). One more
difference, on purpose: the JAX backup hands its paths to `requests`
unquoted, which requotes them and takes a `%` in a name for an escape;
the port quotes each path as the JAX `FilerSync` does. Its faults are
the JAX backup's: `full_sync` reads one page of each directory (the
filer's 1,024 entries), so files past it are not copied.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import urllib.parse

from ..utils.retry import Backoff
from ..utils.urls import KeptConnections, service_url
from .sync import TAIL_ERRORS, TAIL_RETRY_POLICY, meta_tail, source_now_ns


class FilerBackup:
    def __init__(
        self,
        source: str,
        dest_dir: str,
        path: str = "/",
        state_path: str = "filer.backup.state",
    ):
        self.source = source
        self.dest_dir = os.path.abspath(dest_dir)
        self.path = path.rstrip("/") or "/"
        self.state_path = state_path
        self.watermark = 0
        self.copied_files = 0
        self.deleted_files = 0
        self._http = KeptConnections()
        self._tail = KeptConnections()
        self._stop = threading.Event()
        os.makedirs(self.dest_dir, exist_ok=True)
        if os.path.exists(state_path):
            try:
                with open(state_path) as f:
                    self.watermark = int(json.load(f)["watermark"])
            except (ValueError, KeyError, OSError):
                self.watermark = 0

    # ----------------------------------------------------------- helpers

    def _src(self, path: str) -> str:
        return service_url(self.source, urllib.parse.quote(path))

    def _local(self, path: str) -> str:
        rel = path[len(self.path) :].lstrip("/") if self.path != "/" else path.lstrip("/")
        out = os.path.abspath(os.path.join(self.dest_dir, rel))
        # a hostile path ('..') must never escape the backup root
        if out != self.dest_dir and not out.startswith(self.dest_dir + os.sep):
            raise ValueError(f"path {path!r} escapes the backup dir")
        return out

    def _in_scope(self, path: str) -> bool:
        return self.path == "/" or path == self.path or path.startswith(
            self.path + "/"
        )

    def _save_state(self) -> None:
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"watermark": self.watermark}, f)
        os.replace(tmp, self.state_path)

    # ------------------------------------------------------------- copy

    def _copy_file(self, path: str) -> bool:
        r = self._http.get(self._src(path), timeout=300)
        if r.status_code != 200:
            return False
        local = self._local(path)
        os.makedirs(os.path.dirname(local), exist_ok=True)
        tmp = local + ".part"
        with open(tmp, "wb") as f:
            f.write(r.content)
        os.replace(tmp, local)
        self.copied_files += 1
        return True

    def full_sync(self) -> int:
        n = 0
        stack = [self.path]
        while stack:
            d = stack.pop()
            r = self._http.get(
                self._src(d),
                headers={"Accept": "application/json"},
                timeout=60,
            )
            if r.status_code != 200:
                continue
            for e in r.json().get("Entries") or []:
                p = e["FullPath"]
                if e.get("IsDirectory"):
                    os.makedirs(self._local(p), exist_ok=True)
                    stack.append(p)
                elif self._copy_file(p):
                    n += 1
        return n

    # ------------------------------------------------------------- tail

    def apply_event(self, ev: dict) -> None:
        directory = ev.get("directory", "")
        old, new = ev.get("oldEntry"), ev.get("newEntry")
        if new:
            path = (
                f"{directory.rstrip('/')}/{new['name']}"
                if new["name"]
                else directory
            )
            if not self._in_scope(path):
                return
            old_path = (
                f"{directory.rstrip('/')}/{old['name']}"
                if old and old.get("name")
                else ""
            )
            if old_path and old_path != path and self._in_scope(old_path):
                # rename: move locally instead of re-downloading
                try:
                    os.replace(self._local(old_path), self._local(path))
                    return
                except OSError:
                    pass  # fall through to a fresh copy
            if new["isDirectory"]:
                os.makedirs(self._local(path), exist_ok=True)
            else:
                self._copy_file(path)
        elif old:
            path = (
                f"{directory.rstrip('/')}/{old['name']}"
                if old["name"]
                else directory
            )
            if not self._in_scope(path):
                return
            local = self._local(path)
            try:
                if os.path.isdir(local):
                    shutil.rmtree(local, ignore_errors=True)
                else:
                    os.unlink(local)
                self.deleted_files += 1
            except FileNotFoundError:
                pass

    def _source_now_ns(self) -> int:
        return source_now_ns(self._http, self.source)

    def tail_once(self, wait_seconds: float = 10.0) -> int:
        body = meta_tail(self._tail, self.source, self.watermark, wait_seconds)
        dropped_before = int(body.get("droppedBeforeTsNs", 0))
        if 0 < self.watermark < dropped_before:
            # deletions in the rotated-away gap are unrecoverable from
            # the log: full resync (same rule as FilerSync)
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
            self.watermark = self._source_now_ns() - 1
            n = self.full_sync()
            print(f"initial backup: {n} files copied", flush=True)
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
