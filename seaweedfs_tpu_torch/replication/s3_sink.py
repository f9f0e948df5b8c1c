"""Cloud sink: continuous filer → S3-compatible bucket replication.

Reference: weed/replication/sink/s3sink — the same source plumbing as
the filer→filer daemon (full walk, then meta-log tail with a persisted
watermark) but the write side is a RemoteS3Client, so any filer subtree
mirrors into a bucket/prefix on this framework's own S3 gateway or any
S3 endpoint.

Port of seaweedfs_tpu/replication/s3_sink.py, over the port's
`RemoteS3Client` and `utils/urls.KeptConnections` where the JAX sink
uses `requests` (see replication/sync.py). Its faults are the JAX sink's: a renamed
file is put at its new key and its old key stays.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse

from ..remote.s3_client import RemoteS3Client, RemoteStorageError
from ..utils.glog import logger
from ..utils.retry import Backoff
from ..utils.urls import KeptConnections, service_url
from .sync import TAIL_ERRORS, TAIL_RETRY_POLICY, meta_tail, source_now_ns

log = logger("s3sink")


class S3Sink:
    def __init__(
        self,
        source: str,
        client: RemoteS3Client,
        bucket: str,
        key_prefix: str = "",
        path_prefix: str = "/",
        state_file: str = "",
        exclude_prefixes: tuple = ("/topics", "/.tus", "/.uploads"),
    ):
        self.source = source
        self.client = client
        self.bucket = bucket
        self.key_prefix = key_prefix.strip("/")
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

    def _key(self, path: str) -> str:
        rel = path
        if self.prefix != "/" and path.startswith(self.prefix):
            rel = path[len(self.prefix) :]
        rel = rel.lstrip("/")
        return f"{self.key_prefix}/{rel}".strip("/")

    @staticmethod
    def _under(path: str, prefix: str) -> bool:
        return path == prefix or path.startswith(prefix.rstrip("/") + "/")

    def _in_scope(self, path: str) -> bool:
        if any(self._under(path, x) for x in self.exclude):
            return False
        return self.prefix == "/" or self._under(path, self.prefix)

    def _save_state(self) -> None:
        if self.state_file:
            with open(self.state_file, "w") as f:
                json.dump({"sinceNs": self.watermark}, f)

    def _copy(self, path: str) -> bool:
        r = self._http.get(
            service_url(self.source, urllib.parse.quote(path)), timeout=300
        )
        if r.status_code != 200:
            return False
        try:
            self.client.put_object(self.bucket, self._key(path), r.content)
        except RemoteStorageError as e:
            log.warning("put %s: %s", path, e)
            return False
        self.synced_files += 1
        return True

    # ------------------------------------------------------------- phases

    def full_sync(self) -> int:
        from ..client.filer_client import list_dir

        self.client.ensure_bucket(self.bucket)
        copied = 0
        stack = [self.prefix]
        while stack:
            d = stack.pop()
            for e in list_dir(self.source, d):
                path = e["FullPath"]
                if not self._in_scope(path):
                    continue
                if e["IsDirectory"]:
                    stack.append(path)  # S3 has no directories
                elif self._copy(path):
                    copied += 1
        return copied

    def apply_event(self, ev: dict) -> None:
        directory = ev.get("directory", "")
        old, new = ev.get("oldEntry"), ev.get("newEntry")
        if new:
            path = (
                f"{directory.rstrip('/')}/{new['name']}"
                if new["name"]
                else directory
            )
            if self._in_scope(path) and not new["isDirectory"]:
                self._copy(path)
        elif old:
            path = (
                f"{directory.rstrip('/')}/{old['name']}"
                if old["name"]
                else directory
            )
            if not self._in_scope(path):
                return
            try:
                self.client.delete_object(self.bucket, self._key(path))
                self.deleted_files += 1
            except RemoteStorageError as e:
                log.warning("delete %s: %s", path, e)

    def tail_once(self, wait_seconds: float = 10.0) -> int:
        payload = meta_tail(self._tail, self.source, self.watermark, wait_seconds)
        events = payload.get("events", [])
        for ev in events:
            self.apply_event(ev)
            self.watermark = max(self.watermark, int(ev.get("tsNs", 0)))
        if events:
            self._save_state()
        return len(events)

    def run(self) -> None:
        if self.watermark == 0:
            # watermark BEFORE the walk: events during the copy replay
            self.watermark = self._source_now_ns()
            n = self.full_sync()
            log.info("initial copy: %d files -> s3://%s", n, self.bucket)
            self._save_state()
        backoff = Backoff(TAIL_RETRY_POLICY)
        while not self._stop.is_set():
            try:
                self.tail_once()
                backoff.reset()
            except TAIL_ERRORS as e:
                log.warning("tail error: %s", e)
                self._stop.wait(backoff.next_delay())

    def _source_now_ns(self) -> int:
        return source_now_ns(self._http, self.source)

    def stop(self) -> None:
        self._stop.set()
        self._tail.abort()
