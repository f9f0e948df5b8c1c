"""Filer HTTP server: the file API over the Filer core.

Port of seaweedfs_tpu/server/filer_server.py (reference
weed/server/filer_server_handlers_{read,write}.go): file CRUD at path
URLs, JSON directory listings, ranges, mv.from rename, recursive delete,
TUS resumable uploads under /.tus/ (filer/tus.py), the long-poll
metadata tail at /~meta/tail, the pooled front end with its 503 reject
body, /debug/slo and /debug/gateway, TLS through utils/tls.py, and the
gRPC metadata service (filer/grpc_service.py) with the distributed lock
ring (filer/lock_ring.py) set on it and, given peers, a MetaAggregator.
Every route answers with the JAX server's statuses, headers and bodies,
the remote-mount control plane (POST /~remote/<op>, remote/mount.py,
imported on its first call) included.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent import futures
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, unquote, urlparse

import grpc

from ..filer.entry import new_entry, normalize_path
from ..filer.filer import Filer, FilerError
from ..filer.filer_store import NotFound
from ..filer.grpc_service import FilerGrpcService
from ..filer.lock_ring import LockRing
from ..filer.tus import TusError, TusManager
from ..pb import rpc
from ..utils.http_pool import build_http_server, send_body
from ..utils.request_id import RequestTracingMixin
from .multipart import _parse_upload


class FilerServer:
    def __init__(
        self,
        filer: Filer,
        ip: str = "localhost",
        port: int = 8888,
        meta_log=None,
        grpc_port: int = 0,
        peers: list[str] | None = None,
        tls=None,
        http_workers: int = 32,
        http_queue: int = 128,
    ):
        """meta_log: a filer.meta_log.MetaLog; when present it is
        subscribed to the filer, served at GET /~meta/tail (long-poll
        JSON batches) and over the gRPC SubscribeMetadata stream.

        grpc_port: port for the SeaweedFiler gRPC service (0 = pick an
        ephemeral port; exposed as .grpc_port).
        peers: other filers' gRPC addresses: starts a MetaAggregator
        that converges this store with theirs, and rings the locks.
        http_workers/http_queue: bounded worker-pool HTTP front end
        (utils/http_pool.py); saturation answers 503 + Retry-After with a
        JSON error body. 0 workers = unbounded stdlib threading server
        (also the TLS path)."""
        self.filer = filer
        self.ip = ip
        self.port = port
        self.meta_log = meta_log
        if meta_log is not None:
            filer.subscribe(meta_log)
        self._http = build_http_server(
            (ip, port),
            self._handler_class(),
            server_kind="filer",
            workers=http_workers,
            accept_queue=http_queue,
            tls=tls,
            reject_body=lambda: (
                "application/json",
                b'{"error": "filer saturated: worker pool and accept queue are full"}',
            ),
        )
        # Long-poll budget for /~meta/tail on the POOLED front end: a
        # full-length wait pins a worker, so only a quarter of the pool
        # may sit in long-polls at once; excess subscribers get their
        # wait clamped short (an early empty batch is legal long-poll
        # protocol; they re-poll) instead of starving the data plane.
        # The unbounded threaded server needs no budget (None).
        self._tail_slots = (threading.BoundedSemaphore(max(1, http_workers // 4))
                            if http_workers and tls is None else None)
        self.tls = tls
        if tls is not None:
            tls.wrap_server(self._http)
        self._thread = threading.Thread(target=self._http.serve_forever, daemon=True)
        # gRPC metadata service (reference weed/pb/filer.proto service)
        self._grpc = grpc.server(futures.ThreadPoolExecutor(max_workers=16))
        self._grpc_service = FilerGrpcService(filer, meta_log)
        rpc.add_service(self._grpc, rpc.FILER_SERVICE, self._grpc_service)
        self.grpc_port = self._grpc.add_insecure_port(f"{ip}:{grpc_port}")
        # distributed lock ring over the filer peer set (reference
        # weed/cluster/lock_manager); peers are gRPC addresses, as the
        # MetaAggregator's
        self.lock_ring = LockRing(f"{ip}:{self.grpc_port}", list(peers or []))
        self._grpc_service.lock_ring = self.lock_ring
        self.tus = TusManager(filer)
        self.aggregator = None
        if peers:
            from ..filer.meta_aggregator import MetaAggregator

            self.aggregator = MetaAggregator(filer, peers, client_name=f"{ip}:{port}")

    def _handler_class(self):
        filer = self.filer
        server_ref = self

        class Handler(RequestTracingMixin, BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            trace_server_kind = "filer"

            def log_message(self, *a):
                pass

            def _path(self) -> str:
                return normalize_path(unquote(urlparse(self.path).path))

            def _send(self, code: int, body: bytes, ctype="application/json"):
                self.send_response(code)
                if code == 204:  # RFC 9110: no body on 204
                    self.end_headers()
                    return
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            def _json(self, code: int, obj):
                self._send(code, json.dumps(obj).encode())

            def _marked(self, header: str, body: bytes) -> None:
                """A 200 JSON answer carrying one marker header."""
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header(header, "true")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            def do_GET(self):
                q = parse_qs(urlparse(self.path).query)
                if self.serve_slo_endpoint(urlparse(self.path).path):
                    return
                if urlparse(self.path).path == "/~meta/tail":
                    return self._meta_tail(q)
                self._sw_op = "read"
                path = self._path()
                try:
                    entry = filer.find_entry(path)
                except NotFound:
                    return self._json(404, {"error": f"{path} not found"})
                if entry.is_directory:
                    try:
                        limit = int(q.get("limit", ["1024"])[0])
                    except ValueError:
                        limit = 1024
                    last = q.get("lastFileName", [""])[0]
                    entries = [
                        {"FullPath": e.full_path, "IsDirectory": e.is_directory,
                         "FileSize": e.file_size, "Mtime": e.attr.mtime, "Mime": e.attr.mime}
                        for e in filer.list_entries(path, start_from=last, limit=limit)
                    ]
                    return self._marked("X-Filer-Listing", json.dumps(
                        {"Path": path, "Entries": entries,
                         "ShouldDisplayLoadMore": len(entries) >= limit}).encode())
                if q.get("chunks", [""])[0] == "true":
                    # chunk manifest for fsck/ops tooling
                    return self._marked("X-Filer-Chunks", json.dumps(
                        {"chunks": [c.fid for c in entry.chunks]}).encode())
                total = entry.file_size
                # HEAD never touches the data plane: size and type come
                # from the metadata entry alone
                if self.command == "HEAD":
                    self.send_response(200)
                    self.send_header("Content-Type", entry.attr.mime or "application/octet-stream")
                    self.send_header("Content-Length", str(total))
                    self.send_header("Accept-Ranges", "bytes")
                    if entry.attr.md5:
                        self.send_header("ETag", f'"{entry.attr.md5.hex()}"')
                    self.end_headers()
                    return
                # range requests; a malformed Range falls back to 200-full
                offset, size = 0, -1
                status = 200
                rng = self.headers.get("Range", "")
                if rng.startswith("bytes="):
                    try:
                        spec = rng[6:].split(",")[0]
                        lo_s, _, hi_s = spec.partition("-")
                        lo = int(lo_s) if lo_s else max(total - int(hi_s), 0)
                        hi = int(hi_s) if hi_s and lo_s else total - 1
                        if lo > hi or lo >= max(total, 1):
                            self.send_response(416)
                            self.send_header("Content-Range", f"bytes */{total}")
                            self.send_header("Content-Length", "0")
                            self.end_headers()
                            return
                        offset, size = lo, hi - lo + 1
                        status = 206
                    except ValueError:
                        offset, size, status = 0, -1, 200
                try:
                    data = filer.read_entry(entry, offset, size)
                except FilerError as e:
                    return self._json(500, {"error": str(e)})
                self.send_response(status)
                self.send_header("Content-Type", entry.attr.mime or "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                if status == 206:
                    self.send_header("Content-Range",
                                     f"bytes {offset}-{offset + len(data) - 1}/{total}")
                self.send_header("Accept-Ranges", "bytes")
                if entry.attr.md5:
                    self.send_header("ETag", f'"{entry.attr.md5.hex()}"')
                self.end_headers()
                # native body egress on the pooled front end, wfile else
                send_body(self, data)

            def do_HEAD(self):
                # TUS (resumable upload) offset probe
                path = self._path()
                if path.startswith("/.tus/") and "Tus-Resumable" in self.headers:
                    try:
                        state = server_ref.tus.head(path[len("/.tus/"):])
                    except TusError as e:
                        return self._tus_status(e.status)
                    self.send_response(200)
                    self.send_header("Tus-Resumable", "1.0.0")
                    self.send_header("Upload-Offset", str(state["offset"]))
                    self.send_header("Upload-Length", str(state["length"]))
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                return self.do_GET()

            def _tus_status(self, code: int, offset: int | None = None):
                self.send_response(code)
                self.send_header("Tus-Resumable", "1.0.0")
                if offset is not None:
                    self.send_header("Upload-Offset", str(offset))
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_OPTIONS(self):
                self.send_response(204)
                self.send_header("Tus-Resumable", "1.0.0")
                self.send_header("Tus-Version", "1.0.0")
                self.send_header("Tus-Extension", "creation,termination")
                self.send_header("Tus-Max-Size", str(1 << 40))
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_PATCH(self):
                path = self._path()
                # drain the body FIRST: a keep-alive connection must stay
                # framed even when the request is rejected
                try:
                    n = int(self.headers.get("Content-Length", "0") or "0")
                except ValueError:
                    n = 0
                body = self.rfile.read(n)
                if not path.startswith("/.tus/"):
                    return self._json(405, {"error": "PATCH is TUS-only"})
                try:
                    offset = int(self.headers.get("Upload-Offset", "-1"))
                    new_off = server_ref.tus.patch(path[len("/.tus/"):], offset, body)
                except TusError as e:
                    return self._tus_status(e.status)
                except ValueError:
                    return self._tus_status(400)
                except FilerError:
                    # e.g. the target path is a directory: surfaced as an
                    # HTTP status, never a dropped connection
                    return self._tus_status(409)
                self._tus_status(204, offset=new_off)

            def _meta_tail(self, q):
                """Long-poll metadata subscription: events after sinceNs,
                blocking up to waitSeconds for fresh ones."""
                srv_log = server_ref.meta_log
                if srv_log is None:
                    return self._json(404, {"error": "no metadata log"})
                try:
                    since = int(q.get("sinceNs", ["0"])[0])
                    limit = int(q.get("limit", ["10000"])[0])
                    wait_s = min(float(q.get("waitSeconds", ["0"])[0]), 60.0)
                except ValueError:
                    return self._json(400, {"error": "bad parameters"})
                events = srv_log.read_since(since, limit)
                if not events and wait_s > 0:
                    slots = server_ref._tail_slots
                    got_slot = True if slots is None else slots.acquire(blocking=False)
                    try:
                        if not got_slot:
                            # long-poll budget exhausted: answer fast with
                            # an empty batch rather than pinning another
                            # pool worker for up to a minute
                            wait_s = min(wait_s, 0.5)
                        srv_log.wait_for_events(since, timeout=wait_s)
                    finally:
                        if slots is not None and got_slot:
                            slots.release()
                    events = srv_log.read_since(since, limit)
                last = events[-1]["tsNs"] if events else since
                self._json(200, {
                    "events": events,
                    "lastTsNs": last,
                    # gap detection + clock anchoring for subscribers
                    "droppedBeforeTsNs": srv_log.dropped_before_ts,
                    "nowNs": time.time_ns(),
                })

            def _remote_op(self, op: str):
                """Remote-mount control plane (reference shell
                remote.configure/mount/cache/uncache/unmount)."""
                from ..remote import mount as rm

                n = int(self.headers.get("Content-Length", "0") or "0")
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    return self._json(400, {"error": "bad json"})
                try:
                    if op == "configure":
                        rm.configure(filer, body.pop("name"), body)
                        return self._json(200, {"configured": True})
                    if op == "mount":
                        n_objs = rm.mount(
                            filer,
                            body["dir"],
                            body["remote"],
                            body["bucket"],
                            body.get("prefix", ""),
                        )
                        return self._json(200, {"mounted": n_objs})
                    if op == "unmount":
                        rm.unmount(filer, body["dir"])
                        return self._json(200, {"unmounted": True})
                    if op == "cache":
                        e = rm.cache(filer, body["path"])
                        return self._json(
                            200, {"cached": True, "chunks": len(e.chunks)}
                        )
                    if op == "uncache":
                        rm.uncache(filer, body["path"])
                        return self._json(200, {"uncached": True})
                    if op == "mount.buckets":
                        out = rm.mount_buckets(
                            filer,
                            body["dir"],
                            body["remote"],
                            body.get("prefix", ""),
                        )
                        return self._json(
                            200,
                            {"mounted": out, "buckets": len(out)},
                        )
                    if op == "meta.sync":
                        added, updated, removed = rm.meta_sync(
                            filer, body["dir"]
                        )
                        return self._json(
                            200,
                            {
                                "added": added,
                                "updated": updated,
                                "removed": removed,
                            },
                        )
                except (FilerError, NotFound, KeyError) as e:
                    return self._json(409, {"error": str(e)})
                except Exception as e:  # remote endpoint failures
                    return self._json(502, {"error": str(e)})
                return self._json(404, {"error": f"unknown op {op}"})

            def _write(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                path = self._path()
                if path.startswith("/~remote/") and self.command == "POST":
                    return self._remote_op(path[len("/~remote/") :])
                if (self.command == "POST" and "Tus-Resumable" in self.headers
                        and "Upload-Length" in self.headers):
                    # TUS creation: the request path is the target. Drain
                    # any body (creation-with-upload clients) so the
                    # keep-alive stream stays framed.
                    self.rfile.read(int(self.headers.get("Content-Length", "0") or "0"))
                    try:
                        upload_id = server_ref.tus.create(path, int(self.headers["Upload-Length"]))
                    except (TusError, ValueError, FilerError):
                        return self._tus_status(400)
                    self.send_response(201)
                    self.send_header("Tus-Resumable", "1.0.0")
                    self.send_header("Location", f"/.tus/{upload_id}")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if "mv.from" in q:
                    src = normalize_path(q["mv.from"][0])
                    try:
                        filer.rename(src, path)
                    except NotFound:
                        return self._json(404, {"error": f"{src} not found"})
                    except FilerError as e:
                        return self._json(409, {"error": str(e)})
                    return self._json(200, {"from": src, "to": path})
                # trailing slash on the RAW url means mkdir (normalize_path
                # strips it, so check the unnormalized form)
                raw = unquote(u.path)
                raw_is_dir = raw.rstrip() not in ("", "/") and raw.endswith("/")
                if raw_is_dir or q.get("mkdir", [""])[0] == "true":
                    filer.create_entry(new_entry(path, is_directory=True, mode=0o755))
                    return self._json(201, {"path": path})
                if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                    # streaming clients (curl -T, shell fs.cp) send chunked
                    # bodies with no Content-Length
                    parts = []
                    while True:
                        line = self.rfile.readline(1024).strip()
                        try:
                            size = int(line.split(b";")[0], 16)
                        except ValueError:
                            break
                        if size == 0:
                            self.rfile.readline(1024)  # trailing CRLF
                            break
                        parts.append(self.rfile.read(size))
                        self.rfile.read(2)  # chunk CRLF
                    body = b"".join(parts)
                else:
                    body = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                name, mime, data = _parse_upload(self.headers, body)
                ttl_sec = 0
                if q.get("ttl", [""])[0]:
                    spec = q["ttl"][0]
                    mult = {"s": 1, "m": 60, "h": 3600, "d": 86400}.get(spec[-1], 0)
                    try:
                        ttl_sec = int(spec[:-1]) * mult if mult else int(spec)
                    except ValueError:
                        return self._json(400, {"error": f"bad ttl {spec!r}"})
                try:
                    entry = filer.write_file(path, data, mime=mime, ttl_sec=ttl_sec)
                except FilerError as e:
                    return self._json(500, {"error": str(e)})
                self._json(201, {"name": entry.name, "size": entry.file_size})

            do_PUT = _write
            do_POST = _write

            def do_DELETE(self):
                path = self._path()
                if path.startswith("/.tus/") and "Tus-Resumable" in self.headers:
                    try:
                        server_ref.tus.terminate(path[len("/.tus/"):])
                    except TusError as e:
                        return self._tus_status(e.status)
                    return self._tus_status(204)
                q = parse_qs(urlparse(self.path).query)
                recursive = q.get("recursive", [""])[0] == "true"
                try:
                    filer.delete_entry(path, recursive=recursive)
                except FilerError as e:
                    return self._json(409, {"error": str(e)})
                self._json(204, {})

        return Handler

    def start(self) -> None:
        self._thread.start()
        self._grpc.start()
        if self.lock_ring.members != [self.lock_ring.self_addr]:
            self.lock_ring.start()  # probing only matters with peers
        if self.aggregator is not None:
            self.aggregator.start()

    def stop(self) -> None:
        self.lock_ring.stop()
        if self.aggregator is not None:
            self.aggregator.stop()
        self._grpc.stop(grace=0.5)
        self._http.shutdown()
        self._http.server_close()
        self.filer.close()
        if self.meta_log is not None:
            self.meta_log.close()
