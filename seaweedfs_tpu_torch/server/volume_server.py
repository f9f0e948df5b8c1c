"""Volume server: the HTTP data plane and the shard net plane over one
Store, with the gRPC service and the cluster half beside them.

Port of seaweedfs_tpu/server/volume_server.py. This module holds the data
plane (reference weed/server/volume_server.go;
volume_server_handlers_read.go:142 GetOrHeadHandler, _write.go:20
PostHandler):

- the HTTP needle front end on the pooled worker server
  (utils/http_pool.py; the threaded one under TLS, `tls=`): GET and HEAD
  with ranges and ETags (a needle of an EC volume whose shard is gone is
  reconstructed on the card through the Store), thumbnails on
  ?width/?height/?mode (utils/images.py), ?locate=true (where a needle's
  payload lies and which fastread sidecar serves it), POST (a raw body or
  a multipart upload), DELETE, and the /status, /metrics, /debug/pprof,
  /debug/traces, /debug/slo and /debug/gateway surfaces; and, the port's
  own, /debug/kernels: this process's launches
  of each hand-written kernel (`ops/rs_kernels.LAUNCHES`, `MASKED`) and
  the interval-cache loads that degraded reads made, so a process that
  runs the server alone shows which kernels its EC paths launched;
- the shard net plane (ec/net_plane.py) with the server's four
  resolvers: shard ranges, needle payloads, needle writes and
  stream-shard blobs;
- one fastread sidecar (utils/fastread.py) per disk location, on
  `<dir>/.fastread.sock`. Its library failing to build or load stops the
  constructor; a socket that cannot be bound is logged and leaves that
  location on HTTP only, as in the JAX server.

The gRPC service with its EC RPCs, the master client, heartbeats, the
replica fan-out, the remote shard reader and peer-fetch rebuild live in
server/volume_grpc.py, which the constructor imports: this module itself
imports neither grpc nor protobuf. The HTTP handler and the plane's write
resolver call the plain methods `write_needle` and `delete_needle`, which
return what the JAX servicer's WriteNeedle and DeleteNeedle return; the
servicer's adapters call them too. The cluster half is reached under the
JAX server's names (`service`, `peer_fetch_rebuild`, `replicate_write`,
`replicate_delete`, `replicate_ec_delete`, the four `notify_*`).

A write or delete that the JAX server would fan out (a volume whose
replica placement asks for more than one copy, any delete on an EC
volume) goes to the holders the master names, as many as it names:
where it names fewer than the placement asks for, the write is
acknowledged with the copies reached, as in the JAX server. Where the
master lookup fails, a replicated write or delete is done here and
answered with an error that names the missing fan-out
(`FAN_OUT_REFUSED`), where the JAX server acknowledges it with one copy.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlparse

from ..ec import device_queue
from ..ec import net_plane as _netp
from ..ec.context import ECError
from ..ec.stream_encode import stream_summary
from ..storage.file_id import FileId, FileIdError
from ..storage.needle import CrcError, Needle
from ..storage.store import Store
from ..storage.volume import CookieMismatch, NotFoundError, ReadOnlyError, VolumeError
from ..utils import fastread
from ..utils import metrics as M
from ..utils import trace
from ..utils.crc import crc32c
from ..utils.glog import logger
from ..utils.http_pool import build_http_server, send_body
from ..utils.images import detect_format, resized
from ..utils.pprof import handle_debug_endpoint, require_loopback
from ..utils.request_id import RequestTracingMixin
from ..utils.security import JwtError, verify_jwt
from .multipart import _first_part, _parse_upload  # noqa: F401 — the upload parse, shared with the filer server

log = logger("volume")

# The phrase every fan-out refusal carries.
FAN_OUT_REFUSED = "fan-out not served here"


class VolumeServer:
    def __init__(
        self,
        directories: list[str],
        master: str = "",
        ip: str = "localhost",
        port: int = 8080,
        grpc_port: int = 0,
        max_volume_count: int = 8,
        ec_backend: str = "cuda",
        data_center: str = "",
        rack: str = "",
        jwt_key: str = "",
        needle_map_kind: str = "memory",
        tls=None,
        ec_scrub_interval: float = 0.0,
        ec_scrub_bytes_per_sec: float = 64 << 20,
        ec_scrub_bad_retention: float = 0.0,
        ec_interval_cache_mb: int | None = None,
        ec_device_queue: bool = True,
        ec_queue_window: int | None = None,
        ec_queue_recovery_share: float | None = None,
        ec_queue_scrub_share: float | None = None,
        ec_placement: str = "auto",
        ec_trace: bool = False,
        ec_trace_ring: int = 0,
        ec_slow_op_s: float = 0.0,
        http_workers: int = 32,
        http_queue: int = 128,
    ):
        """`master` is the master's HTTP address ("host:port", or a
        comma-separated HA group): heartbeats go to its gRPC port (+10000)
        and the fan-out, the remote shard reader and peer-fetch rebuild
        look holders up there. "" (the default; the JAX server's is
        "localhost:9333") runs the server without one: no heartbeat, and
        every lookup fails at once. The gRPC service listens on
        `grpc_port` (default `port` + 10000) and the net plane on
        `derive_port(grpc_port)`, as peers derive them. `ec_backend` names
        the backend of the mounted EC volumes and of RPCs that name none:
        cuda (the default), cpu or auto. The scheduler, placement and
        trace arguments are the JAX server's: a per-store QueueScope, and
        the process-wide flight recorder armed only when asked. `tls` (a
        utils/tls.TlsConfig) serves HTTPS on `port`."""
        shares = {}
        if ec_queue_recovery_share is not None:
            shares["recovery"] = ec_queue_recovery_share
        if ec_queue_scrub_share is not None:
            shares["scrub"] = ec_queue_scrub_share
        # the tracer is process-wide: arming is opt-in, so a second server
        # built with the defaults does not disarm the first's recorder
        if ec_trace or ec_trace_ring > 0 or ec_slow_op_s > 0:
            trace.configure(
                enabled=True if (ec_trace or ec_slow_op_s > 0) else None,
                ring_size=ec_trace_ring if ec_trace_ring > 0 else None,
                slow_op_s=ec_slow_op_s if ec_slow_op_s > 0 else None,
            )
        self.jwt_key = jwt_key
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port or (port + 10000)
        self.max_volume_count = max_volume_count
        from .volume_grpc import ClusterHalf

        # the gRPC server (bound on grpc_port here), the master client and
        # the heartbeats
        self.cluster = ClusterHalf(self, master, data_center, rack)
        self.service = self.cluster.service
        self.store = Store(
            directories,
            ip=ip,
            port=port,
            ec_backend=ec_backend,
            ec_remote_reader_factory=self.cluster._remote_reader_factory,
            needle_map_kind=needle_map_kind,
            # one reconstructed-interval cache for every EC volume of the
            # server; None keeps the store default, 0 disables it
            ec_interval_cache_bytes=(
                None if ec_interval_cache_mb is None else int(ec_interval_cache_mb) << 20
            ),
            ec_device_queue=ec_device_queue,
            ec_queue_window=ec_queue_window,
            ec_queue_shares=shares,
            ec_placement=ec_placement,
        )
        # bulk-read fast path: a native Unix-socket sendfile server per
        # disk location (the RDMA sidecar analog); same-host clients
        # resolve ?locate=true, then pull bytes kernel to kernel
        self.fastread_sockets: dict[str, str] = {}
        for loc in self.store.locations:
            sock = os.path.join(loc.directory, ".fastread.sock")
            try:
                fastread.start_server(sock, loc.directory)
            except OSError as e:
                log.warning("fastread sidecar of %s disabled: %s", loc.directory, e)
                continue
            self.fastread_sockets[os.path.abspath(loc.directory)] = sock
        # The shard net plane on grpc_port + 10000: shard ranges, needle
        # payloads and needle and blob writes. A port that cannot be bound
        # leaves the server without it, as the JAX server does.
        self.net_plane = None
        try:
            self.net_plane = _netp.ShardNetPlane(
                ip, _netp.derive_port(self.grpc_port),
                self._net_plane_resolve,
                server_label=f"{ip}:{port}",
                resolve_needle=self._net_plane_resolve_needle,
                resolve_write=self._net_plane_resolve_write,
                resolve_blob=self._net_plane_resolve_blob,
            )
        except OSError as e:
            log.warning("shard net plane disabled: %s", e)
        # Bounded worker-pool HTTP data plane: `http_workers` request
        # workers and an `http_queue`-deep connection budget; saturation
        # answers 503 and Retry-After. `http_workers=0`, or TLS, takes the
        # stdlib ThreadingHTTPServer instead.
        self._http = build_http_server(
            (ip, port),
            self._handler_class(),
            server_kind="volume",
            workers=http_workers,
            accept_queue=http_queue,
            tls=tls,
            reject_body=lambda: (
                "application/json",
                b'{"error": "volume server saturated: worker pool and '
                b'accept queue are full"}',
            ),
        )
        self.tls = tls
        if tls is not None:
            tls.wrap_server(self._http)
        self._http_thread = threading.Thread(target=self._http.serve_forever, daemon=True)
        # Background EC scrub (ec/scrub.py): off by default (interval 0)
        self.scrub_daemon = None
        if ec_scrub_interval > 0:
            from ..ec.scrub import ScrubDaemon

            self.scrub_daemon = ScrubDaemon(
                self.store,
                interval=ec_scrub_interval,
                bytes_per_sec=ec_scrub_bytes_per_sec,
                # 0 = keep quarantined .bad files forever (the default)
                bad_retention_s=ec_scrub_bad_retention or None,
            )

    # ---------------------------------------------------------- needles

    def write_needle(self, vid: int, nid: int, cookie: int, data: bytes,
                     name: bytes | str = b"", mime: bytes | str = b"", flags: int = 0,
                     is_replicate: bool = False, fsync: bool | None = None) -> tuple[int, str]:
        """Append one needle to volume `vid`: the body of the JAX
        servicer's WriteNeedle, the same record. Returns (size, error),
        error "" on success, else the servicer's error string. A write
        that is not itself a replica (`is_replicate`) goes to
        `replicate_write` after the local append. `fsync` None is the
        store's default (SEAWEED_VOLUME_FSYNC)."""
        with M.request_seconds.time(server="volume", op="write"):
            size, err = self._write_needle(vid, nid, cookie, data, name, mime, flags,
                                           is_replicate, fsync)
        M.request_total.inc(server="volume", op="write", code="err" if err else "ok")
        return size, err

    def _write_needle(self, vid, nid, cookie, data, name, mime, flags, is_replicate,
                      fsync) -> tuple[int, str]:
        n = Needle(cookie=cookie, needle_id=nid, data=data, flags=flags)
        if name:
            n.set_name(name.encode() if isinstance(name, str) else name)
        if mime:
            n.set_mime(mime.encode() if isinstance(mime, str) else mime)
        try:
            size = self.store.write_needle(vid, n, fsync=fsync)
        except (NotFoundError, ReadOnlyError, VolumeError, ValueError, OSError) as e:
            return 0, str(e)
        if not is_replicate:
            err = self.replicate_write(
                vid, nid, cookie, data,
                name=name.decode(errors="replace") if isinstance(name, bytes) else name,
                mime=mime.decode(errors="replace") if isinstance(mime, bytes) else mime,
                flags=flags,
            )
            if err:
                return 0, err
        return size, ""

    def delete_needle(self, vid: int, nid: int, is_replicate: bool = False) -> tuple[int, str]:
        """Tombstone one needle: the body of the JAX servicer's
        DeleteNeedle. Returns (freed bytes, error), error "" on success;
        (freed, error) where the local delete was done and the fan-out
        was not. Failed legs of a replica delete are ignored, as in the
        JAX server; a failed EC tombstone leg is not (a missed holder
        would bring the needle back)."""
        try:
            freed = self.store.delete_needle(vid, nid)
        except NotFoundError as e:
            return 0, str(e)
        except (ECError, VolumeError, ValueError, OSError) as e:
            # a volume mid-conversion or closing answers an error, never
            # an exception that aborts the connection
            return 0, f"volume busy: {e}"
        if not is_replicate:
            ev = self.store.find_ec_volume(vid)
            if ev is not None:
                err = self.replicate_ec_delete(vid, ev.collection, nid)
            else:
                err = self.replicate_delete(vid, nid)
            if err:
                return freed, err
        return freed, ""

    # --------------------------------------------- the cluster half's names

    def replicate_write(self, vid: int, nid: int, cookie: int, data: bytes, name: str = "",
                        mime: str = "", flags: int = 0) -> str:
        return self.cluster.replicate_write(vid, nid, cookie, data, name, mime, flags)

    def replicate_delete(self, vid: int, nid: int) -> str:
        return self.cluster.replicate_delete(vid, nid)

    def replicate_ec_delete(self, vid: int, collection: str, needle_id: int) -> str:
        return self.cluster.replicate_ec_delete(vid, collection, needle_id)

    def peer_fetch_rebuild(self, vid: int, collection: str = "", backend_name: str = "") -> dict:
        return self.cluster.peer_fetch_rebuild(vid, collection, backend_name)

    def notify_new_volume(self, vid: int) -> None:
        self.cluster.notify_new_volume(vid)

    def notify_deleted_volume(self, vid: int) -> None:
        self.cluster.notify_deleted_volume(vid)

    def notify_new_ec_shards(self, vid: int, collection: str) -> None:
        self.cluster.notify_new_ec_shards(vid, collection)

    def notify_deleted_ec_shards(self, vid: int, collection: str, sids) -> None:
        self.cluster.notify_deleted_ec_shards(vid, collection, sids)

    def _refresh_volume_gauges(self, st: dict | None = None) -> None:
        """`sw_volumes` and `sw_volume_bytes`, set at each heartbeat as the
        JAX server sets them, and by /metrics and /status (a server without
        a master sends none). `st`: a `store.status()` already taken."""
        if st is None:
            st = self.store.status()
        addr = self.store.public_url
        M.volume_count.set(len(st["volumes"]), kind="normal", addr=addr)
        M.volume_count.set(len(st["ec_volumes"]), kind="ec", addr=addr)
        M.volume_bytes.set(sum(v["size"] for v in st["volumes"]), kind="normal", addr=addr)
        M.volume_bytes.set(sum(e["shard_size"] * len(e["shards"]) for e in st["ec_volumes"]),
                           kind="ec", addr=addr)

    # -------------------------------------------------------- net plane

    def _net_plane_resolve(self, vid: int, sid: int, generation: int):
        """Shard fd and size for the shard-read opcode: mounted, the
        generation fence, the shard local."""
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            raise _netp.NetPlaneError("ec volume not mounted")
        if generation and ev.encode_ts_ns != generation:
            raise _netp.NetPlaneError("stale generation")
        fd = ev.shard_fds.get(sid)
        if fd is None:
            raise _netp.NetPlaneError("shard not local")
        return fd, os.fstat(fd).st_size

    def _net_plane_resolve_needle(self, vid: int, nid: int, cookie: int):
        """A needle payload's location for the needle-read opcode. EC,
        TTL'd and cold-tiered volumes refuse as a whole (status 2): their
        reads take the locked, checked HTTP path. A missing needle and a
        wrong cookie answer status 2 too, as the JAX resolver answers
        them: NotFoundError and CookieMismatch are VolumeErrors. The fd is
        opened per request against the current .dat, so a vacuum
        mid-flight shows as the client's CRC mismatch."""
        vol = self.store.find_volume(vid)
        if vol is None:
            raise _netp.NetPlaneVolumeRefusal("volume not here (or EC)")
        try:
            path, off, size, crc = vol.locate_payload(nid, cookie)
        except VolumeError as e:
            raise _netp.NetPlaneVolumeRefusal(str(e)) from None
        except Exception as e:  # noqa: BLE001 — any other fault is this needle's
            raise _netp.NetPlaneError(str(e)) from None
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError as e:
            raise _netp.NetPlaneError(str(e)) from None
        return fd, off, size, crc, True

    def _net_plane_resolve_write(self, vid: int, nid: int, cookie: int, data: bytes,
                                 md: dict) -> tuple[int, int]:
        """Land one needle for the write opcode through `write_needle`, so
        a plane write and an HTTP write give the same record. A keyed
        cluster needs a token in ``x-sw-w-jwt``; ``x-sw-w-replicate: 0``
        marks a replication leg, which is not fanned out further."""
        if self.jwt_key:
            try:
                # the HTTP gate's scope rule: fid tokens and volume tokens
                verify_jwt(self.jwt_key, md.get("x-sw-w-jwt", ""), str(FileId(vid, nid, cookie)))
            except JwtError:
                raise _netp.NetPlaneError("unauthorized") from None
        if self.store.find_volume(vid) is None:
            # not mounted here: no needle will ever land, and status 2 lets
            # clients negative-cache the volume
            raise _netp.NetPlaneVolumeRefusal(f"volume {vid} not found")
        try:
            flags = int(md.get("x-sw-w-flags", "0") or "0")
        except ValueError:
            flags = 0
        size, err = self.write_needle(
            vid, nid, cookie, data,
            name=_netp._unb64(md.get("x-sw-w-name", "")),
            mime=_netp._unb64(md.get("x-sw-w-mime", "")),
            flags=flags,
            is_replicate=md.get("x-sw-w-replicate") == "0",
            fsync=True if md.get("x-sw-w-fsync") == "1" else None,
        )
        if err:
            raise _netp.NetPlaneError(err)
        return size, crc32c(data)

    def _blob_root(self) -> str:
        root = os.environ.get("SEAWEED_EC_STREAM_BLOB_ROOT", "")
        if not root:
            root = os.path.join(self.store.locations[0].directory, "stream_shards")
        return root

    def _net_plane_resolve_blob(self, path: str, op: str, md: dict):
        """Remote stream-shard blobs for kind=blob writes (the `net:`
        remote roots of durable parity). Paths stay inside the blob root
        (SEAWEED_EC_STREAM_BLOB_ROOT, default ``<dir0>/stream_shards``);
        one that escapes refuses. Returns an fd the plane pwrites and
        closes, or None where the op was done here (unlink)."""
        if self.jwt_key:
            try:
                verify_jwt(self.jwt_key, md.get("x-sw-w-jwt", ""), "blob")
            except JwtError:
                raise _netp.NetPlaneError("unauthorized") from None
        root = os.path.realpath(self._blob_root())
        full = os.path.realpath(os.path.join(root, path))
        if full != root and not full.startswith(root + os.sep):
            raise _netp.NetPlaneError("blob path escapes stream root")
        if op == "unlink":
            try:
                os.unlink(full)
            except FileNotFoundError:
                pass
            except OSError as e:
                raise _netp.NetPlaneError(str(e)) from None
            return None
        try:
            os.makedirs(os.path.dirname(full), exist_ok=True)
            return os.open(full, os.O_CREAT | os.O_RDWR, 0o644)
        except OSError as e:
            raise _netp.NetPlaneError(str(e)) from None

    # ------------------------------------------------------------- http

    def _handler_class(self):
        server = self

        class Handler(RequestTracingMixin, BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            trace_server_kind = "volume"

            def log_message(self, *a):
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, msg: str) -> None:
                self._json(code, {"error": msg})

            def _fid(self):
                path = urlparse(self.path).path.lstrip("/")
                # "<vid>,<fid>" and "<vid>/<fid>" alike
                return FileId.parse(path.replace("/", ","))

            def _jwt_rejected(self, fid) -> bool:
                """True (and 401 sent) where the cluster has a signing key
                and the request lacks a valid token (reference
                maybeCheckJwtAuthorization)."""
                if not server.jwt_key:
                    return False
                auth = self.headers.get("Authorization", "")
                token = auth[7:] if auth.startswith("Bearer ") else ""
                try:
                    verify_jwt(server.jwt_key, token, str(fid))
                    return False
                except JwtError as e:
                    self._error(401, f"unauthorized: {e}")
                    return True

            def _traces(self, query: str) -> None:
                """The flight recorder's ring as Chrome trace_event JSON;
                ?trace_id= narrows to one trace, ?op= to one root op class,
                ?min_ms= to slow ops; ?format=spans gives the span trees."""
                if not require_loopback(self, "trace"):
                    return
                q = parse_qs(query)
                try:
                    min_ms = float(q.get("min_ms", ["0"])[0] or 0.0)
                except ValueError:
                    min_ms = 0.0
                docs = trace.traces(q.get("trace_id", [""])[0], op=q.get("op", [""])[0],
                                    min_ms=min_ms)
                self._json(200, docs if q.get("format", [""])[0] == "spans"
                           else trace.chrome_trace(docs=docs))

            def _kernels(self) -> None:
                from ..ops import rs_kernels

                cache = server.store.ec_interval_cache
                self._json(200, {
                    "launches": dict(rs_kernels.LAUNCHES),
                    "masked": dict(rs_kernels.MASKED),
                    "interval_cache": {"loads": cache.loads, "hits": cache.hits}
                    if cache is not None else {},
                })

            def _status(self) -> None:
                server._refresh_volume_gauges()
                st = server.store.status()
                # this server's scheduler scope, per chip and class, and
                # the chips whose fallback breaker is open
                snap = server.store.ec_scheduler.stats_snapshot()
                open_b = sum(1 for e in snap if e.get("breaker") == "open")
                st["ec_device_queue"] = {
                    "queues": snap,
                    "chips": len(snap),
                    "breakers_open": open_b,
                    "degraded": open_b > 0,
                }
                if server.net_plane is not None:
                    st["ec_net_plane"] = server.net_plane.status()
                st["ec_streams"] = stream_summary()
                st["ec_residency"] = device_queue.residency_snapshot()
                self._json(200, st)

            def _locate(self, fid) -> None:
                """The control plane of the bulk-read fast path: where the
                payload bytes lie and which sidecar socket serves them."""
                vol = server.store.find_volume(fid.volume_id)
                if vol is None:
                    return self._error(404, "volume not here (or EC)")
                try:
                    path, off, size, crc = vol.locate_payload(fid.needle_id, fid.cookie)
                except (NotFoundError, CookieMismatch) as e:
                    return self._error(404, str(e))
                except VolumeError as e:
                    return self._error(409, str(e))
                sock = ""
                apath = os.path.abspath(path)
                for d, s in server.fastread_sockets.items():
                    if apath.startswith(d + os.sep):
                        sock = s
                        break
                self._json(200, {"path": apath, "offset": off, "size": size, "crc32c": crc,
                                 "socket": sock})

            def do_GET(self):
                u = urlparse(self.path)
                if handle_debug_endpoint(self, u):
                    return
                if self.serve_slo_endpoint(u.path):
                    return
                if u.path == "/debug/traces":
                    return self._traces(u.query)
                if u.path == "/metrics":
                    server._refresh_volume_gauges()
                    body = M.REGISTRY.render()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if u.path == "/status":
                    return self._status()
                if u.path == "/debug/kernels":
                    return self._kernels()
                # Per-tenant shedding: reads of a tenant over its fair share
                # of the chip back off before any parse or lookup, while the
                # residency ledger is at full shed.
                ra = device_queue.shed_advice(server.store.ec_scheduler.tenant)
                if ra is not None:
                    body = json.dumps({"error": "tenant over fair device share"}).encode()
                    self.send_response(503)
                    self.send_header("Retry-After", str(max(1, int(ra))))
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                try:
                    fid = self._fid()
                except FileIdError as e:
                    return self._error(400, str(e))
                rq = parse_qs(u.query)
                if rq.get("locate", [""])[0] == "true":
                    return self._locate(fid)
                self._sw_op = "read"
                try:
                    # an EC degraded read below opens its own span under
                    # this request's root
                    with trace.stage(trace.current(), "volume.read"):
                        n = server.store.read_needle(fid.volume_id, fid.needle_id, fid.cookie)
                except (NotFoundError, ECError) as e:
                    return self._error(404, str(e))
                except (CookieMismatch, CrcError) as e:
                    return self._error(404, str(e))
                except (VolumeError, ValueError, OSError) as e:
                    # a volume closed or converted mid-read: an error
                    # response, never a dropped connection
                    return self._error(503, str(e))
                ctype = n.mime.decode() if n.mime else "application/octet-stream"
                data = n.data
                # on-the-fly thumbnails (reference weed/images,
                # volume_server_handlers_read.go:362-421)
                etag = f"{n.checksum:08x}"
                if "width" in rq or "height" in rq:
                    try:
                        rw = int(rq.get("width", ["0"])[0] or 0)
                        rh = int(rq.get("height", ["0"])[0] or 0)
                    except ValueError:
                        rw = rh = 0  # malformed dims: serve the original
                    rmode = rq.get("mode", [""])[0]
                    if rmode not in ("", "fit", "fill"):
                        # whitelist: the value is echoed into the ETag
                        # header, so arbitrary bytes would be header
                        # injection (response splitting)
                        rmode = ""
                    out, _, _ = resized(data, rw, rh, rmode)
                    if out is not data:
                        data = out
                        # a re-encode may change the container (GIF to
                        # PNG), and each variant needs its own cache key
                        fmt = detect_format(data)
                        if fmt:
                            ctype = f"image/{fmt.lower()}"
                        etag = f"{n.checksum:08x}-{rw}x{rh}{rmode}"
                total = len(data)
                status = 200
                content_range = None
                rng = self.headers.get("Range", "")
                if rng.startswith("bytes=") and self.command != "HEAD":
                    try:
                        lo_s, _, hi_s = rng[6:].split(",")[0].partition("-")
                        lo = int(lo_s) if lo_s else max(total - int(hi_s), 0)
                        hi = int(hi_s) if hi_s and lo_s else total - 1
                        if lo > hi or lo >= total:  # any range of an empty body too
                            self.send_response(416)
                            self.send_header("Content-Range", f"bytes */{total}")
                            self.send_header("Content-Length", "0")
                            self.end_headers()
                            return
                        hi = min(hi, total - 1)
                        data = data[lo : hi + 1]
                        status = 206
                        content_range = f"bytes {lo}-{hi}/{total}"
                    except ValueError:
                        pass  # a malformed Range: the whole body
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Accept-Ranges", "bytes")
                if content_range:
                    self.send_header("Content-Range", content_range)
                self.send_header("ETag", f'"{etag}"')
                self.end_headers()
                # needle payloads leave through the native scatter-gather
                # sender on the pooled front end
                send_body(self, data)

            do_HEAD = do_GET

            def do_POST(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                try:
                    fid = self._fid()
                except FileIdError as e:
                    return self._error(400, str(e))
                if self._jwt_rejected(fid):
                    return
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                name, mime, data = _parse_upload(self.headers, body)
                size, err = server.write_needle(
                    fid.volume_id, fid.needle_id, fid.cookie, data, name=name, mime=mime,
                    is_replicate=q.get("type", [""])[0] == "replicate",
                )
                if err:
                    return self._error(500, err)
                self._json(201, {"name": name, "size": size})

            def do_DELETE(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                try:
                    fid = self._fid()
                except FileIdError as e:
                    return self._error(400, str(e))
                if self._jwt_rejected(fid):
                    return
                freed, err = server.delete_needle(
                    fid.volume_id, fid.needle_id,
                    is_replicate=q.get("type", [""])[0] == "replicate",
                )
                if err:
                    if freed:
                        code = 500  # deleted here, the fan-out not done
                    elif "not found" in err:
                        code = 404
                    else:
                        # transient (volume mid-conversion, IO): 503, so
                        # clients retry rather than take it as gone
                        code = 503
                    return self._error(code, err)
                self._json(202, {"size": freed})

        return Handler

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.cluster.start()
        self._http_thread.start()
        if self.net_plane is not None:
            self.net_plane.start()
        if self.scrub_daemon is not None:
            self.scrub_daemon.start()

    def stop(self) -> None:
        self.cluster.stop()
        if self.net_plane is not None:
            self.net_plane.stop()
        if self.scrub_daemon is not None:
            self.scrub_daemon.stop()
        for sock in self.fastread_sockets.values():
            fastread.stop_server(sock)
        self._http.shutdown()
        self._http.server_close()
        self.store.close()
