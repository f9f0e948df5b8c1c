"""One-shot client operations: upload/read/delete blobs end to end.

Port of seaweedfs_tpu/client/operations.py (reference weed/operation:
Uploader upload_content.go:163, SubmitFiles, DeleteFiles) — the HTTP data
plane against volume servers, gRPC to the master.

The JAX module speaks HTTP through a `requests.Session`; the port uses
`http.client`, since the card's host has no `requests`. The request
helper `_http` stamps the active X-Request-ID and the ambient trace
context on every call, as the JAX `TracingSession` does. The multipart
upload is the body `requests` builds for a one-file form, so the server
lands the same needle record. The upload's retry policy retries what
`requests.RequestException` stands for here: transport failures
(`OSError`, `http.client.HTTPException`) and 5xx answers
(`HTTPStatusError`, an OSError, as `requests.HTTPError` is). A 4xx
answer stays permanent. An https URL takes the process's client
context (`utils/urls.py`).

A read tries the shard net plane, then the same-host fastread sidecar
(`?locate=true`, then `utils/fastread.read_fid_fast`), then HTTP, in the
JAX order. `FAST_READS` counts the reads the sidecar served.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import time
import uuid
from collections import Counter
from urllib.parse import urlsplit

from .. import faults
from ..ec import native_io
from ..ec import net_plane as _netp
from ..storage.file_id import FileId
from ..utils import urls
from ..utils.fastread import FastReadError, read_fid_fast
from ..utils.retry import RetryError, RetryPolicy, retry_call
from ..utils.urls import service_url
from .master_client import MasterClient


# Reads served by the same-host fastread sidecar ("sidecar"), counted
# where `_try_fast_read` returns its bytes.
FAST_READS: Counter = Counter()


class HTTPStatusError(OSError):
    """An error status from a volume server (the port's counterpart of
    `requests.HTTPError`, an OSError too)."""

    def __init__(self, msg: str, status: int):
        super().__init__(msg)
        self.status = status


class _PermanentUploadError(Exception):
    """Non-retryable upload failure (4xx); carries the HTTPStatusError."""

    def __init__(self, err: Exception):
        super().__init__(str(err))
        self.err = err


def _http(method: str, url: str, body: bytes | None = None, headers: dict | None = None,
          timeout: float = 60) -> tuple[int, bytes]:
    """(status, body) of one request, with the active X-Request-ID and
    (when the flight recorder is armed) the ambient span's trace context
    stamped on it, so one id/trace follows client -> volume hops. An
    error status is an answer; transport failures raise OSError or
    http.client.HTTPException."""
    from ..utils import request_id, trace

    h = dict(headers or {})
    request_id.inject(h)
    trace.http_headers(headers=h)
    parts = urlsplit(url)
    conn = urls.connection(url, timeout)
    try:
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        conn.request(method, path, body=body, headers=h)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _multipart(name: str, data: bytes, mime: str) -> tuple[bytes, str]:
    """The one-file multipart/form-data body `requests` sends for
    files={"file": (name, data, mime)}, and its Content-Type."""
    boundary = uuid.uuid4().hex  # 32 hex digits, as urllib3's boundary
    fname = name.translate({10: "%0A", 13: "%0D", 34: "%22"})
    head = (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
            f'filename="{fname}"\r\nContent-Type: {mime}\r\n\r\n').encode()
    body = head + bytes(data) + f"\r\n--{boundary}--\r\n".encode("latin-1")
    return body, f"multipart/form-data; boundary={boundary}"


class Operations:
    def __init__(self, master: str = "localhost:9333", jwt_key: str = ""):
        """jwt_key: shared write-authz signing key; trusted components
        (filer, tools) self-sign tokens the way the reference's
        security.toml-holding services do."""
        self.master = MasterClient(master)
        self.jwt_key = jwt_key
        # chunk fetches over the shard net plane: the client is
        # connection-lazy (construction makes no sockets).
        # `_plane_refused` negative-caches volumes the plane can never
        # serve (EC/TTL'd/tiered: the server refuses on EVERY read),
        # TTL'd because a volume's tier can change.
        self._plane_client = _netp.NetPlaneClient()
        self._plane_refused: dict[int, float] = {}

    def _auth_headers(self, token: str, fid: str) -> dict:
        if not token and self.jwt_key:
            from ..utils.security import sign_jwt

            token = sign_jwt(self.jwt_key, fid)
        return {"Authorization": f"Bearer {token}"} if token else {}

    # Transient failures only: assign errors, transport errors, 5xx.
    # 4xx is permanent and escapes via _PermanentUploadError (not in
    # retry_on).
    _UPLOAD_POLICY = RetryPolicy(
        max_attempts=4,
        base_delay=0.1,
        max_delay=1.0,
        retry_on=(OSError, http.client.HTTPException, RuntimeError),
    )

    def upload(
        self,
        data: bytes,
        name: str = "",
        mime: str = "",
        collection: str = "",
        replication: str = "",
        ttl: str = "",
    ) -> str:
        """Assign + POST under the unified retry policy (reference
        UploadWithRetry, upload_content.go): a write can race a volume
        going readonly (vacuum, ec.encode) or a momentarily-unassignable
        master — re-assign and try again. 4xx responses are permanent
        and raise immediately."""

        def attempt() -> str:
            a = self.master.assign(
                collection=collection, replication=replication, ttl=ttl
            )
            if self._try_plane_write(a, data, name, mime):
                return a.fid
            url = service_url(a.url, f"/{a.fid}")
            body, ctype = _multipart(name or "file", data, mime or "application/octet-stream")
            status, text = _http(
                "POST", url, body,
                headers={"Content-Type": ctype, **self._auth_headers(a.jwt, a.fid)},
            )
            if status < 400:
                return a.fid
            err = HTTPStatusError(
                f"{status} for {url}: {text.decode(errors='replace')[:200]}", status
            )
            if status < 500:  # permanent (auth, bad request)
                raise _PermanentUploadError(err)
            raise err

        try:
            return retry_call(attempt, self._UPLOAD_POLICY, describe="upload")
        except _PermanentUploadError as e:
            raise e.err from None
        except RetryError as e:
            # callers match on the underlying transport error
            raise e.__cause__ from None

    def read(self, fid: str, fast: bool = True) -> bytes:
        f = FileId.parse(fid)
        for loc in self.master.lookup(f.volume_id):
            if fast:
                # net plane first: one 38-byte request on a persistent
                # TCP connection (locate resolved server-side)
                data = self._try_plane_read(loc, f)
                if data is not None:
                    return data
                data = self._try_fast_read(loc.url, fid)
                if data is not None:
                    return data
            status, body = _http("GET", service_url(loc.url, f"/{fid}"))
            if status == 200:
                return body
        raise LookupError(f"fid {fid} unreadable on all locations")

    # how long a VOLUME-level plane refusal (status 2: EC/TTL'd/tiered)
    # is negative-cached per vid — a volume's tier can change, so the
    # plane is re-probed after this instead of never
    _PLANE_REFUSAL_TTL_S = 60.0

    def _try_plane_read(self, loc, f: FileId) -> bytes | None:
        """Warm-path chunk fetch over the volume server's shard net
        plane: the needle payload lands straight in a pooled aligned
        buffer (sendfile -> sn_recv_into, CRC fused into the copy-in).
        None = fall back to the bit-identical HTTP path (plane disabled,
        sidecar absent, EC/TTL'd volume, CRC mismatch, armed faults —
        chaos belongs to the HTTP path's fault points)."""
        if (
            not native_io.enabled()
            or faults.active()
            or os.environ.get("SEAWEED_CHUNK_NET_PLANE", "1") == "0"
        ):
            return None
        gport = getattr(loc, "grpc_port", 0)
        if not gport:
            return None
        refused_at = self._plane_refused.get(f.volume_id)
        if refused_at is not None:
            if time.monotonic() - refused_at < self._PLANE_REFUSAL_TTL_S:
                return None
            self._plane_refused.pop(f.volume_id, None)
        addr = (loc.url.split(":")[0], _netp.derive_port(gport))
        try:
            return self._plane_client.read_needle(
                addr, f.volume_id, f.needle_id, f.cookie
            )
        except _netp.NetPlaneUnavailable:
            return None
        except _netp.NetPlaneError as e:
            if getattr(e, "volume_refusal", False):
                self._plane_refused[f.volume_id] = time.monotonic()
            return None

    def _try_plane_write(self, a, data: bytes, name: str, mime: str) -> bool:
        """PUT over the volume server's native write plane: header +
        payload on a pooled sidecar connection, CRC32C fused into the
        server's copy-in, replica fan-out running server-side exactly as
        for an HTTP POST. The needle record the server lands is
        bit-identical to the HTTP multipart path's (same name-or-"file" /
        mime defaults). False = fall back to the HTTP POST (plane
        disabled, sidecar absent, non-write chaos armed, or any plane
        error: the POST is the correctness path)."""
        if (
            not native_io.enabled()
            or os.environ.get("SEAWEED_CHUNK_NET_PLANE_WRITE", "1") == "0"
            or not _netp.write_plane_admissible()
        ):
            return False
        gport = getattr(a, "grpc_port", 0)
        if not gport:
            return False
        try:
            f = FileId.parse(a.fid)
        except Exception:  # noqa: BLE001 — odd fid: HTTP can cope
            return False
        refused_at = self._plane_refused.get(f.volume_id)
        if refused_at is not None:
            if time.monotonic() - refused_at < self._PLANE_REFUSAL_TTL_S:
                return False
            self._plane_refused.pop(f.volume_id, None)
        jwt = a.jwt
        if not jwt and self.jwt_key:
            from ..utils.security import sign_jwt

            jwt = sign_jwt(self.jwt_key, str(f.volume_id))
        addr = (a.url.split(":")[0], _netp.derive_port(gport))
        try:
            self._plane_client.write_needle(
                addr,
                f.volume_id,
                f.needle_id,
                f.cookie,
                data,
                name=(name or "file").encode(),
                mime=(mime or "application/octet-stream").encode(),
                jwt=jwt,
            )
            return True
        except _netp.NetPlaneUnavailable:
            return False
        except _netp.NetPlaneError as e:
            if getattr(e, "volume_refusal", False):
                self._plane_refused[f.volume_id] = time.monotonic()
            return False

    _LOCAL_HOSTS = None  # lazily-computed set of this machine's names

    @classmethod
    def _is_local(cls, url: str) -> bool:
        """Cheap locality check BEFORE paying a ?locate round trip:
        remote reads must not eat an extra RTT per chunk."""
        host = url.split("//")[-1].split(":")[0]
        if cls._LOCAL_HOSTS is None:
            names = {"localhost", "127.0.0.1", "::1"}
            try:
                hn = socket.gethostname()
                names.add(hn)
                names.update(socket.gethostbyname_ex(hn)[2])
            except OSError:
                pass
            cls._LOCAL_HOSTS = names
        return host in cls._LOCAL_HOSTS

    def _try_fast_read(self, url: str, fid: str) -> bytes | None:
        """Same-host bulk-read bypass (the RDMA sidecar analog): resolve
        the payload location over HTTP, then pull the bytes through the
        native Unix-socket sendfile server, CRC-verified. None = fall
        back to HTTP (remote host, no sidecar, EC volume, ...)."""
        if not self._is_local(url):
            return None
        if url in getattr(self, "_no_sidecar", set()):
            return None
        try:
            status, body = _http("GET", service_url(url, f"/{fid}?locate=true"), timeout=10)
            if status != 200:
                return None
            loc = json.loads(body)
            sock = loc.get("socket", "")
            if not sock or not os.path.exists(sock):
                # negative-cache: this server has no reachable sidecar,
                # stop probing on every read
                self.__dict__.setdefault("_no_sidecar", set()).add(url)
                return None
            data = read_fid_fast(loc)
        except (OSError, ValueError, KeyError, http.client.HTTPException, FastReadError):
            # a transport failure, a stale locate (CRC mismatch): HTTP;
            # a host library that fails to build or load raises
            return None
        FAST_READS["sidecar"] += 1
        return data

    def delete(self, fid: str) -> None:
        f = FileId.parse(fid)
        canonical = str(f)  # tokens are scoped to the canonical fid form
        for loc in self.master.lookup(f.volume_id):
            status, body = _http(
                "DELETE",
                service_url(loc.url, f"/{canonical}"),
                headers=self._auth_headers("", canonical),
            )
            if status not in (200, 202, 204, 404):
                raise RuntimeError(
                    f"delete {canonical} on {loc.url}: HTTP {status} "
                    f"{body.decode(errors='replace')[:200]}"
                )
            return

    def close(self) -> None:
        self._plane_client.close()
        self.master.close()
