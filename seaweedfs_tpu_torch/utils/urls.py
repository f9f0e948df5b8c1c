"""Cluster-internal URL scheme selection and the client side of TLS.

Port of seaweedfs_tpu/utils/urls.py: callers build a service's URL with
`service_url()` instead of hard-coding a scheme, and `enable_https()`
switches every internal hop of the process to https.

Where the two differ, on purpose: the JAX `enable_https` points
`requests` at a CA bundle (`REQUESTS_CA_BUNDLE`, the certifi roots plus
the cluster CA). The port's clients are `http.client` and `urllib`, which
read no such variable, so `enable_https` builds one process-wide client
`ssl.SSLContext` instead: the system's default roots plus the cluster CA,
the same trust. Where the cluster asks for client certificates (mutual
TLS), the node's own certificate and key go into that context too.
`client_context()`, `urlopen()` and `connection()` hand it to every
https request of the port. `KeptConnections` keeps such connections
alive between requests, where the JAX clients keep a `requests.Session`
(remote storage's S3 client and the replication daemons).
"""

from __future__ import annotations

import http.client
import json
import select
import ssl
import threading
import time
import urllib.request
from urllib.parse import urlencode, urlsplit

_scheme = "http"
_client_ctx: ssl.SSLContext | None = None


def enable_https(ca_file: str | None = None, cert_file: str = "", key_file: str = "") -> None:
    """Switch internal hops to https, trusting the cluster CA IN ADDITION
    to the system roots: a trust store of the cluster CA alone would break
    every external https call (cloud tier backends, webhooks). With
    `cert_file` and `key_file` the process presents that certificate to
    servers that require one."""
    global _scheme, _client_ctx
    ctx = ssl.create_default_context()
    if ca_file:
        ctx.load_verify_locations(ca_file)
    if cert_file:
        ctx.load_cert_chain(cert_file, key_file or None)
    _client_ctx = ctx
    _scheme = "https"


def disable_https() -> None:
    """Back to plain http, and the default client context."""
    global _scheme, _client_ctx
    _scheme = "http"
    _client_ctx = None


def scheme() -> str:
    return _scheme


def client_context() -> ssl.SSLContext:
    """The context an https request of this process takes: the one
    `enable_https` built, else the system's default."""
    return _client_ctx or ssl.create_default_context()


def service_url(hostport: str, path: str = "") -> str:
    """'host:port' (+ optional '/path') -> full URL on the cluster
    scheme. Pass-through when the caller already has a scheme."""
    if hostport.startswith(("http://", "https://")):
        return hostport + path
    return f"{_scheme}://{hostport}{path}"


def urlopen(req, timeout: float):
    """urllib's urlopen with the process's client context on https."""
    url = req.full_url if isinstance(req, urllib.request.Request) else req
    if url.startswith("https://"):
        return urllib.request.urlopen(req, timeout=timeout, context=client_context())
    return urllib.request.urlopen(req, timeout=timeout)


def connection(url: str, timeout: float) -> http.client.HTTPConnection:
    """An http.client connection to the host of `url`: HTTPS with the
    process's client context where the URL is https."""
    parts = urlsplit(url)
    if parts.scheme == "https":
        return http.client.HTTPSConnection(parts.hostname, parts.port or 443, timeout=timeout,
                                           context=client_context())
    return http.client.HTTPConnection(parts.hostname, parts.port or 80, timeout=timeout)


# what a kept connection raises when the server closed it while idle:
# nothing of the request was served, so it is sent again on a new one
_STALE = (http.client.RemoteDisconnected, BrokenPipeError, ConnectionResetError)

# how often a request waiting for its answer looks whether it was aborted
ABORT_POLL_S = 0.2


class HttpStatusError(OSError):
    """An error status where the caller asked for success
    (`Answer.raise_for_status`)."""


class Answer:
    """One whole answer: what the JAX callers read of a `requests.Response`."""

    def __init__(self, status: int, headers: http.client.HTTPMessage, content: bytes):
        self.status_code = status
        self.headers = headers  # case-insensitive .get()
        self.content = content

    @property
    def ok(self) -> bool:
        return self.status_code < 400

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self):
        return json.loads(self.content)

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise HttpStatusError(f"HTTP {self.status_code}")


class KeptConnections:
    """Requests over `connection()`s kept alive between them: one per
    request in flight, pooled per scheme and host, so threads may share
    the pool. A kept connection the server closed while idle is dialled
    again at once. `abort()`, from another thread or a signal handler,
    fails the request waiting for its answer within `ABORT_POLL_S`, and
    every request after it."""

    def __init__(self):
        self._idle: dict[str, list[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()
        self._aborted = False

    def request(self, method: str, url: str, body: bytes | None = None,
                headers: dict | None = None, params: dict | None = None,
                timeout: float = 60) -> Answer:
        parts = urlsplit(url)
        query = parts.query
        if params:
            query = (query + "&" if query else "") + urlencode(params)
        target = (parts.path or "/") + (f"?{query}" if query else "")
        key = f"{parts.scheme}://{parts.netloc}"
        while True:
            if self._aborted:
                raise OSError("aborted: the client is stopping")
            with self._lock:
                kept = self._idle.get(key)
                conn = kept.pop() if kept else None
            fresh = conn is None
            if fresh:
                conn = connection(url, timeout)
            else:
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
            try:
                conn.request(method, target, body=body, headers=headers or {})
                self._await_answer(conn, timeout)
                r = conn.getresponse()
                data = r.read()
            except _STALE:
                conn.close()
                if fresh:
                    raise
                continue
            except BaseException:
                conn.close()
                raise
            if r.will_close:
                conn.close()
            else:
                with self._lock:
                    self._idle.setdefault(key, []).append(conn)
            return Answer(r.status, r.msg, data)

    def _await_answer(self, conn: http.client.HTTPConnection, timeout: float) -> None:
        """Wait until the answer's first bytes are readable, looking
        every ABORT_POLL_S whether `abort()` was called."""
        deadline = time.monotonic() + timeout
        while True:
            if self._aborted:
                raise OSError("aborted: the client is stopping")
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("timed out waiting for the answer")
            ready, _, _ = select.select([conn.sock], [], [], min(left, ABORT_POLL_S))
            if ready:
                return

    def get(self, url: str, **kw) -> Answer:
        return self.request("GET", url, **kw)

    def post(self, url: str, data: bytes = b"", **kw) -> Answer:
        return self.request("POST", url, body=data, **kw)

    def delete(self, url: str, **kw) -> Answer:
        return self.request("DELETE", url, **kw)

    def abort(self) -> None:
        self._aborted = True

    def close(self) -> None:
        """Close the kept connections."""
        with self._lock:
            idle, self._idle = self._idle, {}
        for conns in idle.values():
            for conn in conns:
                conn.close()
