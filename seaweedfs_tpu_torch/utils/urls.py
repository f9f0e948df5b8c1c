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
https request of the port.
"""

from __future__ import annotations

import http.client
import ssl
import urllib.request
from urllib.parse import urlsplit

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
