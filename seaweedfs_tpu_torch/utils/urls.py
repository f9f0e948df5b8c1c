"""Cluster-internal URL scheme selection.

Port of seaweedfs_tpu/utils/urls.py: callers build a service's URL with
`service_url()` instead of hard-coding a scheme. The port serves plain
http only. The JAX module's `enable_https` (the https switch and the CA
bundle it hands to `requests`) comes with TLS (`utils/tls.py`); until
then the launcher refuses a TLS config, and `scheme()` is always "http".
"""

from __future__ import annotations

_scheme = "http"


def scheme() -> str:
    return _scheme


def service_url(hostport: str, path: str = "") -> str:
    """'host:port' (+ optional '/path') -> full URL on the cluster
    scheme. Pass-through when the caller already has a scheme."""
    if hostport.startswith(("http://", "https://")):
        return hostport + path
    return f"{_scheme}://{hostport}{path}"
