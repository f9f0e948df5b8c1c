"""TLS for the port's HTTP listeners, with certificate hot reload.

Port of seaweedfs_tpu/utils/tls.py (reference weed/security/tls.go and
weed/security/certreload/): one SSLContext per listener whose cert chain
is loaded again, after a cheap mtime stat, from the ssl SNI callback,
which fires once per handshake, so operators rotate certificates without
a restart. `generate_self_signed` mints a CA and a leaf signed by it for
tests and bootstrap, with the `cryptography` package, imported inside the
function as in the JAX module.

Left out: `requests_kwargs`, which only `requests` reads; the port's
clients take `client_context()` or the process-wide context of
`utils/urls.py` instead.
"""

from __future__ import annotations

import contextlib
import datetime
import ipaddress
import os
import ssl
import threading
from dataclasses import dataclass, field


@dataclass
class TlsConfig:
    """Paths for one side of a TLS endpoint.

    ``ca_file`` set on a server means "require and verify client
    certificates" (mutual TLS, like the reference's
    grpc.*.ca security.toml keys); on a client it is the trust root.
    """

    cert_file: str
    key_file: str
    ca_file: str | None = None
    client_auth: bool = False
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _ctx: ssl.SSLContext | None = field(default=None, repr=False)
    _mtimes: tuple[float, float] = field(default=(0.0, 0.0), repr=False)

    # -- server side ----------------------------------------------------
    def _stat(self) -> tuple[float, float]:
        try:
            return (os.stat(self.cert_file).st_mtime, os.stat(self.key_file).st_mtime)
        except OSError:
            return self._mtimes

    def server_context(self) -> ssl.SSLContext:
        """A context whose cert chain hot-reloads on file change."""
        with self._lock:
            if self._ctx is None:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.load_cert_chain(self.cert_file, self.key_file)
                if self.client_auth and self.ca_file:
                    ctx.load_verify_locations(self.ca_file)
                    ctx.verify_mode = ssl.CERT_REQUIRED
                ctx.sni_callback = self._sni_reload
                self._ctx = ctx
                self._mtimes = self._stat()
            return self._ctx

    def _sni_reload(self, sslobj, server_name, ctx) -> None:
        # Per-handshake: two stat() calls; reload only when rotated.
        now = self._stat()
        if now != self._mtimes:
            with self._lock:
                if now != self._mtimes:
                    try:
                        ctx.load_cert_chain(self.cert_file, self.key_file)
                        self._mtimes = now
                    except (OSError, ssl.SSLError):
                        pass  # keep serving the old cert on a bad rotate

    def wrap_server(self, httpd) -> None:
        """TLS-enable a ThreadingHTTPServer.

        The handshake must NOT happen in the accept loop (a client that
        connects and sends nothing would stall every other connection),
        so the listening socket stays plain and each accepted socket is
        wrapped in the per-connection thread (finish_request), under a
        handshake timeout."""
        ctx = self.server_context()
        handler_cls = httpd.RequestHandlerClass

        def finish_request(request, client_address):
            request.settimeout(30.0)
            try:
                tls_sock = ctx.wrap_socket(request, server_side=True)
                tls_sock.settimeout(None)
            except (OSError, ssl.SSLError):
                with contextlib.suppress(OSError):
                    request.close()
                return
            handler_cls(tls_sock, client_address, httpd)

        httpd.finish_request = finish_request

    # -- client side ----------------------------------------------------
    def client_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        if self.ca_file:
            ctx.load_verify_locations(self.ca_file)
        else:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if self.cert_file and os.path.exists(self.cert_file):
            try:
                ctx.load_cert_chain(self.cert_file, self.key_file)
            except (OSError, ssl.SSLError):
                pass
        return ctx


def generate_self_signed(
    out_dir: str,
    hosts: tuple[str, ...] = ("localhost", "127.0.0.1"),
    days: int = 365,
    name: str = "server",
) -> TlsConfig:
    """Mint a CA plus a server cert signed by it under ``out_dir``.

    Returns a TlsConfig pointing at <name>.crt/<name>.key with ca.crt
    as the trust root. Re-invoking with the same dir reuses the CA so
    rotated leaf certs keep verifying.
    """
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    os.makedirs(out_dir, exist_ok=True)
    ca_crt = os.path.join(out_dir, "ca.crt")
    ca_key_p = os.path.join(out_dir, "ca.key")
    now = datetime.datetime.now(datetime.timezone.utc)

    if os.path.exists(ca_crt) and os.path.exists(ca_key_p):
        with open(ca_key_p, "rb") as f:
            ca_key = serialization.load_pem_private_key(f.read(), None)
        with open(ca_crt, "rb") as f:
            ca_cert = x509.load_pem_x509_certificate(f.read())
    else:
        ca_key = ec.generate_private_key(ec.SECP256R1())
        ca_name = x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, "seaweedfs-tpu test CA")]
        )
        ca_cert = (
            x509.CertificateBuilder()
            .subject_name(ca_name)
            .issuer_name(ca_name)
            .public_key(ca_key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(x509.BasicConstraints(ca=True, path_length=0), True)
            .sign(ca_key, hashes.SHA256())
        )
        with open(ca_key_p, "wb") as f:
            f.write(
                ca_key.private_bytes(
                    serialization.Encoding.PEM,
                    serialization.PrivateFormat.PKCS8,
                    serialization.NoEncryption(),
                )
            )
        with open(ca_crt, "wb") as f:
            f.write(ca_cert.public_bytes(serialization.Encoding.PEM))

    leaf_key = ec.generate_private_key(ec.SECP256R1())
    sans = []
    for h in hosts:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            sans.append(x509.DNSName(h))
    leaf = (
        x509.CertificateBuilder()
        .subject_name(
            x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, hosts[0])])
        )
        .issuer_name(ca_cert.subject)
        .public_key(leaf_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.SubjectAlternativeName(sans), False)
        .sign(ca_key, hashes.SHA256())
    )
    crt = os.path.join(out_dir, f"{name}.crt")
    key = os.path.join(out_dir, f"{name}.key")
    tmp_key, tmp_crt = key + ".tmp", crt + ".tmp"
    with open(tmp_key, "wb") as f:
        f.write(
            leaf_key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            )
        )
    with open(tmp_crt, "wb") as f:
        f.write(leaf.public_bytes(serialization.Encoding.PEM))
    # key first, then cert: the reload stat pair changes atomically enough
    os.replace(tmp_key, key)
    os.replace(tmp_crt, crt)
    return TlsConfig(cert_file=crt, key_file=key, ca_file=ca_crt)
