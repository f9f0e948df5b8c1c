"""S3 REST gateway over the filer.

Port of seaweedfs_tpu/s3/server.py: every route of the JAX gateway
answers as it does, with the same status codes, headers, XML bodies and
filer state, over the port's filer, `iam/policy`, `iam/oidc`,
`iam/ldap`, `s3/auth`, `s3/chunked`, `s3/post_policy`, `s3/versioning`,
`s3/sse`, `s3/tables` (Iceberg REST and S3 Tables) and `s3/iamapi` (the
embedded IAM API). S3 Select (`POST ?select`) answers one S3 error
document, 501 NotImplemented, naming ROADMAP.md item 19, which brings
it. The gateway is host code and imports no torch; its objects reach
the card where their collection (the bucket) is EC-encoded and read
degraded.

Reference: weed/s3api (s3api_server.go routes, filer_multipart.go,
s3api_object_handlers*.go). Buckets live at /buckets/<name> in the filer
namespace; multipart parts are filer entries whose chunk lists are
spliced (no data copy) on complete.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import json
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
import zlib
from http.server import BaseHTTPRequestHandler

from ..filer.entry import new_entry, normalize_path
from ..filer.filer import Filer, FilerError
from ..filer.filer_store import NotFound
from ..pb import filer_pb2 as fpb
from .auth import Identity, IdentityStore, S3AuthError, verify_v4_ex
from .chunked import decode_aws_chunked
from . import post_policy as ppol
from . import sse
from . import versioning as vtag
from .versioning import (
    LockViolation,
    archive_current,
    check_deletable,
    entry_vid,
    is_delete_marker,
    iter_versions,
    new_version_id,
    promote_latest,
    versions_dir,
)

BUCKETS_ROOT = "/buckets"
UPLOADS_DIR = ".uploads"
XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"

import re as _re

# S3 bucket naming (subset): 2-63 chars, lowercase/digits/dot/hyphen,
# starting and ending alphanumeric — also satisfies the master's
# collection-name rules
_BUCKET_RE = _re.compile(r"^[a-z0-9][a-z0-9.\-]{0,61}[a-z0-9]$")


def _xml(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


def _el(parent, tag, text=None):
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = str(text)
    return e


def _xml_ns(doc: ET.Element) -> str:
    """'{ns}' prefix of a parsed document ('' when un-namespaced)."""
    return doc.tag[: doc.tag.index("}") + 1] if doc.tag.startswith("{") else ""


def _iso(ts: int) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts or 0))


def _saturation_error_doc() -> tuple[str, bytes]:
    """503 body for a saturated gateway: a well-formed S3 error
    document (Code=SlowDown, AWS's throttle code) so SDK clients parse
    and back off instead of choking on a bare close."""
    root = ET.Element("Error")
    _el(root, "Code", "SlowDown")
    _el(
        root,
        "Message",
        "gateway saturated: worker pool and accept queue are full; "
        "reduce your request rate",
    )
    _el(root, "Resource", "/")
    return "application/xml", _xml(root)


def _shed_error_doc(tenant: str) -> tuple[str, bytes]:
    """503 body for per-tenant residency shedding: same SlowDown code
    SDKs already back off on, but the message says WHY this tenant
    (and not the server) is being told to slow down."""
    root = ET.Element("Error")
    _el(root, "Code", "SlowDown")
    _el(
        root,
        "Message",
        f"tenant {tenant!r} exceeds its fair device share during pod "
        "overload; reduce your request rate and retry",
    )
    _el(root, "Resource", "/")
    return "application/xml", _xml(root)


class S3Server:
    def __init__(
        self,
        filer: Filer,
        ip: str = "localhost",
        port: int = 8333,
        identities: IdentityStore | None = None,
        region: str = "us-east-1",
        lifecycle_interval: float = 3600.0,
        sts=None,
        tls=None,
        oidc=None,
        ldap=None,
        http_workers: int = 32,
        http_queue: int = 128,
        tenant: str = "default",
    ):
        """`http_workers`/`http_queue`: the bounded worker-pool front
        end (utils/http_pool.py) — `http_workers` request workers plus
        an `http_queue`-deep connection budget; past it new connections
        get an immediate 503 SlowDown XML error document with
        Retry-After. `http_workers=0` restores the unbounded
        one-thread-per-connection stdlib server (also used when `tls`
        is configured).

        `tenant` names this gateway's accounting domain on the EC
        residency ledger: when the pod is in sustained device
        oversubscription AND this tenant's device usage exceeds its
        fair share, object data-plane requests get an early 503
        SlowDown + Retry-After (per-tenant shedding — a well-behaved
        tenant on the same pod keeps serving)."""
        self.tenant = tenant
        self.filer = filer
        self.ip = ip
        self.port = port
        self.region = region
        # Layer filer-persisted dynamic credentials (shell `s3.*`
        # family writes s3/identity.json) over any static store.
        from .config import FilerIdentityStore

        self.identities = FilerIdentityStore(filer, base=identities)
        # STS service (iam.StsService): AssumeRole on the service
        # endpoint + temp-credential lookup during SigV4 auth
        self.sts_service = sts
        if sts is not None and self.identities.sts is None:
            self.identities.sts = sts
        # OIDC bearer tokens (iam/oidc.py OidcProvider): an alternative
        # authentication path beside SigV4
        self.oidc = oidc
        # LDAP simple-bind provider (iam/ldap.py): backs the STS action
        # AssumeRoleWithLdapIdentity
        self.ldap = ldap
        # SSE-S3 keyring: master key shared via the filer KV store so
        # every gateway over the same filer can decrypt (KMS SPI:
        # replace with an external provider via `sse_keyring=`).
        try:
            self.sse_keyring = sse.load_or_create_keyring(
                filer.store.kv_get,
                filer.store.kv_put,
                getattr(filer.store, "kv_put_if_absent", None),
            )
        except Exception:
            self.sse_keyring = None
        from .tables import TablesCatalog

        self.tables_catalog = TablesCatalog(self)
        # Striped per-key write locks: a conditional PUT's precondition
        # must be atomic against EVERY write to that key (a plain PUT,
        # multipart completion, POST-policy upload, or DELETE racing a
        # CAS would otherwise be silently lost). REENTRANT because the
        # conditional-PUT path holds its stripe around put_object,
        # which takes the same stripe as the common funnel.
        self._put_locks = [threading.RLock() for _ in range(64)]
        from ..utils.http_pool import build_http_server

        self._http = build_http_server(
            (ip, port),
            self._handler_class(),
            server_kind="s3",
            workers=http_workers,
            accept_queue=http_queue,
            tls=tls,
            reject_body=_saturation_error_doc,
        )
        self.tls = tls
        if tls is not None:
            tls.wrap_server(self._http)
        self._thread = threading.Thread(target=self._http.serve_forever, daemon=True)
        from .lifecycle import LifecycleScanner

        self.lifecycle = LifecycleScanner(filer)
        self._lc_interval = lifecycle_interval
        self._lc_stop = threading.Event()
        self._lc_thread = threading.Thread(target=self._lc_loop, daemon=True)
        try:
            self.filer.create_entry(
                new_entry(BUCKETS_ROOT, is_directory=True, mode=0o755)
            )
        except FilerError:
            pass

    def start(self) -> None:
        self._thread.start()
        if self._lc_interval > 0:
            self._lc_thread.start()

    def stop(self) -> None:
        self._lc_stop.set()
        self._http.shutdown()
        self._http.server_close()

    def _lc_loop(self) -> None:
        while not self._lc_stop.wait(self._lc_interval):
            try:
                self.lifecycle.run_once()
            except Exception:
                pass

    def _shed_retry_after(self) -> float | None:
        """Retry-After seconds when the residency shed policy wants
        THIS tenant backed off right now, else None. Never raises —
        overload safety must not add a failure mode to serving."""
        from ..ec.device_queue import shed_advice

        return shed_advice(self.tenant)

    # ------------------------------------------------------------ handler

    def _handler_class(self):
        srv = self

        from ..utils.request_id import RequestTracingMixin

        class Handler(RequestTracingMixin, BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            trace_server_kind = "s3"

            def log_message(self, *a):
                pass

            # ---- plumbing ----

            def _respond(self, code: int, body: bytes = b"", ctype="application/xml", extra=None):
                self.send_response(code)
                merged = {**getattr(self, "_cors", {}), **(extra or {})}
                for k, v in merged.items():
                    self.send_header(k, v)
                if code == 204:
                    self.end_headers()
                    return
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if self.command != "HEAD" and body:
                    # Warm-path GET bodies leave through the native
                    # scatter-gather sender when the pooled front end +
                    # native plane are on (GIL released for the whole
                    # send); bit-identical wfile fallback otherwise.
                    from ..utils.http_pool import send_body

                    send_body(self, body)

            def _error(self, code: int, s3code: str, msg: str):
                root = ET.Element("Error")
                _el(root, "Code", s3code)
                _el(root, "Message", msg)
                _el(root, "Resource", urllib.parse.urlparse(self.path).path)
                self._respond(code, _xml(root))

            def _later(self, item: str, what: str):
                """The one answer of a route whose module comes with a
                later ROADMAP.md item."""
                return self._error(
                    501,
                    "NotImplemented",
                    f"{what} is not ported yet: it comes with ROADMAP.md "
                    f"item {item}",
                )

            def _auth(self, payload: bytes | None = None) -> Identity | None:
                auth_hdr = self.headers.get("Authorization", "")
                if srv.oidc is not None and auth_hdr.startswith("Bearer "):
                    # OIDC path: an unverifiable bearer is REJECTED,
                    # never downgraded to anonymous
                    from ..iam.oidc import OidcError

                    try:
                        claims = srv.oidc.verify(auth_hdr[len("Bearer ") :])
                    except OidcError as e:
                        raise S3AuthError(
                            "InvalidToken", f"OIDC: {e}"
                        ) from None
                    return srv.oidc.identity_for(claims)
                if srv.identities.empty:
                    if srv.oidc is not None:
                        # OIDC-only deployment: an empty SigV4 store
                        # must NOT mean open mode — tokenless requests
                        # are ANONYMOUS (bucket policy may still grant)
                        self._anonymous = True
                        return None
                    return None  # open mode
                u = urllib.parse.urlparse(self.path)
                if "Authorization" not in self.headers and "X-Amz-Signature" not in u.query:
                    # No credentials at all: ANONYMOUS, not an auth
                    # failure — bucket policies and public ACLs may
                    # still grant access (evaluated in _handle).
                    self._anonymous = True
                    return None
                phash = self.headers.get(
                    "x-amz-content-sha256", "UNSIGNED-PAYLOAD"
                )
                ident, self._sig_ctx = verify_v4_ex(
                    srv.identities,
                    self.command,
                    u.path,
                    u.query,
                    self.headers,
                    phash,
                )
                # Integrity-bind the signed x-amz-content-sha256 to the
                # actual body: without this, a signed PUT body is
                # malleable by an on-path attacker (the signature only
                # covers the *claimed* hash).
                if (
                    ident is not None
                    and "Authorization" in self.headers
                    and phash != "UNSIGNED-PAYLOAD"
                    and not phash.startswith("STREAMING-")
                ):
                    body = self._read_body()
                    if hashlib.sha256(body).hexdigest() != phash.lower():
                        raise S3AuthError(
                            "XAmzContentSHA256Mismatch",
                            "x-amz-content-sha256 does not match body",
                        )
                return ident

            def _authorize(
                self, ident, m: str, bucket: str, key: str, q: dict
            ) -> str | None:
                """Combine identity policies, the bucket (resource)
                policy, and canned ACLs per AWS evaluation logic:
                explicit Deny ANYWHERE (identity or bucket policy)
                wins; otherwise any applicable Allow grants; anonymous
                callers need a resource grant (bucket policy Principal
                "*" or a public canned ACL), and ACL grants cover only
                data-plane actions. Returns an error message, or None
                when authorized."""
                from ..iam.policy import (
                    evaluate_bucket_policy,
                    evaluate_policies_verdict,
                    s3_action_and_resource,
                )

                action, resource = s3_action_and_resource(m, bucket, key, q)
                pctx = {
                    "aws:SourceIp": self.client_address[0],
                    "aws:username": ident.name if ident else "",
                    "s3:prefix": q.get("prefix", ""),
                }
                bp_verdict = None
                pdoc = srv.bucket_policy(bucket) if bucket else None
                if pdoc is not None:
                    principal = (
                        f"arn:aws:iam:::user/{ident.name}" if ident else "*"
                    )
                    bp_verdict = evaluate_bucket_policy(
                        pdoc, action, resource, principal, pctx
                    )
                    if bp_verdict == "deny":
                        return f"{action} denied by bucket policy"
                if self._anonymous:
                    if not bucket:
                        return "anonymous access denied"
                    if bp_verdict == "allow":
                        return None
                    if srv.acl_allows_anonymous(bucket, key, action):
                        return None
                    return "anonymous access denied"
                if ident is None:
                    return None  # open mode
                if ident.policies:
                    iv = evaluate_policies_verdict(
                        list(ident.policies), action, resource, pctx
                    )
                    # identity explicit Deny overrides a bucket-policy
                    # Allow (deny anywhere wins)
                    if iv == "deny":
                        return f"{action} on {resource} denied by policy"
                    if iv == "allow" or bp_verdict == "allow":
                        return None
                    return f"{action} on {resource} denied by policy"
                if bp_verdict == "allow" or ident.allows(
                    _required_action(m, bucket, key)
                ):
                    return None
                return "identity lacks permission"

            def _bucket_key(self):
                u = urllib.parse.urlparse(self.path)
                parts = urllib.parse.unquote(u.path).lstrip("/").split("/", 1)
                bucket = parts[0]
                key = parts[1] if len(parts) > 1 else ""
                return bucket, key, dict(
                    urllib.parse.parse_qsl(u.query, keep_blank_values=True)
                )

            def _read_body(self) -> bytes:
                if self._body_read:
                    return self._body_cache
                n = int(self.headers.get("Content-Length", "0") or "0")
                body = self.rfile.read(n)
                self._body_read = True
                # aws-chunked (streaming sigv4) transfer decoding; the
                # signed form verifies the chunk-signature chain seeded
                # by the Authorization signature (chunked_reader_v4.go)
                phash = self.headers.get("x-amz-content-sha256", "")
                if phash.startswith("STREAMING-AWS4-HMAC-SHA256-PAYLOAD"):
                    # verify the chunk chain only when header auth
                    # produced a signing context; open-mode and
                    # presigned requests have no seed to chain from
                    ctx = getattr(self, "_sig_ctx", None)
                    body = decode_aws_chunked(body, ctx, signed=ctx is not None)
                elif phash.startswith("STREAMING-") or "aws-chunked" in (
                    self.headers.get("Content-Encoding", "")
                ):
                    body = decode_aws_chunked(body)
                self._body_cache = body
                return body

            # ---- dispatch ----

            def _handle(self):
                self._body_read = False
                self._body_cache = b""
                self._cors = {}
                self._sig_ctx = None
                self._anonymous = False
                try:
                    bucket, key, q = self._bucket_key()
                    m = self.command
                    # SLO op class (sw_request_seconds{server="s3",op})
                    if key:
                        self._sw_op = {
                            "GET": "get_object",
                            "HEAD": "head_object",
                            "PUT": "put_object",
                            "POST": "post_object",
                            "DELETE": "delete_object",
                        }.get(m, m.lower())
                    elif bucket:
                        self._sw_op = f"bucket_{m.lower()}"
                    if m == "OPTIONS":
                        # browser preflights carry no Authorization by
                        # spec: they must be evaluated BEFORE auth
                        return self._preflight(bucket)
                    if bucket and self.headers.get("Origin"):
                        # every response (incl. errors and writes) needs
                        # the allow-origin header or browsers block it
                        self._cors = self._cors_response_headers(bucket)
                    if key and m in ("GET", "HEAD", "PUT", "POST", "DELETE"):
                        # Per-tenant graceful shedding: when the EC
                        # residency ledger says THIS gateway's tenant
                        # is over its fair device share during pod
                        # overload, the object data plane backs off
                        # here — before auth, before any device work —
                        # with the same SlowDown+Retry-After contract
                        # the saturated accept path already speaks.
                        # Bucket/control ops stay up so operators can
                        # still inspect and reconfigure mid-storm.
                        ra = srv._shed_retry_after()
                        if ra is not None:
                            ctype, body = _shed_error_doc(srv.tenant)
                            return self._respond(
                                503,
                                body,
                                ctype=ctype,
                                extra={"Retry-After": str(max(1, int(ra)))},
                            )
                    if (
                        m == "POST"
                        and bucket
                        and key == ""
                        and "delete" not in q
                        and self.headers.get("Content-Type", "").startswith(
                            "multipart/form-data"
                        )
                    ):
                        # POST-policy browser upload: authn is the
                        # SigV4 signature over the policy document in
                        # the form itself, not the Authorization header
                        return self._post_policy_upload(bucket)
                    try:
                        # gateway stage: SigV4/OIDC verification cost of
                        # this request (trace.current() = the HTTP root
                        # span the mixin opened; no-op disarmed)
                        from ..utils import trace as _trace

                        with _trace.stage(_trace.current(), "s3.auth"):
                            ident = self._auth()
                    except S3AuthError as e:
                        return self._error(403, e.code, str(e))
                    u = urllib.parse.urlparse(self.path)
                    raw_path = urllib.parse.unquote(u.path)
                    from . import tables as _tables

                    # Precise matchers (no substring hijack of ordinary
                    # object keys): /iceberg/v1/..., the S3Tables
                    # X-Amz-Target protocol, or the CLI's ARN-rooted
                    # REST paths. A user bucket literally named
                    # 'iceberg'/'buckets' is shadowed, exactly like the
                    # reference's own route registration.
                    is_tables = self.headers.get(
                        "X-Amz-Target", ""
                    ).startswith("S3Tables.") or _tables.is_s3tables_path(
                        raw_path
                    )
                    if raw_path.startswith("/iceberg/v1/") or is_tables:
                        # Catalog mutation = admin surface: anonymous
                        # callers are refused, and configured
                        # identities must hold the Admin action (the
                        # normal _authorize path never runs here).
                        if self._anonymous:
                            return self._error(
                                403, "AccessDenied", "catalog requires auth"
                            )
                        if ident is not None and not ident.allows("Admin"):
                            return self._error(
                                403,
                                "AccessDenied",
                                "catalog requires the Admin action",
                            )
                        if raw_path.startswith("/iceberg/v1/"):
                            return _tables.handle_iceberg(
                                self, srv.tables_catalog, raw_path
                            )
                        return _tables.handle_s3tables(
                            self, srv.tables_catalog
                        )
                    if bucket == "" and m == "POST":
                        # STS rides the service endpoint (form POST
                        # with Action=AssumeRole, reference weed/iamapi)
                        form = dict(
                            urllib.parse.parse_qsl(
                                self._read_body().decode("utf-8", "replace")
                            )
                        )
                        if form.get("Action") == "AssumeRole":
                            return self._sts_assume_role(ident, form)
                        from . import iamapi as _iam

                        if form.get("Action") in _iam.ACTIONS:
                            # embedded IAM API (reference weed/iamapi):
                            # credential management is an Admin surface
                            if self._anonymous or (
                                ident is not None
                                and not ident.allows("Admin")
                            ):
                                return self._error(
                                    403,
                                    "AccessDenied",
                                    "IAM requires the Admin action",
                                )
                            try:
                                body = _iam.execute(srv.filer.store, form)
                            except _iam.IamError as e:
                                return self._respond(
                                    e.code, _iam.error_xml(e)
                                )
                            return self._respond(200, body)
                        if (
                            form.get("Action")
                            == "AssumeRoleWithLdapIdentity"
                        ):
                            return self._sts_assume_role_ldap(form)
                        return self._error(405, "MethodNotAllowed", m)
                    err = self._authorize(ident, m, bucket, key, q)
                    if err is not None:
                        return self._error(403, "AccessDenied", err)
                    if bucket == "":
                        if m in ("GET", "HEAD"):
                            return self._list_buckets()
                        return self._error(405, "MethodNotAllowed", m)
                    if key == "":
                        return self._bucket_op(bucket, q)
                    return self._object_op(bucket, key, q)
                except sse.SseError as e:
                    code = {
                        "AccessDenied": 403,
                        "InternalError": 500,
                        "NotImplemented": 501,
                    }.get(e.code, 400)
                    return self._error(code, e.code, str(e))
                except S3AuthError as e:
                    # post-dispatch failures: chunk-signature errors are
                    # auth (403); malformed/truncated bodies are client
                    # errors (400, AWS semantics — SDKs treat 403 as a
                    # credential failure and won't retry)
                    code = (
                        400
                        if e.code
                        in (
                            "IncompleteBody",
                            "InvalidRequest",
                            "MalformedXML",
                            "InvalidArgument",
                        )
                        else 403
                    )
                    return self._error(code, e.code, str(e))
                except NotFound:
                    return self._error(404, "NoSuchKey", "not found")
                except FilerError as e:
                    return self._error(409, "OperationAborted", str(e))
                except (ValueError, ET.ParseError, binascii.Error) as e:
                    return self._error(400, "InvalidArgument", str(e))
                except BrokenPipeError:
                    pass
                finally:
                    # drain any unread body so HTTP/1.1 keep-alive
                    # connections stay in sync
                    try:
                        if not self._body_read:
                            n = int(self.headers.get("Content-Length", "0") or "0")
                            if n:
                                self.rfile.read(n)
                                self._body_read = True
                    except (OSError, ValueError):
                        pass

            do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = do_OPTIONS = _handle

            # ---- sts ----

            def _sts_assume_role_ldap(self, form: dict):
                """AssumeRoleWithLdapIdentity (reference weed/iam/ldap
                + sts AssumeRoleWithLdapIdentity): the LDAP bind IS the
                authentication, so no SigV4 identity is required. The
                role must trust "*" or "ldap:<username>"."""
                if srv.sts_service is None or srv.ldap is None:
                    return self._error(
                        400, "InvalidAction", "LDAP STS not configured"
                    )
                from ..iam.ldap import LdapError

                username = form.get("LdapUsername", "")
                try:
                    srv.ldap.authenticate(
                        username, form.get("LdapPassword", "")
                    )
                except LdapError as e:
                    return self._error(403, "AccessDenied", f"LDAP: {e}")
                role_name = (
                    form.get("RoleArn", "").rsplit("/", 1)[-1]
                    or form.get("RoleName", "")
                )
                try:
                    cred = srv.sts_service.assume_role(
                        f"ldap:{username}",
                        None,  # LDAP callers carry no IAM policies
                        role_name,
                        int(form.get("DurationSeconds", "3600") or "3600"),
                    )
                except PermissionError as e:
                    return self._error(403, "AccessDenied", str(e))
                except ValueError:
                    return self._error(
                        400, "InvalidParameterValue", "duration"
                    )
                root = ET.Element(
                    "AssumeRoleWithLdapIdentityResponse",
                    xmlns="https://sts.amazonaws.com/doc/2011-06-15/",
                )
                res = _el(root, "AssumeRoleWithLdapIdentityResult")
                c = _el(res, "Credentials")
                _el(c, "AccessKeyId", cred.access_key)
                _el(c, "SecretAccessKey", cred.secret_key)
                _el(c, "SessionToken", cred.session_token)
                _el(
                    c,
                    "Expiration",
                    time.strftime(
                        "%Y-%m-%dT%H:%M:%SZ",
                        time.gmtime(cred.expires_at),
                    ),
                )
                return self._respond(200, _xml(root))

            def _sts_assume_role(self, ident, form: dict):
                if srv.sts_service is None:
                    return self._error(400, "InvalidAction", "STS not configured")
                if ident is None and not srv.identities.empty:
                    return self._error(
                        403, "AccessDenied", "anonymous cannot assume roles"
                    )
                role_name = (
                    form.get("RoleArn", "").rsplit("/", 1)[-1]
                    or form.get("RoleName", "")
                )
                caller_key = ident.access_key if ident else "anonymous"
                caller_policies = (
                    list(ident.policies) if ident and ident.policies else None
                )
                if (
                    ident is not None
                    and not ident.policies
                    and not ident.allows("Admin")
                ):
                    return self._error(
                        403, "AccessDenied", "identity cannot assume roles"
                    )
                try:
                    cred = srv.sts_service.assume_role(
                        caller_key,
                        caller_policies,
                        role_name,
                        int(form.get("DurationSeconds", "3600") or "3600"),
                    )
                except PermissionError as e:
                    return self._error(403, "AccessDenied", str(e))
                except ValueError:
                    return self._error(400, "InvalidParameterValue", "duration")
                root = ET.Element(
                    "AssumeRoleResponse",
                    xmlns="https://sts.amazonaws.com/doc/2011-06-15/",
                )
                res = _el(root, "AssumeRoleResult")
                c = _el(res, "Credentials")
                _el(c, "AccessKeyId", cred.access_key)
                _el(c, "SecretAccessKey", cred.secret_key)
                _el(c, "SessionToken", cred.session_token)
                _el(
                    c,
                    "Expiration",
                    time.strftime(
                        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(cred.expires_at)
                    ),
                )
                u = _el(res, "AssumedRoleUser")
                _el(u, "Arn", cred.role.arn)
                _el(u, "AssumedRoleId", f"{cred.access_key}:{role_name}")
                self._respond(200, _xml(root))

            # ---- cors ----

            def _cors_rules(self, bucket: str) -> list[dict]:
                raw = srv.filer.store.kv_get(f"cors-rules/{bucket}".encode())
                if raw is None:
                    return []
                try:
                    return json.loads(raw)
                except ValueError:
                    return []

            def _match_cors(self, bucket: str, origin: str, method: str):
                for rule in self._cors_rules(bucket):
                    if method not in rule["methods"]:
                        continue
                    for o in rule["origins"]:
                        if o == "*" or o == origin:
                            return rule, o
                return None, None

            def _preflight(self, bucket: str):
                origin = self.headers.get("Origin", "")
                method = self.headers.get("Access-Control-Request-Method", "")
                rule, matched = self._match_cors(bucket, origin, method)
                if rule is None:
                    return self._error(403, "AccessForbidden", "CORSResponse")
                self._respond(
                    200,
                    extra={
                        "Access-Control-Allow-Origin": "*" if matched == "*" else origin,
                        "Access-Control-Allow-Methods": ", ".join(rule["methods"]),
                        "Access-Control-Allow-Headers": ", ".join(
                            rule["headers"]
                        )
                        or "*",
                        "Access-Control-Max-Age": "3600",
                    },
                )

            def _cors_response_headers(self, bucket: str) -> dict:
                origin = self.headers.get("Origin", "")
                if not origin:
                    return {}
                rule, matched = self._match_cors(bucket, origin, self.command)
                if rule is None:
                    return {}
                return {
                    "Access-Control-Allow-Origin": "*" if matched == "*" else origin,
                    "Vary": "Origin",
                }

            # ---- service ----

            def _list_buckets(self):
                root = ET.Element("ListAllMyBucketsResult", xmlns=XMLNS)
                owner = _el(root, "Owner")
                _el(owner, "ID", "seaweedfs_tpu")
                buckets = _el(root, "Buckets")
                try:
                    for e in srv.filer.list_entries(BUCKETS_ROOT, limit=10_000):
                        if not e.is_directory or e.name == UPLOADS_DIR:
                            continue
                        b = _el(buckets, "Bucket")
                        _el(b, "Name", e.name)
                        _el(b, "CreationDate", _iso(e.attr.crtime))
                except NotFound:
                    pass
                self._respond(200, _xml(root))

            # ---- bucket ----

            def _bucket_op(self, bucket: str, q: dict):
                path = f"{BUCKETS_ROOT}/{bucket}"
                m = self.command
                if m == "PUT" and "cors" in q:
                    if not srv.filer.exists(path):
                        return self._error(404, "NoSuchBucket", bucket)
                    body = self._read_body()
                    try:
                        doc = ET.fromstring(body)
                    except ET.ParseError:
                        return self._error(400, "MalformedXML", "cors config")
                    ns = _xml_ns(doc)
                    rules = []
                    for rule in doc.iter(f"{ns}CORSRule"):
                        rules.append(
                            {
                                "origins": [
                                    e.text or ""
                                    for e in rule.findall(f"{ns}AllowedOrigin")
                                ],
                                "methods": [
                                    e.text or ""
                                    for e in rule.findall(f"{ns}AllowedMethod")
                                ],
                                "headers": [
                                    e.text or ""
                                    for e in rule.findall(f"{ns}AllowedHeader")
                                ],
                            }
                        )
                    if not rules:
                        return self._error(400, "MalformedXML", "no CORSRule")
                    # parsed ONCE here; the hot read path loads JSON
                    srv.filer.store.kv_put(f"cors/{bucket}".encode(), body)
                    srv.filer.store.kv_put(
                        f"cors-rules/{bucket}".encode(),
                        json.dumps(rules).encode(),
                    )
                    return self._respond(200)
                if m == "DELETE" and "cors" in q:
                    srv.filer.store.kv_delete(f"cors/{bucket}".encode())
                    srv.filer.store.kv_delete(f"cors-rules/{bucket}".encode())
                    return self._respond(204)
                if m == "PUT" and "versioning" in q:
                    if not srv.filer.exists(path):
                        return self._error(404, "NoSuchBucket", bucket)
                    doc = ET.fromstring(self._read_body())
                    ns = _xml_ns(doc)
                    status = doc.findtext(f"{ns}Status") or ""
                    if status not in ("Enabled", "Suspended"):
                        return self._error(
                            400, "MalformedXML", f"bad Status {status!r}"
                        )
                    if status == "Suspended" and srv.lock_conf(bucket):
                        # AWS: object-lock buckets cannot suspend versioning
                        return self._error(
                            409,
                            "InvalidBucketState",
                            "object lock requires versioning",
                        )
                    srv.filer.store.kv_put(
                        f"versioning/{bucket}".encode(), status.encode()
                    )
                    return self._respond(200)
                if m == "PUT" and "object-lock" in q:
                    return self._put_object_lock_conf(bucket, path)
                if m == "PUT" and "lifecycle" in q:
                    return self._put_lifecycle(bucket, path)
                if "policy" in q or "policyStatus" in q:
                    return self._bucket_policy_op(bucket, path, q)
                if "encryption" in q:
                    return self._bucket_encryption_op(bucket, path)
                if "acl" in q:
                    return self._bucket_acl_op(bucket, path)
                if m == "DELETE" and "lifecycle" in q:
                    srv.filer.store.kv_delete(f"lifecycle/{bucket}".encode())
                    srv.filer.store.kv_delete(
                        f"lifecycle-rules/{bucket}".encode()
                    )
                    return self._respond(204)
                if m == "PUT":
                    # bucket names double as volume collections: enforce
                    # S3 naming up front so object uploads can't fail on
                    # the master's collection validation later
                    if not _BUCKET_RE.match(bucket):
                        return self._error(400, "InvalidBucketName", bucket)
                    if srv.filer.exists(path):
                        return self._error(
                            409, "BucketAlreadyExists", bucket
                        )
                    srv.filer.create_entry(
                        new_entry(path, is_directory=True, mode=0o755)
                    )
                    if (
                        self.headers.get(
                            "x-amz-bucket-object-lock-enabled", ""
                        ).lower()
                        == "true"
                    ):
                        # lock implies versioning (AWS invariant)
                        srv.filer.store.kv_put(
                            f"object-lock/{bucket}".encode(),
                            json.dumps({"Enabled": True}).encode(),
                        )
                        srv.filer.store.kv_put(
                            f"versioning/{bucket}".encode(), b"Enabled"
                        )
                    return self._respond(200, extra={"Location": "/" + bucket})
                if m == "HEAD":
                    if not srv.filer.exists(path):
                        return self._error(404, "NoSuchBucket", bucket)
                    return self._respond(200)
                if m == "DELETE":
                    if not srv.filer.exists(path):
                        return self._error(404, "NoSuchBucket", bucket)
                    children = list(srv.filer.list_entries(path, limit=2))
                    if children:
                        return self._error(409, "BucketNotEmpty", bucket)
                    srv.filer.delete_entry(path, recursive=True)
                    # a future bucket of the same name must not inherit
                    # this one's CORS/policy/ACL/encryption grants
                    srv.filer.store.kv_delete(f"cors/{bucket}".encode())
                    srv.filer.store.kv_delete(f"cors-rules/{bucket}".encode())
                    srv.filer.store.kv_delete(f"policy/{bucket}".encode())
                    srv.filer.store.kv_delete(f"acl/{bucket}".encode())
                    srv.filer.store.kv_delete(f"encryption/{bucket}".encode())
                    srv.filer.store.kv_delete(f"quota/{bucket}".encode())
                    srv.filer.store.kv_delete(
                        f"quota-exceeded/{bucket}".encode()
                    )
                    # fast space reclaim: drop the bucket's collection
                    # volumes cluster-wide (reference bucket=collection)
                    try:
                        srv.filer.ops.master.collection_delete(bucket)
                    except Exception:
                        pass
                    return self._respond(204)
                if m == "POST" and "delete" in q:
                    return self._delete_objects(bucket)
                if m == "GET":
                    if not srv.filer.exists(path):
                        return self._error(404, "NoSuchBucket", bucket)
                    if "location" in q:
                        root = ET.Element("LocationConstraint", xmlns=XMLNS)
                        root.text = srv.region
                        return self._respond(200, _xml(root))
                    if "cors" in q:
                        raw = srv.filer.store.kv_get(f"cors/{bucket}".encode())
                        if raw is None:
                            return self._error(
                                404, "NoSuchCORSConfiguration", bucket
                            )
                        return self._respond(200, raw)
                    if "versioning" in q:
                        root = ET.Element("VersioningConfiguration", xmlns=XMLNS)
                        state = srv.bucket_versioning(bucket)
                        if state:
                            _el(root, "Status", state)
                        return self._respond(200, _xml(root))
                    if "object-lock" in q:
                        return self._get_object_lock_conf(bucket)
                    if "lifecycle" in q:
                        raw = srv.filer.store.kv_get(
                            f"lifecycle/{bucket}".encode()
                        )
                        if raw is None:
                            return self._error(
                                404,
                                "NoSuchLifecycleConfiguration",
                                bucket,
                            )
                        return self._respond(200, raw)
                    if "versions" in q:
                        return self._list_object_versions(bucket, q)
                    if "uploads" in q:
                        return self._list_uploads(bucket)
                    return self._list_objects(bucket, q)
                return self._error(405, "MethodNotAllowed", m)

            def _list_objects(self, bucket: str, q: dict):
                prefix = q.get("prefix", "")
                delimiter = q.get("delimiter", "")
                v2 = q.get("list-type") == "2"
                max_keys = min(int(q.get("max-keys", "1000") or "1000"), 1000)
                token = (
                    q.get("continuation-token") or q.get("start-after") or ""
                    if v2
                    else q.get("marker", "")
                )
                if v2 and q.get("continuation-token"):
                    token = base64.urlsafe_b64decode(
                        q["continuation-token"].encode()
                    ).decode()

                contents, common, truncated, next_token = srv._walk_keys(
                    bucket, prefix, delimiter, token, max_keys
                )
                root = ET.Element("ListBucketResult", xmlns=XMLNS)
                _el(root, "Name", bucket)
                _el(root, "Prefix", prefix)
                if delimiter:
                    _el(root, "Delimiter", delimiter)
                _el(root, "MaxKeys", max_keys)
                _el(root, "KeyCount", len(contents) + len(common))
                _el(root, "IsTruncated", "true" if truncated else "false")
                if v2 and truncated:
                    _el(
                        root,
                        "NextContinuationToken",
                        base64.urlsafe_b64encode(next_token.encode()).decode(),
                    )
                elif not v2:
                    _el(root, "Marker", q.get("marker", ""))
                    if truncated:
                        _el(root, "NextMarker", next_token)
                for key, entry in contents:
                    c = _el(root, "Contents")
                    _el(c, "Key", key)
                    _el(c, "LastModified", _iso(entry.attr.mtime))
                    _el(c, "ETag", f'"{_entry_etag(entry)}"')
                    _el(c, "Size", entry.file_size)
                    _el(c, "StorageClass", "STANDARD")
                for p in sorted(common):
                    cp = _el(root, "CommonPrefixes")
                    _el(cp, "Prefix", p)
                self._respond(200, _xml(root))

            def _delete_objects(self, bucket: str):
                body = self._read_body()
                doc = ET.fromstring(body)
                ns = _xml_ns(doc)
                quiet = (doc.findtext(f"{ns}Quiet") or "").lower() == "true"
                root = ET.Element("DeleteResult", xmlns=XMLNS)
                state = srv.bucket_versioning(bucket)
                bypass = (
                    self.headers.get(
                        "x-amz-bypass-governance-retention", ""
                    ).lower()
                    == "true"
                )
                for obj in doc.findall(f"{ns}Object"):
                    key = obj.findtext(f"{ns}Key") or ""
                    vid_param = obj.findtext(f"{ns}VersionId") or ""
                    path = normalize_path(f"{BUCKETS_ROOT}/{bucket}/{key}")
                    try:
                        marker_vid = ""
                        if vid_param:
                            try:
                                cur = srv.filer.find_entry(path)
                            except NotFound:
                                cur = None
                            if (
                                cur is not None
                                and not cur.is_directory
                                and entry_vid(cur) == vid_param
                            ):
                                check_deletable(cur, bypass)
                                srv.filer.delete_entry(path, gc_chunks=True)
                                promote_latest(
                                    srv.filer, BUCKETS_ROOT, bucket, key
                                )
                            else:
                                vpath = f"{versions_dir(BUCKETS_ROOT, bucket, key)}/{vid_param}"
                                try:
                                    ve = srv.filer.find_entry(vpath)
                                    check_deletable(ve, bypass)
                                    srv.filer.delete_entry(
                                        vpath, gc_chunks=True
                                    )
                                except NotFound:
                                    pass
                        elif state:
                            marker_vid = vtag.write_delete_marker(
                                srv.filer, BUCKETS_ROOT, bucket, key, state
                            )
                        else:
                            srv.filer.delete_entry(path, recursive=True)
                        if not quiet:
                            d = _el(root, "Deleted")
                            _el(d, "Key", key)
                            if vid_param:
                                _el(d, "VersionId", vid_param)
                            if marker_vid:
                                _el(d, "DeleteMarker", "true")
                                _el(d, "DeleteMarkerVersionId", marker_vid)
                    except LockViolation as e:
                        er = _el(root, "Error")
                        _el(er, "Key", key)
                        _el(er, "Code", "AccessDenied")
                        _el(er, "Message", str(e))
                    except FilerError as e:
                        er = _el(root, "Error")
                        _el(er, "Key", key)
                        _el(er, "Code", "InternalError")
                        _el(er, "Message", str(e))
                self._respond(200, _xml(root))

            # ---- object lock / lifecycle / versions (bucket level) ----

            def _put_object_lock_conf(self, bucket: str, path: str):
                if not srv.filer.exists(path):
                    return self._error(404, "NoSuchBucket", bucket)
                doc = ET.fromstring(self._read_body())
                ns = _xml_ns(doc)
                if (doc.findtext(f"{ns}ObjectLockEnabled") or "") != "Enabled":
                    return self._error(
                        400, "MalformedXML", "ObjectLockEnabled must be Enabled"
                    )
                conf: dict = {"Enabled": True}
                dr = doc.find(f"{ns}Rule/{ns}DefaultRetention")
                if dr is not None:
                    conf["DefaultRetention"] = {
                        "Mode": dr.findtext(f"{ns}Mode") or "GOVERNANCE",
                        "Days": int(dr.findtext(f"{ns}Days") or "0"),
                        "Years": int(dr.findtext(f"{ns}Years") or "0"),
                    }
                srv.filer.store.kv_put(
                    f"object-lock/{bucket}".encode(), json.dumps(conf).encode()
                )
                # lock requires versioning on
                srv.filer.store.kv_put(
                    f"versioning/{bucket}".encode(), b"Enabled"
                )
                return self._respond(200)

            def _get_object_lock_conf(self, bucket: str):
                conf = srv.lock_conf(bucket)
                if conf is None:
                    return self._error(
                        404,
                        "ObjectLockConfigurationNotFoundError",
                        bucket,
                    )
                root = ET.Element("ObjectLockConfiguration", xmlns=XMLNS)
                _el(root, "ObjectLockEnabled", "Enabled")
                dr = conf.get("DefaultRetention")
                if dr:
                    rule = _el(root, "Rule")
                    drel = _el(rule, "DefaultRetention")
                    _el(drel, "Mode", dr.get("Mode", "GOVERNANCE"))
                    if dr.get("Days"):
                        _el(drel, "Days", dr["Days"])
                    if dr.get("Years"):
                        _el(drel, "Years", dr["Years"])
                return self._respond(200, _xml(root))

            def _put_lifecycle(self, bucket: str, path: str):
                from .lifecycle import parse_lifecycle_xml

                if not srv.filer.exists(path):
                    return self._error(404, "NoSuchBucket", bucket)
                body = self._read_body()
                try:
                    rules = parse_lifecycle_xml(body)
                except ValueError as e:
                    return self._error(400, "MalformedXML", str(e))
                if not rules:
                    return self._error(400, "MalformedXML", "no Rule")
                srv.filer.store.kv_put(f"lifecycle/{bucket}".encode(), body)
                srv.filer.store.kv_put(
                    f"lifecycle-rules/{bucket}".encode(),
                    json.dumps(rules).encode(),
                )
                return self._respond(200)

            # ---- bucket policy / encryption / acl subresources ----

            def _bucket_policy_op(self, bucket: str, path: str, q: dict):
                if not srv.filer.exists(path):
                    return self._error(404, "NoSuchBucket", bucket)
                m = self.command
                kv_key = f"policy/{bucket}".encode()
                from ..iam.policy import (
                    PolicyError,
                    bucket_policy_is_public,
                    validate_bucket_policy,
                )

                if m == "GET" and "policyStatus" in q:
                    doc = srv.bucket_policy(bucket)
                    if doc is None:
                        return self._error(
                            404, "NoSuchBucketPolicy", bucket
                        )
                    root = ET.Element("PolicyStatus", xmlns=XMLNS)
                    _el(
                        root,
                        "IsPublic",
                        "true" if bucket_policy_is_public(doc) else "false",
                    )
                    return self._respond(200, _xml(root))
                if m == "GET":
                    raw = srv.filer.store.kv_get(kv_key)
                    if raw is None:
                        return self._error(404, "NoSuchBucketPolicy", bucket)
                    return self._respond(200, raw, ctype="application/json")
                if m == "PUT":
                    body = self._read_body()
                    try:
                        doc = json.loads(body)
                        validate_bucket_policy(doc, bucket)
                    except json.JSONDecodeError:
                        return self._error(
                            400, "MalformedPolicy", "policy is not JSON"
                        )
                    except PolicyError as e:
                        return self._error(400, "MalformedPolicy", str(e))
                    srv.filer.store.kv_put(kv_key, body)
                    return self._respond(204)
                if m == "DELETE":
                    srv.filer.store.kv_delete(kv_key)
                    return self._respond(204)
                return self._error(405, "MethodNotAllowed", m)

            def _bucket_encryption_op(self, bucket: str, path: str):
                if not srv.filer.exists(path):
                    return self._error(404, "NoSuchBucket", bucket)
                m = self.command
                kv_key = f"encryption/{bucket}".encode()
                if m == "GET":
                    algo = srv.bucket_default_encryption(bucket)
                    if not algo:
                        return self._error(
                            404,
                            "ServerSideEncryptionConfigurationNotFoundError",
                            bucket,
                        )
                    root = ET.Element(
                        "ServerSideEncryptionConfiguration", xmlns=XMLNS
                    )
                    rule = ET.SubElement(root, "Rule")
                    dflt = ET.SubElement(
                        rule, "ApplyServerSideEncryptionByDefault"
                    )
                    _el(dflt, "SSEAlgorithm", algo)
                    return self._respond(200, _xml(root))
                if m == "PUT":
                    try:
                        doc = ET.fromstring(self._read_body())
                    except ET.ParseError:
                        return self._error(400, "MalformedXML", "encryption config")
                    ns = _xml_ns(doc)
                    algo = doc.findtext(
                        f".//{ns}ApplyServerSideEncryptionByDefault/{ns}SSEAlgorithm"
                    ) or doc.findtext(f".//{ns}SSEAlgorithm")
                    if algo == "aws:kms":
                        return self._error(
                            501,
                            "NotImplemented",
                            "aws:kms requires an external KMS provider",
                        )
                    if algo != "AES256":
                        return self._error(
                            400, "MalformedXML", f"bad SSEAlgorithm {algo!r}"
                        )
                    srv.filer.store.kv_put(kv_key, b"AES256")
                    return self._respond(200)
                if m == "DELETE":
                    srv.filer.store.kv_delete(kv_key)
                    return self._respond(204)
                return self._error(405, "MethodNotAllowed", m)

            _CANNED_ACLS = (
                "private",
                "public-read",
                "public-read-write",
                "authenticated-read",
                "bucket-owner-read",
                "bucket-owner-full-control",
            )

            def _validate_canned_acl(self, acl: str) -> str:
                if acl not in self._CANNED_ACLS:
                    raise S3AuthError(
                        "InvalidArgument", f"unknown canned acl {acl!r}"
                    )
                return acl

            def _canned_acl_header(self) -> str | None:
                """Validated x-amz-acl request header (None if absent)."""
                acl = self.headers.get("x-amz-acl", "")
                return self._validate_canned_acl(acl) if acl else None

            def _acl_xml(self, acl: str) -> bytes:
                root = ET.Element("AccessControlPolicy", xmlns=XMLNS)
                owner = ET.SubElement(root, "Owner")
                _el(owner, "ID", "seaweedfs")
                grants = ET.SubElement(root, "AccessControlList")

                def grant(grantee_uri: str | None, perm: str):
                    g = ET.SubElement(grants, "Grant")
                    ge = ET.SubElement(g, "Grantee")
                    ge.set(
                        "{http://www.w3.org/2001/XMLSchema-instance}type",
                        "Group" if grantee_uri else "CanonicalUser",
                    )
                    if grantee_uri:
                        _el(ge, "URI", grantee_uri)
                    else:
                        _el(ge, "ID", "seaweedfs")
                    _el(g, "Permission", perm)

                grant(None, "FULL_CONTROL")
                AU = "http://acs.amazonaws.com/groups/global/AllUsers"
                if acl in ("public-read", "public-read-write"):
                    grant(AU, "READ")
                if acl == "public-read-write":
                    grant(AU, "WRITE")
                if acl == "authenticated-read":
                    grant(
                        "http://acs.amazonaws.com/groups/global/AuthenticatedUsers",
                        "READ",
                    )
                return _xml(root)

            def _bucket_acl_op(self, bucket: str, path: str):
                if not srv.filer.exists(path):
                    return self._error(404, "NoSuchBucket", bucket)
                m = self.command
                if m == "GET":
                    return self._respond(200, self._acl_xml(srv.bucket_acl(bucket)))
                if m == "PUT":
                    acl = self._canned_acl_header() or "private"
                    srv.filer.store.kv_put(f"acl/{bucket}".encode(), acl.encode())
                    return self._respond(200)
                return self._error(405, "MethodNotAllowed", m)

            def _object_acl_op(self, bucket: str, key: str, path: str):
                try:
                    entry = srv.filer.find_entry(path)
                except NotFound:
                    return self._error(404, "NoSuchKey", key)
                m = self.command
                if m == "GET":
                    acl = (entry.extended.get("s3-acl") or b"private").decode()
                    return self._respond(200, self._acl_xml(acl))
                if m == "PUT":
                    acl = self._canned_acl_header() or "private"
                    srv.filer.mutate_entry(
                        path,
                        lambda e: e.extended.update({"s3-acl": acl.encode()}),
                    )
                    return self._respond(200)
                return self._error(405, "MethodNotAllowed", m)

            # ---- POST-policy browser uploads ----

            def _post_policy_upload(self, bucket: str):
                if not srv.filer.exists(f"{BUCKETS_ROOT}/{bucket}"):
                    return self._error(404, "NoSuchBucket", bucket)
                body = self._read_body()
                ident = None
                try:
                    fields, file_bytes, filename = ppol.parse_multipart_form(
                        body, self.headers.get("Content-Type", "")
                    )
                    key = fields.get("key", "")
                    if not key:
                        return self._error(
                            400, "InvalidArgument", "POST form missing key"
                        )
                    key = key.replace("${filename}", filename)
                    if not srv.identities.empty:
                        ident = ppol.verify_post_signature(
                            srv.identities, fields, srv.region
                        )
                        ppol.check_policy_document(
                            fields, len(file_bytes), bucket, key
                        )
                    elif srv.oidc is not None:
                        # Mirror _auth: an OIDC-only deployment (empty
                        # SigV4 store) must NOT mean open mode — an
                        # unsigned POST-policy form is ANONYMOUS, so
                        # only a bucket-policy/ACL grant can allow it.
                        self._anonymous = True
                except S3AuthError as e:
                    code = 403 if e.code in (
                        "AccessDenied",
                        "SignatureDoesNotMatch",
                        "InvalidAccessKeyId",
                    ) else 400
                    return self._error(code, e.code, str(e))
                # Authentication is not authorization: the signer must
                # also be ALLOWED to put this object (identity policies
                # + bucket policy; a self-signed form from a read-only
                # credential must not write).
                err = self._authorize(ident, "PUT", bucket, key, {})
                if err is not None:
                    return self._error(403, "AccessDenied", err)
                if srv.quota_exceeded(bucket):
                    return self._error(
                        403,
                        "QuotaExceeded",
                        f"bucket {bucket} is over its storage quota",
                    )
                # SSE: explicit form header fields are not standard;
                # bucket default encryption still applies
                sse_algo = srv.bucket_default_encryption(bucket)
                data, sse_ext, sse_hdrs = sse.encrypt_for_put(
                    file_bytes, None, sse_algo, srv.sse_keyring
                )
                ext = dict(sse_ext)
                acl = fields.get("acl", "")
                if acl:
                    self._validate_canned_acl(acl)
                    ext["s3-acl"] = acl.encode()
                entry, vid = srv.put_object(
                    bucket,
                    key,
                    data,
                    mime=fields.get("content-type", "")
                    or "application/octet-stream",
                    extra_extended=ext,
                )
                status = int(fields.get("success_action_status", "204") or 204)
                if status not in (200, 201, 204):
                    status = 204
                extra = {"ETag": f'"{entry.attr.md5.hex()}"', **sse_hdrs}
                if vid:
                    extra["x-amz-version-id"] = vid
                if status == 201:
                    root = ET.Element("PostResponse")
                    _el(root, "Bucket", bucket)
                    _el(root, "Key", key)
                    _el(root, "ETag", f'"{entry.attr.md5.hex()}"')
                    return self._respond(201, _xml(root), extra=extra)
                return self._respond(status, extra=extra)

            def _list_object_versions(self, bucket: str, q: dict):
                prefix = q.get("prefix", "")
                max_keys = min(int(q.get("max-keys", "1000") or "1000"), 1000)
                contents, _, key_truncated, _ = srv._walk_keys(
                    bucket, prefix, "", q.get("key-marker", ""), max_keys,
                    include_markers=True,
                )
                root = ET.Element("ListVersionsResult", xmlns=XMLNS)
                _el(root, "Name", bucket)
                _el(root, "Prefix", prefix)
                _el(root, "MaxKeys", max_keys)

                elements: list = []

                def emit(key, entry, latest: bool):
                    tag = (
                        "DeleteMarker" if is_delete_marker(entry) else "Version"
                    )
                    el = ET.Element(tag)
                    _el(el, "Key", key)
                    _el(el, "VersionId", entry_vid(entry))
                    _el(el, "IsLatest", "true" if latest else "false")
                    _el(el, "LastModified", _iso(entry.attr.mtime))
                    if tag == "Version":
                        _el(el, "ETag", f'"{_entry_etag(entry)}"')
                        _el(el, "Size", entry.file_size)
                        _el(el, "StorageClass", "STANDARD")
                    elements.append(el)

                # resume granularity is the key: emit whole keys until
                # the version budget is spent, then signal truncation
                truncated = key_truncated
                next_marker = ""
                for key, entry in contents:
                    if len(elements) >= max_keys:
                        truncated = True
                        break
                    emit(key, entry, True)
                    for v in iter_versions(
                        srv.filer, BUCKETS_ROOT, bucket, key
                    ):
                        emit(key, v, False)
                    next_marker = key
                _el(root, "IsTruncated", "true" if truncated else "false")
                if truncated and next_marker:
                    _el(root, "NextKeyMarker", next_marker)
                root.extend(elements)
                self._respond(200, _xml(root))

            # ---- object ----

            def _put_object_body(self, bucket: str, key: str):
                """The shared plain-PUT body (copy, SSE, ACL, store);
                callers have already evaluated quotas/preconditions."""
                src = self.headers.get("x-amz-copy-source", "")
                if src:
                    return self._copy_object(bucket, key, src)
                data = self._read_body()
                ext = self._lock_headers_extended(bucket)
                # server-side encryption: explicit SSE-C / SSE-S3
                # headers, else the bucket's default configuration
                ssec_key, sse_algo = sse.resolve_put_encryption(
                    self.headers, srv.bucket_default_encryption(bucket)
                )
                data, sse_ext, sse_hdrs = sse.encrypt_for_put(
                    data, ssec_key, sse_algo, srv.sse_keyring
                )
                ext.update(sse_ext)
                acl = self._canned_acl_header()
                if acl:
                    ext["s3-acl"] = acl.encode()
                entry, vid = srv.put_object(
                    bucket,
                    key,
                    data,
                    mime=self.headers.get("Content-Type", "")
                    or "application/octet-stream",
                    extra_extended=ext,
                )
                etag = entry.attr.md5.hex()
                extra = {"ETag": f'"{etag}"', **sse_hdrs}
                if vid:
                    extra["x-amz-version-id"] = vid
                return self._respond(200, extra=extra)

            def _object_op(self, bucket: str, key: str, q: dict):
                bpath = f"{BUCKETS_ROOT}/{bucket}"
                if not srv.filer.exists(bpath):
                    return self._error(404, "NoSuchBucket", bucket)
                path = normalize_path(f"{bpath}/{key}")
                m = self.command
                if m == "POST" and "uploads" in q:
                    return self._initiate_multipart(bucket, key)
                if m == "PUT" and "partNumber" in q and "uploadId" in q:
                    return self._upload_part(bucket, key, q)
                if m == "POST" and "uploadId" in q:
                    return self._complete_multipart(bucket, key, q)
                if m == "DELETE" and "uploadId" in q:
                    return self._abort_multipart(bucket, key, q)
                if m == "GET" and "uploadId" in q:
                    return self._list_parts(bucket, key, q)

                if m == "POST" and "select" in q:
                    return self._later("19", "S3 Select")
                if "tagging" in q:
                    return self._object_tagging(bucket, key, path)
                if "retention" in q:
                    return self._object_retention(bucket, key, path, q)
                if "legal-hold" in q:
                    return self._object_legal_hold(bucket, key, path, q)
                if "acl" in q:
                    return self._object_acl_op(bucket, key, path)

                if m == "PUT":
                    if srv.quota_exceeded(bucket):
                        return self._error(
                            403,
                            "QuotaExceeded",
                            f"bucket {bucket} is over its storage quota",
                        )
                    # AWS conditional writes: If-None-Match: * =
                    # create-only; If-Match: <etag> = compare-and-swap.
                    # The precondition and the write hold one lock so
                    # two racing CAS PUTs can never both pass the check
                    # (check-then-act would lose an update silently).
                    inm = self.headers.get("If-None-Match", "")
                    im = self.headers.get("If-Match", "")
                    if inm and inm != "*":
                        # AWS: conditional writes only support '*'
                        return self._error(
                            501,
                            "NotImplemented",
                            "If-None-Match only supports *",
                        )
                    with srv.put_lock(path):
                        if inm or im:
                            try:
                                cur = srv.filer.find_entry(path)
                            except NotFound:
                                cur = None
                            if cur is not None and (
                                cur.is_directory
                                or vtag.is_delete_marker(cur)
                            ):
                                # logically absent: a delete marker or
                                # a directory placeholder is NOT an
                                # object (AWS create-only PUT succeeds
                                # over a deleted key)
                                cur = None
                            if inm == "*" and cur is not None:
                                return self._error(
                                    412,
                                    "PreconditionFailed",
                                    "object already exists "
                                    "(If-None-Match: *)",
                                )
                            if im:
                                cur_etag = (
                                    _entry_etag(cur)
                                    if cur is not None
                                    else ""
                                )
                                if not cur_etag or not _etag_cond_match(
                                    im, cur_etag
                                ):
                                    return self._error(
                                        412,
                                        "PreconditionFailed",
                                        "ETag mismatch (If-Match)",
                                    )
                        return self._put_object_body(bucket, key)
                if m in ("GET", "HEAD"):
                    vid_param = q.get("versionId", "")
                    entry = self._resolve_version(bucket, key, path, vid_param)
                    if entry is None:
                        return  # _resolve_version responded
                    # SSE: resolve the data key BEFORE emitting any
                    # bytes (fail closed — never serve ciphertext), and
                    # advertise the object's encryption in the response.
                    sse_data_key = sse.decrypt_key_for_entry(
                        entry,
                        sse.parse_customer_headers(self.headers),
                        srv.sse_keyring,
                    )
                    total = entry.file_size
                    headers = {
                        **sse.response_headers_for_entry(entry),
                        **self._cors_response_headers(bucket),
                        "ETag": f'"{_entry_etag(entry)}"',
                        "Last-Modified": time.strftime(
                            "%a, %d %b %Y %H:%M:%S GMT",
                            time.gmtime(entry.attr.mtime),
                        ),
                        "Accept-Ranges": "bytes",
                    }
                    if srv.bucket_versioning(bucket):
                        headers["x-amz-version-id"] = entry_vid(entry)
                    mode, until = vtag.get_retention(entry)
                    if mode:
                        headers["x-amz-object-lock-mode"] = mode
                        headers["x-amz-object-lock-retain-until-date"] = (
                            until.isoformat()
                        )
                    ctype = entry.attr.mime or "application/octet-stream"
                    # conditional reads (RFC 9110 semantics, the subset
                    # S3 documents): If-(None-)Match on the ETag,
                    # If-(Un)Modified-Since on Last-Modified
                    etag_now = _entry_etag(entry)
                    inm = self.headers.get("If-None-Match", "")
                    ims_ts = _http_date(
                        self.headers.get("If-Modified-Since", "")
                    )
                    if (inm and _etag_cond_match(inm, etag_now)) or (
                        not inm
                        and ims_ts is not None
                        and entry.attr.mtime <= ims_ts
                    ):
                        self.send_response(304)
                        for hk, hv in headers.items():
                            self.send_header(hk, hv)
                        self.end_headers()
                        return
                    imatch = self.headers.get("If-Match", "")
                    ius_ts = _http_date(
                        self.headers.get("If-Unmodified-Since", "")
                    )
                    if (
                        imatch and not _etag_cond_match(imatch, etag_now)
                    ) or (
                        not imatch
                        and ius_ts is not None
                        and entry.attr.mtime > ius_ts
                    ):
                        return self._error(
                            412, "PreconditionFailed", "precondition failed"
                        )
                    if m == "HEAD":
                        self.send_response(200)
                        for k, v in headers.items():
                            self.send_header(k, v)
                        self.send_header("Content-Type", ctype)
                        self.send_header("Content-Length", str(total))
                        self.end_headers()
                        return
                    rng = self.headers.get("Range", "")
                    offset, size, status = 0, -1, 200
                    if rng.startswith("bytes="):
                        try:
                            lo_s, _, hi_s = rng[6:].split(",")[0].partition("-")
                            lo = int(lo_s) if lo_s else max(total - int(hi_s), 0)
                            hi = int(hi_s) if hi_s and lo_s else total - 1
                            if lo > hi or lo >= max(total, 1):
                                return self._respond(
                                    416,
                                    extra={"Content-Range": f"bytes */{total}"},
                                )
                            offset, size, status = lo, hi - lo + 1, 206
                            headers["Content-Range"] = (
                                f"bytes {lo}-{min(hi, total - 1)}/{total}"
                            )
                        except ValueError:
                            pass
                    if sse_data_key is None:
                        data = srv.filer.read_entry(entry, offset, size)
                    else:
                        # unified CTR seek: single-IV objects and
                        # multipart part-maps (per-part streams)
                        data = sse.read_decrypted(
                            lambda o, n: srv.filer.read_entry(entry, o, n),
                            entry,
                            sse_data_key,
                            offset,
                            size,
                        )
                    return self._respond(status, data, ctype, headers)
                if m == "DELETE":
                    # same stripe as writes: a DELETE racing an
                    # If-Match PUT must not resurrect/lose either side
                    with srv.put_lock(path):
                        return self._delete_object(bucket, key, path, q)
                return self._error(405, "MethodNotAllowed", m)

            def _lock_headers_extended(self, bucket: str) -> dict:
                """x-amz-object-lock-* request headers → extended attrs.

                AWS rejects lock headers on buckets without an object
                lock configuration (otherwise a bogus COMPLIANCE lock
                could be stored with no API path to ever clear it)."""
                mode = self.headers.get("x-amz-object-lock-mode", "")
                until = self.headers.get(
                    "x-amz-object-lock-retain-until-date", ""
                )
                hold = self.headers.get("x-amz-object-lock-legal-hold", "")
                if not (mode or until or hold):
                    return {}
                if srv.lock_conf(bucket) is None:
                    raise S3AuthError(
                        "InvalidRequest",
                        "bucket has no object lock configuration",
                    )
                ext: dict = {}
                if mode or until:
                    if mode not in ("GOVERNANCE", "COMPLIANCE") or not until:
                        raise S3AuthError(
                            "InvalidRequest", "malformed object-lock headers"
                        )
                    from datetime import datetime as _dt

                    try:
                        _dt.fromisoformat(until.replace("Z", "+00:00"))
                    except ValueError:
                        raise S3AuthError(
                            "InvalidRequest", "bad retain-until date"
                        ) from None
                    ext[vtag.RETENTION_KEY] = json.dumps(
                        {"Mode": mode, "RetainUntilDate": until}
                    ).encode()
                if hold:
                    if hold not in ("ON", "OFF"):
                        raise S3AuthError(
                            "InvalidRequest", "bad legal hold status"
                        )
                    ext[vtag.LEGAL_HOLD_KEY] = hold.encode()
                return ext

            def _resolve_version(
                self, bucket: str, key: str, path: str, vid_param: str
            ):
                """Entry for GET/HEAD honoring ?versionId; responds with
                the right error itself and returns None on failure."""
                if not vid_param:
                    entry = srv.filer.find_entry(path)
                    if entry.is_directory:
                        self._error(404, "NoSuchKey", key)
                        return None
                    if is_delete_marker(entry):
                        self._respond_marker_error(404, "NoSuchKey", key, entry)
                        return None
                    return entry
                try:
                    cur = srv.filer.find_entry(path)
                    if not cur.is_directory and entry_vid(cur) == vid_param:
                        entry = cur
                    else:
                        raise NotFound(key)
                except NotFound:
                    try:
                        entry = srv.filer.find_entry(
                            f"{versions_dir(BUCKETS_ROOT, bucket, key)}/{vid_param}"
                        )
                    except NotFound:
                        self._error(404, "NoSuchVersion", vid_param)
                        return None
                if is_delete_marker(entry):
                    # AWS: GET on a delete-marker version is 405
                    self._respond_marker_error(
                        405, "MethodNotAllowed", key, entry
                    )
                    return None
                return entry

            def _respond_marker_error(self, code, s3code, key, entry):
                root = ET.Element("Error")
                _el(root, "Code", s3code)
                _el(root, "Message", "delete marker")
                _el(root, "Resource", key)
                self._respond(
                    code,
                    _xml(root),
                    extra={
                        "x-amz-delete-marker": "true",
                        "x-amz-version-id": entry_vid(entry),
                    },
                )

            def _delete_object(self, bucket: str, key: str, path: str, q: dict):
                state = srv.bucket_versioning(bucket)
                vid_param = q.get("versionId", "")
                bypass = (
                    self.headers.get(
                        "x-amz-bypass-governance-retention", ""
                    ).lower()
                    == "true"
                )
                if vid_param:
                    # permanent deletion of one version — lock-checked
                    try:
                        cur = srv.filer.find_entry(path)
                    except NotFound:
                        cur = None
                    try:
                        if (
                            cur is not None
                            and not cur.is_directory
                            and entry_vid(cur) == vid_param
                        ):
                            check_deletable(cur, bypass)
                            srv.filer.delete_entry(path, gc_chunks=True)
                            promote_latest(srv.filer, BUCKETS_ROOT, bucket, key)
                        else:
                            vpath = f"{versions_dir(BUCKETS_ROOT, bucket, key)}/{vid_param}"
                            ve = srv.filer.find_entry(vpath)
                            check_deletable(ve, bypass)
                            srv.filer.delete_entry(vpath, gc_chunks=True)
                    except LockViolation as e:
                        return self._error(403, "AccessDenied", str(e))
                    except NotFound:
                        pass  # deleting a missing version succeeds (AWS)
                    return self._respond(
                        204, extra={"x-amz-version-id": vid_param}
                    )
                if state:
                    # versioned simple DELETE: add a delete marker
                    vid = vtag.write_delete_marker(
                        srv.filer, BUCKETS_ROOT, bucket, key, state
                    )
                    return self._respond(
                        204,
                        extra={
                            "x-amz-delete-marker": "true",
                            "x-amz-version-id": vid,
                        },
                    )
                srv.filer.delete_entry(path, recursive=False, gc_chunks=True)
                return self._respond(204)

            def _object_retention(self, bucket, key, path, q: dict):
                target = self._resolve_version(
                    bucket, key, path, q.get("versionId", "")
                )
                if target is None:
                    return
                m = self.command
                if m == "GET":
                    mode, until = vtag.get_retention(target)
                    if not mode:
                        return self._error(
                            404,
                            "NoSuchObjectLockConfiguration",
                            key,
                        )
                    root = ET.Element("Retention", xmlns=XMLNS)
                    _el(root, "Mode", mode)
                    _el(root, "RetainUntilDate", until.isoformat())
                    return self._respond(200, _xml(root))
                if m == "PUT":
                    if srv.lock_conf(bucket) is None:
                        return self._error(
                            400,
                            "InvalidRequest",
                            "bucket has no object lock configuration",
                        )
                    doc = ET.fromstring(self._read_body())
                    ns = _xml_ns(doc)
                    mode = doc.findtext(f"{ns}Mode") or ""
                    until_s = doc.findtext(f"{ns}RetainUntilDate") or ""
                    if mode not in ("GOVERNANCE", "COMPLIANCE") or not until_s:
                        return self._error(400, "MalformedXML", "retention")
                    from datetime import datetime as _dt

                    new_until = _dt.fromisoformat(
                        until_s.replace("Z", "+00:00")
                    )
                    old_mode, old_until = vtag.get_retention(target)
                    bypass = (
                        self.headers.get(
                            "x-amz-bypass-governance-retention", ""
                        ).lower()
                        == "true"
                    )
                    # weakening an active lock needs bypass (GOVERNANCE)
                    # and is never allowed for COMPLIANCE
                    if old_mode and old_until and new_until < old_until:
                        if old_mode == "COMPLIANCE" or not bypass:
                            return self._error(
                                403,
                                "AccessDenied",
                                "cannot shorten active retention",
                            )
                    srv.filer.mutate_entry(
                        target.full_path,
                        lambda e: e.extended.__setitem__(
                            vtag.RETENTION_KEY,
                            json.dumps(
                                {
                                    "Mode": mode,
                                    "RetainUntilDate": new_until.isoformat(),
                                }
                            ).encode(),
                        ),
                    )
                    return self._respond(200)
                return self._error(405, "MethodNotAllowed", m)

            def _object_legal_hold(self, bucket, key, path, q: dict):
                target = self._resolve_version(
                    bucket, key, path, q.get("versionId", "")
                )
                if target is None:
                    return
                m = self.command
                if m == "GET":
                    root = ET.Element("LegalHold", xmlns=XMLNS)
                    _el(root, "Status", vtag.legal_hold(target))
                    return self._respond(200, _xml(root))
                if m == "PUT":
                    if srv.lock_conf(bucket) is None:
                        return self._error(
                            400,
                            "InvalidRequest",
                            "bucket has no object lock configuration",
                        )
                    doc = ET.fromstring(self._read_body())
                    ns = _xml_ns(doc)
                    status = doc.findtext(f"{ns}Status") or ""
                    if status not in ("ON", "OFF"):
                        return self._error(400, "MalformedXML", "legal hold")
                    srv.filer.mutate_entry(
                        target.full_path,
                        lambda e: e.extended.__setitem__(
                            vtag.LEGAL_HOLD_KEY, status.encode()
                        ),
                    )
                    return self._respond(200)
                return self._error(405, "MethodNotAllowed", m)

            def _object_tagging(self, bucket: str, key: str, path: str):
                """Get/Put/DeleteObjectTagging: tags ride the entry's
                extended attributes (reference s3api tagging handlers)."""
                entry = srv.filer.find_entry(path)
                if entry.is_directory:
                    return self._error(404, "NoSuchKey", key)
                m = self.command
                if m == "GET":
                    root = ET.Element("Tagging", xmlns=XMLNS)
                    tagset = _el(root, "TagSet")
                    raw = entry.extended.get("s3-tags", b"{}")
                    for k2, v2 in sorted(json.loads(raw).items()):
                        t = _el(tagset, "Tag")
                        _el(t, "Key", k2)
                        _el(t, "Value", v2)
                    return self._respond(200, _xml(root))
                if m == "PUT":
                    doc = ET.fromstring(self._read_body())
                    ns = _xml_ns(doc)
                    tags = {}
                    for t in doc.iter(f"{ns}Tag"):
                        k2 = t.findtext(f"{ns}Key") or ""
                        # AWS rejects bad tag sets rather than storing a subset
                        if not k2 or k2 in tags:
                            return self._error(
                                400, "InvalidTag", f"empty or duplicate key {k2!r}"
                            )
                        tags[k2] = t.findtext(f"{ns}Value") or ""
                    if len(tags) > 10:
                        return self._error(
                            400, "BadRequest", "object tag set exceeds 10 tags"
                        )
                    srv.filer.mutate_entry(
                        path,
                        lambda e: e.extended.__setitem__(
                            "s3-tags", json.dumps(tags, sort_keys=True).encode()
                        ),
                    )
                    return self._respond(200)
                if m == "DELETE":
                    srv.filer.mutate_entry(
                        path, lambda e: e.extended.pop("s3-tags", None)
                    )
                    return self._respond(204)
                return self._error(405, "MethodNotAllowed", m)

            def _copy_object(self, bucket: str, key: str, src: str):
                src = urllib.parse.unquote(src)
                src_vid = ""
                if "?versionId=" in src:
                    src, _, src_vid = src.partition("?versionId=")
                if not src.startswith("/"):
                    src = "/" + src
                src_path = normalize_path(f"{BUCKETS_ROOT}{src}")
                if src_vid:
                    sb, _, sk = src.lstrip("/").partition("/")
                    entry = self._resolve_version(sb, sk, src_path, src_vid)
                    if entry is None:
                        return
                else:
                    entry = srv.filer.find_entry(src_path)
                    if entry.is_directory or is_delete_marker(entry):
                        # a versioned key behind a delete marker reads
                        # as absent — copy must 404 like GET does
                        return self._error(404, "NoSuchKey", src)
                # x-amz-copy-source-if-* preconditions (AWS CopyObject):
                # same RFC 9110 matching as GET, evaluated against the
                # SOURCE entry before any bytes move
                src_etag = _entry_etag(entry)
                cim = self.headers.get("x-amz-copy-source-if-match", "")
                cinm = self.headers.get(
                    "x-amz-copy-source-if-none-match", ""
                )
                cims = _http_date(
                    self.headers.get(
                        "x-amz-copy-source-if-modified-since", ""
                    )
                )
                cius = _http_date(
                    self.headers.get(
                        "x-amz-copy-source-if-unmodified-since", ""
                    )
                )
                # RFC 9110 precedence, same as the GET path: an ETag
                # condition overrides its date counterpart
                if (
                    (cim and not _etag_cond_match(cim, src_etag))
                    or (
                        not cim
                        and cius is not None
                        and entry.attr.mtime > cius
                    )
                    or (cinm and _etag_cond_match(cinm, src_etag))
                    or (
                        not cinm
                        and cims is not None
                        and entry.attr.mtime <= cims
                    )
                ):
                    return self._error(
                        412,
                        "PreconditionFailed",
                        "copy source precondition failed",
                    )
                data = srv.filer.read_entry(entry)
                # decrypt the source (SSE-C via the x-amz-copy-source-*
                # key headers; SSE-S3 via the keyring), then apply the
                # destination's own encryption
                src_key = sse.decrypt_key_for_entry(
                    entry,
                    sse.parse_customer_headers(
                        self.headers, prefix=sse.COPY_CUSTOMER_PREFIX
                    ),
                    srv.sse_keyring,
                )
                if src_key is not None:
                    data = sse.read_decrypted(
                        lambda o, n: data[o:] if n < 0 else data[o : o + n],
                        entry,
                        src_key,
                        0,
                        -1,
                    )
                dst_ssec, dst_algo = sse.resolve_put_encryption(
                    self.headers, srv.bucket_default_encryption(bucket)
                )
                data, sse_ext, sse_hdrs = sse.encrypt_for_put(
                    data, dst_ssec, dst_algo, srv.sse_keyring
                )
                copy_ext = dict(sse_ext)
                acl = self._canned_acl_header()
                if acl:
                    copy_ext["s3-acl"] = acl.encode()
                dst, vid = srv.put_object(
                    bucket,
                    key,
                    data,
                    mime=entry.attr.mime,
                    extra_extended=copy_ext,
                )
                root = ET.Element("CopyObjectResult", xmlns=XMLNS)
                _el(root, "ETag", f'"{dst.attr.md5.hex()}"')
                _el(root, "LastModified", _iso(dst.attr.mtime))
                extra = {**sse_hdrs}
                if vid:
                    extra["x-amz-version-id"] = vid
                self._respond(200, _xml(root), extra=extra)

            # ---- multipart ----

            def _initiate_multipart(self, bucket: str, key: str):
                if srv.quota_exceeded(bucket):
                    return self._error(
                        403,
                        "QuotaExceeded",
                        f"bucket {bucket} is over its storage quota",
                    )
                # SSE context for the whole upload (reference
                # SerializeSSECMetadata-per-chunk model): parts become
                # independent CTR streams under one data key; the
                # part map lands on the completed object.
                sse_meta: dict = {}
                ssec_key, sse_algo = sse.resolve_put_encryption(
                    self.headers, srv.bucket_default_encryption(bucket)
                )
                if ssec_key is not None:
                    # the key itself is NEVER stored; every UploadPart
                    # must present it again (AWS SSE-C semantics)
                    sse_meta = {
                        "algo": "SSE-C",
                        "key_md5": sse.key_md5_b64(ssec_key),
                    }
                elif sse_algo:
                    if srv.sse_keyring is None:
                        return self._error(
                            501, "NotImplemented", "SSE keyring unavailable"
                        )
                    key_id, _dk, wrapped = srv.sse_keyring.generate_data_key()
                    sse_meta = {
                        "algo": "AES256",
                        "key_id": key_id,
                        "wrapped": wrapped.hex(),
                    }
                upload_id = uuid.uuid4().hex
                meta_path = srv._upload_dir(bucket, upload_id)
                e = new_entry(meta_path, is_directory=True, mode=0o755)
                srv.filer.create_entry(e)
                # x-amz-object-lock-* headers arrive on the initiate
                # request; they must stick to the completed object
                lock_ext = {
                    k2: v2.decode()
                    for k2, v2 in self._lock_headers_extended(bucket).items()
                }
                srv.filer.store.kv_put(
                    f"upload/{upload_id}".encode(),
                    json.dumps(
                        {
                            "bucket": bucket,
                            "key": key,
                            "mime": self.headers.get("Content-Type", ""),
                            "lock_ext": lock_ext,
                            "sse": sse_meta,
                        }
                    ).encode(),
                )
                root = ET.Element("InitiateMultipartUploadResult", xmlns=XMLNS)
                _el(root, "Bucket", bucket)
                _el(root, "Key", key)
                _el(root, "UploadId", upload_id)
                self._respond(200, _xml(root))

            def _upload_part(self, bucket: str, key: str, q: dict):
                if srv.quota_exceeded(bucket):
                    # parts consume storage immediately — an over-quota
                    # bucket must not grow unbounded via multipart
                    return self._error(
                        403,
                        "QuotaExceeded",
                        f"bucket {bucket} is over its storage quota",
                    )
                upload_id = q["uploadId"]
                part = int(q["partNumber"])
                meta_raw = srv.filer.store.kv_get(f"upload/{upload_id}".encode())
                if meta_raw is None:
                    return self._error(404, "NoSuchUpload", upload_id)
                data = self._read_body()
                part_ext: dict = {}
                sse_meta = (json.loads(meta_raw) or {}).get("sse") or {}
                if sse_meta:
                    dk = self._upload_data_key(sse_meta)
                    if isinstance(dk, bytes):
                        iv, data = sse.encrypt(dk, data)
                        part_ext["s3-sse-part-iv"] = iv
                    else:
                        return dk  # an error response was sent
                entry = srv.filer.write_file(
                    f"{srv._upload_dir(bucket, upload_id)}/{part:05d}.part",
                    data,
                    collection=bucket,
                    inline=False,  # completion splices chunk lists
                    extended=part_ext,
                )
                self._respond(200, extra={"ETag": f'"{entry.attr.md5.hex()}"'})

            def _upload_data_key(self, sse_meta: dict):
                """Resolve the upload's data key: SSE-C re-presents the
                customer key on every part request (MD5-bound to the
                initiate); SSE-S3 unwraps the stored envelope key.
                Returns bytes, or None after sending an error."""
                if sse_meta.get("algo") == "SSE-C":
                    ck = sse.parse_customer_headers(self.headers)
                    if ck is None:
                        self._error(
                            400,
                            "InvalidRequest",
                            "upload uses SSE-C; part requests need the key",
                        )
                        return None
                    if sse.key_md5_b64(ck) != sse_meta.get("key_md5"):
                        self._error(
                            403, "AccessDenied", "SSE-C key does not match upload"
                        )
                        return None
                    return ck
                return srv.sse_keyring.decrypt_data_key(
                    sse_meta.get("key_id", ""),
                    bytes.fromhex(sse_meta.get("wrapped", "")),
                )

            def _complete_multipart(self, bucket: str, key: str, q: dict):
                if srv.quota_exceeded(bucket):
                    return self._error(
                        403,
                        "QuotaExceeded",
                        f"bucket {bucket} is over its storage quota",
                    )
                upload_id = q["uploadId"]
                meta_raw = srv.filer.store.kv_get(f"upload/{upload_id}".encode())
                if meta_raw is None:
                    return self._error(404, "NoSuchUpload", upload_id)
                meta = json.loads(meta_raw)
                updir = srv._upload_dir(bucket, upload_id)
                parts = sorted(
                    (
                        e
                        for e in srv.filer.list_entries(updir, limit=10_000)
                        if e.name.endswith(".part")
                    ),
                    key=lambda e: e.name,
                )
                # honor the client's part list when provided
                body = self._read_body()
                if body.strip():
                    doc = ET.fromstring(body)
                    ns = _xml_ns(doc)
                    wanted = {
                        int(p.findtext(f"{ns}PartNumber") or "0")
                        for p in doc.findall(f"{ns}Part")
                    }
                    if wanted:
                        chosen = [
                            e for e in parts if int(e.name.split(".")[0]) in wanted
                        ]
                        if len(chosen) != len(wanted):
                            return self._error(
                                400, "InvalidPart", "listed part missing"
                            )
                        parts = chosen
                # splice chunk lists: no data copy (filer_multipart.go)
                chunks, offset, md5s = [], 0, []
                for p in parts:
                    if p.content and not p.chunks:
                        # a part stored inline (e.g. pre-inline=False
                        # uploads) must become a chunk or its bytes
                        # would vanish from the spliced object
                        fid = srv.filer.ops.upload(
                            p.content, collection=bucket
                        )
                        c0 = fpb.FileChunk(
                            fid=fid,
                            offset=0,
                            size=len(p.content),
                            modified_ts_ns=time.time_ns(),
                        )
                        p.chunks.append(c0)
                    for c in p.chunks:
                        nc = fpb.FileChunk()
                        nc.CopyFrom(c)
                        nc.offset = offset + c.offset
                        chunks.append(nc)
                    offset += p.file_size
                    md5s.append(p.attr.md5)
                final_path = normalize_path(f"{BUCKETS_ROOT}/{bucket}/{key}")
                final = new_entry(final_path, mime=meta.get("mime", ""))
                final.chunks = chunks
                final.attr.file_size = offset
                etag = hashlib.md5(b"".join(md5s)).hexdigest() + f"-{len(parts)}"
                final.extended["s3-etag"] = etag.encode()
                sse_meta = meta.get("sse") or {}
                if sse_meta:
                    # assemble the per-part CTR map (length + IV per
                    # part, in splice order); key material mirrors the
                    # single-PUT layout so the read path is uniform
                    part_map = []
                    for p in parts:
                        iv = p.extended.get("s3-sse-part-iv")
                        if not iv:
                            return self._error(
                                400,
                                "InvalidPart",
                                f"part {p.name} missing SSE metadata",
                            )
                        part_map.append([p.file_size, iv.hex()])
                    final.extended[sse.SSE_PART_MAP_KEY] = json.dumps(
                        part_map
                    ).encode()
                    if sse_meta["algo"] == "SSE-C":
                        final.extended[sse.SSE_ALGO_KEY] = b"SSE-C"
                        final.extended[sse.SSE_KEY_MD5_KEY] = sse_meta[
                            "key_md5"
                        ].encode()
                    else:
                        final.extended[sse.SSE_ALGO_KEY] = b"AES256"
                        final.extended[sse.SSE_KEY_ID_KEY] = sse_meta[
                            "key_id"
                        ].encode()
                        final.extended[sse.SSE_WRAPPED_KEY] = bytes.fromhex(
                            sse_meta["wrapped"]
                        )
                # bucket default retention applies to multipart objects
                # too — large SDK uploads must not escape WORM
                for k2, v2 in vtag.default_retention_extended(
                    srv.lock_conf(bucket)
                ).items():
                    final.extended[k2] = v2
                for k2, v2 in (meta.get("lock_ext") or {}).items():
                    final.extended[k2] = v2.encode()
                # versioning-aware finalize (mirrors srv.put_object);
                # the key's write stripe makes it atomic vs CAS PUTs
                # and deletes on the same key
                final_lock = srv.put_lock(final_path)
                final_lock.acquire()
                state = srv.bucket_versioning(bucket)
                vid = ""
                old = None
                if state == "Enabled":
                    vid = new_version_id()
                    final.extended[vtag.VID_KEY] = vid.encode()
                    archive_current(srv.filer, BUCKETS_ROOT, bucket, key)
                elif state == "Suspended":
                    vid = vtag.NULL_VID
                    try:
                        cur = srv.filer.find_entry(final_path)
                        if not cur.is_directory and entry_vid(cur) != vtag.NULL_VID:
                            archive_current(srv.filer, BUCKETS_ROOT, bucket, key)
                        elif not cur.is_directory:
                            old = cur
                    except NotFound:
                        pass
                else:
                    # an overwritten object's chunks must be GC'd
                    # (write_file does this for the simple-PUT path)
                    try:
                        old = srv.filer.find_entry(final_path)
                    except NotFound:
                        old = None
                try:
                    srv.filer.create_entry(final)
                finally:
                    final_lock.release()
                if old is not None and not old.is_directory:
                    srv.filer.gc_chunks(old.chunks)
                # drop part entries WITHOUT GC'ing chunks (now referenced
                # by the final entry)
                for p in parts:
                    srv.filer.delete_entry(p.full_path, gc_chunks=False)
                srv.filer.delete_entry(updir, recursive=True, gc_chunks=False)
                srv.filer.store.kv_delete(f"upload/{upload_id}".encode())
                root = ET.Element("CompleteMultipartUploadResult", xmlns=XMLNS)
                _el(root, "Bucket", bucket)
                _el(root, "Key", key)
                _el(root, "ETag", f'"{etag}"')
                self._respond(
                    200,
                    _xml(root),
                    extra={"x-amz-version-id": vid} if vid else None,
                )

            def _abort_multipart(self, bucket: str, key: str, q: dict):
                upload_id = q["uploadId"]
                srv.filer.delete_entry(
                    srv._upload_dir(bucket, upload_id), recursive=True
                )
                srv.filer.store.kv_delete(f"upload/{upload_id}".encode())
                self._respond(204)

            def _list_parts(self, bucket: str, key: str, q: dict):
                upload_id = q["uploadId"]
                updir = srv._upload_dir(bucket, upload_id)
                if srv.filer.store.kv_get(
                    f"upload/{upload_id}".encode()
                ) is None or not srv.filer.exists(updir):
                    return self._error(404, "NoSuchUpload", upload_id)
                root = ET.Element("ListPartsResult", xmlns=XMLNS)
                _el(root, "Bucket", bucket)
                _el(root, "Key", key)
                _el(root, "UploadId", upload_id)
                try:
                    for e in srv.filer.list_entries(updir, limit=10_000):
                        if not e.name.endswith(".part"):
                            continue
                        p = _el(root, "Part")
                        _el(p, "PartNumber", int(e.name.split(".")[0]))
                        _el(p, "ETag", f'"{e.attr.md5.hex()}"')
                        _el(p, "Size", e.file_size)
                except NotFound:
                    return self._error(404, "NoSuchUpload", upload_id)
                self._respond(200, _xml(root))

            def _list_uploads(self, bucket: str):
                root = ET.Element("ListMultipartUploadsResult", xmlns=XMLNS)
                _el(root, "Bucket", bucket)
                updir = f"{BUCKETS_ROOT}/{UPLOADS_DIR}/{bucket}"
                try:
                    for e in srv.filer.list_entries(updir, limit=10_000):
                        meta_raw = srv.filer.store.kv_get(
                            f"upload/{e.name}".encode()
                        )
                        if meta_raw is None:
                            continue
                        meta = json.loads(meta_raw)
                        u = _el(root, "Upload")
                        _el(u, "Key", meta["key"])
                        _el(u, "UploadId", e.name)
                except NotFound:
                    pass
                self._respond(200, _xml(root))

        return Handler

    # -------------------------------------------------------- versioning

    def quota_exceeded(self, bucket: str) -> bool:
        """Set by the s3.bucket.quota.enforce sweep (reference
        command_s3_bucketquota.go): over-quota buckets reject writes
        until usage drops below the quota and a sweep clears the flag."""
        v = self.filer.store.kv_get(f"quota-exceeded/{bucket}".encode())
        return bool(v)

    def bucket_policy(self, bucket: str) -> dict | None:
        raw = self.filer.store.kv_get(f"policy/{bucket}".encode())
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return None

    def bucket_acl(self, bucket: str) -> str:
        raw = self.filer.store.kv_get(f"acl/{bucket}".encode())
        return raw.decode() if raw else "private"

    def bucket_default_encryption(self, bucket: str) -> str:
        """'' | 'AES256': bucket default applied to unencrypted PUTs."""
        raw = self.filer.store.kv_get(f"encryption/{bucket}".encode())
        return raw.decode() if raw else ""

    # Canned ACLs grant DATA-PLANE actions only: never control-plane
    # operations (policy/acl/encryption/lifecycle/bucket delete), which
    # would let an anonymous caller escalate on a public-read-write
    # bucket.
    _ACL_READ_ACTIONS = frozenset(
        {"s3:GetObject", "s3:GetObjectVersion", "s3:ListBucket"}
    )
    _ACL_WRITE_ACTIONS = frozenset({"s3:PutObject", "s3:DeleteObject"})

    def put_lock(self, path: str) -> threading.Lock:
        return self._put_locks[zlib.crc32(path.encode()) % len(self._put_locks)]

    def acl_allows_anonymous(self, bucket: str, key: str, action: str) -> bool:
        """Canned-ACL grant check for unauthenticated requests:
        public-read(-write) on the bucket, or public-read on the object
        itself (object ACL stored in entry.extended at PUT)."""
        acl = self.bucket_acl(bucket)
        if action in self._ACL_READ_ACTIONS:
            if acl in ("public-read", "public-read-write"):
                return True
            if key:
                try:
                    entry = self.filer.find_entry(
                        normalize_path(f"{BUCKETS_ROOT}/{bucket}/{key}")
                    )
                except NotFound:
                    return False
                oacl = (entry.extended.get("s3-acl") or b"").decode()
                return oacl in ("public-read", "public-read-write")
            return False
        if action in self._ACL_WRITE_ACTIONS:
            return acl == "public-read-write"
        return False

    def bucket_versioning(self, bucket: str) -> str:
        """"" (never enabled) | "Enabled" | "Suspended"."""
        raw = self.filer.store.kv_get(f"versioning/{bucket}".encode())
        return raw.decode() if raw else ""

    def lock_conf(self, bucket: str) -> dict | None:
        raw = self.filer.store.kv_get(f"object-lock/{bucket}".encode())
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None

    def put_object(
        self,
        bucket: str,
        key: str,
        data: bytes,
        mime: str = "",
        extra_extended: dict | None = None,
    ):
        """Versioning-aware object write (reference
        s3api_object_versioning.go putVersionedObject). Returns
        (entry, version_id-or-None)."""
        path = normalize_path(f"{BUCKETS_ROOT}/{bucket}/{key}")
        with self.put_lock(path):
            return self._put_object_locked(
                bucket, key, path, data, mime, extra_extended
            )

    def _put_object_locked(
        self,
        bucket: str,
        key: str,
        path: str,
        data: bytes,
        mime: str,
        extra_extended: dict | None,
    ):
        state = self.bucket_versioning(bucket)
        ext = dict(extra_extended or {})
        ext.update(vtag.default_retention_extended(self.lock_conf(bucket)))
        if state == "Enabled":
            vid = new_version_id()
            ext[vtag.VID_KEY] = vid.encode()
            archive_current(self.filer, BUCKETS_ROOT, bucket, key)
            entry = self.filer.write_file(
                path, data, mime=mime, collection=bucket, extended=ext
            )
            return entry, vid
        if state == "Suspended":
            # the new object becomes the "null" version; an existing
            # non-null current version is retained, a null one replaced
            try:
                cur = self.filer.find_entry(path)
                if not cur.is_directory and entry_vid(cur) != vtag.NULL_VID:
                    archive_current(self.filer, BUCKETS_ROOT, bucket, key)
            except NotFound:
                pass
            entry = self.filer.write_file(
                path, data, mime=mime, collection=bucket, extended=ext
            )
            return entry, vtag.NULL_VID
        entry = self.filer.write_file(
            path, data, mime=mime, collection=bucket, extended=ext or None
        )
        return entry, None

    # -------------------------------------------------------------- walk

    def _upload_dir(self, bucket: str, upload_id: str) -> str:
        return f"{BUCKETS_ROOT}/{UPLOADS_DIR}/{bucket}/{upload_id}"

    def _walk_keys(
        self,
        bucket: str,
        prefix: str,
        delimiter: str,
        after: str,
        max_keys: int,
        include_markers: bool = False,
    ):
        """Flat key listing with prefix/delimiter grouping.

        DFS over the filer tree in sorted order (the namespace IS the
        key space, reference s3api list semantics over the filer)."""
        bpath = f"{BUCKETS_ROOT}/{bucket}"
        contents: list = []
        common: set[str] = set()
        truncated = False
        last_emitted = ""

        def cap_reached() -> bool:
            nonlocal truncated
            if len(contents) + len(common) >= max_keys:
                truncated = True
                return True
            return False

        def dfs(dir_path: str, key_prefix: str) -> bool:
            nonlocal last_emitted
            for e in self.filer.list_entries(dir_path, limit=100_000):
                key = key_prefix + e.name
                if dir_path == bpath and e.name == vtag.VERSIONS_DIR:
                    continue  # hidden noncurrent-version tree
                if not include_markers and is_delete_marker(e):
                    continue
                if e.is_directory:
                    sub = key + "/"
                    # prune subtrees that cannot contain matching keys
                    if prefix and not (
                        sub.startswith(prefix) or prefix.startswith(sub)
                    ):
                        continue
                    if delimiter == "/" and sub.startswith(prefix) and sub != prefix:
                        cut = prefix + sub[len(prefix) :].split("/")[0] + "/"
                        if after.startswith(cut):
                            continue  # group already emitted on a prior page
                        if cut <= after:
                            continue
                        if cut in common:
                            continue
                        if cap_reached():
                            return False
                        common.add(cut)
                        last_emitted = cut
                        continue
                    if not dfs(e.full_path, sub):
                        return False
                else:
                    if prefix and not key.startswith(prefix):
                        continue
                    if after and key <= after:
                        continue
                    if cap_reached():
                        return False
                    contents.append((key, e))
                    last_emitted = key
            return True

        try:
            dfs(bpath, "")
        except NotFound:
            pass
        return contents, common, truncated, last_emitted


def _required_action(method: str, bucket: str, key: str) -> str:
    """Map a request to the coarse action model (reference
    auth_credentials.go identity actions: Admin/Read/Write/List)."""
    if key == "":
        if method in ("GET", "HEAD"):
            return "List"
        if method == "POST":  # batch delete
            return "Write"
        return "Admin"  # bucket create/delete
    return "Read" if method in ("GET", "HEAD") else "Write"


def _http_date(header: str):
    """RFC 7231 date -> epoch seconds, or None for malformed input
    (RFC 9110: an unparseable validator date IGNORES the condition)."""
    try:
        import email.utils as _eu

        return _eu.parsedate_to_datetime(header).timestamp()
    except (TypeError, ValueError):
        return None


def _etag_cond_match(header: str, etag: str) -> bool:
    """RFC 9110 If-(None-)Match list semantics: '*' matches any
    existing representation; otherwise EXACT entity-tag comparison per
    comma-separated member (substring matching would confuse
    'deadbeef-2' with 'deadbeef-25')."""
    header = header.strip()
    if header == "*":
        return True
    for member in header.split(","):
        tag = member.strip()
        if tag.startswith("W/"):
            tag = tag[2:]
        if tag.strip('"') == etag:
            return True
    return False


def _entry_etag(entry) -> str:
    s3etag = entry.extended.get("s3-etag")
    if s3etag:
        return s3etag.decode()
    return entry.attr.md5.hex() if entry.attr.md5 else ""


