"""Twin S3 gateways for the port's gateway tests (tests/test_torch_s3_gateway.py,
tests/test_torch_s3_objects.py, tests/test_torch_s3_tables.py and
tests/test_torch_iam_providers.py).

One JAX `S3Server` over a JAX filer, master and volume server, and one
port `S3Server` over the port's (`ec_backend="cpu"`), both loading one
identities file (OIDC and LDAP blocks included) through their own
`load_s3_config`; a client that signs
each request with its own package's `sign_v4`. What differs between two
clusters and two clocks is pinned or masked:

- version ids and multipart upload ids come from one counter per package;
- the catalog's table and view uuids, the IAM API's request ids and
  minted key pairs from counters per package, and the catalog's clock
  from one that starts at `CATALOG_T0` and ticks a second per reading;
- SSE's randomness (the keyring's master key, data keys, IVs) from one
  seeded stream per package, so ciphertexts are byte-identical;
- the `Date` and `Last-Modified` headers, the XML timestamps and the STS
  credentials are masked; the request id is the caller's, echoed.

A scenario is a list of steps; `run_scenario` runs each step on the JAX
side, then on the port side, and keeps each side's answers with the
`/buckets` tree and the filer's KV after the step.
"""

import base64
import hashlib
import hmac
import http.client
import itertools
import json
import os
import re
import time
import types
import urllib.parse
from datetime import datetime, timezone

import numpy as np
import pytest
from conftest import wait_for
from test_torch_volume_server import _ports

import seaweedfs_tpu.ec.device_queue as j_dq
import seaweedfs_tpu.s3.auth as j_auth
import seaweedfs_tpu.s3.chunked as j_chunked
import seaweedfs_tpu.s3.config as j_config
import seaweedfs_tpu.s3.iamapi as j_iamapi
import seaweedfs_tpu.s3.lifecycle as j_lifecycle
import seaweedfs_tpu.s3.server as j_server
import seaweedfs_tpu.s3.sse as j_sse
import seaweedfs_tpu.s3.tables as j_tables
import seaweedfs_tpu.s3.versioning as j_versioning
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.filer import MemoryStore as JaxMemoryStore
from seaweedfs_tpu.server.master import MasterServer as JaxMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer
import seaweedfs_tpu_torch.ec.device_queue as p_dq
import seaweedfs_tpu_torch.s3.auth as p_auth
import seaweedfs_tpu_torch.s3.chunked as p_chunked
import seaweedfs_tpu_torch.s3.config as p_config
import seaweedfs_tpu_torch.s3.iamapi as p_iamapi
import seaweedfs_tpu_torch.s3.lifecycle as p_lifecycle
import seaweedfs_tpu_torch.s3.server as p_server
import seaweedfs_tpu_torch.s3.sse as p_sse
import seaweedfs_tpu_torch.s3.tables as p_tables
import seaweedfs_tpu_torch.s3.versioning as p_versioning
from seaweedfs_tpu_torch.filer import Filer, MemoryStore
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

PKGS = {
    "jax": types.SimpleNamespace(
        master=JaxMasterServer, volume=JaxVolumeServer, filer=JaxFiler, memory=JaxMemoryStore,
        server=j_server, auth=j_auth, chunked=j_chunked, config=j_config, lifecycle=j_lifecycle,
        sse=j_sse, versioning=j_versioning, dq=j_dq, tables=j_tables, iamapi=j_iamapi),
    "port": types.SimpleNamespace(
        master=MasterServer, volume=VolumeServer, filer=Filer, memory=MemoryStore,
        server=p_server, auth=p_auth, chunked=p_chunked, config=p_config, lifecycle=p_lifecycle,
        sse=p_sse, versioning=p_versioning, dq=p_dq, tables=p_tables, iamapi=p_iamapi),
}
CHUNK = 64 * 1024
CATALOG_T0 = 1_780_000_000.0
REGION = "us-east-1"
# who signs: access key, secret key (the STS side fills "sts" at run time)
KEYS = {"admin": ("AKADMIN", "admin/secret+1"), "reader": ("AKREADER", "reader/secret+2"),
        "policy": ("AKPOLICY", "policy/secret+3"), "ghost": ("AKGHOST", "not/configured")}
ROLE_POLICY = {"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:PutObject", "s3:GetObject"],
     "Resource": ["arn:aws:s3:::gw/sts/*"]}]}
USER_POLICY = {"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:GetObject", "s3:ListBucket", "sts:AssumeRole"],
     "Resource": ["arn:aws:s3:::*", "arn:aws:iam:::role/*"]},
    {"Effect": "Deny", "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::gw/secret/*"]}]}
IDENTITIES = {
    "identities": [
        {"name": "admin", "accessKey": KEYS["admin"][0], "secretKey": KEYS["admin"][1],
         "actions": ["Admin"]},
        {"name": "reader", "accessKey": KEYS["reader"][0], "secretKey": KEYS["reader"][1],
         "actions": ["Read", "List"]},
        {"name": "policy", "accessKey": KEYS["policy"][0], "secretKey": KEYS["policy"][1],
         "policies": [USER_POLICY]},
    ],
    "roles": [{"name": "uploader", "policies": [ROLE_POLICY], "trusted": ["*"]}],
}
MASKED_HEADERS = {"date", "last-modified"}
MASKED_XML = re.compile(
    rb"<(LastModified|CreationDate|Expiration|AccessKeyId|SecretAccessKey|SessionToken|"
    rb"AssumedRoleId)>[^<]*</")


class _Uuid:
    """A uuid4 stand-in from a counter: `hex` and `str` as uuid.UUID gives them."""

    def __init__(self, n: int):
        self.hex = f"{n:032x}"

    def __str__(self):
        h = self.hex
        return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


class SeededOs:
    """`os` with a seeded `urandom`: the SSE module's randomness pinned."""

    def __init__(self, rng):
        self._rng = rng

    def urandom(self, n: int) -> bytes:
        return self._rng.bytes(n)

    def __getattr__(self, name):
        return getattr(os, name)


def norm(status: int, headers: dict, body: bytes):
    """(status, headers, body) with the clocks and credentials masked; an
    XML body whole, any other body by its length and sha256."""
    hs = {k.lower(): v for k, v in headers.items() if k.lower() not in MASKED_HEADERS}
    if body.startswith(b"<?xml") or body.startswith(b"<Error"):
        return status, hs, MASKED_XML.sub(rb"<\1>*</", body)
    return status, hs, (len(body), sha(body))


class Side:
    """One twin: a master, a volume server, a filer and an S3 gateway of
    one package, with its pins applied through `mp`."""

    def __init__(self, name: str, root, mp, seed: int = 27, config: dict | None = None,
                 **s3_kw):
        pkg = PKGS[name]
        self.name, self.pkg = name, pkg
        ids, vids = itertools.count(1), itertools.count(1)
        mp.setattr(pkg.server, "uuid", types.SimpleNamespace(
            uuid4=lambda: types.SimpleNamespace(hex=f"{next(ids):032x}")))

        def version_id() -> str:
            return f"{(1 << 63) - next(vids):016x}{0:08x}"

        mp.setattr(pkg.versioning, "new_version_id", version_id)
        mp.setattr(pkg.server, "new_version_id", version_id)
        mp.setattr(pkg.sse, "os", SeededOs(np.random.default_rng(seed)))
        tuids, clock, rids, keys = (itertools.count(1), itertools.count(),
                                    itertools.count(1), itertools.count(1))
        mp.setattr(pkg.tables, "uuid", types.SimpleNamespace(uuid4=lambda: _Uuid(next(tuids))))
        mp.setattr(pkg.tables, "time", types.SimpleNamespace(
            time=lambda: CATALOG_T0 + next(clock)))
        mp.setattr(pkg.iamapi, "uuid", types.SimpleNamespace(
            uuid4=lambda: types.SimpleNamespace(hex=f"{next(rids):032x}")))
        mp.setattr(pkg.iamapi, "mint_key_pair",
                   lambda: (f"SWTWIN{next(keys):014d}", f"twin/secret/{next(keys)}"))
        self.mport = _ports()
        self.master = pkg.master(ip="127.0.0.1", port=self.mport, vacuum_interval=3600)
        self.master.start()
        self.vs = pkg.volume([str(root / "v")], master=f"127.0.0.1:{self.mport}", ip="127.0.0.1",
                             port=_ports(), ec_backend="cpu")
        self.vs.start()
        wait_for(lambda: self.master.topo.nodes, timeout=30, msg=f"the {name} server registered")
        self.filer = pkg.filer(pkg.memory(), master=f"127.0.0.1:{self.mport}", chunk_size=CHUNK)
        conf = root / "identities.json"
        conf.write_text(json.dumps(IDENTITIES if config is None else config))
        idents, sts, oidc, ldap = pkg.config.load_s3_config(str(conf))
        self.port = _ports()
        kw = dict(ip="127.0.0.1", port=self.port, identities=idents, sts=sts, oidc=oidc,
                  ldap=ldap, lifecycle_interval=0, http_workers=4)
        kw.update(s3_kw)
        self.s3 = pkg.server.S3Server(self.filer, **kw)
        self.s3.start()
        self.keys = {who: (ak, sk, "") for who, (ak, sk) in KEYS.items()}
        self.rids = itertools.count(1)

    # ------------------------------------------------------------ client

    def call(self, method: str, path: str, query: str = "", body: bytes = b"",
             headers: dict | None = None, who: str | None = "admin", phash: str | None = None,
             mutate=None):
        """One request, signed by `who` (None: anonymous) with this
        package's `sign_v4`, its signed headers passed through `mutate`;
        the normalised answer."""
        return norm(*self.raw(method, path, query, body, headers, who, phash, mutate))

    def raw(self, method, path, query="", body=b"", headers=None, who="admin", phash=None,
            mutate=None):
        wire = urllib.parse.quote(path, safe="/-_.~")
        hs = {"host": f"127.0.0.1:{self.port}", **(headers or {})}
        if who is not None:
            ak, sk, token = self.keys[who]
            if token:
                hs["x-amz-security-token"] = token
            hs = self.pkg.auth.sign_v4(method, wire, query, access_key=ak, secret_key=sk,
                                       headers=hs, payload_hash=phash or sha(body), region=REGION)
        if mutate is not None:
            hs = mutate(hs)
        return self.send(method, wire + (f"?{query}" if query else ""), body, hs)

    def send(self, method: str, target: str, body: bytes, headers: dict):
        headers = {**headers, "X-Request-ID": f"twin-{next(self.rids)}"}
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            c.request(method, target, body=body, headers=headers)
            r = c.getresponse()
            return r.status, dict(r.getheaders()), r.read()
        except (http.client.RemoteDisconnected, ConnectionResetError):
            # a handler that raised: the server drops the connection
            return 0, {}, b"connection dropped"
        finally:
            c.close()

    def presigned(self, method: str, path: str, who: str = "admin", expires: int = 3600,
                  age: int = 0, query: str = ""):
        """A presigned URL, signed as an SDK signs it, `age` seconds old."""
        ak, sk, _ = self.keys[who]
        date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(time.time() - age))
        auth = self.pkg.auth
        q = {"X-Amz-Algorithm": "AWS4-HMAC-SHA256",
             "X-Amz-Credential": f"{ak}/{date[:8]}/{REGION}/s3/aws4_request",
             "X-Amz-Date": date, "X-Amz-Expires": str(expires), "X-Amz-SignedHeaders": "host"}
        qs = urllib.parse.urlencode(q, quote_via=urllib.parse.quote) + (f"&{query}" if query else "")
        wire = urllib.parse.quote(path, safe="/-_.~")
        creq = "\n".join([method, auth.canonical_uri(wire), auth.canonical_query(qs),
                          f"host:127.0.0.1:{self.port}\n", "host", "UNSIGNED-PAYLOAD"])
        sts = "\n".join(["AWS4-HMAC-SHA256", date, f"{date[:8]}/{REGION}/s3/aws4_request",
                         sha(creq.encode())])
        key = auth.signing_key(sk, date[:8], REGION)
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        return norm(*self.send(method, f"{wire}?{qs}&X-Amz-Signature={sig}", b"",
                               {"host": f"127.0.0.1:{self.port}"}))

    def streaming_put(self, path: str, data: bytes, chunk: int = 16 * 1024, tamper: bool = False,
                      headers: dict | None = None):
        """A signed aws-chunked PUT, encoded by this package's
        `encode_aws_chunked`; `tamper` flips one payload byte."""
        ak, sk, _ = self.keys["admin"]
        wire = urllib.parse.quote(path, safe="/-_.~")
        hs = {"host": f"127.0.0.1:{self.port}", "content-encoding": "aws-chunked",
              "x-amz-decoded-content-length": str(len(data)), **(headers or {})}
        hs = self.pkg.auth.sign_v4("PUT", wire, "", access_key=ak, secret_key=sk, headers=hs,
                                   payload_hash="STREAMING-AWS4-HMAC-SHA256-PAYLOAD", region=REGION)
        date = hs["x-amz-date"]
        seed = hs["Authorization"].rsplit("Signature=", 1)[1]
        ctx = self.pkg.auth.SigningContext(
            signing_key=self.pkg.auth.signing_key(sk, date[:8], REGION), amz_date=date,
            scope=f"{date[:8]}/{REGION}/s3/aws4_request", seed_signature=seed)
        body = self.pkg.chunked.encode_aws_chunked(data, ctx, chunk_size=chunk)
        if tamper:
            i = body.index(b"\r\n") + 2
            body = body[:i] + bytes([body[i] ^ 1]) + body[i + 1:]
        return norm(*self.send("PUT", wire, body, hs))

    def post_form(self, bucket: str, fields: dict, file_bytes: bytes, who: str | None = "admin",
                  expiration: str = "2099-01-01T00:00:00Z", conditions=None, bad_sig=False):
        """A POST-policy browser upload: the policy signed by `who`."""
        fields = dict(fields)
        if who is not None:
            ak, sk, _ = self.keys[who]
            date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            fields.update({"x-amz-algorithm": "AWS4-HMAC-SHA256",
                           "x-amz-credential": f"{ak}/{date[:8]}/{REGION}/s3/aws4_request",
                           "x-amz-date": date})
            conds = conditions if conditions is not None else [{"bucket": bucket}] + [
                ["starts-with", "$key", v.split("${filename}")[0]] if k == "key"
                else ["eq", f"${k}", v] for k, v in fields.items()]
            policy = base64.b64encode(json.dumps(
                {"expiration": expiration, "conditions": conds}).encode()).decode()
            fields["policy"] = policy
            sig = hmac.new(self.pkg.auth.signing_key(sk, date[:8], REGION), policy.encode(),
                           hashlib.sha256).hexdigest()
            fields["x-amz-signature"] = ("0" * 64) if bad_sig else sig
        b = "twin-boundary-27"
        parts = [f'--{b}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
                 for k, v in fields.items()]
        parts.append((f'--{b}\r\nContent-Disposition: form-data; name="file"; '
                      f'filename="up.bin"\r\nContent-Type: application/octet-stream\r\n\r\n')
                     .encode() + file_bytes + f"\r\n--{b}--\r\n".encode())
        return norm(*self.send("POST", f"/{bucket}", b"".join(parts),
                               {"Content-Type": f"multipart/form-data; boundary={b}"}))

    # ------------------------------------------------------------ state

    def tree(self, root: str = "/buckets") -> list:
        """Every entry under `root`: path, kind, mime, size, md5, chunk
        count, extended attributes (less the filer's own `sw-mts`) and
        the sha256 of what the filer reads."""
        out, stack = [], [root]
        while stack:
            d = stack.pop()
            for e in self.filer.list_entries(d, limit=100_000):
                ext = sorted((k, bytes(v)) for k, v in e.extended.items() if k != "sw-mts")
                data = None if e.is_directory else sha(self.filer.read_entry(e))
                out.append((e.full_path, e.is_directory, e.attr.mime, e.file_size,
                            bytes(e.attr.md5).hex(), len(e.chunks), ext, data))
                if e.is_directory:
                    stack.append(e.full_path)
        return sorted(out)

    def kv(self) -> dict:
        return dict(self.filer.store._kv)

    def stop(self):
        self.s3.stop()
        self.filer.close()
        self.vs.stop()
        self.master.stop()


def run_scenario(root, steps, after=None, **side_kw) -> dict:
    """{side: {step: (answers, tree, kv) or the exception}} of `steps`
    ((name, fn(side)) pairs), each step run on the JAX side, then on the
    port side; under "after", what `after(sides)` returns before the
    sides stop."""
    mp = pytest.MonkeyPatch()
    sides = {}
    out: dict = {name: {} for name in PKGS}
    try:
        for name in PKGS:
            (root / name).mkdir()
            sides[name] = Side(name, root / name, mp, **side_kw)
        for step, fn in steps:
            for name, side in sides.items():
                try:
                    out[name][step] = (fn(side), side.tree(), side.kv())
                except Exception as e:  # noqa: BLE001 — compared, and shown
                    out[name][step] = ("raised", repr(e))
        if after is not None:
            out["after"] = after(sides)
        return out
    finally:
        for s in sides.values():
            s.stop()
        mp.undo()


def ssec_headers(key: bytes, prefix: str = "x-amz-server-side-encryption-customer-") -> dict:
    return {f"{prefix}algorithm": "AES256", f"{prefix}key": base64.b64encode(key).decode(),
            f"{prefix}key-MD5": base64.b64encode(hashlib.md5(key).digest()).decode()}


def http_date(dt: datetime) -> str:
    return dt.astimezone(timezone.utc).strftime("%a, %d %b %Y %H:%M:%S GMT")


def seeded_bytes(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)
