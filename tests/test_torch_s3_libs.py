"""PyTorch port: S3's libraries (seaweedfs_tpu_torch/s3: auth, chunked,
post_policy, config, versioning, sse), held against the JAX package on
the CPU.

Inputs come from a numpy seed and go through the JAX function and its
port twin; every comparison is exact (tolerance 0):

- SigV4: `sign_v4` and `signing_key` byte-identical; `verify_v4_ex`'s
  verdicts and error codes equal under seeded tamperings, for presigned
  URLs and at the clock-skew edges (both modules' clocks pinned), memo
  hits included;
- aws-chunked: encodings byte-identical, each package decodes the
  other's, a tampered chunk or trailer refused with the same code;
- POST forms: `parse_multipart_form` equal (payloads ending in CR/LF
  included), signature and policy-document verdicts equal;
- config: `FilerIdentityStore` over a port and a JAX `Filer` holding the
  same KV bytes, `load_s3_config` on seeded files and on files with
  `oidc` / `ldap` blocks (the providers it builds, or its refusal);
- versioning: twin filers run one versioning sequence (retention and
  legal hold included), the trees and `iter_versions` equal with the
  filer's clock masked;
- SSE: ciphertexts cross-decrypt; with the randomness pinned
  `encrypt_for_put` is byte-identical, attributes and headers included;
  ranges decrypt alike; each keyring unwraps the other's keys; without
  `cryptography` both raise the same `SseError`.
"""

import base64
import dataclasses
import hashlib
import hmac
import json
import os
import time
import types
import urllib.parse
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import seaweedfs_tpu.s3.auth as jax_auth
import seaweedfs_tpu.s3.chunked as jax_chunked
import seaweedfs_tpu.s3.config as jax_config
import seaweedfs_tpu.s3.post_policy as jax_pp
import seaweedfs_tpu.s3.sse as jax_sse
import seaweedfs_tpu.s3.versioning as jax_ver
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.filer import MemoryStore as JaxMemoryStore
from seaweedfs_tpu.iam import sts as jax_sts
import seaweedfs_tpu_torch.s3 as port_s3
import seaweedfs_tpu_torch.s3.auth as port_auth
import seaweedfs_tpu_torch.s3.chunked as port_chunked
import seaweedfs_tpu_torch.s3.config as port_config
import seaweedfs_tpu_torch.s3.post_policy as port_pp
import seaweedfs_tpu_torch.s3.sse as port_sse
import seaweedfs_tpu_torch.s3.versioning as port_ver
from seaweedfs_tpu_torch.filer import Filer, MemoryStore
from seaweedfs_tpu_torch.iam import sts as port_sts
from seaweedfs_tpu_torch.utils import metrics as M

AUTH = (jax_auth, port_auth)
NOW = datetime(2026, 5, 4, 12, 30, 15, tzinfo=timezone.utc)


def _outcome(fn, *args, **kwargs):
    """("ok", value) or the refusal: its type, S3 code and message."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 — the refusal is compared
        return (type(e).__name__, getattr(e, "code", None), str(e))


class Frozen(datetime):
    """`datetime` whose now() is NOW: the modules' clocks, pinned."""

    @classmethod
    def now(cls, tz=None):
        return NOW if tz is not None else NOW.replace(tzinfo=None)


@pytest.fixture
def frozen(monkeypatch):
    for mod in AUTH:
        monkeypatch.setattr(mod, "datetime", Frozen)
    for mod in (jax_pp, port_pp):
        monkeypatch.setattr(mod, "_dt", types.SimpleNamespace(datetime=Frozen, timezone=timezone))
    for mod in AUTH:
        mod.auth_cache_clear()
    yield
    for mod in AUTH:
        mod.auth_cache_clear()


def _amz(dt: datetime) -> str:
    return dt.strftime("%Y%m%dT%H%M%SZ")


# ----------------------------------------------------------------- SigV4


PATHS = ["/", "/b", "/b/k.txt", "/b/dir/a b.txt", "/b/ünï/ç%2F.bin", "/b/x~y_z-1.2", "/b/a+b=c"]
QUERIES = ["", "uploads", "partNumber=2&uploadId=abc", "list-type=2&prefix=a%20b&max-keys=5",
           "b=2&a=1&a=0", "tagging", "versionId=3%2B4"]


def _request(rng) -> dict:
    headers = {"Host": f"127.0.0.1:{int(rng.integers(1000, 9999))}"}
    if rng.random() < 0.5:
        headers["Content-Type"] = "  text/plain;   charset=utf-8 "
    if rng.random() < 0.3:
        headers["x-amz-meta-Note"] = "a  b\tc"
    body = rng.bytes(int(rng.integers(0, 300)))
    return {
        "method": str(rng.choice(["GET", "PUT", "HEAD", "DELETE", "POST"])),
        "path": str(rng.choice(PATHS)),
        "query": str(rng.choice(QUERIES)),
        "headers": headers,
        "payload_hash": (hashlib.sha256(body).hexdigest() if rng.random() < 0.7
                         else str(rng.choice(["UNSIGNED-PAYLOAD",
                                              "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"]))),
        "region": str(rng.choice(["us-east-1", "eu-west-2"])),
    }


@pytest.mark.parametrize("memo", ["2048", "0"])
def test_sign_v4_and_signing_key_are_byte_identical(frozen, monkeypatch, memo):
    monkeypatch.setenv("SEAWEED_S3_AUTH_MEMO", memo)
    rng = np.random.default_rng(11)
    for _ in range(200):
        r = _request(rng)
        secret = base64.b64encode(rng.bytes(30)).decode()
        date = _amz(NOW - timedelta(seconds=int(rng.integers(0, 10**6))))
        signed = [m.sign_v4(r["method"], r["path"], r["query"], access_key="AK", secret_key=secret,
                            headers=r["headers"], payload_hash=r["payload_hash"],
                            region=r["region"], amz_date=date) for m in AUTH]
        assert signed[0] == signed[1]
        keys = [m.signing_key(secret, date[:8], r["region"], s) for m in AUTH for s in ("s3", "sts")]
        assert keys[:2] == keys[2:]
    # without amz_date both sign at their (pinned) now
    assert (jax_auth.sign_v4("GET", "/", access_key="a", secret_key="s", payload_hash="x")
            == port_auth.sign_v4("GET", "/", access_key="a", secret_key="s", payload_hash="x"))
    assert jax_auth.auth_cache_stats() == port_auth.auth_cache_stats()
    for q in QUERIES + ["X-Amz-Signature=zz&a=1", "=x&&b"]:
        for drop in (None, "X-Amz-Signature"):
            assert port_auth.canonical_query(q, drop) == jax_auth.canonical_query(q, drop)
    for p in PATHS:
        assert port_auth.canonical_uri(p) == jax_auth.canonical_uri(p)


def _stores():
    """One identity store per package: two users, one STS credential."""
    out = []
    for m, sts_mod in ((jax_auth, jax_sts), (port_auth, port_sts)):
        sts = sts_mod.StsService()
        sts.put_role(sts_mod.Role("up", policies=[{"Statement": []}]))
        cred = sts_mod.TempCredential("ASIATEMP", "tempsecret", "tok-123", sts.get_role("up"),
                                      expires_at=time.time() + 3600)
        sts._creds[cred.access_key] = cred
        store = m.IdentityStore(sts=sts)
        store.add(m.Identity("ann", "AKANN", "secret/ann+1"))
        store.add(m.Identity("bob", "AKBOB", "bobsecret", actions=("Read",)))
        out.append(store)
    return out


def _ctx(c):
    return None if c is None else dataclasses.astuple(c)


def _verdict(m, store, req):
    r = _outcome(m.verify_v4_ex, store, req["method"], req["path"], req["query"], req["headers"],
                 req["payload_hash"])
    if r[0] == "ok":
        ident, ctx = r[1]
        return ("ok", dataclasses.astuple(ident), _ctx(ctx))
    return r


TAMPERINGS = ["none", "method", "path", "query", "signed_header", "unsigned_header",
              "signature", "unknown_key", "scheme", "malformed", "skew+900", "skew+901",
              "skew-900", "skew-901", "bad_date", "date_header", "no_auth", "payload", "token_ok",
              "token_missing", "token_wrong"]


def _tampered(rng, kind: str) -> tuple[dict, str]:
    r = _request(rng)
    ak, sk = ("ASIATEMP", "tempsecret") if kind.startswith("token") else ("AKANN", "secret/ann+1")
    when = NOW
    if kind.startswith("skew"):
        when = NOW + timedelta(seconds=int(kind[4:]))
    h = port_auth.sign_v4(r["method"], r["path"], r["query"], access_key=ak, secret_key=sk,
                          headers=r["headers"], payload_hash=r["payload_hash"],
                          region=r["region"], amz_date=_amz(when))
    if kind == "method":
        r["method"] = "PATCH"
    elif kind == "path":
        r["path"] += "x"
    elif kind == "query":
        r["query"] += "&extra=1"
    elif kind == "signed_header":
        h["host"] += "0"
    elif kind == "unsigned_header":
        h["x-unsigned"] = "whatever"
    elif kind == "signature":
        sig = h["Authorization"][-64:]
        flip = "0" if sig[7] != "0" else "1"
        h["Authorization"] = h["Authorization"][:-64] + sig[:7] + flip + sig[8:]
    elif kind == "unknown_key":
        h["Authorization"] = h["Authorization"].replace("Credential=AKANN/", "Credential=AKZED/")
    elif kind == "scheme":
        h["Authorization"] = "AWS AKANN:abc"
    elif kind == "malformed":
        h["Authorization"] = h["Authorization"].split(", Signature=")[0]
    elif kind == "bad_date":
        h["x-amz-date"] = _amz(NOW)[:-1] + "X"
    elif kind == "date_header":
        h["Date"] = h.pop("x-amz-date")
    elif kind == "no_auth":
        del h["Authorization"]
    elif kind == "payload":
        r["payload_hash"] = hashlib.sha256(b"other").hexdigest()
    elif kind == "token_ok":
        h["x-amz-security-token"] = "tok-123"
    elif kind == "token_wrong":
        h["x-amz-security-token"] = "tok-124"
    # a header dict with case-insensitive reads, as the servers hand over
    r["headers"] = Caseless(h)
    return r, kind


class Caseless(dict):
    def __init__(self, d):
        super().__init__({k.lower(): v for k, v in d.items()})

    def get(self, k, default=None):
        return super().get(k.lower(), default)


@pytest.mark.parametrize("memo", ["2048", "0"])
def test_verify_v4_verdicts_equal_under_seeded_tampering(frozen, monkeypatch, memo):
    monkeypatch.setenv("SEAWEED_S3_AUTH_MEMO", memo)
    stores = _stores()
    rng = np.random.default_rng(12)
    codes = {}
    before = {r: M.s3_auth_memo_total.snapshot().get((r,), 0.0) for r in ("hit", "miss", "bypass")}
    for i in range(3 * len(TAMPERINGS)):
        req, kind = _tampered(rng, TAMPERINGS[i % len(TAMPERINGS)])
        # twice: the second verification of a good request is a memo hit
        got = [[_verdict(m, s, req) for _ in range(2)] for m, s in zip(AUTH, stores)]
        assert got[0] == got[1], (kind, req)
        assert got[1][0] == got[1][1]
        codes.setdefault(kind, set()).add(got[1][0][0] if got[1][0][0] == "ok" else got[1][0][1])
    assert codes["none"] == codes["unsigned_header"] == codes["skew+900"] == {"ok"}
    assert codes["skew-900"] == codes["token_ok"] == {"ok"}
    assert codes["skew+901"] == codes["skew-901"] == {"RequestTimeTooSkewed"}
    # x-amz-date is a signed header: read from `Date`, its line is empty
    assert codes["signature"] == codes["signed_header"] == codes["date_header"] == {
        "SignatureDoesNotMatch"}
    assert codes["unknown_key"] == {"InvalidAccessKeyId"}
    assert codes["malformed"] == {"AuthorizationHeaderMalformed"}
    assert codes["token_missing"] == codes["token_wrong"] == {"InvalidToken"}
    assert codes["no_auth"] == codes["scheme"] == codes["bad_date"] == {"AccessDenied"}
    moved = {r: M.s3_auth_memo_total.snapshot().get((r,), 0.0) - before[r] for r in before}
    if memo == "0":
        assert moved["hit"] == moved["miss"] == 0 and moved["bypass"] > 0
    else:
        assert moved["hit"] > 0 and moved["miss"] > 0
    assert jax_auth.auth_cache_stats() == port_auth.auth_cache_stats()


def _presign(method, path, ak, sk, when, expires, query="", token="", host="h:1",
             region="us-east-1"):
    """A presigned URL's query, signed as an SDK signs it."""
    date = _amz(when)
    q = {"X-Amz-Algorithm": "AWS4-HMAC-SHA256",
         "X-Amz-Credential": f"{ak}/{date[:8]}/{region}/s3/aws4_request",
         "X-Amz-Date": date, "X-Amz-Expires": str(expires), "X-Amz-SignedHeaders": "host"}
    if token:
        q["X-Amz-Security-Token"] = token
    qs = urllib.parse.urlencode(q, quote_via=urllib.parse.quote) + (f"&{query}" if query else "")
    creq = "\n".join([method, jax_auth.canonical_uri(path), jax_auth.canonical_query(qs),
                      f"host:{host}\n", "host", "UNSIGNED-PAYLOAD"])
    sts = "\n".join(["AWS4-HMAC-SHA256", date, f"{date[:8]}/{region}/s3/aws4_request",
                     hashlib.sha256(creq.encode()).hexdigest()])
    k = ("AWS4" + sk).encode()
    for part in (date[:8], region, "s3", "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    sig = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
    return qs + f"&X-Amz-Signature={sig}"


def test_presigned_urls_verify_alike(frozen):
    stores = _stores()
    hdr = Caseless({"Host": "h:1"})
    cases = []
    for expires, age in ((3600, 0), (3600, 3600), (3600, 3601), (1, 2), (604800, 604800),
                         (0, 0), (604801, 0), (60, -30)):
        cases.append(("GET", "/b/k", _presign("GET", "/b/k", "AKANN", "secret/ann+1",
                                              NOW - timedelta(seconds=age), expires)))
    good = _presign("PUT", "/b/a b", "AKBOB", "bobsecret", NOW, 300, query="partNumber=1")
    cases += [
        ("PUT", "/b/a b", good),
        ("PUT", "/b/a c", good),
        ("GET", "/b/a b", good),
        ("PUT", "/b/a b", good.replace("partNumber=1", "partNumber=2")),
        ("PUT", "/b/a b", good[:-1] + ("0" if good[-1] != "0" else "1")),
        ("GET", "/b/k", _presign("GET", "/b/k", "AKZED", "x", NOW, 60)),
        ("GET", "/b/k", _presign("GET", "/b/k", "AKANN", "secret/ann+1", NOW, 60).replace(
            "X-Amz-Date=", "X-Amz-Date=2")),
        ("GET", "/b/k", _presign("GET", "/b/k", "AKANN", "secret/ann+1", NOW, 60).replace(
            "X-Amz-Expires=60", "X-Amz-Expires=sixty")),
        ("GET", "/b/k", "X-Amz-Signature=abc"),
        ("GET", "/b/k", _presign("GET", "/b/k", "ASIATEMP", "tempsecret", NOW, 60,
                                 token="tok-123")),
        ("GET", "/b/k", _presign("GET", "/b/k", "ASIATEMP", "tempsecret", NOW, 60)),
        ("GET", "/b/k", "a=1"),
    ]
    got = [[_verdict(m, s, {"method": meth, "path": path, "query": q, "headers": hdr,
                            "payload_hash": "UNSIGNED-PAYLOAD"}) for meth, path, q in cases]
           for m, s in zip(AUTH, stores)]
    assert got[0] == got[1]
    assert [g[0] if g[0] == "ok" else g[1] for g in got[1]] == [
        "ok", "ok", "AccessDenied", "AccessDenied", "ok", "AuthorizationQueryParametersError",
        "AuthorizationQueryParametersError", "ok", "ok", "SignatureDoesNotMatch",
        "SignatureDoesNotMatch", "SignatureDoesNotMatch", "SignatureDoesNotMatch",
        "InvalidAccessKeyId", "AuthorizationQueryParametersError",
        "AuthorizationQueryParametersError", "AuthorizationQueryParametersError", "ok",
        "InvalidToken", "AccessDenied"]


def _signing_ctx(m, seed: int):
    rng = np.random.default_rng(seed)
    return m.SigningContext(signing_key=rng.bytes(32), amz_date=_amz(NOW),
                            scope="20260504/us-east-1/s3/aws4_request",
                            seed_signature=rng.bytes(32).hex())


def test_chunk_and_trailer_signatures_equal():
    rng = np.random.default_rng(13)
    for i in range(50):
        ctxs = [_signing_ctx(m, i) for m in AUTH]
        prev, data = rng.bytes(32).hex(), rng.bytes(int(rng.integers(0, 5000)))
        assert (jax_auth.verify_chunk_signature(ctxs[0], prev, data)
                == port_auth.verify_chunk_signature(ctxs[1], prev, data))
        assert (jax_auth.verify_trailer_signature(ctxs[0], prev, data)
                == port_auth.verify_trailer_signature(ctxs[1], prev, data))


def test_identity_and_store_surfaces_equal():
    ids = [m.Identity("x", "AK", "SK", actions=("Read", "List")) for m in AUTH]
    for action in ("Read", "Write", "Admin", "List"):
        assert ids[0].allows(action) == ids[1].allows(action)
    stores = _stores()
    for ak in ("AKANN", "AKBOB", "ASIATEMP", "AKZED"):
        got = [s.lookup(ak) for s in stores]
        assert (None if got[0] is None else dataclasses.astuple(got[0])) == (
            None if got[1] is None else dataclasses.astuple(got[1]))
    assert [s.empty for s in stores] == [False, False]
    assert [m.IdentityStore().allow_anonymous for m in AUTH] == [True, True]
    assert (port_s3.Identity, port_s3.IdentityStore, port_s3.S3AuthError) == (
        port_auth.Identity, port_auth.IdentityStore, port_auth.S3AuthError)


# ------------------------------------------------------------ aws-chunked


@pytest.mark.parametrize("seed", range(3))
def test_aws_chunked_encodings_are_byte_identical_and_cross_decode(seed):
    rng = np.random.default_rng(20 + seed)
    mods = (jax_chunked, port_chunked)
    for i in range(12):
        ctxs = [_signing_ctx(m, 100 * seed + i) for m in AUTH]
        data = rng.bytes(int(rng.integers(0, 200_000)))
        size = int(rng.choice([61, 1000, 8192, 64 * 1024]))
        enc = [m.encode_aws_chunked(data, c, chunk_size=size) for m, c in zip(mods, ctxs)]
        assert enc[0] == enc[1]
        for dec, ctx in zip(mods, ctxs):
            for body in enc:
                assert dec.decode_aws_chunked(body, ctx, signed=True) == data
                assert dec.decode_aws_chunked(body) == data  # framing only


def _trailer(ctx, prev_sig: str, fields: list[tuple[bytes, bytes]], sign: bool, tamper=False):
    canonical = b"".join(k.lower() + b":" + v + b"\n" for k, v in fields)
    lines = [k + b":" + v for k, v in fields]
    if sign:
        sig = jax_auth.verify_trailer_signature(ctx, prev_sig, canonical)
        if tamper:
            sig = sig[:-1] + ("0" if sig[-1] != "0" else "1")
        lines.append(b"x-amz-trailer-signature:" + sig.encode())
    return b"\r\n".join(lines) + b"\r\n\r\n"


def test_aws_chunked_refusals_equal():
    ctxs = [_signing_ctx(m, 7) for m in AUTH]
    data = np.random.default_rng(21).bytes(50_000)
    good = port_chunked.encode_aws_chunked(data, ctxs[1], chunk_size=16_384)
    last_sig = good.rsplit(b"chunk-signature=", 1)[1][:64].decode()
    flip = bytearray(good)
    flip[good.index(b"\r\n") + 2 + 100] ^= 1
    bodies = {
        "good": good,
        "flipped": bytes(flip),
        "no_final": good[: good.rindex(b"0;chunk-signature=")],
        "truncated": good[:20_000],
        "bad_header": b"zz;chunk-signature=ab\r\nhello\r\n",
        "no_signature": good.replace(b";chunk-signature=", b";chunk-sig=", 1),
        "trailer": good + _trailer(ctxs[0], last_sig, [(b"x-amz-checksum-crc32", b"AAAA")], True),
        "trailer_bad": good + _trailer(ctxs[0], last_sig, [(b"x-amz-checksum-crc32", b"AAAA")],
                                       True, tamper=True),
        "trailer_unsigned": good + _trailer(ctxs[0], last_sig, [(b"X-Amz-Checksum-Sha256",
                                                                 b" x ")], False),
    }
    for name, body in bodies.items():
        for signed in (True, False):
            got = [_outcome(m.decode_aws_chunked, body, c, signed)
                   for m, c in zip((jax_chunked, port_chunked), ctxs)]
            assert got[0] == got[1], (name, signed)
    codes = {name: _outcome(port_chunked.decode_aws_chunked, b, ctxs[1], True)
             for name, b in bodies.items()}
    codes = {name: None if r[0] == "ok" else r[1] for name, r in codes.items()}
    assert codes == {"good": None, "flipped": "SignatureDoesNotMatch", "no_final": "IncompleteBody",
                     "truncated": "IncompleteBody", "bad_header": "InvalidRequest",
                     "no_signature": "AccessDenied", "trailer": None,
                     "trailer_bad": "SignatureDoesNotMatch", "trailer_unsigned": None}


# ------------------------------------------------------------- POST forms


def _form(parts: list[tuple[str, bytes, str]], boundary: str = "XyZ") -> bytes:
    out = b"preamble\r\n"
    for name, payload, fname in parts:
        disp = f'form-data; name="{name}"' + (f'; filename="{fname}"' if fname else "")
        out += (f"--{boundary}\r\nContent-Disposition: {disp}\r\n"
                f"Content-Type: application/octet-stream\r\n\r\n").encode() + payload + b"\r\n"
    return out + f"--{boundary}--\r\nepilogue".encode()


def test_parse_multipart_form_equal():
    rng = np.random.default_rng(30)
    forms = []
    for i in range(30):
        tail = [b"", b"\r\n", b"\n", b"\r", b"\r\n\r\n", b"--"][i % 6]
        parts = [("key", f"k/{i}.bin".encode(), ""), ("X-Amz-Meta-Tag", b"v\r\n", ""),
                 ("file", rng.bytes(int(rng.integers(0, 3000))) + tail, f"f{i}.bin"),
                 ("after", b"ignored?", "")]
        if i % 4 == 1:
            parts.insert(0, ("", b"nameless", ""))
        if i % 5 == 2:
            parts.append(("file", b"second file", "two"))
        forms.append((_form(parts), "multipart/form-data; boundary=XyZ"))
    forms += [
        (_form([("key", b"k", "")]), "multipart/form-data; boundary=XyZ"),
        (_form([("file", b"x", "")]), "multipart/form-data"),
        (_form([("file", b"x", "q")], boundary="a b"), 'multipart/form-data; boundary="a b"'),
        (b"", "multipart/form-data; boundary=XyZ"),
    ]
    for body, ctype in forms:
        got = [_outcome(m.parse_multipart_form, body, ctype) for m in (jax_pp, port_pp)]
        assert got[0] == got[1], body[:80]


def _post_fields(sk: str, ak: str = "AKANN", when: datetime = NOW, conditions=None,
                 expiration: str | None = None, extra: dict | None = None, region="us-east-1"):
    doc = {"conditions": conditions if conditions is not None else
           [{"bucket": "b"}, ["starts-with", "$key", "up/"], ["content-length-range", 1, 1000]]}
    if expiration is not False:
        doc["expiration"] = expiration or (NOW + timedelta(hours=1)).isoformat().replace(
            "+00:00", "Z")
    policy = base64.b64encode(json.dumps(doc).encode()).decode()
    date = _amz(when)[:8]
    k = ("AWS4" + sk).encode()
    for part in (date, region, "s3", "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    fields = {"key": "up/a.txt", "policy": policy, "x-amz-algorithm": "AWS4-HMAC-SHA256",
              "x-amz-credential": f"{ak}/{date}/{region}/s3/aws4_request",
              "x-amz-signature": hmac.new(k, policy.encode(), "sha256").hexdigest()}
    fields.update(extra or {})
    return fields


def test_post_signature_and_policy_verdicts_equal(frozen):
    stores = _stores()
    cases = [
        _post_fields("secret/ann+1"),
        _post_fields("wrong"),
        _post_fields("x", ak="AKZED"),
        _post_fields("secret/ann+1", extra={"x-amz-algorithm": "AWS4-HMAC-SHA1"}),
        _post_fields("secret/ann+1", extra={"x-amz-credential": "AKANN/20260504/us-east-1/s3"}),
        _post_fields("secret/ann+1", extra={"x-amz-credential":
                                            "AKANN/20260504/us-east-1/ec2/aws4_request"}),
        _post_fields("secret/ann+1", extra={"policy": ""}),
        _post_fields("secret/ann+1", expiration=(NOW - timedelta(seconds=1)).isoformat()),
        _post_fields("secret/ann+1", expiration=NOW.isoformat()),
        _post_fields("secret/ann+1", expiration="tomorrow"),
        _post_fields("secret/ann+1", expiration=False),
        _post_fields("secret/ann+1", extra={"acl": "public-read"}),
        _post_fields("secret/ann+1", extra={"x-ignore-me": "1"}),
        _post_fields("secret/ann+1", conditions=[{"bucket": "b"}, {"key": "up/a.txt"},
                                                 ["eq", "$acl", "private"]],
                     extra={"acl": "private"}),
        _post_fields("secret/ann+1", conditions=[{"bucket": "other"}, ["starts-with", "$key", ""]]),
        _post_fields("secret/ann+1", conditions=[["eq", "$key", "up/b.txt"]]),
        _post_fields("secret/ann+1", conditions=[["starts-with", "$key", "down/"]]),
        _post_fields("secret/ann+1", conditions=[["starts-with", "$key", ""], "junk"]),
        _post_fields("secret/ann+1", conditions=[["starts-with", "$key", ""],
                                                 ["content-length-range", 100, 200]]),
        _post_fields("secret/ann+1", conditions=[["starts-with", "$key", ""],
                                                 ["content-length-range", 1, 10]]),
        _post_fields("bobsecret", ak="AKBOB", region="eu-west-2"),
        {**_post_fields("secret/ann+1"), "policy": "!!notbase64"},
    ]
    for i, fields in enumerate(cases):
        sig = [_outcome(m.verify_post_signature, s, fields, "us-east-1")
               for m, s in zip((jax_pp, port_pp), stores)]
        sig = [s if s[0] != "ok" else ("ok", dataclasses.astuple(s[1])) for s in sig]
        assert sig[0] == sig[1], i
        for size in (0, 50, 150, 1000, 1001):
            got = [_outcome(m.check_policy_document, fields, size, "b", fields.get("key", ""))
                   for m in (jax_pp, port_pp)]
            assert got[0] == got[1], (i, size)


# ----------------------------------------------------------------- config


def _filers():
    return [JaxFiler(JaxMemoryStore(), master="127.0.0.1:1"),
            Filer(MemoryStore(), master="127.0.0.1:1")]


def _ident(i):
    return None if i is None else dataclasses.astuple(i)


def test_filer_identity_store_reads_the_same_kv_alike():
    filers = _filers()
    stores = [m.FilerIdentityStore(f, ttl=0.0) for m, f in zip((jax_config, port_config), filers)]
    rng = np.random.default_rng(40)
    assert [s.empty for s in stores] == [True, True]
    blobs = [b"", b"{not json", json.dumps({"identities": []}).encode()]
    for n in range(6):
        idents = []
        for j in range(int(rng.integers(1, 6))):
            ident = {"name": f"u{n}{j}", "accessKey": f"AK{n}{j}", "secretKey": f"SK{j}" * 3}
            r = rng.random()
            if r < 0.2:
                ident["accessKey"] = ""  # a user without a key
            elif r < 0.3:
                del ident["secretKey"]  # unusable: skipped
            elif r < 0.5:
                ident["policies"] = [{"Statement": [{"Effect": "Allow", "Action": "s3:*"}]}]
            elif r < 0.7:
                ident["actions"] = ["Read", "List"]
            if rng.random() < 0.2:
                del ident["name"]
            idents.append(ident)
        blobs.append(json.dumps({"identities": idents}).encode())
    for blob in blobs:
        for f in filers:
            f.store.kv_put(port_config.S3_IDENTITY_KV, blob)
        for n in range(6):
            for j in range(6):
                got = [_ident(s.lookup(f"AK{n}{j}")) for s in stores]
                assert got[0] == got[1], (blob, n, j)
        assert stores[0].empty == stores[1].empty
    # a static base over the dynamic view; the sts setter reaches the base
    bases = _stores()
    layered = [m.FilerIdentityStore(f, base=b, ttl=0.0)
               for m, f, b in zip((jax_config, port_config), filers, bases)]
    for ak in ("AKANN", "ASIATEMP", "AK50", "AKZED"):
        assert _ident(layered[0].lookup(ak)) == _ident(layered[1].lookup(ak))
    for s in layered:
        s.sts = None
    assert [_ident(s.lookup("ASIATEMP")) for s in layered] == [None, None]
    assert port_config.S3_IDENTITY_KV == jax_config.S3_IDENTITY_KV
    for f in filers:
        f.close() if hasattr(f, "close") else None


def test_mint_key_pair_is_the_jax_format(monkeypatch):
    import random
    import secrets

    outs = []
    for m in (jax_config, port_config):
        rng = random.Random(5)
        monkeypatch.setattr(secrets, "token_hex", lambda n: rng.randbytes(n).hex())
        monkeypatch.setattr(secrets, "token_urlsafe", lambda n: rng.randbytes(n).hex())
        outs.append(m.mint_key_pair())
    assert outs[0] == outs[1] and outs[0][0].startswith("SW") and len(outs[0][0]) == 20


def _loaded(res):
    store, sts, oidc, ldap = res
    idents = {k: dataclasses.astuple(v) for k, v in store._by_access_key.items()}
    roles = None if sts is None else {k: (r.name, r.policies, r.trusted, r.arn)
                                      for k, r in sts._roles.items()}
    return (idents, store.allow_anonymous, roles, store.sts is sts, _provider(oidc),
            _provider(ldap))


def _provider(p):
    """An OIDC or LDAP provider by what it was built from."""
    if p is None:
        return None
    if hasattr(p, "verify"):
        rs = None if p._rs_key is None else p._rs_key.public_numbers()
        return ("oidc", p.issuer, p.audience, p.role_claim, p.roles, p.clock_skew, p._hs_secret,
                None if rs is None else (rs.n, rs.e))
    return ("ldap", p.host, p.port, p.bind_dn_template, p.timeout)


def test_load_s3_config_equal_on_seeded_files(tmp_path):
    rng = np.random.default_rng(41)
    confs = [{"identities": []},
             {"roles": [{"name": "r"}]},
             {"identities": [{"accessKey": "A", "secretKey": "S"}],
              "roles": [{"name": "r", "trusted": ["A"], "policies": [{"Statement": []}]}]}]
    for n in range(8):
        conf = {"identities": [{"name": f"u{j}", "accessKey": f"A{n}{j}", "secretKey": f"S{j}",
                                "actions": ["Read"] if rng.random() < 0.5 else []}
                               for j in range(int(rng.integers(0, 4)))]}
        if rng.random() < 0.5:
            conf["roles"] = [{"name": f"role{j}", "policies": [{"Statement": []}]}
                             for j in range(int(rng.integers(1, 3)))]
        confs.append(conf)
    confs.append({"identities": [{"name": "x"}]})  # no accessKey: KeyError in both
    for i, conf in enumerate(confs):
        path = tmp_path / f"c{i}.json"
        path.write_text(json.dumps(conf))
        got = [_outcome(m.load_s3_config, str(path)) for m in (jax_config, port_config)]
        got = [("ok", _loaded(g[1])) if g[0] == "ok" else g for g in got]
        assert got[0] == got[1], conf


def _rsa_pem(seed: int) -> str:
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=1024 + 64 * seed)
    return key.public_key().public_bytes(serialization.Encoding.PEM,
                                         serialization.PublicFormat.SubjectPublicKeyInfo).decode()


OIDC_BLOCKS = [
    {"issuer": "https://x", "hs256_secret": "s3cret"},
    {"issuer": "https://x", "audience": "sw", "hs256_secret": "k", "role_claim": "groups",
     "roles": {"reader": {"actions": ["Read", "List"]}}, "clock_skew": 5},
    {"issuer": "https://x"},  # no key: refused alike
    {"issuer": "https://x", "rs256_public_key_pem": "not a pem"},
    {"issuer": "https://x", "hs256_secret": "k", "bogus": 1},
]
LDAP_BLOCKS = [
    {"server": "ldap://127.0.0.1:3389", "bind_dn_template": "uid={username},dc=x"},
    {"server": "localhost", "bind_dn_template": "cn={username}", "timeout": 2.5},
    {"server": "ldaps://idp:636", "bind_dn_template": "cn={username}"},
    {"server": "ldap://h:1"},  # no template: TypeError alike
]


@pytest.mark.parametrize("provider", ["oidc", "ldap"])
def test_load_s3_config_names_item_13c_for_oidc_and_ldap(tmp_path, provider):
    """`load_s3_config` with an `oidc` or an `ldap` block (the providers
    once refused with a message naming item 13c): the same store, roles
    and provider, or the same refusal, from each package."""
    blocks = list(OIDC_BLOCKS if provider == "oidc" else LDAP_BLOCKS)
    if provider == "oidc":
        blocks.append({"issuer": "https://x", "rs256_public_key_pem": _rsa_pem(1)})
    ident = [{"accessKey": "A", "secretKey": "S"}]
    roles = [{"name": "r"}]
    confs = []
    for block in blocks:
        confs += [{"identities": ident, "roles": roles, provider: block},
                  {"identities": ident, provider: block},
                  {"roles": roles, provider: block}, {provider: block}]
    kinds = set()
    for i, conf in enumerate(confs):
        path = tmp_path / f"s3-{i}.json"
        path.write_text(json.dumps(conf))
        got = [_outcome(m.load_s3_config, str(path)) for m in (jax_config, port_config)]
        got = [("ok", _loaded(g[1])) if g[0] == "ok" else g for g in got]
        assert got[0] == got[1], conf
        kinds.add(got[1][0])
    assert {"ok", "ValueError", "TypeError"} <= kinds, kinds


# ------------------------------------------------------------- versioning


class Pinned:
    """time.time / time.time_ns and os.urandom from one settable clock and
    one seeded stream, restarted for each package's run."""

    def __init__(self, monkeypatch):
        self.restart(0)
        monkeypatch.setattr(time, "time", lambda: self.now)
        monkeypatch.setattr(time, "time_ns", lambda: int(self.now * 1e9))
        monkeypatch.setattr(os, "urandom", lambda n: self.rng.bytes(n))

    def restart(self, seed: int) -> None:
        self.now = 1_777_000_000.5
        self.rng = np.random.default_rng(seed)


def _entry(e):
    ext = sorted((k, v) for k, v in e.extended.items() if k != "sw-mts")
    return (e.full_path, e.is_directory, bytes(e.content), e.file_size, ext)


def _tree(filer, root="/buckets"):
    out, stack = [], [root]
    while stack:
        d = stack.pop()
        for e in filer.list_entries(d, limit=100_000):
            out.append(_entry(e))
            if e.is_directory:
                stack.append(e.full_path)
    return sorted(out)


def _versioning_run(mod, filer, clock) -> list:
    clock.restart(51)
    root, b = "/buckets", "vb"
    out = []

    def put(key, body, vid):
        clock.now += 1.25
        filer.write_file(f"{root}/{b}/{key}", body, extended={mod.VID_KEY: vid.encode()})

    for key in ("k", "dir/k2"):
        for i in range(3):
            vid = mod.new_version_id()
            out.append(vid)
            mod.archive_current(filer, root, b, key)
            put(key, f"{key} v{i}".encode() * (i + 1), vid)
    out.append([_entry(e) for e in mod.iter_versions(filer, root, b, "k")])
    clock.now += 1
    out.append(mod.write_delete_marker(filer, root, b, "k", "Enabled"))
    cur = filer.find_entry(f"{root}/{b}/k")
    out.append((mod.entry_vid(cur), mod.is_delete_marker(cur)))
    # the marker removed: the newest noncurrent version comes back
    filer.delete_entry(f"{root}/{b}/k")
    out.append(mod.promote_latest(filer, root, b, "k"))
    out.append(_entry(filer.find_entry(f"{root}/{b}/k")))
    # a suspended bucket: the null version, archived over twice
    out.append(mod.write_delete_marker(filer, root, b, "dir/k2", "Suspended"))
    put("dir/k2", b"null body", "")
    mod.archive_current(filer, root, b, "dir/k2")
    put("dir/k2", b"null body 2", "")
    mod.archive_current(filer, root, b, "dir/k2")
    out.append([_entry(e) for e in mod.iter_versions(filer, root, b, "dir/k2")])
    out.append(mod.promote_latest(filer, root, b, "nokey"))
    mod.archive_current(filer, root, b, "nokey")
    filer.create_entry(filer_new_entry(filer)(f"{root}/{b}/adir", is_directory=True))
    mod.archive_current(filer, root, b, "adir")  # a directory stays
    # retention and legal hold
    e = filer.find_entry(f"{root}/{b}/k")
    now = datetime.fromtimestamp(clock.now, tz=timezone.utc)
    checks = []
    for mode, delta in (("GOVERNANCE", 60), ("COMPLIANCE", 60), ("GOVERNANCE", -60), ("", 60)):
        e.extended.pop(mod.LEGAL_HOLD_KEY, None)
        mod.set_retention(e, mode, now + timedelta(seconds=delta))
        checks.append((mod.get_retention(e), [_outcome(mod.check_deletable, e, bypass)
                                              for bypass in (False, True)]))
    e.extended[mod.LEGAL_HOLD_KEY] = b"ON"
    checks.append((mod.legal_hold(e), _outcome(mod.check_deletable, e, True)))
    e.extended[mod.RETENTION_KEY] = b'{"Mode": "GOVERNANCE", "RetainUntilDate": "2030-01-01T00:00:00"}'
    checks.append(mod.get_retention(e))
    e.extended[mod.RETENTION_KEY] = b"{broken"
    checks.append(mod.get_retention(e))
    out.append(checks)
    for conf in (None, {}, {"DefaultRetention": {}}, {"DefaultRetention": {"Days": 0}},
                 {"DefaultRetention": {"Days": 3, "Mode": "COMPLIANCE"}},
                 {"DefaultRetention": {"Years": 1}}):
        out.append(mod.default_retention_extended(conf))
    out.append(mod.versions_dir(root, b, "/x//y/"))
    out.append(_tree(filer))
    return out


def filer_new_entry(filer):
    if isinstance(filer, Filer):
        from seaweedfs_tpu_torch.filer.entry import new_entry
    else:
        from seaweedfs_tpu.filer.entry import new_entry
    return new_entry


def test_versioning_sequence_equal_on_twin_filers(monkeypatch):
    clock = Pinned(monkeypatch)
    filers = _filers()
    got = [_versioning_run(m, f, clock) for m, f in zip((jax_ver, port_ver), filers)]
    assert got[0] == got[1]
    assert got[1][0] != got[1][1] and got[1][0] > got[1][1]  # newer ids sort first
    assert len(got[1][6]) == 2  # two noncurrent versions of k
    assert (port_ver.VERSIONS_DIR, port_ver.NULL_VID) == (jax_ver.VERSIONS_DIR, jax_ver.NULL_VID)


# -------------------------------------------------------------------- SSE


SSE = (jax_sse, port_sse)


def test_ciphertexts_cross_decrypt():
    rng = np.random.default_rng(60)
    for _ in range(40):
        key, data = rng.bytes(32), rng.bytes(int(rng.integers(0, 100_000)))
        for enc, dec in ((jax_sse, port_sse), (port_sse, jax_sse)):
            iv, ct = enc.encrypt(key, data)
            assert len(ct) == len(data) and dec.decrypt(key, iv, ct) == data


def _put_cases(mod, keyring):
    key = bytes(range(32))
    data = np.random.default_rng(61).bytes(70_001)
    return [_outcome(mod.encrypt_for_put, data, k, algo, ring)
            for k, algo, ring in ((key, "", None), (None, "AES256", keyring),
                                  (None, "aws:kms", keyring), (None, "DES", keyring),
                                  (key, "AES256", keyring), (None, "AES256", None),
                                  (None, "", None))]


def test_encrypt_for_put_is_byte_identical_with_randomness_pinned(monkeypatch):
    clock = Pinned(monkeypatch)
    master = np.random.default_rng(62).bytes(32)
    outs = []
    for mod in SSE:
        clock.restart(63)
        outs.append(_put_cases(mod, mod.LocalKeyring(master)))
    assert outs[0] == outs[1]
    assert [o[0] for o in outs[1]] == ["ok", "ok", "SseError", "SseError", "SseError",
                                      "SseError", "ok"]


def test_ranges_and_part_maps_decrypt_alike():
    rng = np.random.default_rng(64)
    key = rng.bytes(32)
    data = rng.bytes(300_000)
    iv, ct = port_sse.encrypt(key, data)
    single = types.SimpleNamespace(extended={port_sse.SSE_IV_KEY: iv})
    # a multipart object: three parts, each its own CTR stream
    bounds = [0, 70_001, 200_000, 300_000]
    parts, cts = [], []
    for lo, hi in zip(bounds, bounds[1:]):
        piv, pct = jax_sse.encrypt(key, data[lo:hi])
        parts.append([hi - lo, piv.hex()])
        cts.append(pct)
    multi = types.SimpleNamespace(extended={port_sse.SSE_PART_MAP_KEY: json.dumps(parts).encode()})
    mct = b"".join(cts)
    for _ in range(150):
        off = int(rng.integers(0, len(data)))
        size = int(rng.choice([-1, 0, 1, 15, 16, 17, int(rng.integers(0, 100_000))]))
        want = data[off:] if size < 0 else data[off:off + size]
        for entry, blob in ((single, ct), (multi, mct)):
            read = lambda o, n, blob=blob: blob[o:] if n < 0 else blob[o:o + n]  # noqa: E731
            got = [m.read_decrypted(read, entry, key, off, size) for m in SSE]
            assert got[0] == got[1] == want, (off, size)
        aligned = off - off % 16
        got = [m.decrypt_range(key, iv, ct[aligned:aligned + 4096], off) for m in SSE]
        assert got[0] == got[1] == data[off:aligned + 4096]


def test_keyrings_unwrap_each_others_keys(monkeypatch):
    master = np.random.default_rng(65).bytes(32)
    rings = [m.LocalKeyring(master) for m in SSE]
    for wrap, unwrap in ((rings[0], rings[1]), (rings[1], rings[0])):
        kid, dk, wrapped = wrap.generate_data_key()
        assert unwrap.decrypt_data_key(kid, wrapped) == dk
    kid, dk, wrapped = rings[0].generate_data_key()
    bad = bytearray(wrapped)
    bad[20] ^= 1
    for args in ((kid, bytes(bad)), ("other-key", wrapped)):
        got = [_outcome(r.decrypt_data_key, *args) for r in rings]
        assert got[0] == got[1] and got[0][0] == "SseError"
    assert [_outcome(m.LocalKeyring, b"short") for m in SSE][0] == (
        [_outcome(m.LocalKeyring, b"short") for m in SSE][1])
    # the master key in the filers' KV: both adopt the stored key
    filers = _filers()
    for f in filers:
        f.store.kv_put(b"s3-sse/master-key", master)
    rings = [m.load_or_create_keyring(f.store.kv_get, f.store.kv_put, f.store.kv_put_if_absent)
             for m, f in zip(SSE, filers)]
    kid, dk, wrapped = rings[0].generate_data_key()
    assert rings[1].decrypt_data_key(kid, wrapped) == dk
    # created on first boot, and a corrupt stored key overwritten, alike
    clock = Pinned(monkeypatch)
    for setup in (None, b"corrupt"):
        stored = []
        for m in SSE:
            clock.restart(66)
            (f,) = [x for x in _filers() if isinstance(x, Filer) == (m is port_sse)]
            if setup is not None:
                f.store.kv_put(b"s3-sse/master-key", setup)
            m.load_or_create_keyring(f.store.kv_get, f.store.kv_put, f.store.kv_put_if_absent)
            stored.append(f.store.kv_get(b"s3-sse/master-key"))
        assert stored[0] == stored[1] and len(stored[0]) == 32


def test_header_triage_and_entry_keys_equal():
    key = bytes(range(32))
    good = {"x-amz-server-side-encryption-customer-algorithm": "AES256",
            "x-amz-server-side-encryption-customer-key": base64.b64encode(key).decode(),
            "x-amz-server-side-encryption-customer-key-MD5": jax_sse.key_md5_b64(key)}
    variants = [{}, good, {**good, "x-amz-server-side-encryption-customer-algorithm": "AES128"},
                {k: v for k, v in good.items() if not k.endswith("MD5")},
                {**good, "x-amz-server-side-encryption-customer-key": "!!"},
                {**good, "x-amz-server-side-encryption-customer-key":
                 base64.b64encode(key[:16]).decode()},
                {**good, "x-amz-server-side-encryption-customer-key-MD5": "AAAA"},
                {**good, "x-amz-server-side-encryption": "AES256"},
                {"x-amz-server-side-encryption": "aws:kms"},
                {"x-amz-server-side-encryption": "AES256"},
                {"x-amz-server-side-encryption": "rot13"}]
    for h in variants:
        for default in ("", "AES256", "aws:kms"):
            got = [_outcome(m.resolve_put_encryption, h, default) for m in SSE]
            assert got[0] == got[1], (h, default)
        got = [_outcome(m.parse_customer_headers, h) for m in SSE]
        assert got[0] == got[1], h
    ring = port_sse.LocalKeyring(bytes(32))
    kid, dk, wrapped = ring.generate_data_key()
    entries = [
        {},
        {jax_sse.SSE_ALGO_KEY: b"SSE-C", jax_sse.SSE_KEY_MD5_KEY: jax_sse.key_md5_b64(key).encode()},
        {jax_sse.SSE_ALGO_KEY: b"AES256", jax_sse.SSE_KEY_ID_KEY: kid.encode(),
         jax_sse.SSE_WRAPPED_KEY: wrapped},
        {jax_sse.SSE_ALGO_KEY: b"AES256", jax_sse.SSE_KEY_ID_KEY: b"nope",
         jax_sse.SSE_WRAPPED_KEY: wrapped},
        {jax_sse.SSE_ALGO_KEY: b"ROT13"},
    ]
    for ext in entries:
        e = types.SimpleNamespace(extended=ext)
        assert port_sse.response_headers_for_entry(e) == jax_sse.response_headers_for_entry(e)
        assert port_sse.entry_sse_algo(e) == jax_sse.entry_sse_algo(e)
        for ssec in (None, key, bytes(32)):
            for keyring in (None, ring):
                got = [_outcome(m.decrypt_key_for_entry, e, ssec, keyring) for m in SSE]
                assert got[0] == got[1], (ext, ssec, keyring)


def test_without_cryptography_both_raise_the_same_sse_error(monkeypatch):
    for m in SSE:
        for name in ("Cipher", "algorithms", "modes", "AESGCM"):
            monkeypatch.setattr(m, name, None)
    got = []
    for m in SSE:
        ring = m.LocalKeyring(bytes(32))  # constructs: the gateway still boots
        got.append([_outcome(m.encrypt, bytes(32), b"data"),
                    _outcome(m.decrypt_range, bytes(32), bytes(16), b"data", 3),
                    _outcome(ring.generate_data_key), _outcome(ring.decrypt_data_key, "local-0", b"x"),
                    _outcome(m.encrypt_for_put, b"data", bytes(32), "", None),
                    _outcome(m.encrypt_for_put, b"data", None, "", None)])
    assert got[0] == got[1]
    assert got[1][0] == ("SseError", "NotImplemented",
                         "SSE requires the 'cryptography' package (not installed)")
    assert got[1][-1] == ("ok", (b"data", {}, {}))
