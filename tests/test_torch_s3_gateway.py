"""PyTorch port: the S3 gateway's control plane (seaweedfs_tpu_torch/s3/server.py)
and the lifecycle scanner (s3/lifecycle.py), held against the JAX package
on the CPU.

Twin gateways (tests/torch_s3_twins.py: a JAX `S3Server` over a JAX
cluster, a port `S3Server` over a port cluster, one identities file) take
one seeded sequence of signed requests. Each step's statuses, S3 error
codes, headers and XML bodies must be equal with the clocks and STS
credentials masked, and so must the `/buckets` trees and the filers' KV
after it (tolerance 0). The steps: bucket CRUD and name rules; SigV4
(anonymous, a read-only user, a tampered signature, an unknown key, a
body that is not the signed one, presigned URLs); STS `AssumeRole` and
its credential; identity and bucket policies; canned ACLs of buckets and
objects; CORS and preflight; default encryption's configuration; quotas;
per-tenant shedding; the catalog and IAM routes refused alike to callers
who are not admins, and answered alike to an admin; lifecycle rules through the gateway, then the
scanner at pinned clocks over versions, markers and stale uploads; the
bucket's deletion, which drops its collection.

Also: the saturated gateway's 503 (head and body equal);
`parse_lifecycle_xml`'s verdicts and errors; and the port's one answer
for the route of a later item, 501 NotImplemented naming ROADMAP.md item
19 (Select).
"""

import http.client
import json
import socket
import time
import urllib.parse
import xml.etree.ElementTree as ET

import pytest
from torch_s3_twins import PKGS, norm, run_scenario, seeded_bytes

from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.filer import MemoryStore as JaxMemoryStore
from seaweedfs_tpu_torch.filer import Filer, MemoryStore
from test_torch_volume_server import _ports

FORM = {"Content-Type": "application/x-www-form-urlencoded"}
DAY = 86400.0


def form(**kv) -> bytes:
    return urllib.parse.urlencode(kv).encode()


def _xml_text(body: bytes, tag: str) -> str:
    root = ET.fromstring(body)
    for el in root.iter():
        if el.tag.split("}")[-1] == tag:
            return el.text or ""
    return ""


# ---------------------------------------------------------------- steps


def s_buckets(s):
    c = s.call
    out = [c("GET", "/"), c("PUT", "/gw"), c("PUT", "/gw")]
    out += [c("PUT", f"/{b}") for b in ("A", "ab_c", "x", "-ab", "ab-", "a" * 64)]
    out += [c("HEAD", "/gw"), c("HEAD", "/nope"), c("GET", "/gw", "location"), c("GET", "/"),
            c("DELETE", "/nope"), c("GET", "/", who=None),
            c("POST", "/", body=form(Action="Nope"), headers=FORM),
            c("PUT", "/gw2"), c("PUT", "/gw2/x", body=seeded_bytes(2, 2000))]
    # the bucket's objects land in the collection named after it, and
    # the bucket's deletion drops it
    out.append(sorted(s.master.topo.collections()))
    out += [c("DELETE", "/gw2/x"), c("DELETE", "/gw2"), c("HEAD", "/gw2"),
            sorted(s.master.topo.collections())]
    return out


def _flip_signature(hs: dict) -> dict:
    a = hs["Authorization"]
    hs["Authorization"] = a[:-1] + ("0" if a[-1] != "0" else "1")
    return hs


def s_auth(s):
    c = s.call
    return [
        c("PUT", "/gw/a.txt", body=b"hello"),
        c("PUT", "/gw/anon.txt", body=b"x", who=None),
        c("PUT", "/gw/r.txt", body=b"x", who="reader"),
        c("GET", "/gw/a.txt", who="reader"),
        c("GET", "/gw", "list-type=2", who="reader"),
        c("DELETE", "/gw/a.txt", who="reader"),
        c("PUT", "/gw/t.txt", body=b"x", mutate=_flip_signature),
        c("GET", "/gw/a.txt", who="ghost"),
        c("PUT", "/gw/m.txt", body=b"the body", phash=s.pkg.auth._sha256(b"another body")),
        c("GET", "/gw/a.txt", mutate=lambda hs: {**hs, "Authorization": "AWS abc:def"}),
        s.presigned("GET", "/gw/a.txt"),
        s.presigned("GET", "/gw/a.txt", expires=3600, age=7200),
        s.presigned("GET", "/gw/a.txt", who="ghost"),
        s.presigned("PUT", "/gw/p.txt", who="reader"),
        c("GET", "/gw/a.txt", who="policy"),
        c("PUT", "/gw/pol.txt", body=b"x", who="policy"),
        c("GET", "/gw", "list-type=2", who="policy"),
    ]


def s_sts(s):
    c = s.call
    status, hs, body = s.raw("POST", "/", body=form(
        Action="AssumeRole", RoleArn="arn:aws:iam:::role/uploader", DurationSeconds="900"),
        headers=FORM)
    out = [norm(status, hs, body)]
    s.keys["sts"] = (_xml_text(body, "AccessKeyId"), _xml_text(body, "SecretAccessKey"),
                     _xml_text(body, "SessionToken"))
    out += [
        c("PUT", "/gw/sts/obj", body=b"written with a role's credential", who="sts"),
        c("GET", "/gw/sts/obj", who="sts"),
        c("PUT", "/gw/other", body=b"x", who="sts"),
        c("GET", "/gw/a.txt", who="sts"),
        c("POST", "/", body=form(Action="AssumeRole", RoleName="uploader"), headers=FORM,
          who="reader"),
        c("POST", "/", body=form(Action="AssumeRole", RoleName="ghost"), headers=FORM),
        c("POST", "/", body=form(Action="AssumeRole", RoleName="uploader", DurationSeconds="x"),
          headers=FORM),
        c("POST", "/", body=form(Action="AssumeRole", RoleName="uploader"), headers=FORM,
          who=None),
        c("POST", "/", body=form(Action="AssumeRole", RoleName="uploader"), headers=FORM,
          who="policy"),
    ]
    # the session token is part of the credential
    ak, sk, _ = s.keys["sts"]
    s.keys["sts-notoken"] = (ak, sk, "")
    out.append(c("GET", "/gw/sts/obj", who="sts-notoken"))
    return out


def s_policy(s):
    c = s.call
    pol = {"Version": "2012-10-17", "Statement": [
        {"Effect": "Allow", "Principal": "*", "Action": ["s3:GetObject"],
         "Resource": ["arn:aws:s3:::gw/pub/*"]}]}
    deny = {"Version": "2012-10-17", "Statement": [
        {"Effect": "Deny", "Principal": "*", "Action": ["s3:GetObject"],
         "Resource": ["arn:aws:s3:::gw/pub/*"]}]}
    return [
        c("PUT", "/gw/pub/p.txt", body=b"public"), c("PUT", "/gw/secret/s.txt", body=b"secret"),
        c("GET", "/gw", "policy"), c("GET", "/gw", "policyStatus"),
        c("PUT", "/gw", "policy", body=b"{not json"),
        c("PUT", "/gw", "policy", body=json.dumps({"Statement": "x"}).encode()),
        c("PUT", "/gw", "policy", body=json.dumps(
            {"Statement": [{"Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
                            "Resource": "arn:aws:s3:::other/*"}]}).encode()),
        c("PUT", "/gw", "policy", body=json.dumps(pol).encode()),
        c("GET", "/gw", "policy"), c("GET", "/gw", "policyStatus"),
        c("GET", "/gw/pub/p.txt", who=None),
        c("GET", "/gw/secret/s.txt", who=None),
        c("GET", "/gw/secret/s.txt", who="policy"),
        c("GET", "/gw/pub/p.txt", who="policy"),
        c("PUT", "/gw/pub/x", body=b"x", who="policy"),
        c("PUT", "/gw", "policy", body=json.dumps(deny).encode()),
        c("GET", "/gw/pub/p.txt", who="reader"),
        c("GET", "/gw/pub/p.txt"),
        c("DELETE", "/gw", "policy"), c("GET", "/gw/pub/p.txt", who=None),
        c("GET", "/nope", "policy"),
    ]


def s_acl(s):
    c = s.call
    return [
        c("GET", "/gw", "acl"),
        c("PUT", "/gw", "acl", headers={"x-amz-acl": "public-read"}), c("GET", "/gw", "acl"),
        c("GET", "/gw/pub/p.txt", who=None), c("GET", "/gw", "list-type=2", who=None),
        c("PUT", "/gw/anon", body=b"x", who=None),
        c("PUT", "/gw", "acl", headers={"x-amz-acl": "bogus"}),
        c("PUT", "/gw", "acl", headers={"x-amz-acl": "public-read-write"}),
        c("PUT", "/gw/anonw", body=b"anonymous write", who=None),
        c("DELETE", "/gw", "policy", who=None),
        c("PUT", "/gw", "acl"), c("GET", "/gw", "acl"),
        c("PUT", "/gw/objacl.txt", body=b"o", headers={"x-amz-acl": "public-read"}),
        c("GET", "/gw/objacl.txt", who=None), c("GET", "/gw/objacl.txt", "acl"),
        c("PUT", "/gw/objacl.txt", "acl", headers={"x-amz-acl": "authenticated-read"}),
        c("GET", "/gw/objacl.txt", "acl"), c("GET", "/gw/objacl.txt", who=None),
        c("PUT", "/gw/objacl.txt", "acl", headers={"x-amz-acl": "nope"}),
        c("GET", "/gw/missing.txt", "acl"),
        c("PUT", "/gw/bad-acl.txt", body=b"x", headers={"x-amz-acl": "world"}),
    ]


CORS = (b"<CORSConfiguration><CORSRule><AllowedOrigin>https://app.example</AllowedOrigin>"
        b"<AllowedMethod>GET</AllowedMethod><AllowedMethod>PUT</AllowedMethod>"
        b"<AllowedHeader>x-amz-meta-a</AllowedHeader></CORSRule><CORSRule>"
        b"<AllowedOrigin>*</AllowedOrigin><AllowedMethod>HEAD</AllowedMethod></CORSRule>"
        b"</CORSConfiguration>")


def s_cors(s):
    c = s.call

    def pre(origin, method):
        return c("OPTIONS", "/gw/a.txt", headers={"Origin": origin,
                                                 "Access-Control-Request-Method": method},
                 who=None)

    return [
        c("GET", "/gw", "cors"), c("PUT", "/gw", "cors", body=b"<bad"),
        c("PUT", "/gw", "cors", body=b"<CORSConfiguration/>"),
        c("PUT", "/gw", "cors", body=CORS), c("GET", "/gw", "cors"),
        pre("https://app.example", "PUT"), pre("https://evil.example", "GET"),
        pre("https://any.example", "HEAD"), pre("", "GET"),
        c("GET", "/gw/a.txt", headers={"Origin": "https://app.example"}),
        c("HEAD", "/gw/a.txt", headers={"Origin": "https://x.example"}),
        c("PUT", "/gw/c.txt", body=b"c", headers={"Origin": "https://app.example"}),
        c("GET", "/gw/nope.txt", headers={"Origin": "https://app.example"}),
        c("DELETE", "/gw", "cors"), pre("https://app.example", "PUT"),
    ]


def s_encryption_config(s):
    c = s.call
    sse = (b'<ServerSideEncryptionConfiguration><Rule><ApplyServerSideEncryptionByDefault>'
           b'<SSEAlgorithm>%s</SSEAlgorithm></ApplyServerSideEncryptionByDefault></Rule>'
           b'</ServerSideEncryptionConfiguration>')
    return [
        c("GET", "/gw", "encryption"), c("PUT", "/gw", "encryption", body=sse % b"aws:kms"),
        c("PUT", "/gw", "encryption", body=sse % b"DES"),
        c("PUT", "/gw", "encryption", body=b"<x"),
        c("PUT", "/gw", "encryption", body=sse % b"AES256"), c("GET", "/gw", "encryption"),
        c("PUT", "/gw/enc.txt", body=b"encrypted by default"), c("GET", "/gw/enc.txt"),
        c("HEAD", "/gw/enc.txt"),
        c("DELETE", "/gw", "encryption"), c("GET", "/gw", "encryption"),
        c("POST", "/gw", "encryption", body=b""),
    ]


def s_quota(s):
    c = s.call
    s.filer.store.kv_put(b"quota-exceeded/gw", b"1")
    out = [c("PUT", "/gw/q.txt", body=b"q"), c("POST", "/gw/q.bin", "uploads"),
           s.post_form("gw", {"key": "q/form.bin"}, b"form"),
           c("GET", "/gw/a.txt"), c("DELETE", "/gw/anonw")]
    s.filer.store.kv_delete(b"quota-exceeded/gw")
    out += [c("PUT", "/gw/q.txt", body=b"q")]
    return out


def s_shedding(s):
    c = s.call
    dq = s.pkg.dq
    real = dq.shed_advice
    dq.shed_advice = lambda tenant: 2.5 if tenant == "default" else None
    try:
        out = [c("GET", "/gw/a.txt"), c("PUT", "/gw/x", body=b"x"), c("HEAD", "/gw/a.txt"),
               c("DELETE", "/gw/a.txt", who=None), c("GET", "/"),
               c("GET", "/gw", "list-type=2")]
        dq.shed_advice = lambda tenant: 0.2 if tenant == "default" else None
        out.append(c("GET", "/gw/a.txt"))
        dq.shed_advice = lambda tenant: 9.0 if tenant == "other" else None
        out.append(c("GET", "/gw/a.txt"))
    finally:
        dq.shed_advice = real
    out.append(c("GET", "/gw/a.txt"))
    return out


def s_later_routes(s):
    """The catalog and IAM routes refuse callers who are not admins in
    both packages, before the route itself, and answer an admin alike
    (tests/test_torch_s3_tables.py drives them whole)."""
    c = s.call
    tables = {"X-Amz-Target": "S3Tables.ListTableBuckets", "Content-Type": "application/json"}
    return [
        c("GET", "/iceberg/v1/config", who=None), c("GET", "/iceberg/v1/config", who="reader"),
        c("POST", "/", body=b"{}", headers=tables, who=None),
        c("POST", "/", body=b"{}", headers=tables, who="reader"),
        c("GET", "/buckets", who="reader"),
        c("GET", "/buckets/arn:aws:s3tables:us-east-1:0:bucket/t", who=None),
        c("POST", "/", body=form(Action="ListUsers"), headers=FORM, who=None),
        c("POST", "/", body=form(Action="CreateUser", UserName="u"), headers=FORM, who="reader"),
        c("GET", "/gw/iceberg/v1/config"),
        c("GET", "/gw/buckets/arn:aws:s3tables:x"),
        c("GET", "/iceberg/v1/config"),
        c("POST", "/", body=b"{}", headers={**tables, "X-Amz-Target": "S3Tables.CreateTableBucket"}),
        c("GET", "/buckets"),
        c("PUT", "/namespaces/arn:aws:s3tables:us-east-1:1:bucket/t"),
        c("POST", "/", body=form(Action="CreateAccessKey", UserName="u"), headers=FORM),
        c("POST", "/", body=form(Action="AssumeRoleWithLdapIdentity", LdapUsername="u"),
          headers=FORM),
    ]


LC = (b"<LifecycleConfiguration xmlns='http://s3.amazonaws.com/doc/2006-03-01/'><Rule>"
      b"<ID>old</ID><Filter><Prefix>lc/</Prefix></Filter><Status>Enabled</Status>"
      b"<Expiration><Date>2020-01-01T00:00:00Z</Date></Expiration></Rule><Rule><ID>days</ID>"
      b"<Prefix>tmp/</Prefix><Status>Enabled</Status><Expiration><Days>1</Days></Expiration>"
      b"</Rule><Rule><ID>off</ID><Prefix>keep/</Prefix><Status>Disabled</Status>"
      b"<Expiration><Days>1</Days></Expiration></Rule></LifecycleConfiguration>")


def s_lifecycle(s):
    c = s.call
    out = [c("GET", "/gw", "lifecycle"), c("PUT", "/gw", "lifecycle", body=b"<x"),
           c("PUT", "/gw", "lifecycle", body=b"<LifecycleConfiguration/>"),
           c("PUT", "/gw", "lifecycle",
             body=b"<LifecycleConfiguration><Rule><ID>r</ID></Rule></LifecycleConfiguration>"),
           c("PUT", "/nope", "lifecycle", body=LC),
           c("PUT", "/gw", "lifecycle", body=LC), c("GET", "/gw", "lifecycle")]
    for k in ("lc/1", "lc/2", "lc/deep/3", "tmp/1", "keep/1", "lcx"):
        out.append(c("PUT", f"/gw/{k}", body=seeded_bytes(len(k), 700)))
    now = time.time()
    out.append(s.s3.lifecycle.run_once(now=now))
    out.append(s.s3.lifecycle.run_once(now=now + 2 * DAY, bucket="other"))
    out.append(s.s3.lifecycle.run_once(now=now + 2 * DAY, bucket="gw"))
    out += [c("GET", f"/gw/{k}") for k in ("lc/1", "lc/deep/3", "tmp/1", "keep/1", "lcx")]
    out += [c("DELETE", "/gw", "lifecycle"), c("GET", "/gw", "lifecycle")]
    return out


VERSIONING = b"<VersioningConfiguration><Status>%s</Status></VersioningConfiguration>"
LC_VERSIONS = (b"<LifecycleConfiguration><Rule><ID>nc</ID><Prefix>v/</Prefix>"
               b"<Status>Enabled</Status><NoncurrentVersionExpiration><NoncurrentDays>1"
               b"</NoncurrentDays></NoncurrentVersionExpiration></Rule><Rule><ID>exp</ID>"
               b"<Prefix>e/</Prefix><Status>Enabled</Status><Expiration><Days>3</Days>"
               b"</Expiration></Rule><Rule><ID>mpu</ID><Prefix></Prefix><Status>Enabled</Status>"
               b"<AbortIncompleteMultipartUpload><DaysAfterInitiation>1</DaysAfterInitiation>"
               b"</AbortIncompleteMultipartUpload></Rule></LifecycleConfiguration>")


def s_lifecycle_versions(s):
    """The scanner over a versioned bucket: noncurrent versions expire,
    a retention-locked one stays, current objects get delete markers,
    stale multipart uploads are aborted."""
    c = s.call
    out = [c("PUT", "/lcv", headers={"x-amz-bucket-object-lock-enabled": "true"}),
           c("PUT", "/lcv", "versioning", body=VERSIONING % b"Enabled")]
    for i in range(3):
        out.append(c("PUT", "/lcv/v/k", body=b"version %d" % i))
    out.append(c("PUT", "/lcv/v/locked", body=b"locked", headers={
        "x-amz-object-lock-mode": "GOVERNANCE",
        "x-amz-object-lock-retain-until-date": "2099-01-01T00:00:00Z"}))
    out.append(c("PUT", "/lcv/v/locked", body=b"current over a locked version"))
    out += [c("PUT", "/lcv/e/1", body=b"e1"), c("POST", "/lcv/mp.bin", "uploads"),
            c("PUT", "/lcv", "lifecycle", body=LC_VERSIONS)]
    now = time.time()
    out.append(s.s3.lifecycle.run_once(now=now))
    out.append(s.s3.lifecycle.run_once(now=now + 2 * DAY))
    out.append(s.s3.lifecycle.run_once(now=now + 4 * DAY))
    out += [c("GET", "/lcv", "versions"), c("GET", "/lcv", "uploads"), c("GET", "/lcv/e/1")]
    return out


def _all_keys(s, bucket: str) -> list:
    status, _, body = s.raw("GET", f"/{bucket}", "list-type=2")
    root = ET.fromstring(body)
    return [el.text for el in root.iter() if el.tag.endswith("}Key")]


def s_delete_bucket(s):
    c = s.call
    out = [c("DELETE", "/gw")]
    keys = _all_keys(s, "gw")
    doc = "<Delete>" + "".join(f"<Object><Key>{k}</Key></Object>" for k in keys) + "</Delete>"
    out += [keys, c("POST", "/gw", "delete", body=doc.encode()), c("DELETE", "/gw")]
    # what DeleteObjects leaves: the directories the keys lived in
    left = [e.name for e in s.filer.list_entries("/buckets/gw", limit=100)]
    for d in left:
        s.filer.delete_entry(f"/buckets/gw/{d}", recursive=True)
    out += [left, c("DELETE", "/gw"), c("HEAD", "/gw"), c("GET", "/")]
    return out


STEPS = [(f.__name__[2:], f) for f in (
    s_buckets, s_auth, s_sts, s_policy, s_acl, s_cors, s_encryption_config, s_quota,
    s_shedding, s_later_routes, s_lifecycle, s_lifecycle_versions, s_delete_bucket)]


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    return run_scenario(tmp_path_factory.mktemp("s3-gateway"), STEPS)


@pytest.mark.parametrize("step", [name for name, _ in STEPS])
def test_gateway_step_against_jax(scenario, step):
    jax, port = scenario["jax"][step], scenario["port"][step]
    assert port[0] != "raised", port[1]
    assert port[0] == jax[0], "the answers"
    assert port[1] == jax[1], "the /buckets tree"
    assert port[2] == jax[2], "the filer's KV"


def test_the_scenario_reaches_what_it_means_to(scenario):
    """The scenario is not vacuous: each class of answer it is meant to
    compare occurs in it."""
    ans = scenario["port"]
    codes = {a[0] for _, (answers, _, _) in ans.items() for a in answers
             if isinstance(a, tuple) and len(a) == 3 and isinstance(a[0], int)}
    assert {200, 204, 400, 403, 404, 405, 409, 501, 503} <= codes, codes
    auth = ans["auth"][0]
    assert [a[0] for a in auth] == [200, 403, 403, 200, 200, 403, 403, 403, 403, 403, 200, 403,
                                    403, 403, 200, 403, 200]
    assert b"<Code>SignatureDoesNotMatch</Code>" in auth[6][2]
    assert b"<Code>InvalidAccessKeyId</Code>" in auth[7][2]
    assert b"<Code>XAmzContentSHA256Mismatch</Code>" in auth[8][2]
    sts = ans["sts"][0]
    assert sts[0][0] == 200 and sts[1][0] == 200 and sts[2][0] == 200 and sts[3][0] == 403
    shed = ans["shedding"][0]
    assert shed[0][0] == 503 and shed[0][1]["retry-after"] == "2"
    assert b"SlowDown" in shed[0][2] and shed[4][0] == 200 and shed[-1][0] == 200
    lc = ans["lifecycle"][0]
    assert lc[13] == {"expired": 3, "noncurrent_expired": 0, "aborted_uploads": 0}
    assert lc[15] == {"expired": 1, "noncurrent_expired": 0, "aborted_uploads": 0}
    assert [a[0] for a in lc[16:21]] == [404, 404, 404, 200, 200]
    lcv = ans["lifecycle_versions"][0]
    assert lcv[10:13] == [{"expired": 0, "noncurrent_expired": 0, "aborted_uploads": 0},
                         {"expired": 0, "noncurrent_expired": 2, "aborted_uploads": 1},
                         {"expired": 1, "noncurrent_expired": 0, "aborted_uploads": 0}]
    assert ans["buckets"][0][18] == ["gw2"] and ans["buckets"][0][22] == []
    # a policy whose Statement is not a list drops the connection in both
    assert ans["policy"][0][5] == (0, {}, (18, ans["policy"][0][5][2][1]))
    drop = ans["delete_bucket"][0]
    assert drop[0][0] == 409 and drop[-3][0] == 204 and drop[-2][0] == 404


# ------------------------------------------------- the saturated gateway


def test_saturated_gateway_answers_the_jax_503():
    got = {}
    for name, (filer_cls, store_cls) in {"jax": (JaxFiler, JaxMemoryStore),
                                         "port": (Filer, MemoryStore)}.items():
        filer = filer_cls(store_cls(), master="localhost:1")
        srv = PKGS[name].server.S3Server(filer, ip="127.0.0.1", port=_ports(),
                                         lifecycle_interval=0, http_workers=1, http_queue=0)
        srv.start()
        held = socket.create_connection(("127.0.0.1", srv.port))
        try:
            time.sleep(0.3)
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
            c.request("GET", "/", headers={"X-Request-ID": "saturated"})
            r = c.getresponse()
            got[name] = norm(r.status, dict(r.getheaders()), r.read())
            c.close()
        finally:
            held.close()
            srv.stop()
            filer.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 503 and got["port"][1].get("retry-after")
    assert ET.fromstring(got["port"][2]).findtext("Code") == "SlowDown"


# ------------------------------------------------ lifecycle rules, parsed

RULE_DOCS = [
    LC, LC_VERSIONS, b"<LifecycleConfiguration/>", b"not xml", b"<a><Rule/></a>",
    b"<LifecycleConfiguration><Rule><Expiration><Days>x</Days></Expiration></Rule>"
    b"</LifecycleConfiguration>",
    b"<LifecycleConfiguration><Rule><Status>Enabled</Status></Rule></LifecycleConfiguration>",
    b"<LifecycleConfiguration><Rule><Expiration><Date>2030-02-03</Date></Expiration></Rule>"
    b"<Rule><ID>x</ID><Filter><Prefix>p/</Prefix></Filter><AbortIncompleteMultipartUpload>"
    b"<DaysAfterInitiation>4</DaysAfterInitiation></AbortIncompleteMultipartUpload></Rule>"
    b"</LifecycleConfiguration>",
]


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:  # noqa: BLE001 — the refusal is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("i", range(len(RULE_DOCS)))
def test_parse_lifecycle_xml_matches_jax(i):
    got = [_outcome(PKGS[n].lifecycle.parse_lifecycle_xml, RULE_DOCS[i]) for n in PKGS]
    assert got[0] == got[1]


def test_expiry_dates_and_ages_match_jax():
    rules = [{"ExpirationDate": d} for d in ("2020-01-01", "2030-06-07T00:00:00Z", "bad",
                                               "2026-05-04")]
    rules += [{"ExpirationDays": n} for n in (0, 1, 30)] + [{}]
    now = 1_777_900_000.0
    for mtime in (0, int(now) - 86400 * 31, int(now) - 3600, int(now)):
        got = [[m.LifecycleScanner._expired(mtime, r, now) for r in rules]
               + [m.entry_age_days(mtime, now)] for m in (PKGS["jax"].lifecycle,
                                                            PKGS["port"].lifecycle)]
        assert got[0] == got[1]


# -------------------------------- the routes of later items, in the port


def test_later_items_routes_answer_one_501_naming_their_item(tmp_path):
    """`?select` answers one 501 naming item 19; the catalog, IAM and LDAP
    routes that once answered so are compared whole in s_later_routes."""
    filer = Filer(MemoryStore(), master="localhost:1")
    srv = PKGS["port"].server.S3Server(filer, ip="127.0.0.1", port=_ports(),
                                       lifecycle_interval=0, http_workers=2)
    srv.start()

    def call(method, path, body=b"", headers=None):
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        try:
            c.request(method, path, body=body, headers=headers or {})
            r = c.getresponse()
            return r.status, r.read()
        finally:
            c.close()

    try:
        assert call("PUT", "/bk")[0] == 200
        assert call("PUT", "/bk/k", b"x")[0] == 200
        cases = [
            ("POST", "/bk/k?select&select-type=2", b"<SelectObjectContentRequest/>", None,
             "S3 Select", "19"),
        ]
        for method, path, body, headers, what, item in cases:
            status, doc = call(method, path, body, headers)
            root = ET.fromstring(doc)
            assert status == 501, (path, doc)
            assert root.findtext("Code") == "NotImplemented"
            assert root.findtext("Message") == (f"{what} is not ported yet: it comes with "
                                                f"ROADMAP.md item {item}")
        # ordinary requests keep their routes
        assert call("GET", "/bk/k")[0] == 200
        assert call("POST", "/", form(Action="Nope"), FORM)[0] == 405
    finally:
        srv.stop()
        filer.close()
