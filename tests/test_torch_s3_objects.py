"""PyTorch port: the S3 gateway's object path (seaweedfs_tpu_torch/s3/server.py),
held against the JAX package on the CPU.

Twin gateways (tests/torch_s3_twins.py) take one seeded sequence of
signed requests; each step's statuses, S3 error codes, headers (ETag,
Content-Range, Content-Length, `x-amz-version-id`, the SSE headers and
every other but `Date` and `Last-Modified`) and bodies must be equal,
and so must the `/buckets` trees (every entry's attributes and the
sha256 of what the filer reads) and the filers' KV after it (tolerance
0). The steps: PUT, GET and HEAD of inline and chunked objects, ranges
(suffix, 416, malformed) and conditional reads and writes; ListObjects v1
and v2 with prefixes, delimiters, markers and continuation; CopyObject
with its source preconditions; multipart (a part the filer holds inline
spliced as a chunk, list parts and uploads, abort, a missing part);
aws-chunked bodies, signed and unsigned, and a tampered chunk; POST
policy uploads; SSE-S3 and SSE-C (whole, ranged, copied, multipart, the
bucket default); versioning (versions, delete markers, `?versionId`,
Suspended); object lock (retention, legal hold, governance bypass);
tagging; DeleteObjects, quiet and versioned.

SSE's randomness is pinned, so the stored ciphertexts are byte-identical;
beyond that each package decrypts the object the other stored.
"""

import hashlib
import urllib.parse
import xml.etree.ElementTree as ET

import pytest
from torch_s3_twins import PKGS, http_date, norm, run_scenario, seeded_bytes, ssec_headers
from datetime import datetime, timezone

MP = "<CompleteMultipartUpload>{}</CompleteMultipartUpload>"
KEY1 = seeded_bytes(7, 32)
KEY2 = seeded_bytes(8, 32)
COPY_PREFIX = "x-amz-copy-source-server-side-encryption-customer-"
FAR_PAST = http_date(datetime(2000, 1, 1, tzinfo=timezone.utc))
FAR_FUTURE = http_date(datetime(2099, 1, 1, tzinfo=timezone.utc))
SIZES = [0, 1, 511, 513, 70_000, 200_000]


def md5(b: bytes) -> str:
    return hashlib.md5(b).hexdigest()


def _text(body: bytes, tag: str) -> list:
    return [el.text or "" for el in ET.fromstring(body).iter() if el.tag.split("}")[-1] == tag]


def complete_doc(parts) -> bytes:
    return MP.format("".join(f"<Part><PartNumber>{n}</PartNumber></Part>" for n in parts)).encode()


# ---------------------------------------------------------------- steps


def s_put_get(s):
    c = s.call
    out = [c("PUT", "/ob")]
    for i, n in enumerate(SIZES):
        out.append(c("PUT", f"/ob/d/{i}.bin", body=seeded_bytes(100 + i, n),
                     headers={"Content-Type": "application/x-twin"}))
    out += [c("GET", f"/ob/d/{i}.bin") for i in range(len(SIZES))]
    out.append(c("HEAD", "/ob/d/5.bin"))
    for r in ("bytes=0-99", "bytes=65530-65545", "bytes=-100", "bytes=199990-", "bytes=300000-",
              "bytes=5-2", "bytes=abc", "bytes=0-999999", "bytes=0-0,5-9", "items=0-1"):
        out.append(c("GET", "/ob/d/5.bin", headers={"Range": r}))
    out.append(c("GET", "/ob/d/0.bin", headers={"Range": "bytes=0-0"}))
    etag = f'"{md5(seeded_bytes(105, SIZES[5]))}"'
    for h in ({"If-None-Match": etag}, {"If-None-Match": '"other"'}, {"If-None-Match": "*"},
              {"If-Match": '"other"'}, {"If-Match": f'W/{etag}, "x"'},
              {"If-Modified-Since": FAR_FUTURE}, {"If-Modified-Since": FAR_PAST},
              {"If-Unmodified-Since": FAR_PAST}, {"If-Unmodified-Since": "garbage"},
              {"If-None-Match": '"other"', "If-Modified-Since": FAR_FUTURE}):
        out.append(c("GET", "/ob/d/5.bin", headers=h))
    out.append(c("HEAD", "/ob/d/5.bin", headers={"If-None-Match": etag}))
    out += [
        c("PUT", "/ob/d/1.bin", body=b"again", headers={"If-None-Match": "*"}),
        c("PUT", "/ob/new.bin", body=b"created", headers={"If-None-Match": "*"}),
        c("PUT", "/ob/new.bin", body=b"swapped", headers={"If-Match": f'"{md5(b"created")}"'}),
        c("PUT", "/ob/new.bin", body=b"lost", headers={"If-Match": f'"{md5(b"created")}"'}),
        c("PUT", "/ob/new.bin", body=b"x", headers={"If-None-Match": '"abc"'}),
        c("PUT", "/ob/absent.bin", body=b"x", headers={"If-Match": '"abc"'}),
        c("GET", "/ob/new.bin"), c("GET", "/ob/missing"), c("GET", "/nob/k"),
        c("GET", "/ob/d"), c("PUT", "/ob/d", body=b"over a directory"),
        c("DELETE", "/ob/d/0.bin"), c("GET", "/ob/d/0.bin"), c("DELETE", "/ob/d/0.bin"),
        c("PATCH", "/ob/new.bin", body=b"x"), c("POST", "/ob/new.bin", body=b"x"),
        c("PUT", "/ob/d/1.bin", body=seeded_bytes(200, 90_000)), c("GET", "/ob/d/1.bin"),
    ]
    return out


def _follow(s, bucket: str, query: str) -> list:
    """Every page of a v2 listing, following its continuation tokens."""
    pages = []
    q = query
    while True:
        st, hs, body = s.raw("GET", f"/{bucket}", q)
        pages.append(norm(st, hs, body))
        tok = _text(body, "NextContinuationToken")
        if st != 200 or not tok or len(pages) > 20:
            return pages
        q = f"{query}&continuation-token={urllib.parse.quote(tok[0], safe='')}"


def s_list(s):
    c = s.call
    out = [c("PUT", "/ls")]
    for k in ("a.txt", "dir/one.txt", "dir/two.txt", "dir/sub/three.txt", "z.txt",
              "sp ace/é.txt", "dir2/x", "dira"):
        out.append(c("PUT", f"/ls/{k}", body=k.encode()))
    out += [c("GET", "/ls"), c("GET", "/ls", "max-keys=2"), c("GET", "/ls", "marker=dir/one.txt"),
            c("GET", "/ls", "delimiter=/"), c("GET", "/ls", "prefix=dir/&delimiter=/"),
            c("GET", "/ls", "list-type=2"), c("GET", "/ls", "list-type=2&delimiter=/"),
            c("GET", "/ls", "list-type=2&prefix=dir&delimiter=/"),
            c("GET", "/ls", "list-type=2&prefix=dir/&delimiter=/"),
            c("GET", "/ls", "list-type=2&start-after=dir/sub/three.txt"),
            c("GET", "/ls", "list-type=2&max-keys=0"),
            c("GET", "/ls", "list-type=2&max-keys=5000"),
            c("GET", "/ls", "list-type=2&prefix=nothing"),
            c("GET", "/ls", "max-keys=x"), c("GET", "/nols", "list-type=2")]
    out += _follow(s, "ls", "list-type=2&max-keys=2")
    out += _follow(s, "ls", "list-type=2&max-keys=1&delimiter=/")
    return out


def s_copy(s):
    c = s.call
    src = seeded_bytes(300, 150_000)
    etag = f'"{md5(src)}"'
    return [
        c("PUT", "/ob/src.bin", body=src, headers={"Content-Type": "image/x-src"}),
        c("PUT", "/ob/dst.bin", headers={"x-amz-copy-source": "/ob/src.bin"}),
        c("GET", "/ob/dst.bin"),
        c("PUT", "/ob/dst2.bin", headers={"x-amz-copy-source": "ob/src.bin",
                                          "x-amz-acl": "public-read"}),
        c("PUT", "/ob/dst3.bin", headers={"x-amz-copy-source": "/ob/src.bin",
                                          "x-amz-copy-source-if-match": '"nope"'}),
        c("PUT", "/ob/dst3.bin", headers={"x-amz-copy-source": "/ob/src.bin",
                                          "x-amz-copy-source-if-none-match": etag}),
        c("PUT", "/ob/dst3.bin", headers={"x-amz-copy-source": "/ob/src.bin",
                                          "x-amz-copy-source-if-modified-since": FAR_FUTURE}),
        c("PUT", "/ob/dst3.bin", headers={"x-amz-copy-source": "/ob/src.bin",
                                          "x-amz-copy-source-if-unmodified-since": FAR_PAST}),
        c("PUT", "/ob/dst3.bin", headers={"x-amz-copy-source": "/ob/src.bin",
                                          "x-amz-copy-source-if-match": etag}),
        c("PUT", "/ob/dst4.bin", headers={"x-amz-copy-source": "/ob/missing.bin"}),
        c("PUT", "/ob/dst4.bin", headers={"x-amz-copy-source": "/ob/d"}),
        c("PUT", "/ob/sp%20ce.bin", headers={"x-amz-copy-source": "/ob/src.bin"}),
        c("GET", "/ob/sp%20ce.bin"),
    ]


def s_multipart(s):
    c = s.call
    st, hs, body = s.raw("POST", "/ob/mp.bin", "uploads", headers={"Content-Type": "x/mp"})
    out = [norm(st, hs, body)]
    uid = _text(body, "UploadId")[0]
    p1, p2, p3 = seeded_bytes(400, 100_000), seeded_bytes(401, 70_000), seeded_bytes(402, 300)
    out += [c("PUT", "/ob/mp.bin", f"partNumber=1&uploadId={uid}", body=p1),
            c("PUT", "/ob/mp.bin", f"partNumber=2&uploadId={uid}", body=p2),
            c("PUT", "/ob/mp.bin", f"partNumber=2&uploadId={uid}", body=p2)]
    # a part the filer holds inline (as an upload made before parts were
    # forced into chunks): completion must turn it into a chunk
    s.filer.write_file(f"/buckets/.uploads/ob/{uid}/00003.part", p3)
    out += [c("GET", "/ob/mp.bin", f"uploadId={uid}"), c("GET", "/ob", "uploads"),
            c("POST", "/ob/mp.bin", f"uploadId={uid}", body=complete_doc([1, 2, 3])),
            c("GET", "/ob/mp.bin"), c("HEAD", "/ob/mp.bin"),
            c("GET", "/ob/mp.bin", headers={"Range": "bytes=99990-100009"}),
            c("GET", "/ob/mp.bin", headers={"Range": "bytes=-310"}),
            c("GET", "/ob/mp.bin", f"uploadId={uid}"), c("GET", "/ob", "uploads")]
    st, hs, body = s.raw("POST", "/ob/ab.bin", "uploads")
    out.append(norm(st, hs, body))
    uid2 = _text(body, "UploadId")[0]
    out += [c("PUT", "/ob/ab.bin", f"partNumber=1&uploadId={uid2}", body=p3),
            c("GET", "/ob", "uploads"),
            c("DELETE", "/ob/ab.bin", f"uploadId={uid2}"),
            c("GET", "/ob/ab.bin", f"uploadId={uid2}"),
            c("POST", "/ob/ab.bin", f"uploadId={uid2}", body=complete_doc([1])),
            c("PUT", "/ob/ab.bin", f"partNumber=1&uploadId={uid2}", body=p3)]
    st, hs, body = s.raw("POST", "/ob/mp2.bin", "uploads")
    out.append(norm(st, hs, body))
    uid3 = _text(body, "UploadId")[0]
    out += [c("PUT", "/ob/mp2.bin", f"partNumber=1&uploadId={uid3}", body=p1),
            c("PUT", "/ob/mp2.bin", f"partNumber=4&uploadId={uid3}", body=p2),
            c("POST", "/ob/mp2.bin", f"uploadId={uid3}", body=complete_doc([1, 5])),
            c("POST", "/ob/mp2.bin", f"uploadId={uid3}", body=b"<bad"),
            c("POST", "/ob/mp2.bin", f"uploadId={uid3}"), c("GET", "/ob/mp2.bin"),
            c("POST", "/ob/mp.bin", "uploads"),
            c("POST", "/ob/mp.bin", f"uploadId={uid}", body=complete_doc([1]))]
    return out


def _unsigned_chunked(data: bytes, size: int) -> bytes:
    out = [b"%x\r\n%s\r\n" % (len(data[i:i + size]), data[i:i + size])
           for i in range(0, len(data), size)]
    return b"".join(out) + b"0\r\n\r\n"


def s_chunked(s):
    c = s.call
    data = seeded_bytes(500, 100_000)
    unsigned = {"content-encoding": "aws-chunked", "x-amz-decoded-content-length": str(len(data))}
    return [
        s.streaming_put("/ob/stream.bin", data), c("GET", "/ob/stream.bin"),
        s.streaming_put("/ob/stream2.bin", data[:5000], chunk=1024,
                        headers={"x-amz-meta-x": "y", "content-type": "text/x"}),
        c("HEAD", "/ob/stream2.bin"),
        s.streaming_put("/ob/tampered.bin", data[:40_000], tamper=True),
        c("GET", "/ob/tampered.bin"),
        c("PUT", "/ob/unsigned.bin", body=_unsigned_chunked(data[:30_000], 8192),
          headers=unsigned, phash="STREAMING-UNSIGNED-PAYLOAD-TRAILER"),
        c("GET", "/ob/unsigned.bin"),
        c("PUT", "/ob/cut.bin", body=_unsigned_chunked(data[:30_000], 8192)[:-20],
          headers=unsigned, phash="STREAMING-UNSIGNED-PAYLOAD-TRAILER"),
        c("PUT", "/ob/junk.bin", body=b"zz\r\nnot hex\r\n", headers=unsigned,
          phash="STREAMING-UNSIGNED-PAYLOAD-TRAILER"),
    ]


def s_post_policy(s):
    data = seeded_bytes(600, 20_000)
    return [
        s.post_form("ob", {"key": "forms/${filename}"}, data),
        s.call("GET", "/ob/forms/up.bin"),
        s.post_form("ob", {"key": "forms/created.bin", "success_action_status": "201",
                           "content-type": "text/x-form", "acl": "public-read"}, data[:100]),
        s.call("GET", "/ob/forms/created.bin", who=None),
        s.post_form("ob", {"key": "forms/old.bin"}, data, expiration="2001-01-01T00:00:00Z"),
        s.post_form("ob", {"key": "forms/wide.bin", "acl": "public-read"}, data,
                    conditions=[{"bucket": "ob"}, ["starts-with", "$key", "forms/"]]),
        s.post_form("ob", {"key": "forms/bad.bin"}, data, bad_sig=True),
        s.post_form("ob", {"success_action_status": "200"}, data),
        s.post_form("ob", {"key": "forms/big.bin"}, data, conditions=[
            {"bucket": "ob"}, ["starts-with", "$key", "forms/"], ["content-length-range", 0, 10],
            ["starts-with", "$x-amz-algorithm", ""], ["starts-with", "$x-amz-credential", ""],
            ["starts-with", "$x-amz-date", ""]]),
        s.post_form("ob", {"key": "forms/anon.bin"}, data, who=None),
        s.post_form("ob", {"key": "forms/rd.bin"}, data, who="reader"),
        s.post_form("nob", {"key": "k"}, data),
        s.post_form("ob", {"key": "forms/weird.bin", "success_action_status": "302"}, data[:10]),
        s.post_form("ob", {"key": "forms/badacl.bin", "acl": "everyone"}, data[:10]),
    ]


def s_sse(s):
    c = s.call
    d1, d2, d3 = seeded_bytes(700, 100_000), seeded_bytes(701, 50_000), seeded_bytes(702, 300)
    out = [
        c("PUT", "/ob/sse-s3.bin", body=d1, headers={"x-amz-server-side-encryption": "AES256"}),
        c("GET", "/ob/sse-s3.bin"), c("HEAD", "/ob/sse-s3.bin"),
        c("GET", "/ob/sse-s3.bin", headers={"Range": "bytes=65530-65600"}),
        c("PUT", "/ob/sse-c.bin", body=d2, headers=ssec_headers(KEY1)),
        c("GET", "/ob/sse-c.bin"), c("GET", "/ob/sse-c.bin", headers=ssec_headers(KEY2)),
        c("GET", "/ob/sse-c.bin", headers=ssec_headers(KEY1)),
        c("HEAD", "/ob/sse-c.bin", headers=ssec_headers(KEY1)),
        c("GET", "/ob/sse-c.bin", headers={**ssec_headers(KEY1), "Range": "bytes=100-199"}),
        c("PUT", "/ob/sse-c-small.bin", body=d3, headers=ssec_headers(KEY1)),
        c("GET", "/ob/sse-c-small.bin", headers=ssec_headers(KEY1)),
        c("PUT", "/ob/sse-bad.bin", body=d3, headers={"x-amz-server-side-encryption": "aws:kms"}),
        c("PUT", "/ob/sse-bad.bin", body=d3, headers={**ssec_headers(KEY1),
                                                      "x-amz-server-side-encryption-customer-key-MD5": "AAAA"}),
        c("PUT", "/ob/plain-from-c.bin", headers={"x-amz-copy-source": "/ob/sse-c.bin",
                                                  **ssec_headers(KEY1, COPY_PREFIX)}),
        c("GET", "/ob/plain-from-c.bin"),
        c("PUT", "/ob/c2.bin", headers={"x-amz-copy-source": "/ob/sse-c.bin"}),
        c("PUT", "/ob/c-from-s3.bin", headers={"x-amz-copy-source": "/ob/sse-s3.bin",
                                               **ssec_headers(KEY2)}),
        c("GET", "/ob/c-from-s3.bin", headers=ssec_headers(KEY2)),
    ]
    st, hs, body = s.raw("POST", "/ob/mp-s3.bin", "uploads",
                         headers={"x-amz-server-side-encryption": "AES256"})
    out.append(norm(st, hs, body))
    uid = _text(body, "UploadId")[0]
    out += [c("PUT", "/ob/mp-s3.bin", f"partNumber=1&uploadId={uid}", body=d1),
            c("PUT", "/ob/mp-s3.bin", f"partNumber=2&uploadId={uid}", body=d2),
            c("POST", "/ob/mp-s3.bin", f"uploadId={uid}", body=complete_doc([1, 2])),
            c("GET", "/ob/mp-s3.bin"),
            c("GET", "/ob/mp-s3.bin", headers={"Range": "bytes=99990-100020"})]
    st, hs, body = s.raw("POST", "/ob/mp-c.bin", "uploads", headers=ssec_headers(KEY1))
    out.append(norm(st, hs, body))
    uid = _text(body, "UploadId")[0]
    out += [c("PUT", "/ob/mp-c.bin", f"partNumber=1&uploadId={uid}", body=d2),
            c("PUT", "/ob/mp-c.bin", f"partNumber=1&uploadId={uid}", body=d2,
              headers=ssec_headers(KEY1)),
            c("PUT", "/ob/mp-c.bin", f"partNumber=2&uploadId={uid}", body=d3,
              headers=ssec_headers(KEY2)),
            c("PUT", "/ob/mp-c.bin", f"partNumber=2&uploadId={uid}", body=d3,
              headers=ssec_headers(KEY1)),
            c("POST", "/ob/mp-c.bin", f"uploadId={uid}", body=complete_doc([1, 2])),
            c("GET", "/ob/mp-c.bin", headers=ssec_headers(KEY1)),
            c("PUT", "/enc"),
            c("PUT", "/enc", "encryption", body=(
                b"<ServerSideEncryptionConfiguration><Rule><ApplyServerSideEncryptionByDefault>"
                b"<SSEAlgorithm>AES256</SSEAlgorithm></ApplyServerSideEncryptionByDefault></Rule>"
                b"</ServerSideEncryptionConfiguration>")),
            c("PUT", "/enc/by-default.bin", body=d3), c("GET", "/enc/by-default.bin"),
            s.post_form("enc", {"key": "form.bin"}, d3), c("GET", "/enc/form.bin"),
            c("PUT", "/enc/copied.bin", headers={"x-amz-copy-source": "/ob/d/1.bin"}),
            c("HEAD", "/enc/copied.bin")]
    return out


VERSIONING = b"<VersioningConfiguration><Status>%s</Status></VersioningConfiguration>"


def s_versioning(s):
    c = s.call
    out = [c("PUT", "/vb"), c("GET", "/vb", "versioning"),
           c("PUT", "/vb", "versioning", body=VERSIONING % b"Bogus"),
           c("PUT", "/nvb", "versioning", body=VERSIONING % b"Enabled"),
           c("PUT", "/vb", "versioning", body=VERSIONING % b"Enabled"),
           c("GET", "/vb", "versioning")]
    vids = []
    for i in range(3):
        st, hs, body = s.raw("PUT", "/vb/k", body=seeded_bytes(800 + i, 1000 * (i + 1)))
        out.append(norm(st, hs, body))
        vids.append(hs.get("x-amz-version-id"))
    out += [c("GET", "/vb/k"), c("GET", "/vb/k", f"versionId={vids[0]}"),
            c("HEAD", "/vb/k", f"versionId={vids[1]}"), c("GET", "/vb/k", "versionId=bogus"),
            c("GET", "/vb", "versions"), c("GET", "/vb", "versions&prefix=k&max-keys=2"),
            c("PUT", "/vb/k2", body=b"other key")]
    st, hs, body = s.raw("DELETE", "/vb/k")
    out.append(norm(st, hs, body))
    marker = hs.get("x-amz-version-id")
    out += [c("GET", "/vb/k"), c("HEAD", "/vb/k"), c("GET", "/vb/k", f"versionId={marker}"),
            c("GET", "/vb", "versions"), c("GET", "/vb", "list-type=2"),
            c("PUT", "/vb/k3", headers={"x-amz-copy-source": "/vb/k"}),
            c("PUT", "/vb/k3", headers={"x-amz-copy-source": f"/vb/k?versionId={vids[0]}"}),
            c("GET", "/vb/k3"),
            c("DELETE", "/vb/k", f"versionId={marker}"), c("GET", "/vb/k"),
            c("DELETE", "/vb/k", f"versionId={vids[0]}"),
            c("DELETE", "/vb/k", "versionId=nope"), c("GET", "/vb", "versions"),
            c("PUT", "/vb", "versioning", body=VERSIONING % b"Suspended"),
            c("PUT", "/vb/k", body=b"null version"), c("PUT", "/vb/k", body=b"null again"),
            c("GET", "/vb/k"), c("GET", "/vb", "versions"), c("DELETE", "/vb/k2"),
            c("GET", "/vb", "versions"), c("GET", "/vb", "list-type=2")]
    return out


LOCK_CONF = (b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled</ObjectLockEnabled>%s"
             b"</ObjectLockConfiguration>")
RULE = b"<Rule><DefaultRetention><Mode>GOVERNANCE</Mode><Days>1</Days></DefaultRetention></Rule>"
RETENTION = b"<Retention><Mode>%s</Mode><RetainUntilDate>%s</RetainUntilDate></Retention>"
HOLD = b"<LegalHold><Status>%s</Status></LegalHold>"
BYPASS = {"x-amz-bypass-governance-retention": "true"}


def s_object_lock(s):
    c = s.call
    lock = {"x-amz-object-lock-mode": "GOVERNANCE",
            "x-amz-object-lock-retain-until-date": "2099-01-01T00:00:00Z"}
    out = [c("PUT", "/lk", headers={"x-amz-bucket-object-lock-enabled": "true"}),
           c("GET", "/lk", "object-lock"), c("GET", "/lk", "versioning"),
           c("PUT", "/lk", "object-lock", body=LOCK_CONF % RULE), c("GET", "/lk", "object-lock"),
           c("PUT", "/lk", "object-lock", body=b"<ObjectLockConfiguration/>"),
           c("PUT", "/lk", "versioning", body=VERSIONING % b"Suspended"),
           # the default retention's date follows the clock: the objects
           # below carry explicit dates only
           c("PUT", "/lk", "object-lock", body=LOCK_CONF % b""),
           c("GET", "/ob", "object-lock")]
    st, hs, body = s.raw("PUT", "/lk/doc", body=b"locked document", headers=lock)
    out.append(norm(st, hs, body))
    vid = hs.get("x-amz-version-id")
    out += [
        c("PUT", "/lk/bad", body=b"x", headers={**lock, "x-amz-object-lock-mode": "BOGUS"}),
        c("PUT", "/lk/bad", body=b"x", headers={**lock, "x-amz-object-lock-retain-until-date":
                                                "not a date"}),
        c("PUT", "/lk/bad", body=b"x", headers={"x-amz-object-lock-legal-hold": "MAYBE"}),
        c("PUT", "/ob/locked", body=b"x", headers=lock),
        c("GET", "/lk/doc", "retention"), c("HEAD", "/lk/doc"),
        c("PUT", "/lk/doc", "retention", body=RETENTION % (b"GOVERNANCE", b"2098-01-01T00:00:00Z")),
        c("PUT", "/lk/doc", "retention", body=RETENTION % (b"GOVERNANCE", b"2098-01-01T00:00:00Z"),
          headers=BYPASS),
        c("PUT", "/lk/doc", "retention", body=RETENTION % (b"COMPLIANCE", b"2099-06-01T00:00:00Z")),
        c("PUT", "/lk/doc", "retention", body=RETENTION % (b"GOVERNANCE", b"2099-01-01T00:00:00Z"),
          headers=BYPASS),
        c("PUT", "/lk/doc", "retention", body=RETENTION % (b"WEIRD", b"2099-01-01T00:00:00Z")),
        c("GET", "/lk/doc", "retention"),
        c("GET", "/lk/doc", "legal-hold"),
        c("PUT", "/lk/doc", "legal-hold", body=HOLD % b"ON"), c("GET", "/lk/doc", "legal-hold"),
        c("PUT", "/lk/doc", "legal-hold", body=HOLD % b"MAYBE"),
        c("DELETE", "/lk/doc", f"versionId={vid}"),
        c("DELETE", "/lk/doc", f"versionId={vid}", headers=BYPASS),
        c("PUT", "/lk/held", body=b"held", headers={"x-amz-object-lock-legal-hold": "ON"}),
        c("GET", "/lk/held", "retention"),
        c("DELETE", "/lk/doc"), c("GET", "/lk/doc"), c("GET", "/lk", "versions"),
        c("PUT", "/ob/new.bin", "legal-hold", body=HOLD % b"ON"),
        c("PUT", "/ob/new.bin", "retention", body=RETENTION % (b"GOVERNANCE", b"2099-01-01")),
        c("GET", "/ob/missing", "legal-hold"),
    ]
    return out


TAGS = "<Tagging><TagSet>{}</TagSet></Tagging>"


def tagdoc(pairs) -> bytes:
    return TAGS.format("".join(f"<Tag><Key>{k}</Key><Value>{v}</Value></Tag>"
                               for k, v in pairs)).encode()


def s_tagging(s):
    c = s.call
    return [
        c("PUT", "/ob/t.txt", body=b"tagged"), c("GET", "/ob/t.txt", "tagging"),
        c("PUT", "/ob/t.txt", "tagging", body=tagdoc([("team", "a"), ("env", "prod")])),
        c("GET", "/ob/t.txt", "tagging"),
        c("PUT", "/ob/t.txt", "tagging", body=tagdoc([("k", "1"), ("k", "2")])),
        c("PUT", "/ob/t.txt", "tagging", body=tagdoc([(f"k{i}", i) for i in range(11)])),
        c("PUT", "/ob/t.txt", "tagging", body=tagdoc([("", "v")])),
        c("PUT", "/ob/t.txt", "tagging", body=b"<bad"),
        c("GET", "/ob/t.txt", "tagging", who="reader"),
        c("DELETE", "/ob/t.txt", "tagging"), c("GET", "/ob/t.txt", "tagging"),
        c("GET", "/ob/missing", "tagging"), c("GET", "/ob/d", "tagging"),
        c("POST", "/ob/t.txt", "tagging"),
    ]


def delete_doc(objs, quiet=False) -> bytes:
    body = "".join(f"<Object><Key>{k}</Key>" + (f"<VersionId>{v}</VersionId>" if v else "")
                   + "</Object>" for k, v in objs)
    return (f"<Delete>{'<Quiet>true</Quiet>' if quiet else ''}{body}</Delete>").encode()


def s_delete_objects(s):
    c = s.call
    out = [c("PUT", f"/ob/del/{i}", body=seeded_bytes(900 + i, 700 * i)) for i in range(1, 5)]
    out += [c("POST", "/ob", "delete", body=delete_doc([("del/1", ""), ("del/2", ""),
                                                        ("nope", "")])),
            c("POST", "/ob", "delete", body=delete_doc([("del/3", "")], quiet=True)),
            c("POST", "/ob", "delete", body=b"<Delete><Object>"),
            c("POST", "/ob", "delete", body=delete_doc([("del/4", "")]), who="reader"),
            c("GET", "/ob", "list-type=2&prefix=del/")]
    st, hs, body = s.raw("GET", "/vb", "versions")
    versions = [(k, v) for k, v in zip(_text(body, "Key"), _text(body, "VersionId"))]
    out += [c("POST", "/vb", "delete", body=delete_doc([("k", "")])),
            c("POST", "/vb", "delete", body=delete_doc(versions[:2])),
            c("GET", "/vb", "versions")]
    st, hs, body = s.raw("GET", "/lk", "versions")
    locked = [(k, v) for k, v in zip(_text(body, "Key"), _text(body, "VersionId"))]
    out += [c("POST", "/lk", "delete", body=delete_doc(locked)),
            c("POST", "/lk", "delete", body=delete_doc(locked), headers=BYPASS),
            c("GET", "/lk", "versions")]
    return out


STEPS = [(f.__name__[2:], f) for f in (
    s_put_get, s_list, s_copy, s_multipart, s_chunked, s_post_policy, s_sse, s_versioning,
    s_object_lock, s_tagging, s_delete_objects)]


def cross_decrypt(sides) -> dict:
    """Each package decrypts the SSE objects the other stored, with its own
    keyring (the two keyrings hold one pinned master key)."""
    out = {}
    for reader, writer in (("port", "jax"), ("jax", "port")):
        sse, keyring = PKGS[reader].sse, sides[reader].s3.sse_keyring
        f = sides[writer].filer
        got = {}
        for key, ck in (("sse-s3.bin", None), ("sse-c.bin", KEY1), ("mp-s3.bin", None),
                        ("mp-c.bin", KEY1), ("c-from-s3.bin", KEY2)):
            e = f.find_entry(f"/buckets/ob/{key}")
            dk = sse.decrypt_key_for_entry(e, ck, keyring)
            got[key] = hashlib.sha256(sse.read_decrypted(
                lambda o, n, e=e: f.read_entry(e, o, n), e, dk, 0, -1)).hexdigest()
        out[f"{reader} reads {writer}"] = got
    return out


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    return run_scenario(tmp_path_factory.mktemp("s3-objects"), STEPS, after=cross_decrypt)


@pytest.mark.parametrize("step", [name for name, _ in STEPS])
def test_object_step_against_jax(scenario, step):
    jax, port = scenario["jax"][step], scenario["port"][step]
    assert port[0] != "raised", port[1]
    assert port[0] == jax[0], "the answers"
    assert port[1] == jax[1], "the /buckets tree"
    assert port[2] == jax[2], "the filer's KV"


def test_each_package_decrypts_what_the_other_stored(scenario):
    got = scenario["after"]
    assert got["port reads jax"] == got["jax reads port"]
    want = {"sse-s3.bin": seeded_bytes(700, 100_000), "sse-c.bin": seeded_bytes(701, 50_000),
            "mp-s3.bin": seeded_bytes(700, 100_000) + seeded_bytes(701, 50_000),
            "mp-c.bin": seeded_bytes(701, 50_000) + seeded_bytes(702, 300),
            "c-from-s3.bin": seeded_bytes(700, 100_000)}
    assert got["port reads jax"] == {k: hashlib.sha256(v).hexdigest() for k, v in want.items()}


def test_the_object_scenario_reaches_what_it_means_to(scenario):
    ans = scenario["port"]
    codes = {a[0] for _, (answers, _, _) in ans.items() for a in answers}
    assert {200, 204, 206, 304, 400, 403, 404, 405, 409, 412, 416, 501} <= codes, codes
    pg = ans["put_get"][0]
    assert [a[0] for a in pg[7:13]] == [200] * 6
    assert pg[13][0] == 200 and pg[13][1]["content-length"] == str(SIZES[5])
    assert pg[14][0] == 206 and pg[14][1]["content-range"] == f"bytes 0-99/{SIZES[5]}"
    mp = ans["multipart"][0]
    assert mp[6][0] == 200 and b'-3"</ETag>' in mp[6][2]
    assert mp[7][2] == (170_300, hashlib.sha256(
        seeded_bytes(400, 100_000) + seeded_bytes(401, 70_000) + seeded_bytes(402, 300)).hexdigest())
    assert [mp[i][0] for i in (11, 16, 17, 18, 23, 24, 28)] == [404, 204, 404, 404, 400, 400, 404]
    ch = ans["chunked"][0]
    assert ch[0][0] == 200 and ch[1][2] == (100_000, hashlib.sha256(
        seeded_bytes(500, 100_000)).hexdigest())
    assert ch[4][0] == 403 and ch[5][0] == 404 and ch[7][0] == 200
    pp = ans["post_policy"][0]
    assert [a[0] for a in pp] == [204, 200, 201, 200, 403, 403, 403, 400, 400, 403, 403, 404, 204,
                                  400]
    assert pp[1][2] == (20_000, hashlib.sha256(seeded_bytes(600, 20_000)).hexdigest())
    sse = ans["sse"][0]
    assert sse[0][1]["x-amz-server-side-encryption"] == "AES256"
    assert sse[1][2] == (100_000, hashlib.sha256(seeded_bytes(700, 100_000)).hexdigest())
    assert [sse[i][0] for i in (5, 6, 7)] == [400, 403, 200]
