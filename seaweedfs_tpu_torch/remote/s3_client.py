"""SigV4-signing S3 client (the remote_storage SPI's one concrete
implementation).

Port of seaweedfs_tpu/remote/s3_client.py (reference
weed/remote_storage/s3): list/read/write/delete objects on an
S3-compatible endpoint. Signing is AWS Signature V4 (header form), the
mirror image of the gateway's verify_v4, written as in the JAX client.

Where the two differ, on purpose: the JAX client sends over a
`requests.Session`; the card's host has no `requests`, so the port sends
over `http.client` through `utils/urls.connection` (https with the
process's client context where the endpoint is https), its connections
kept alive between requests (`urls.KeptConnections`, one per request in
flight, so a client shared by a server's threads reuses them). The
retried connection failures are `OSError` and `http.client.HTTPException`,
where the JAX client names `requests.ConnectionError` and
`requests.Timeout`. `_request` answers a `urls.Answer` with the
`status_code`, `headers`, `content`, `text` and `json()` its callers read.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass

from ..utils import urls
from ..utils.retry import RetryError, RetryPolicy, retry_call


class RemoteStorageError(Exception):
    pass


class TransientRemoteError(RemoteStorageError):
    """Retryable remote failure: connection reset, timeout, HTTP 5xx or
    429. Permanent rejections (4xx) stay RemoteStorageError and are
    never retried."""


# Unified policy (utils/retry.py): 3 quick signed attempts. Each
# attempt re-signs (fresh x-amz-date), so a retry is never rejected for
# clock skew accumulated while backing off.
DEFAULT_S3_RETRY_POLICY = RetryPolicy(
    max_attempts=3,
    base_delay=0.2,
    max_delay=2.0,
    retry_on=(
        TransientRemoteError,
        OSError,
        http.client.HTTPException,
    ),
)


@dataclass
class RemoteObject:
    key: str
    size: int
    etag: str = ""
    mtime: str = ""


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class RemoteS3Client:
    def __init__(
        self,
        endpoint: str,
        access_key: str = "",
        secret_key: str = "",
        region: str = "us-east-1",
        retry_policy: RetryPolicy | None = DEFAULT_S3_RETRY_POLICY,
    ):
        """endpoint: http(s)://host:port (path-style addressing).
        `retry_policy` governs transient-failure retries per request
        (None disables)."""
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.retry_policy = retry_policy
        self._http = urls.KeptConnections()

    # ------------------------------------------------------------ sigv4

    def _headers(
        self, method: str, path: str, query: str, payload: bytes
    ) -> dict:
        host = urllib.parse.urlparse(self.endpoint).netloc
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        phash = hashlib.sha256(payload).hexdigest()
        headers = {
            "Host": host,
            "x-amz-date": amz_date,
            "x-amz-content-sha256": phash,
        }
        if not self.access_key:
            return headers  # anonymous (open-mode gateways)
        canonical_q = "&".join(
            sorted(
                f"{urllib.parse.quote(k, safe='')}="
                f"{urllib.parse.quote(v, safe='')}"
                for k, v in urllib.parse.parse_qsl(
                    query, keep_blank_values=True
                )
            )
        )
        signed = "host;x-amz-content-sha256;x-amz-date"
        canonical = "\n".join(
            [
                method,
                urllib.parse.quote(path),
                canonical_q,
                f"host:{host}\n"
                f"x-amz-content-sha256:{phash}\n"
                f"x-amz-date:{amz_date}\n",
                signed,
                phash,
            ]
        )
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical.encode()).hexdigest(),
            ]
        )
        k = _sign(
            _sign(
                _sign(
                    _sign(
                        ("AWS4" + self.secret_key).encode(), datestamp
                    ),
                    self.region,
                ),
                "s3",
            ),
            "aws4_request",
        )
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}"
        )
        return headers

    def close(self) -> None:
        """Close the kept connections."""
        self._http.close()

    def _request(
        self,
        method: str,
        path: str,
        query: str = "",
        payload: bytes = b"",
        extra_headers: dict | None = None,
        ok=(200,),
    ) -> urls.Answer:
        url = self.endpoint + urllib.parse.quote(path)
        if query:
            url += "?" + query

        def attempt() -> urls.Answer:
            headers = self._headers(method, path, query, payload)
            if extra_headers:
                headers.update(extra_headers)
            r = self._http.request(method, url, body=payload or None, headers=headers,
                                   timeout=60)
            if r.status_code not in ok:
                err = (
                    TransientRemoteError
                    if r.status_code >= 500 or r.status_code == 429
                    else RemoteStorageError
                )
                raise err(
                    f"{method} {path}: HTTP {r.status_code} {r.text[:200]}"
                )
            return r

        if self.retry_policy is None:
            return attempt()
        try:
            return retry_call(
                attempt, self.retry_policy, describe=f"s3 {method} {path}"
            )
        except RetryError as e:
            # callers classify on RemoteStorageError — surface the last
            # underlying failure in that taxonomy, not the retry wrapper
            cause = e.__cause__
            if isinstance(cause, RemoteStorageError):
                raise cause from e
            raise RemoteStorageError(str(e)) from e

    # ------------------------------------------------------- operations

    def list_objects(
        self, bucket: str, prefix: str = "", max_keys: int = 100_000
    ) -> list[RemoteObject]:
        """Full listing via ListObjectsV2 continuation."""
        out: list[RemoteObject] = []
        token = ""
        while len(out) < max_keys:
            q = "list-type=2&max-keys=1000"
            if prefix:
                q += "&prefix=" + urllib.parse.quote(prefix, safe="")
            if token:
                q += "&continuation-token=" + urllib.parse.quote(
                    token, safe=""
                )
            r = self._request("GET", f"/{bucket}", q)
            root = ET.fromstring(r.content)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for c in root.findall(f"{ns}Contents"):
                out.append(
                    RemoteObject(
                        key=c.findtext(f"{ns}Key", ""),
                        size=int(c.findtext(f"{ns}Size", "0")),
                        etag=c.findtext(f"{ns}ETag", "").strip('"'),
                        mtime=c.findtext(f"{ns}LastModified", ""),
                    )
                )
            token = root.findtext(f"{ns}NextContinuationToken", "")
            if root.findtext(f"{ns}IsTruncated", "false") != "true" or not token:
                break
        return out

    def get_object(
        self, bucket: str, key: str, offset: int = 0, size: int = -1
    ) -> bytes:
        headers = {}
        if offset or size >= 0:
            end = "" if size < 0 else str(offset + size - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        r = self._request(
            "GET",
            f"/{bucket}/{key}",
            extra_headers=headers,
            ok=(200, 206),
        )
        data = r.content
        if r.status_code == 200 and (offset or size >= 0):
            data = data[offset : offset + size if size >= 0 else None]
        return data

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        self._request("PUT", f"/{bucket}/{key}", payload=data, ok=(200, 201))

    def delete_object(self, bucket: str, key: str) -> None:
        self._request(
            "DELETE", f"/{bucket}/{key}", ok=(200, 202, 204, 404)
        )

    def head_object(self, bucket: str, key: str) -> RemoteObject | None:
        try:
            # the HEAD's empty body is read with it, so the kept
            # connection stays framed
            r = self._request("HEAD", f"/{bucket}/{key}")
        except RemoteStorageError:
            return None
        return RemoteObject(
            key=key,
            size=int(r.headers.get("Content-Length", "0")),
            etag=r.headers.get("ETag", "").strip('"'),
        )

    def ensure_bucket(self, bucket: str) -> None:
        self._request("PUT", f"/{bucket}", ok=(200, 201, 409))

    def list_buckets(self) -> list[str]:
        """GET / (ListAllMyBuckets) -> bucket names."""
        r = self._request("GET", "/")
        root = ET.fromstring(r.content)
        ns = root.tag[: root.tag.index("}") + 1] if root.tag.startswith("{") else ""
        return [
            e.text or ""
            for e in root.findall(f".//{ns}Bucket/{ns}Name")
            if e.text
        ]
