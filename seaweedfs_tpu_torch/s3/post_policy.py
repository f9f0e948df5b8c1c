"""POST-policy form uploads (browser-based uploads).

Port of seaweedfs_tpu/s3/post_policy.py, whole.

Reference: weed/s3api/s3api_object_handlers_postpolicy.go +
weed/s3api/policy/post-policy.go. A browser POSTs multipart/form-data
to the bucket URL with a base64 policy document, a SigV4 signature
over that exact base64 string, and the file; the server verifies the
signature with the credential's secret, checks the policy's expiration
and conditions, then stores the object.
"""

from __future__ import annotations

import base64
import datetime as _dt
import hmac
import json

from .auth import S3AuthError, signing_key


def parse_multipart_form(body: bytes, content_type: str) -> tuple[dict, bytes, str]:
    """-> (fields, file_bytes, filename). Minimal RFC 2046 parser: the
    S3 POST form is flat (no nested multiparts), fields are text, and
    exactly one part is named `file` (everything after it is ignored,
    per AWS)."""
    boundary = ""
    for seg in content_type.split(";"):
        seg = seg.strip()
        if seg.startswith("boundary="):
            boundary = seg[len("boundary=") :].strip('"')
    if not boundary:
        raise S3AuthError("MalformedPOSTRequest", "missing multipart boundary")
    # RFC 2046 framing: parts are delimited by CRLF + "--boundary"; the
    # CRLF belongs to the DELIMITER, not the payload, so splitting on it
    # preserves payloads that themselves end in CR/LF bytes (a
    # .strip(b"\r\n") here would silently corrupt such files).
    delim = b"\r\n--" + boundary.encode()
    fields: dict[str, str] = {}
    file_bytes: bytes | None = None
    filename = ""
    segments = (b"\r\n" + body).split(delim)
    for part in segments[1:]:  # [0] is the preamble
        if part.startswith(b"--"):
            break  # closing delimiter
        if part.startswith(b"\r\n"):
            part = part[2:]
        head, _, payload = part.partition(b"\r\n\r\n")
        disp = ""
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-disposition:"):
                disp = line.decode("utf-8", "replace")
        name = ""
        fname = ""
        for seg in disp.split(";"):
            seg = seg.strip()
            if seg.startswith("name="):
                name = seg[5:].strip('"')
            elif seg.startswith("filename="):
                fname = seg[9:].strip('"')
        if not name:
            continue
        if name == "file":
            if file_bytes is None:
                file_bytes = payload
                filename = fname
        else:
            fields[name.lower()] = payload.decode("utf-8", "replace")
    if file_bytes is None:
        raise S3AuthError("MalformedPOSTRequest", "form has no file part")
    return fields, file_bytes, filename


def verify_post_signature(identities, fields: dict, region: str):
    """SigV4 policy signature check -> the signing Identity."""
    policy_b64 = fields.get("policy")
    if not policy_b64:
        raise S3AuthError("AccessDenied", "POST without policy")
    algo = fields.get("x-amz-algorithm", "")
    if algo != "AWS4-HMAC-SHA256":
        raise S3AuthError("AccessDenied", f"unsupported algorithm {algo!r}")
    cred = fields.get("x-amz-credential", "")
    try:
        access_key, date, cred_region, service, term = cred.split("/")
    except ValueError:
        raise S3AuthError("AccessDenied", f"malformed credential {cred!r}") from None
    if service != "s3" or term != "aws4_request":
        raise S3AuthError("AccessDenied", "malformed credential scope")
    ident = identities.lookup(access_key)
    if ident is None:
        raise S3AuthError("InvalidAccessKeyId", access_key)
    sk = signing_key(ident.secret_key, date, cred_region)
    want = hmac.new(sk, policy_b64.encode(), "sha256").hexdigest()
    got = fields.get("x-amz-signature", "")
    if not hmac.compare_digest(want, got):
        raise S3AuthError("SignatureDoesNotMatch", "POST policy signature")
    return ident


def check_policy_document(
    fields: dict, file_size: int, bucket: str, key: str
) -> None:
    """Enforce expiration + conditions of the (already authenticated)
    policy document against the submitted form."""
    try:
        doc = json.loads(base64.b64decode(fields["policy"]))
    except Exception:
        raise S3AuthError("MalformedPOSTRequest", "policy is not base64 JSON") from None

    exp = doc.get("expiration")
    if not exp:
        raise S3AuthError("MalformedPOSTRequest", "policy missing expiration")
    try:
        when = _dt.datetime.fromisoformat(exp.replace("Z", "+00:00"))
    except ValueError:
        raise S3AuthError("MalformedPOSTRequest", f"bad expiration {exp!r}") from None
    if when <= _dt.datetime.now(_dt.timezone.utc):
        raise S3AuthError("AccessDenied", "policy expired")

    def form_value(name: str) -> str:
        if name == "bucket":
            return bucket
        if name == "key":
            return key
        return fields.get(name.lower(), "")

    # AWS rule: every form field except x-amz-signature, file, policy
    # and x-ignore-* MUST be covered by a condition — otherwise the
    # holder of a signed form could append unauthorized fields (e.g.
    # acl=public-read-write) the signer never approved.
    covered: set[str] = {"bucket"}
    for cond in doc.get("conditions", []):
        if isinstance(cond, dict):
            covered.update(k.lower() for k in cond)
        elif isinstance(cond, list) and len(cond) == 3:
            covered.add(str(cond[1]).lstrip("$").lower())
    exempt = {"policy", "x-amz-signature", "file"}
    for name in fields:
        if name in exempt or name.startswith("x-ignore-"):
            continue
        if name not in covered:
            raise S3AuthError(
                "AccessDenied",
                f"form field {name!r} is not covered by the policy",
            )

    for cond in doc.get("conditions", []):
        if isinstance(cond, dict):
            for k, v in cond.items():
                if form_value(k) != str(v):
                    raise S3AuthError(
                        "AccessDenied",
                        f"policy condition failed: {k} == {v!r}",
                    )
        elif isinstance(cond, list) and len(cond) == 3:
            op, name, val = cond
            op = str(op).lower()
            if op == "content-length-range":
                lo, hi = int(name), int(val)
                if not (lo <= file_size <= hi):
                    raise S3AuthError(
                        "EntityTooLarge"
                        if file_size > hi
                        else "EntityTooSmall",
                        f"file size {file_size} outside [{lo}, {hi}]",
                    )
                continue
            field = str(name).lstrip("$")
            have = form_value(field)
            if op == "eq" and have != str(val):
                raise S3AuthError(
                    "AccessDenied", f"policy condition failed: {field} eq {val!r}"
                )
            if op == "starts-with" and not have.startswith(str(val)):
                raise S3AuthError(
                    "AccessDenied",
                    f"policy condition failed: {field} starts-with {val!r}",
                )
        else:
            raise S3AuthError(
                "MalformedPOSTRequest", f"unparseable condition {cond!r}"
            )
