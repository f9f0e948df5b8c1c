"""Write/read authorization JWTs.

Port of seaweedfs_tpu/utils/security.py (weed/security/jwt.go): the
master signs a short-lived token scoped to one fid, and a server checks
it before it takes a write. HMAC-SHA256 compact JWS, standard library
only; the tokens are byte-identical to the JAX package's under the same
clock.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


class JwtError(Exception):
    pass


def _b64(b: bytes) -> bytes:
    return base64.urlsafe_b64encode(b).rstrip(b"=")


def _unb64(s: bytes) -> bytes:
    return base64.urlsafe_b64decode(s + b"=" * (-len(s) % 4))


def sign_jwt(key: str, fid: str, ttl_seconds: int = 10) -> str:
    """Token authorizing one operation on one fid."""
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64(json.dumps({"fid": fid, "exp": int(time.time()) + ttl_seconds}).encode())
    msg = header + b"." + payload
    sig = _b64(hmac.new(key.encode(), msg, hashlib.sha256).digest())
    return (msg + b"." + sig).decode()


def verify_jwt(key: str, token: str, fid: str) -> None:
    """Raises JwtError unless the token is valid, unexpired, and scoped
    to this fid."""
    try:
        header_b, payload_b, sig_b = token.encode().split(b".")
    except ValueError:
        raise JwtError("malformed token") from None
    msg = header_b + b"." + payload_b
    want = _b64(hmac.new(key.encode(), msg, hashlib.sha256).digest())
    if not hmac.compare_digest(want, sig_b):
        raise JwtError("bad signature")
    try:
        payload = json.loads(_unb64(payload_b))
    except (ValueError, json.JSONDecodeError):
        raise JwtError("malformed payload") from None
    if payload.get("exp", 0) < time.time():
        raise JwtError("token expired")
    claimed = payload.get("fid", "")
    # a token scoped to a fid also covers its volume ("vid,fid" or "vid")
    if claimed not in (fid, fid.split(",")[0]):
        raise JwtError("token not valid for this fid")
