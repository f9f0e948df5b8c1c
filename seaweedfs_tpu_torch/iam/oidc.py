"""OIDC bearer-token authentication for the S3 gateway.

Port of seaweedfs_tpu/iam/oidc.py, whole: the same checks, errors and
role mapping, over the port's `utils/security` and `s3/auth`.

Reference: weed/iam (OIDC provider wiring in the advanced IAM config):
clients present `Authorization: Bearer <jwt>`; the gateway verifies
the token against the configured issuer's keys and maps claims to an
identity with attached policies. Zero-egress build: keys are
CONFIGURED (shared secret for HS256 or PEM public key for RS256), not
fetched from a JWKS endpoint — the SPI seam (`OidcProvider.verify`)
is where a JWKS-fetching deployment plugs in.

Config shape (s3 config file / constructor):

    {"issuer": "https://idp.example", "audience": "seaweedfs",
     "hs256_secret": "...",            # or
     "rs256_public_key_pem": "-----BEGIN PUBLIC KEY-----...",
     "role_claim": "roles",
     "roles": {"admin": {"actions": ["Admin"]},
               "reader": {"policies": [{...}]}}}
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import json
import time

from ..utils.security import _unb64 as _unb64_bytes


class OidcError(Exception):
    pass


def _unb64(s: str) -> bytes:
    return _unb64_bytes(s.encode())


class OidcProvider:
    def __init__(
        self,
        issuer: str,
        audience: str = "",
        hs256_secret: str = "",
        rs256_public_key_pem: str = "",
        role_claim: str = "roles",
        roles: dict | None = None,
        clock_skew: float = 60.0,
    ):
        if not hs256_secret and not rs256_public_key_pem:
            raise ValueError("OIDC needs hs256_secret or rs256_public_key_pem")
        self.issuer = issuer
        self.audience = audience
        self.role_claim = role_claim
        self.roles = roles or {}
        self.clock_skew = clock_skew
        self._hs_secret = hs256_secret.encode() if hs256_secret else None
        self._rs_key = None
        if rs256_public_key_pem:
            from cryptography.hazmat.primitives.serialization import (
                load_pem_public_key,
            )

            self._rs_key = load_pem_public_key(rs256_public_key_pem.encode())

    # ------------------------------------------------------------- verify

    def verify(self, token: str) -> dict:
        """-> validated claims dict; raises OidcError on ANY failure
        (fail closed: an unverifiable bearer is not anonymous, it is
        rejected)."""
        try:
            h_b64, p_b64, sig_b64 = token.split(".")
            header = json.loads(_unb64(h_b64))
            claims = json.loads(_unb64(p_b64))
            sig = _unb64(sig_b64)
        except (ValueError, json.JSONDecodeError) as e:
            raise OidcError(f"malformed token: {e}") from None
        alg = header.get("alg")
        signing_input = f"{h_b64}.{p_b64}".encode()
        if alg == "HS256":
            if self._hs_secret is None:
                raise OidcError("HS256 token but no shared secret configured")
            want = hmac_mod.new(
                self._hs_secret, signing_input, hashlib.sha256
            ).digest()
            if not hmac_mod.compare_digest(want, sig):
                raise OidcError("signature mismatch")
        elif alg == "RS256":
            if self._rs_key is None:
                raise OidcError("RS256 token but no public key configured")
            from cryptography.exceptions import InvalidSignature
            from cryptography.hazmat.primitives.asymmetric import padding
            from cryptography.hazmat.primitives.hashes import SHA256

            try:
                self._rs_key.verify(
                    sig, signing_input, padding.PKCS1v15(), SHA256()
                )
            except InvalidSignature:
                raise OidcError("signature mismatch") from None
        else:
            raise OidcError(f"unsupported alg {alg!r}")

        now = time.time()
        if claims.get("iss") != self.issuer:
            raise OidcError(f"wrong issuer {claims.get('iss')!r}")
        if self.audience:
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                raise OidcError(f"wrong audience {aud!r}")

        def num(name):
            v = claims.get(name)
            if v is None:
                return None
            try:
                return float(v)
            except (TypeError, ValueError):
                # contract: OidcError on ANY failure — a misbehaving
                # IdP's exp:"never" must 403, not 400/500
                raise OidcError(f"non-numeric {name} claim") from None

        exp = num("exp")
        if exp is None or now > exp + self.clock_skew:
            raise OidcError("token expired")
        nbf = num("nbf")
        if nbf is not None and now < nbf - self.clock_skew:
            raise OidcError("token not yet valid")
        return claims

    # ----------------------------------------------------------- identity

    def identity_for(self, claims: dict):
        """Map verified claims to an s3.auth.Identity via the role
        table; unmapped subjects get NO permissions (fail closed)."""
        from ..s3.auth import Identity

        raw = claims.get(self.role_claim) or []
        names = raw if isinstance(raw, list) else [raw]
        actions: list[str] = []
        policies: list[dict] = []
        for r in names:
            conf = self.roles.get(str(r))
            if not conf:
                continue
            actions.extend(conf.get("actions", []))
            policies.extend(conf.get("policies", []))
        return Identity(
            name=f"oidc:{claims.get('sub', '?')}",
            access_key="",
            secret_key="",
            actions=tuple(actions),
            policies=tuple(policies),
        )
