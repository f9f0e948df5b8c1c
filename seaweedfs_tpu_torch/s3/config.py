"""S3 gateway identity/role configuration.

Port of seaweedfs_tpu/s3/config.py, whole: `load_s3_config` builds the
port's OIDC and LDAP providers where the JAX one builds its own.

Reference: weed/s3api auth_credentials.go loading identities.json (the
`-s3.config` flag) — names, key pairs, coarse actions, and IAM policy
documents; plus STS roles.

    {"identities": [
        {"name": "admin", "accessKey": "AK", "secretKey": "SK",
         "actions": ["Admin"]},
        {"name": "ro", "accessKey": "AK2", "secretKey": "SK2",
         "policies": [{"Version": "2012-10-17", "Statement": [...]}]}],
     "roles": [
        {"name": "uploader", "trusted": ["AK"],
         "policies": [{"Statement": [...]}]}]}
"""

from __future__ import annotations

import json
import threading
import time

from ..iam.sts import Role, StsService
from .auth import Identity, IdentityStore

# Filer KV key holding the dynamic identity config (written by the
# shell's s3.* command family, read by every gateway over the filer —
# the reference keeps the same file at /etc/iam/identity.json).
S3_IDENTITY_KV = b"s3/identity.json"


def mint_key_pair() -> tuple[str, str]:
    """One credential format for every minting surface (shell
    s3.accesskey.create AND the embedded IAM API)."""
    import secrets

    return "SW" + secrets.token_hex(9).upper(), secrets.token_urlsafe(30)


def identity_from_conf(ident: dict) -> Identity:
    return Identity(
        name=ident.get("name", ident["accessKey"]),
        access_key=ident["accessKey"],
        secret_key=ident["secretKey"],
        actions=tuple(ident.get("actions", ())) or (),
        policies=tuple(ident.get("policies", ())),
    )


class FilerIdentityStore:
    """IdentityStore facade layering dynamic, filer-persisted
    credentials (s3/identity.json in the filer KV, maintained by the
    shell `s3.*` commands) over an optional static base store (CLI
    flags / config file). The KV is re-read at most every `ttl`
    seconds, so a key created in the shell authenticates against every
    gateway within seconds — and creating the FIRST identity flips an
    open-mode gateway to authenticated mode."""

    def __init__(self, filer, base: IdentityStore | None = None, ttl: float = 2.0):
        self.base = base or IdentityStore()
        self._filer = filer
        self._ttl = ttl
        self._next = 0.0
        self._blob: bytes | None = None
        self._dynamic: dict[str, Identity] = {}
        self._lock = threading.Lock()

    # --- IdentityStore surface ---

    @property
    def sts(self):
        return self.base.sts

    @sts.setter
    def sts(self, value):
        self.base.sts = value

    def add(self, ident: Identity) -> None:
        self.base.add(ident)

    def lookup(self, access_key: str) -> Identity | None:
        found = self.base.lookup(access_key)
        if found is not None:
            return found
        self._refresh()
        return self._dynamic.get(access_key)

    @property
    def empty(self) -> bool:
        if not self.base.empty or self._dynamic:
            return False
        self._refresh()
        return not self._dynamic

    # --- dynamic reload ---

    def _refresh(self) -> None:
        now = time.monotonic()
        with self._lock:
            if now < self._next:
                return
            self._next = now + self._ttl
            try:
                raw = self._filer.store.kv_get(S3_IDENTITY_KV)
            except Exception:  # noqa: BLE001 — keep serving the last view
                return
            if raw == self._blob:
                return
            self._blob = raw
            dyn: dict[str, Identity] = {}
            if raw:
                try:
                    conf = json.loads(raw)
                except json.JSONDecodeError:
                    return  # malformed config: keep the previous view
                for ident in conf.get("identities", []):
                    try:
                        i = identity_from_conf(ident)
                    except KeyError:
                        continue
                    if not i.access_key:
                        # keyless placeholder (IAM CreateUser before
                        # CreateAccessKey): a user, not a credential
                        continue
                    dyn[i.access_key] = i
            self._dynamic = dyn


def load_s3_config(path: str):
    """-> (IdentityStore, StsService | None, OidcProvider | None,
    LdapProvider | None)."""
    with open(path) as f:
        conf = json.load(f)
    store = IdentityStore()
    for ident in conf.get("identities", []):
        store.add(identity_from_conf(ident))
    oidc = None
    if conf.get("oidc"):
        from ..iam.oidc import OidcProvider

        oidc = OidcProvider(**conf["oidc"])
    ldap = None
    if conf.get("ldap"):
        from ..iam.ldap import LdapProvider

        ldap = LdapProvider(**conf["ldap"])
    sts = None
    roles = conf.get("roles", [])
    if roles and store.empty and oidc is None:
        # roles without identities would leave the gateway in open mode
        # (anonymous = admin) with STS credentials never verified —
        # refuse the misconfiguration instead of silently ignoring it
        raise ValueError(
            f"{path}: 'roles' configured but no 'identities'; "
            "an empty identity store runs the gateway in open mode"
        )
    if roles:
        sts = StsService()
        for r in roles:
            sts.put_role(
                Role(
                    name=r["name"],
                    policies=list(r.get("policies", [])),
                    trusted=list(r.get("trusted", ["*"])),
                )
            )
        store.sts = sts
    if ldap is not None and sts is None:
        raise ValueError(
            f"{path}: 'ldap' requires 'roles' (LDAP identities assume a "
            "role for their credentials)"
        )
    return store, sts, oidc, ldap
