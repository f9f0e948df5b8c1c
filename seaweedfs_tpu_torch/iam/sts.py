"""STS: temporary credentials via AssumeRole.

Port of seaweedfs_tpu/iam/sts.py, whole.

Reference: weed/iam/sts (sts_service.go AssumeRole* flows) collapsed to
the self-hosted form: roles are named bundles of policy documents; an
identity whose policies allow ``sts:AssumeRole`` on the role's ARN can
mint short-lived credentials (ASIA… access key + session token) that
the S3 gateway verifies like any other identity, plus token expiry and
the x-amz-security-token header check.
"""

from __future__ import annotations

import hmac
import hashlib
import os
import threading
import time
from dataclasses import dataclass, field

from .policy import evaluate_policies


@dataclass
class Role:
    name: str
    policies: list[dict] = field(default_factory=list)
    # principals allowed to assume (access key ids or "*"); evaluated
    # IN ADDITION to the caller's own sts:AssumeRole policy grant
    trusted: list[str] = field(default_factory=lambda: ["*"])

    @property
    def arn(self) -> str:
        return f"arn:aws:iam:::role/{self.name}"


@dataclass
class TempCredential:
    access_key: str
    secret_key: str
    session_token: str
    role: Role
    expires_at: float

    @property
    def expired(self) -> bool:
        return time.time() >= self.expires_at


class StsService:
    MAX_DURATION = 12 * 3600
    MIN_DURATION = 900

    def __init__(self):
        self._roles: dict[str, Role] = {}
        self._creds: dict[str, TempCredential] = {}
        self._lock = threading.Lock()

    # --------------------------------------------------------------- roles

    def put_role(self, role: Role) -> None:
        with self._lock:
            self._roles[role.name] = role

    def get_role(self, name: str) -> Role | None:
        return self._roles.get(name)

    # ------------------------------------------------------------- assume

    def assume_role(
        self,
        caller_access_key: str,
        caller_policies: list[dict],
        role_name: str,
        duration: int = 3600,
    ) -> TempCredential:
        role = self._roles.get(role_name)
        if role is None:
            raise PermissionError(f"no such role {role_name!r}")
        if "*" not in role.trusted and caller_access_key not in role.trusted:
            raise PermissionError(f"{caller_access_key} not trusted by role")
        if caller_policies is not None and not evaluate_policies(
            caller_policies, "sts:AssumeRole", role.arn
        ):
            raise PermissionError("caller policy denies sts:AssumeRole")
        duration = max(self.MIN_DURATION, min(int(duration), self.MAX_DURATION))
        ak = "ASIA" + os.urandom(8).hex().upper()
        sk = os.urandom(20).hex()
        token = hmac.new(
            os.urandom(16), f"{ak}{time.time_ns()}".encode(), hashlib.sha256
        ).hexdigest()
        cred = TempCredential(
            access_key=ak,
            secret_key=sk,
            session_token=token,
            role=role,
            expires_at=time.time() + duration,
        )
        with self._lock:
            self._creds[ak] = cred
            self._gc_locked()
        return cred

    def lookup(self, access_key: str) -> TempCredential | None:
        cred = self._creds.get(access_key)
        if cred is None:
            return None
        if cred.expired:
            with self._lock:
                self._creds.pop(access_key, None)
            return None
        return cred

    def _gc_locked(self) -> None:
        now = time.time()
        for ak in [a for a, c in self._creds.items() if c.expires_at < now]:
            del self._creds[ak]
