"""AWS-style IAM policy evaluation.

Port of seaweedfs_tpu/iam/policy.py, whole and stdlib only: its verdicts
are the JAX module's for every document and request.

Reference: weed/iam/policy/policy_engine.go (2,022 LoC: statement
matching with wildcards + condition evaluators) and
weed/s3api/auth_credentials.go (identity -> policy binding).

Documents are standard AWS policy JSON:

    {"Version": "2012-10-17",
     "Statement": [{"Sid": "ro", "Effect": "Allow",
                    "Action": ["s3:GetObject", "s3:ListBucket"],
                    "Resource": "arn:aws:s3:::logs/*",
                    "Condition": {"IpAddress": {"aws:SourceIp": "10.0.0.0/8"}}}]}

Evaluation order is AWS's: explicit Deny wins over any Allow; no
matching Allow = implicit deny.
"""

from __future__ import annotations

import fnmatch
import ipaddress
from typing import Iterable


class PolicyError(Exception):
    pass


def _as_list(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _wildcard_match(pattern: str, value: str) -> bool:
    """AWS wildcard semantics: * matches any run (including '/'),
    ? matches one char. fnmatch's [seq] has no AWS meaning — escape."""
    pattern = pattern.replace("[", "[[]")
    return fnmatch.fnmatchcase(value, pattern)


# ------------------------------------------------------------- conditions


def _cond_string_equals(want: list[str], have: str) -> bool:
    return have in want


def _cond_string_like(want: list[str], have: str) -> bool:
    return any(_wildcard_match(w, have) for w in want)


def _cond_ip(want: list[str], have: str) -> bool:
    try:
        ip = ipaddress.ip_address(have)
    except ValueError:
        return False
    for cidr in want:
        try:
            if ip in ipaddress.ip_network(cidr, strict=False):
                return True
        except ValueError:
            continue
    return False


def _numeric(op):
    def check(want: list[str], have: str) -> bool:
        try:
            h = float(have)
        except (TypeError, ValueError):
            return False
        return any(op(h, float(w)) for w in want)

    return check


_CONDITION_EVALUATORS = {
    "StringEquals": _cond_string_equals,
    "StringNotEquals": lambda w, h: not _cond_string_equals(w, h),
    "StringLike": _cond_string_like,
    "StringNotLike": lambda w, h: not _cond_string_like(w, h),
    "IpAddress": _cond_ip,
    "NotIpAddress": lambda w, h: not _cond_ip(w, h),
    "NumericEquals": _numeric(lambda a, b: a == b),
    "NumericLessThan": _numeric(lambda a, b: a < b),
    "NumericLessThanEquals": _numeric(lambda a, b: a <= b),
    "NumericGreaterThan": _numeric(lambda a, b: a > b),
    "NumericGreaterThanEquals": _numeric(lambda a, b: a >= b),
    "Bool": lambda w, h: str(h).lower() in [str(x).lower() for x in w],
}


def _conditions_met(conditions: dict, context: dict) -> bool:
    """Every operator block and every key within it must pass (AWS
    ANDs condition operators and keys; values within a key are ORed —
    the evaluators above take the value list)."""
    for op_name, keys in (conditions or {}).items():
        evaluator = _CONDITION_EVALUATORS.get(op_name)
        if evaluator is None:
            return False  # unknown operator: fail closed
        for ckey, cvals in keys.items():
            have = context.get(ckey)
            if have is None:
                return False
            if not evaluator([str(v) for v in _as_list(cvals)], str(have)):
                return False
    return True


# -------------------------------------------------------------- statements


def _statement_matches(
    stmt: dict, action: str, resource: str, context: dict
) -> bool:
    if "NotAction" in stmt:
        nots = [str(a) for a in _as_list(stmt["NotAction"])]
        if any(_wildcard_match(a, action) for a in nots):
            return False
    else:
        actions = [str(a) for a in _as_list(stmt.get("Action"))]
        if not any(_wildcard_match(a, action) for a in actions):
            return False
    if "NotResource" in stmt:
        nots = [str(r) for r in _as_list(stmt["NotResource"])]
        if any(_wildcard_match(r, resource) for r in nots):
            return False
    else:
        resources = [str(r) for r in _as_list(stmt.get("Resource", "*"))]
        if not any(_wildcard_match(r, resource) for r in resources):
            return False
    return _conditions_met(stmt.get("Condition"), context)


def evaluate_policies_verdict(
    policies: Iterable[dict],
    action: str,
    resource: str,
    context: dict | None = None,
) -> str | None:
    """-> "deny" | "allow" | None (no matching statement). Explicit
    Deny anywhere wins — callers combining identity and resource
    policies need the three-way answer, because an identity explicit
    Deny must override a resource-policy Allow (AWS evaluation
    logic), which a boolean cannot express."""
    context = context or {}
    verdict: str | None = None
    for doc in policies:
        for stmt in _as_list(doc.get("Statement")):
            if not _statement_matches(stmt, action, resource, context):
                continue
            effect = str(stmt.get("Effect", "")).lower()
            if effect == "deny":
                return "deny"
            if effect == "allow":
                verdict = "allow"
    return verdict


def evaluate_policies(
    policies: Iterable[dict],
    action: str,
    resource: str,
    context: dict | None = None,
) -> bool:
    """True iff the action on the resource is allowed: explicit Deny
    anywhere wins; otherwise at least one Allow must match."""
    return evaluate_policies_verdict(policies, action, resource, context) == "allow"


def _principal_matches(stmt: dict, principal_arn: str) -> bool:
    """Bucket-policy Principal matching. Accepted shapes: "*",
    {"AWS": "*"}, {"AWS": [arn,...]}; an arn pattern may use
    wildcards. NotPrincipal inverts."""

    def match(spec) -> bool:
        if spec == "*":
            return True
        if isinstance(spec, dict):
            spec = spec.get("AWS", [])
        return any(
            _wildcard_match(str(p), principal_arn) for p in _as_list(spec)
        )

    if "NotPrincipal" in stmt:
        return not match(stmt["NotPrincipal"])
    if "Principal" not in stmt:
        return False  # resource policies require a principal
    return match(stmt["Principal"])


def evaluate_bucket_policy(
    doc: dict,
    action: str,
    resource: str,
    principal_arn: str,
    context: dict | None = None,
) -> str | None:
    """Resource-based (bucket) policy evaluation -> "deny" | "allow" |
    None (no matching statement). The caller combines this with
    identity-based results per AWS rules: explicit deny anywhere wins;
    a resource-policy allow suffices on its own (it can grant anonymous
    principals)."""
    context = context or {}
    verdict: str | None = None
    for stmt in _as_list(doc.get("Statement")):
        if not _principal_matches(stmt, principal_arn):
            continue
        if not _statement_matches(stmt, action, resource, context):
            continue
        effect = str(stmt.get("Effect", "")).lower()
        if effect == "deny":
            return "deny"
        if effect == "allow":
            verdict = "allow"
    return verdict


def bucket_policy_is_public(doc: dict) -> bool:
    """GetBucketPolicyStatus semantics: any Allow to Principal '*'
    without restrictive conditions counts as public."""
    for stmt in _as_list(doc.get("Statement")):
        if str(stmt.get("Effect", "")).lower() != "allow":
            continue
        p = stmt.get("Principal")
        if p == "*" or (isinstance(p, dict) and "*" in _as_list(p.get("AWS"))):
            if not stmt.get("Condition"):
                return True
    return False


def validate_bucket_policy(doc: dict, bucket: str) -> None:
    """Structural validation at PutBucketPolicy time (reference
    s3api_bucket_policy_handlers.go): statements must exist, carry
    principals, and reference only this bucket's ARNs."""
    stmts = _as_list(doc.get("Statement"))
    if not stmts:
        raise PolicyError("policy has no Statement")
    for stmt in stmts:
        if str(stmt.get("Effect", "")).lower() not in ("allow", "deny"):
            raise PolicyError(f"bad Effect {stmt.get('Effect')!r}")
        if "Principal" not in stmt and "NotPrincipal" not in stmt:
            raise PolicyError("bucket policy statement missing Principal")
        if "Action" not in stmt and "NotAction" not in stmt:
            raise PolicyError("statement missing Action")
        for r in _as_list(stmt.get("Resource")):
            r = str(r)
            if not (
                r == f"arn:aws:s3:::{bucket}"
                or r.startswith(f"arn:aws:s3:::{bucket}/")
            ):
                raise PolicyError(
                    f"resource {r!r} does not match bucket {bucket!r}"
                )


class PolicyEngine:
    """Named-policy registry + evaluation (reference policy_engine.go
    PolicyEngine with its policy store)."""

    def __init__(self):
        self._policies: dict[str, dict] = {}

    def put_policy(self, name: str, document: dict) -> None:
        if "Statement" not in document:
            raise PolicyError(f"policy {name}: no Statement")
        self._policies[name] = document

    def get_policy(self, name: str) -> dict | None:
        return self._policies.get(name)

    def delete_policy(self, name: str) -> None:
        self._policies.pop(name, None)

    def names(self) -> list[str]:
        return sorted(self._policies)

    def is_allowed(
        self,
        policy_names: Iterable[str],
        action: str,
        resource: str,
        context: dict | None = None,
    ) -> bool:
        docs = [
            self._policies[n] for n in policy_names if n in self._policies
        ]
        return evaluate_policies(docs, action, resource, context)


# ----------------------------------------------------- S3 request mapping


def s3_action_and_resource(
    method: str, bucket: str, key: str, q: dict
) -> tuple[str, str]:
    """Map one S3 request to its IAM action + resource ARN (reference
    s3api action constants in s3_constants + auth_credentials.go)."""
    if not bucket:
        return "s3:ListAllMyBuckets", "arn:aws:s3:::*"
    bucket_arn = f"arn:aws:s3:::{bucket}"
    obj_arn = f"{bucket_arn}/{key}" if key else bucket_arn
    if key:
        if "tagging" in q:
            return (
                {
                    "GET": "s3:GetObjectTagging",
                    "PUT": "s3:PutObjectTagging",
                    "DELETE": "s3:DeleteObjectTagging",
                }.get(method, "s3:GetObjectTagging"),
                obj_arn,
            )
        if "retention" in q:
            return (
                "s3:PutObjectRetention"
                if method == "PUT"
                else "s3:GetObjectRetention",
                obj_arn,
            )
        if "legal-hold" in q:
            return (
                "s3:PutObjectLegalHold"
                if method == "PUT"
                else "s3:GetObjectLegalHold",
                obj_arn,
            )
        if "acl" in q:
            return (
                "s3:PutObjectAcl" if method == "PUT" else "s3:GetObjectAcl",
                obj_arn,
            )
        if method in ("GET", "HEAD"):
            if "uploadId" in q:
                return "s3:ListMultipartUploadParts", obj_arn
            if "versionId" in q:
                return "s3:GetObjectVersion", obj_arn
            return "s3:GetObject", obj_arn
        if method == "PUT" or (method == "POST" and ("uploads" in q or "uploadId" in q)):
            return "s3:PutObject", obj_arn
        if method == "DELETE":
            if "uploadId" in q:
                return "s3:AbortMultipartUpload", obj_arn
            if "versionId" in q:
                return "s3:DeleteObjectVersion", obj_arn
            return "s3:DeleteObject", obj_arn
        return "s3:GetObject", obj_arn
    # bucket level
    if "policy" in q or "policyStatus" in q:
        return (
            {
                "GET": "s3:GetBucketPolicy",
                "PUT": "s3:PutBucketPolicy",
                "DELETE": "s3:DeleteBucketPolicy",
            }.get(method, "s3:GetBucketPolicy"),
            bucket_arn,
        )
    if "acl" in q:
        return (
            "s3:PutBucketAcl" if method == "PUT" else "s3:GetBucketAcl",
            bucket_arn,
        )
    if "encryption" in q:
        return (
            {
                "GET": "s3:GetEncryptionConfiguration",
                "PUT": "s3:PutEncryptionConfiguration",
                "DELETE": "s3:PutEncryptionConfiguration",
            }.get(method, "s3:GetEncryptionConfiguration"),
            bucket_arn,
        )
    if "lifecycle" in q:
        return (
            "s3:PutLifecycleConfiguration"
            if method in ("PUT", "DELETE")
            else "s3:GetLifecycleConfiguration",
            bucket_arn,
        )
    if "versioning" in q:
        return (
            "s3:PutBucketVersioning"
            if method == "PUT"
            else "s3:GetBucketVersioning",
            bucket_arn,
        )
    if "object-lock" in q:
        return (
            "s3:PutBucketObjectLockConfiguration"
            if method == "PUT"
            else "s3:GetBucketObjectLockConfiguration",
            bucket_arn,
        )
    if "cors" in q:
        return (
            {
                "GET": "s3:GetBucketCORS",
                "PUT": "s3:PutBucketCORS",
                "DELETE": "s3:PutBucketCORS",
            }.get(method, "s3:GetBucketCORS"),
            bucket_arn,
        )
    if "versions" in q:
        return "s3:ListBucketVersions", bucket_arn
    if "uploads" in q:
        return "s3:ListBucketMultipartUploads", bucket_arn
    if method in ("GET", "HEAD"):
        return "s3:ListBucket", bucket_arn
    if method == "PUT":
        return "s3:CreateBucket", bucket_arn
    if method == "DELETE":
        return "s3:DeleteBucket", bucket_arn
    if method == "POST" and "delete" in q:
        return "s3:DeleteObject", f"{bucket_arn}/*"
    return "s3:ListBucket", bucket_arn
