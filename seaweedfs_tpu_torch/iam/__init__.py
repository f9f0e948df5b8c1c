"""IAM: policy engine + STS temporary credentials.

Port of seaweedfs_tpu/iam: `policy`, `sts`, `oidc` and `ldap`.

Reference: weed/iam/policy (policy_engine.go), weed/iam/sts.
"""

from .policy import PolicyEngine, evaluate_policies  # noqa: F401
from .sts import StsService  # noqa: F401
