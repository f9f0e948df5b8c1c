"""IAM: policy engine + STS temporary credentials.

Port of seaweedfs_tpu/iam: `policy` and `sts`. OIDC and LDAP come with
ROADMAP.md item 13c.

Reference: weed/iam/policy (policy_engine.go), weed/iam/sts.
"""

from .policy import PolicyEngine, evaluate_policies  # noqa: F401
from .sts import StsService  # noqa: F401
