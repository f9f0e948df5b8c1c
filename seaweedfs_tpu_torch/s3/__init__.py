"""S3 REST gateway (layer 6) over the filer.

Port of seaweedfs_tpu/s3: the gateway (`server`), its lifecycle scanner
(`lifecycle`) and its libraries: SigV4 (`auth`), aws-chunked bodies
(`chunked`), POST-policy forms (`post_policy`), identities (`config`),
versioning and object lock (`versioning`) and server-side encryption
(`sse`), the Iceberg REST catalog and S3 Tables (`tables`) and the
embedded IAM API (`iamapi`). S3 Select comes with ROADMAP.md item 19.
"""

from .auth import Identity, IdentityStore, S3AuthError  # noqa: F401
from .server import S3Server  # noqa: F401
