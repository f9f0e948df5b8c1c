"""S3 over the filer: the gateway's libraries.

Port of seaweedfs_tpu/s3's libraries: SigV4 (`auth`), aws-chunked bodies
(`chunked`), POST-policy forms (`post_policy`), identities (`config`),
versioning and object lock (`versioning`) and server-side encryption
(`sse`). The gateway itself (`S3Server`) comes with ROADMAP.md item 13b,
so the package exports `auth`'s names only.
"""

from .auth import Identity, IdentityStore, S3AuthError  # noqa: F401
