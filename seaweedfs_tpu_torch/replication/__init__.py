"""Cross-cluster replication (filer.sync analog).

Port of seaweedfs_tpu/replication/: `FilerSync` (filer to filer),
`FilerBackup` (filer to a local directory), `S3Sink` (filer to a bucket)
and the `python -m seaweedfs_tpu_torch.replication` daemon. Nothing here
imports torch.
"""

from .sync import FilerSync
