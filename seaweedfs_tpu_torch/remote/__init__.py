"""Remote (cloud) storage: client SPI, lazy remote mounts, sync sinks.

Port of seaweedfs_tpu/remote/ (reference weed/remote_storage: the
s3/gcs/azure client SPI; weed/filer/read_remote.go and
filer_lazy_remote*.go: cloud-backed directories with read-through
caching). One concrete client, S3-compatible with SigV4, which covers
the port's own S3 gateway (cluster to cluster) and any S3-style
endpoint. Nothing here imports torch: the filer and its server load it.
"""

from .s3_client import RemoteS3Client, RemoteStorageError  # noqa: F401
