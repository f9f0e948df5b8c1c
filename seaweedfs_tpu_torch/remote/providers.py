"""Remote-storage provider registry (reference weed/remote_storage:
pluggable s3/gcs/azure/aliyun/... clients behind one interface).

Port of seaweedfs_tpu/remote/providers.py, whole.

The S3 client is native (own SigV4 signer, remote/s3_client.py) and
also fronts every S3-compatible store (MinIO, Ceph RGW, Wasabi, B2's
S3 endpoint, GCS's XML interop endpoint with HMAC keys). GCS-native
and Azure-Blob-native protocols need their SDKs, which this image does
not ship — those providers are GATED with explicit errors instead of
silently missing, and the SPI is the seam a deployment with the SDKs
installed plugs into.
"""

from __future__ import annotations

from typing import Callable

from .s3_client import RemoteS3Client

_REGISTRY: dict[str, Callable] = {}


def register(kind: str, factory: Callable) -> None:
    _REGISTRY[kind] = factory


def make_remote_client(
    kind: str,
    endpoint: str = "",
    access_key: str = "",
    secret_key: str = "",
    region: str = "us-east-1",
    **kw,
):
    """kind: s3 | gcs-s3 | gcs | azure | <registered>. Returns a client
    with the RemoteS3Client surface (list/get/put/delete objects)."""
    if kind in _REGISTRY:
        return _REGISTRY[kind](
            endpoint=endpoint,
            access_key=access_key,
            secret_key=secret_key,
            region=region,
            **kw,
        )
    if kind == "s3":
        return RemoteS3Client(
            endpoint=endpoint,
            access_key=access_key,
            secret_key=secret_key,
            region=region,
            **kw,
        )
    if kind == "gcs-s3":
        # GCS XML interoperability endpoint speaks S3 with HMAC keys
        return RemoteS3Client(
            endpoint=endpoint or "https://storage.googleapis.com",
            access_key=access_key,
            secret_key=secret_key,
            region=region,
            **kw,
        )
    if kind == "gcs":
        try:
            import google.cloud.storage  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "native GCS requires google-cloud-storage (not installed in "
                "this build); use kind='gcs-s3' (the XML interop endpoint "
                "with HMAC keys) or register() a provider"
            ) from e
        raise NotImplementedError("gcs: SDK present but unwired")
    if kind == "azure":
        try:
            import azure.storage.blob  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "Azure Blob requires azure-storage-blob (not installed in "
                "this build); use an S3-compatible gateway or register() a "
                "provider"
            ) from e
        raise NotImplementedError("azure: SDK present but unwired")
    raise ValueError(f"unknown remote storage kind {kind!r}")
