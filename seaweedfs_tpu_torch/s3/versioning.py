"""S3 object versioning + object-lock helpers.

Port of seaweedfs_tpu/s3/versioning.py, whole, over the port's filer
(filer/entry.py, filer/filer_store.py): the same tree, version ids and
extended attributes.

Reference: weed/s3api/s3api_object_versioning.go (version directory per
object, latest materialized), s3api_object_retention.go (retention /
legal hold / governance bypass).

Layout (redesigned for this filer): the latest version of a key lives
at its normal path ``/buckets/<b>/<key>`` with the version id in
extended["s3-version-id"]; noncurrent versions are renamed (metadata
move, chunks by reference) into the hidden per-bucket tree
``/buckets/<b>/.versions/<key>/<version-id>``. Delete markers are
zero-length entries with extended["s3-delete-marker"]=b"1". Version ids
are inverse-timestamp hex, so ascending name order = newest first.
"""

from __future__ import annotations

import json
import os
import time
from datetime import datetime, timezone

from ..filer.entry import normalize_path
from ..filer.filer_store import NotFound

VERSIONS_DIR = ".versions"
NULL_VID = "null"

VID_KEY = "s3-version-id"
MARKER_KEY = "s3-delete-marker"
RETENTION_KEY = "s3-retention"
LEGAL_HOLD_KEY = "s3-legal-hold"


def new_version_id() -> str:
    """Inverse-timestamp so lexicographic ascending = newest first."""
    return f"{(1 << 63) - time.time_ns():016x}{os.urandom(4).hex()}"


def entry_vid(entry) -> str:
    raw = entry.extended.get(VID_KEY)
    return raw.decode() if raw else NULL_VID


def is_delete_marker(entry) -> bool:
    return entry.extended.get(MARKER_KEY) == b"1"


def versions_dir(buckets_root: str, bucket: str, key: str) -> str:
    return normalize_path(f"{buckets_root}/{bucket}/{VERSIONS_DIR}/{key}")


class LockViolation(Exception):
    """Deleting/overwriting a version protected by retention or hold."""


def get_retention(entry) -> tuple[str, datetime | None]:
    raw = entry.extended.get(RETENTION_KEY)
    if not raw:
        return "", None
    try:
        d = json.loads(raw)
        until = datetime.fromisoformat(d["RetainUntilDate"])
        if until.tzinfo is None:
            until = until.replace(tzinfo=timezone.utc)
        return d.get("Mode", ""), until
    except (ValueError, KeyError):
        return "", None


def set_retention(entry, mode: str, until: datetime) -> None:
    entry.extended[RETENTION_KEY] = json.dumps(
        {"Mode": mode, "RetainUntilDate": until.isoformat()}
    ).encode()


def legal_hold(entry) -> str:
    raw = entry.extended.get(LEGAL_HOLD_KEY)
    return raw.decode() if raw else "OFF"


def check_deletable(entry, bypass_governance: bool = False) -> None:
    """Raise LockViolation if the version is protected (reference
    s3api_object_retention.go enforcement)."""
    if legal_hold(entry) == "ON":
        raise LockViolation("object version is under legal hold")
    mode, until = get_retention(entry)
    if mode and until and until > datetime.now(timezone.utc):
        if mode == "COMPLIANCE" or not bypass_governance:
            raise LockViolation(
                f"object version is locked ({mode}) until {until.isoformat()}"
            )


def default_retention_extended(lock_conf: dict | None) -> dict:
    """Extended attrs implementing the bucket's DefaultRetention on a
    freshly written version."""
    if not lock_conf:
        return {}
    dr = lock_conf.get("DefaultRetention")
    if not dr:
        return {}
    days = int(dr.get("Days", 0)) + 365 * int(dr.get("Years", 0))
    if days <= 0:
        return {}
    until = datetime.fromtimestamp(
        time.time() + days * 86400, tz=timezone.utc
    )
    return {
        RETENTION_KEY: json.dumps(
            {"Mode": dr.get("Mode", "GOVERNANCE"), "RetainUntilDate": until.isoformat()}
        ).encode()
    }


def archive_current(filer, buckets_root: str, bucket: str, key: str) -> None:
    """Move the current version (if any) into the versions tree under
    its version id. Metadata-only: chunks move by reference."""
    path = normalize_path(f"{buckets_root}/{bucket}/{key}")
    try:
        cur = filer.find_entry(path)
    except NotFound:
        return
    if cur.is_directory:
        return
    vid = entry_vid(cur)
    dst = f"{versions_dir(buckets_root, bucket, key)}/{vid}"
    if filer.exists(dst):
        # re-archiving the null version overwrites the previous null
        filer.delete_entry(dst, gc_chunks=True)
    filer.rename(path, dst)


def iter_versions(filer, buckets_root: str, bucket: str, key: str):
    """Noncurrent versions of one key, newest first."""
    vdir = versions_dir(buckets_root, bucket, key)
    try:
        entries = list(filer.list_entries(vdir, limit=100_000))
    except NotFound:
        return
    for e in sorted(entries, key=lambda e: e.name):
        if not e.is_directory:
            yield e


def write_delete_marker(
    filer, buckets_root: str, bucket: str, key: str, state: str
) -> str:
    """Archive the current version and leave a delete marker at the
    normal path. Suspended buckets get the null version id (AWS
    semantics); Enabled buckets a fresh one. Returns the marker vid."""
    from ..filer.entry import new_entry

    archive_current(filer, buckets_root, bucket, key)
    vid = new_version_id() if state == "Enabled" else NULL_VID
    path = normalize_path(f"{buckets_root}/{bucket}/{key}")
    marker = new_entry(path)
    marker.extended[MARKER_KEY] = b"1"
    marker.extended[VID_KEY] = vid.encode()
    filer.create_entry(marker)
    return vid


def promote_latest(filer, buckets_root: str, bucket: str, key: str) -> bool:
    """After the current version is removed, materialize the newest
    remaining version back at the normal path. Returns True if one was
    promoted."""
    for e in iter_versions(filer, buckets_root, bucket, key):
        path = normalize_path(f"{buckets_root}/{bucket}/{key}")
        filer.rename(e.full_path, path)
        return True
    return False
