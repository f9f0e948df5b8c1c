"""Bucket lifecycle rules + expiry scanner.

Port of seaweedfs_tpu/s3/lifecycle.py, whole, over the port's filer and
`s3/versioning`: the same rules, verdicts and counters.

Reference: weed/s3api lifecycle handlers + S3_LIFECYCLE_REDESIGN.md and
the worker task weed/worker/tasks/s3_lifecycle. Rules are stored by the
gateway in the filer KV (raw XML for GET round-trip + parsed JSON for
the scanner); the scanner walks each configured bucket and applies:

- Expiration (Days | Date) on current versions — delete-marker
  semantics when the bucket is versioned, hard delete otherwise;
- NoncurrentVersionExpiration (NoncurrentDays) on archived versions;
- AbortIncompleteMultipartUpload (DaysAfterInitiation) on stale
  multipart upload directories.
"""

from __future__ import annotations

import json
import time
import xml.etree.ElementTree as ET

from ..filer.entry import normalize_path
from ..filer.filer_store import NotFound
from ..utils.glog import logger
from . import versioning as vtag

log = logger("s3.lifecycle")

BUCKETS_ROOT = "/buckets"
UPLOADS_DIR = ".uploads"


def parse_lifecycle_xml(body: bytes) -> list[dict]:
    """<LifecycleConfiguration><Rule>... → rule dicts; raises ValueError
    on malformed input."""
    try:
        doc = ET.fromstring(body)
    except ET.ParseError as e:
        raise ValueError(f"bad XML: {e}") from e
    ns = doc.tag[: doc.tag.index("}") + 1] if doc.tag.startswith("{") else ""
    rules = []
    for r in doc.findall(f"{ns}Rule"):
        rule: dict = {
            "ID": r.findtext(f"{ns}ID") or f"rule-{len(rules)}",
            "Status": r.findtext(f"{ns}Status") or "Enabled",
            "Prefix": (
                r.findtext(f"{ns}Filter/{ns}Prefix")
                or r.findtext(f"{ns}Prefix")
                or ""
            ),
        }
        exp = r.find(f"{ns}Expiration")
        if exp is not None:
            days = exp.findtext(f"{ns}Days")
            date = exp.findtext(f"{ns}Date")
            if days:
                rule["ExpirationDays"] = int(days)
            if date:
                rule["ExpirationDate"] = date
        nce = r.find(f"{ns}NoncurrentVersionExpiration")
        if nce is not None:
            nd = nce.findtext(f"{ns}NoncurrentDays")
            if nd:
                rule["NoncurrentDays"] = int(nd)
        ab = r.find(f"{ns}AbortIncompleteMultipartUpload")
        if ab is not None:
            d = ab.findtext(f"{ns}DaysAfterInitiation")
            if d:
                rule["AbortMultipartDays"] = int(d)
        if not any(
            k in rule
            for k in (
                "ExpirationDays",
                "ExpirationDate",
                "NoncurrentDays",
                "AbortMultipartDays",
            )
        ):
            raise ValueError(f"rule {rule['ID']} has no action")
        rules.append(rule)
    return rules


class LifecycleScanner:
    """Applies stored lifecycle rules across all buckets. Runs inside
    the S3 gateway (background thread) and as a worker-fleet task."""

    def __init__(self, filer):
        self.filer = filer

    # ------------------------------------------------------------ helpers

    def _bucket_rules(self, bucket: str) -> list[dict]:
        raw = self.filer.store.kv_get(f"lifecycle-rules/{bucket}".encode())
        if raw is None:
            return []
        try:
            return json.loads(raw)
        except ValueError:
            return []

    def _versioning(self, bucket: str) -> str:
        raw = self.filer.store.kv_get(f"versioning/{bucket}".encode())
        return raw.decode() if raw else ""

    def _walk_files(self, dir_path: str, key_prefix: str = ""):
        try:
            entries = list(self.filer.list_entries(dir_path, limit=100_000))
        except NotFound:
            return
        for e in entries:
            if e.is_directory:
                if key_prefix == "" and e.name in (
                    vtag.VERSIONS_DIR,
                    UPLOADS_DIR,
                ):
                    continue
                yield from self._walk_files(
                    e.full_path, key_prefix + e.name + "/"
                )
            else:
                yield key_prefix + e.name, e

    # ------------------------------------------------------------ actions

    def run_once(self, now: float | None = None, bucket: str = "") -> dict:
        """One scan of every bucket with rules (or just `bucket`);
        returns counters."""
        now = time.time() if now is None else now
        stats = {"expired": 0, "noncurrent_expired": 0, "aborted_uploads": 0}
        try:
            buckets = [
                e.name
                for e in self.filer.list_entries(BUCKETS_ROOT, limit=10_000)
                if e.is_directory and e.name != UPLOADS_DIR
                and (not bucket or e.name == bucket)
            ]
        except NotFound:
            return stats
        for bucket in buckets:
            rules = self._bucket_rules(bucket)
            if not rules:
                continue
            try:
                self._apply_bucket(bucket, rules, now, stats)
            except Exception as e:  # a broken bucket must not stall others
                log.warning("lifecycle: bucket %s: %s", bucket, e)
        return stats

    def _apply_bucket(
        self, bucket: str, rules: list[dict], now: float, stats: dict
    ) -> None:
        versioned = self._versioning(bucket)  # "" | Enabled | Suspended
        active = [r for r in rules if r.get("Status") == "Enabled"]
        if not active:
            return
        exp_rules = [
            r for r in active if "ExpirationDays" in r or "ExpirationDate" in r
        ]
        if exp_rules:
            for key, entry in list(self._walk_files(f"{BUCKETS_ROOT}/{bucket}")):
                if vtag.is_delete_marker(entry):
                    continue
                for r in exp_rules:
                    if not key.startswith(r.get("Prefix", "")):
                        continue
                    if self._expired(entry.attr.mtime, r, now):
                        if self._expire_current(bucket, key, versioned):
                            stats["expired"] += 1
                        break
        nc_rules = [r for r in active if "NoncurrentDays" in r]
        if nc_rules:
            vroot = f"{BUCKETS_ROOT}/{bucket}/{vtag.VERSIONS_DIR}"
            for vkey, ventry in list(self._walk_files(vroot, "")):
                # vkey = "<object key>/<version id>"
                okey = vkey.rsplit("/", 1)[0]
                for r in nc_rules:
                    if not okey.startswith(r.get("Prefix", "")):
                        continue
                    if entry_age_days(ventry.attr.mtime, now) >= r["NoncurrentDays"]:
                        try:
                            # expiry must not destroy retention-locked
                            # or legal-held versions
                            vtag.check_deletable(ventry)
                        except vtag.LockViolation:
                            break
                        self.filer.delete_entry(
                            ventry.full_path, gc_chunks=True
                        )
                        stats["noncurrent_expired"] += 1
                        break
        ab_rules = [r for r in active if "AbortMultipartDays" in r]
        if ab_rules:
            days = min(r["AbortMultipartDays"] for r in ab_rules)
            updir = f"{BUCKETS_ROOT}/{UPLOADS_DIR}/{bucket}"
            try:
                uploads = list(self.filer.list_entries(updir, limit=10_000))
            except NotFound:
                uploads = []
            for u in uploads:
                if u.is_directory and entry_age_days(u.attr.crtime, now) >= days:
                    self.filer.delete_entry(u.full_path, recursive=True)
                    self.filer.store.kv_delete(f"upload/{u.name}".encode())
                    stats["aborted_uploads"] += 1

    @staticmethod
    def _expired(mtime: int, rule: dict, now: float) -> bool:
        if "ExpirationDays" in rule:
            return entry_age_days(mtime, now) >= rule["ExpirationDays"]
        if "ExpirationDate" in rule:
            import calendar

            try:
                # AWS dates are UTC instants, never server-local time
                t = calendar.timegm(
                    time.strptime(rule["ExpirationDate"][:10], "%Y-%m-%d")
                )
            except ValueError:
                return False
            return now >= t
        return False

    def _expire_current(self, bucket: str, key: str, versioned: str) -> bool:
        path = normalize_path(f"{BUCKETS_ROOT}/{bucket}/{key}")
        if versioned:
            # delete-marker semantics: the data stays reachable as a
            # noncurrent version until NoncurrentVersionExpiration
            vtag.write_delete_marker(
                self.filer, BUCKETS_ROOT, bucket, key, versioned
            )
            return True
        try:
            vtag.check_deletable(self.filer.find_entry(path))
        except vtag.LockViolation:
            return False
        except NotFound:
            return False
        self.filer.delete_entry(path, gc_chunks=True)
        return True


def entry_age_days(ts: int, now: float) -> float:
    return max(0.0, (now - (ts or 0)) / 86400.0)
