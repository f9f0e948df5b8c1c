"""Iceberg REST catalog + AWS S3-Tables API on the S3 gateway.

Port of seaweedfs_tpu/s3/tables.py, whole: the same routes, JSON
bodies, KV documents and metadata files, over the port's filer and
gateway. Each `TablesCatalog` holds its own lock.

Reference: weed/s3api/iceberg/ (REST catalog per the Apache Iceberg
spec, backed by table-bucket storage) and weed/s3api/s3api_tables.go
(the AWS S3Tables surface: table buckets -> namespaces -> tables,
driven either by X-Amz-Target JSON posts or the CLI's REST paths).

Implemented subset:
- Iceberg REST v1 under /iceberg/v1 (and /iceberg/v1/{prefix} where
  prefix names a table bucket): config, namespace CRUD + property
  updates, table list/create/load/exists/drop/rename, and commits that
  set/remove properties (each commit writes a NEW metadata file and
  appends to the metadata log, as the spec requires).
- S3Tables: CreateTableBucket / ListTableBuckets / DeleteTableBucket,
  Create/List/Get/DeleteNamespace, Create/List/Get/DeleteTable via
  X-Amz-Target; ARN-path REST aliases for the same ops.

Metadata files are ordinary S3 objects in the table bucket
(<ns>/<table>/metadata/NNNNN-<uuid>.metadata.json), so any Iceberg
reader pointed at the gateway can load them; the catalog pointers live
in the filer KV.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.parse
import uuid

from ..filer.filer_store import NotFound

DEFAULT_BUCKET = "default"  # un-prefixed /v1 routes land here
_ARN_RE = re.compile(r"arn:aws:s3tables:[^/:]*:[^/:]*:bucket/[^/]+")
_REST_RE = re.compile(
    r"^/(buckets(/arn:aws:s3tables:|$|/$)"
    r"|namespaces/arn:aws:s3tables:"
    r"|tables/arn:aws:s3tables:)"
)


def is_s3tables_path(path: str) -> bool:
    """CLI-style S3Tables REST path (ARN-rooted, or the bare /buckets
    collection) — matched on the path PREFIX so an ordinary object key
    merely containing an ARN substring is never hijacked."""
    return bool(_REST_RE.match(path))


class TablesError(Exception):
    def __init__(self, code: int, typ: str, message: str):
        super().__init__(message)
        self.code = code
        self.typ = typ


_NAME_RE = re.compile(r"^[a-zA-Z0-9][a-zA-Z0-9._\-]{0,254}$")


def _check_name(kind: str, name: str) -> str:
    """Catalog identifiers: no empty names, no KV-separator (:) or
    path (/) characters — 'a' + ns 'b:c' must never share a KV key
    with bucket 'a:b' + ns 'c'."""
    if not _NAME_RE.match(name or ""):
        raise TablesError(
            400, "BadRequestException", f"invalid {kind} name {name!r}"
        )
    return name


class TablesCatalog:
    """Catalog state in the filer KV; metadata files in the bucket.

    The catalog's lock serializes every read-modify-write of the KV
    docs: ThreadingHTTPServer handles requests concurrently and a lost
    update here orphans metadata files."""

    def __init__(self, srv):
        self.srv = srv  # S3Server (filer + put_object access)
        self._lock = threading.RLock()

    # ------------------------------------------------------------ kv

    def _kv(self, key: str) -> dict:
        raw = self.srv.filer.store.kv_get(key.encode())
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except ValueError:
            return {}

    def _kv_put(self, key: str, doc: dict) -> None:
        self.srv.filer.store.kv_put(key.encode(), json.dumps(doc).encode())

    # -------------------------------------------------------- buckets

    def buckets(self) -> dict:
        return self._kv("s3tables:buckets")

    def create_bucket(self, name: str) -> dict:
        _check_name("bucket", name)
        with self._lock:
            return self._create_bucket_locked(name)

    def _create_bucket_locked(self, name: str) -> dict:
        b = self.buckets()
        if name in b:
            raise TablesError(409, "ConflictException", f"bucket {name} exists")
        arn = f"arn:aws:s3tables:local:000000000000:bucket/{name}"
        b[name] = {"arn": arn, "createdAt": time.time()}
        self._kv_put("s3tables:buckets", b)
        # the table bucket is a REAL s3 bucket: metadata/data objects
        # live in it and are readable over the ordinary S3 surface
        from ..filer.entry import new_entry

        if not self.srv.filer.exists(f"/buckets/{name}"):
            self.srv.filer.create_entry(
                new_entry(f"/buckets/{name}", is_directory=True, mode=0o755)
            )
        return b[name]

    def require_bucket(self, name: str) -> dict:
        b = self.buckets().get(name)
        if b is None:
            raise TablesError(
                404, "NotFoundException", f"table bucket {name} not found"
            )
        return b

    def delete_bucket(self, name: str) -> None:
        with self._lock:
            self._delete_bucket_locked(name)

    def _delete_bucket_locked(self, name: str) -> None:
        self.require_bucket(name)
        if self._kv(f"s3tables:ns:{name}"):
            raise TablesError(
                409, "ConflictException", "table bucket is not empty"
            )
        b = self.buckets()
        b.pop(name, None)
        self._kv_put("s3tables:buckets", b)

    # ----------------------------------------------------- namespaces

    def namespaces(self, bucket: str) -> dict:
        return self._kv(f"s3tables:ns:{bucket}")

    def create_namespace(self, bucket: str, ns: str, props: dict) -> None:
        _check_name("namespace", ns)
        with self._lock:
            self._create_namespace_locked(bucket, ns, props)

    def _create_namespace_locked(self, bucket: str, ns: str, props: dict) -> None:
        self.require_bucket(bucket)
        all_ns = self.namespaces(bucket)
        if ns in all_ns:
            raise TablesError(
                409, "AlreadyExistsException", f"namespace {ns} exists"
            )
        all_ns[ns] = {"properties": props or {}, "createdAt": time.time()}
        self._kv_put(f"s3tables:ns:{bucket}", all_ns)

    def require_namespace(self, bucket: str, ns: str) -> dict:
        got = self.namespaces(bucket).get(ns)
        if got is None:
            raise TablesError(
                404, "NoSuchNamespaceException", f"namespace {ns} not found"
            )
        return got

    def update_namespace_props(
        self, bucket: str, ns: str, removals: list, updates: dict
    ) -> dict:
        with self._lock:
            return self._update_ns_props_locked(bucket, ns, removals, updates)

    def _update_ns_props_locked(
        self, bucket: str, ns: str, removals: list, updates: dict
    ) -> dict:
        all_ns = self.namespaces(bucket)
        rec = all_ns.get(ns)
        if rec is None:
            raise TablesError(
                404, "NoSuchNamespaceException", f"namespace {ns} not found"
            )
        missing = [r for r in removals or [] if r not in rec["properties"]]
        for r in removals or []:
            rec["properties"].pop(r, None)
        rec["properties"].update(updates or {})
        self._kv_put(f"s3tables:ns:{bucket}", all_ns)
        return {
            "removed": [r for r in removals or [] if r not in missing],
            "updated": sorted((updates or {}).keys()),
            "missing": missing,
        }

    def drop_namespace(self, bucket: str, ns: str) -> None:
        with self._lock:
            self._drop_namespace_locked(bucket, ns)

    def _drop_namespace_locked(self, bucket: str, ns: str) -> None:
        self.require_namespace(bucket, ns)
        if self.tables(bucket, ns) or self.views(bucket, ns):
            raise TablesError(
                409, "NamespaceNotEmptyException", f"namespace {ns} not empty"
            )
        all_ns = self.namespaces(bucket)
        all_ns.pop(ns, None)
        self._kv_put(f"s3tables:ns:{bucket}", all_ns)

    # --------------------------------------------------------- tables

    def tables(self, bucket: str, ns: str) -> dict:
        return self._kv(f"s3tables:tables:{bucket}:{ns}")

    def _write_metadata(
        self, bucket: str, ns: str, name: str, metadata: dict, version: int
    ) -> str:
        body = json.dumps(metadata, indent=2).encode()
        key = (
            f"{ns}/{name}/metadata/"
            f"{version:05d}-{uuid.uuid4().hex}.metadata.json"
        )
        self.srv.put_object(
            bucket, key, body, mime="application/json"
        )
        return f"s3://{bucket}/{key}"

    def create_table(
        self, bucket: str, ns: str, name: str, schema: dict, props: dict
    ) -> dict:
        _check_name("table", name)
        with self._lock:
            return self._create_table_locked(bucket, ns, name, schema, props)

    def _create_table_locked(
        self, bucket: str, ns: str, name: str, schema: dict, props: dict
    ) -> dict:
        self.require_namespace(bucket, ns)
        self._check_identifier_free(bucket, ns, name)
        tables = self.tables(bucket, ns)
        schema = schema or {"type": "struct", "schema-id": 0, "fields": []}
        schema.setdefault("schema-id", 0)
        last_col = max(
            (f.get("id", 0) for f in schema.get("fields", [])), default=0
        )
        tuid = str(uuid.uuid4())
        location = f"s3://{bucket}/{ns}/{name}"
        metadata = {
            "format-version": 2,
            "table-uuid": tuid,
            "location": location,
            "last-sequence-number": 0,
            "last-updated-ms": int(time.time() * 1000),
            "last-column-id": last_col,
            "current-schema-id": schema["schema-id"],
            "schemas": [schema],
            "default-spec-id": 0,
            "partition-specs": [{"spec-id": 0, "fields": []}],
            "last-partition-id": 999,
            "default-sort-order-id": 0,
            "sort-orders": [{"order-id": 0, "fields": []}],
            "properties": props or {},
            "current-snapshot-id": -1,
            "snapshots": [],
            "snapshot-log": [],
            "metadata-log": [],
        }
        loc = self._write_metadata(bucket, ns, name, metadata, 0)
        tables[name] = {
            "uuid": tuid,
            "location": location,
            "metadata_location": loc,
            "version": 0,
            "createdAt": time.time(),
        }
        self._kv_put(f"s3tables:tables:{bucket}:{ns}", tables)
        return {"metadata-location": loc, "metadata": metadata}

    def table_exists(self, bucket: str, ns: str, name: str) -> bool:
        return name in self.tables(bucket, ns)

    def load_table(self, bucket: str, ns: str, name: str) -> dict:
        return self._load_metadata_doc("tables", bucket, ns, name)

    def _load_metadata_doc(
        self, kind: str, bucket: str, ns: str, name: str
    ) -> dict:
        rec = self._registry(kind, bucket, ns).get(name)
        if rec is None:
            raise self._missing(kind, ns, name)
        loc = rec["metadata_location"]
        key = loc.split(f"s3://{bucket}/", 1)[1]
        entry = self.srv.filer.find_entry(f"/buckets/{bucket}/{key}")
        body = self.srv.filer.read_entry(entry)
        return {
            "metadata-location": loc,
            "metadata": json.loads(body),
            "config": {},
        }

    def commit_table(
        self,
        bucket: str,
        ns: str,
        name: str,
        updates: list,
        requirements: list | None = None,
    ) -> dict:
        with self._lock:
            return self._commit_table_locked(
                bucket, ns, name, updates, requirements
            )

    def _commit_table_locked(
        self,
        bucket: str,
        ns: str,
        name: str,
        updates: list,
        requirements: list | None = None,
    ) -> dict:
        """Apply a commit's updates (the Iceberg spec's
        TableUpdate kinds — see _apply_metadata_update); every commit
        writes a NEW metadata file and logs the old one. The
        `requirements` (TableRequirement) are the writer's optimistic-
        concurrency preconditions — a failed one MUST 409 so the
        client rebases and retries instead of silently clobbering a
        concurrent commit."""
        metadata = self._prepare_commit_locked(
            bucket, ns, name, updates, requirements
        )
        return self._persist_commit_locked(bucket, ns, name, metadata)

    def _prepare_commit_locked(
        self,
        bucket: str,
        ns: str,
        name: str,
        updates: list,
        requirements: list | None = None,
    ) -> dict:
        """Validate phase: check requirements and apply every update to
        an in-memory copy. Raises without persisting anything — the
        split lets commit_transaction validate ALL tables before any
        metadata file is written."""
        metadata = self.load_table(bucket, ns, name)["metadata"]
        for req in requirements or []:
            _check_table_requirement(metadata, req)
        for u in updates or []:
            _apply_metadata_update(metadata, u)
        return metadata

    def _stamp_and_write_locked(
        self, bucket: str, ns: str, name: str, metadata: dict
    ) -> tuple[str, int]:
        """Write the new metadata file; the catalog pointer is NOT
        moved yet. An orphaned file from a later failure is harmless —
        nothing references it."""
        rec = self.tables(bucket, ns)[name]
        metadata["last-updated-ms"] = int(time.time() * 1000)
        metadata.setdefault("metadata-log", []).append(
            {
                "timestamp-ms": metadata["last-updated-ms"],
                "metadata-file": rec["metadata_location"],
            }
        )
        version = rec.get("version", 0) + 1
        loc = self._write_metadata(bucket, ns, name, metadata, version)
        return loc, version

    def _swap_pointer_locked(
        self, bucket: str, ns: str, name: str, metadata: dict,
        loc: str, version: int,
    ) -> dict:
        tables = self.tables(bucket, ns)
        rec = tables[name]
        rec["metadata_location"] = loc
        rec["version"] = version
        # an assign-uuid commit must keep the catalog record (the
        # source of the S3Tables ARN) in step with the metadata
        rec["uuid"] = metadata.get("table-uuid", rec.get("uuid"))
        self._kv_put(f"s3tables:tables:{bucket}:{ns}", tables)
        return {"metadata-location": loc, "metadata": metadata}

    def _persist_commit_locked(
        self, bucket: str, ns: str, name: str, metadata: dict
    ) -> dict:
        loc, version = self._stamp_and_write_locked(bucket, ns, name, metadata)
        return self._swap_pointer_locked(
            bucket, ns, name, metadata, loc, version
        )

    def commit_transaction(self, bucket: str, table_changes: list) -> None:
        """Multi-table transaction (Iceberg REST /v1/transactions/commit):
        every change's requirements AND updates are validated first;
        only when the whole set passes is anything persisted, so a 409
        on table N leaves tables 1..N-1 untouched."""
        with self._lock:
            prepared = []
            seen = set()
            for ch in table_changes or []:
                ident = ch.get("identifier") or {}
                ns = ".".join(ident.get("namespace") or [])
                name = ident.get("name", "")
                if (ns, name) in seen:
                    # each prepare loads the PRE-transaction metadata:
                    # a second change for the same table would silently
                    # discard the first one's updates at persist time
                    raise TablesError(
                        400,
                        "BadRequestException",
                        f"duplicate table {ns}.{name} in transaction",
                    )
                seen.add((ns, name))
                prepared.append(
                    (
                        ns,
                        name,
                        self._prepare_commit_locked(
                            bucket,
                            ns,
                            name,
                            ch.get("updates", []),
                            ch.get("requirements", []),
                        ),
                    )
                )
            # metadata files first, catalog-pointer swaps last: a file
            # write failing mid-set leaves every pointer untouched
            # (orphaned files reference nothing); only the KV swaps —
            # small, local, far less failure-prone — remain after
            written = [
                (ns, name, metadata)
                + self._stamp_and_write_locked(bucket, ns, name, metadata)
                for ns, name, metadata in prepared
            ]
            for ns, name, metadata, loc, version in written:
                self._swap_pointer_locked(
                    bucket, ns, name, metadata, loc, version
                )

    def expire_snapshots(
        self, older_than_ms: int, bucket: str = "", dry_run: bool = False
    ) -> dict:
        """Snapshot expiry across the catalog (reference weed worker
        `iceberg` maintenance task: expire old table snapshots).
        Snapshots still reachable from any ref — including the current
        one — are NEVER expired regardless of age; expiry goes through
        the same remove-snapshots update path as a client commit, so
        snapshot-log/refs cleanup and metadata versioning are identical.
        """
        # enumerate under the lock, then sweep one table at a time so
        # API traffic only ever stalls behind ONE table's expiry, not
        # the whole catalog walk (each commit writes a metadata file)
        with self._lock:
            buckets = (
                [bucket]
                if bucket
                else sorted({DEFAULT_BUCKET, *self.buckets()})
            )
            idents = [
                (b, ns, t)
                for b in buckets
                for ns in self.namespaces(b)
                for t in self.tables(b, ns)
            ]
        out = {
            "tables_scanned": 0,
            "tables_updated": 0,
            "snapshots_expired": 0,
        }
        for b, ns, t in idents:
            with self._lock:
                try:
                    md = self.load_table(b, ns, t)["metadata"]
                except (TablesError, NotFound):
                    continue  # dropped since enumeration
                out["tables_scanned"] += 1
                keep = {
                    r.get("snapshot-id")
                    for r in md.get("refs", {}).values()
                }
                cur = md.get("current-snapshot-id", -1)
                if cur != -1:
                    keep.add(cur)
                stale = [
                    s["snapshot-id"]
                    for s in md.get("snapshots", [])
                    if s.get("timestamp-ms", 0) < older_than_ms
                    and s.get("snapshot-id") not in keep
                ]
                if not stale:
                    continue
                out["tables_updated"] += 1
                out["snapshots_expired"] += len(stale)
                if not dry_run:
                    self._commit_table_locked(
                        b,
                        ns,
                        t,
                        [
                            {
                                "action": "remove-snapshots",
                                "snapshot-ids": stale,
                            }
                        ],
                    )
        return out

    # ------------------------------------ kind-generic drop/rename/load
    # ("tables" | "views": one registry layout, one exception naming
    # scheme — a private copy per kind is how the cross-kind identifier
    # invariant gets missed)

    _NOT_FOUND = {
        "tables": ("table", "NoSuchTableException"),
        "views": ("view", "NoSuchViewException"),
    }

    def _registry(self, kind: str, bucket: str, ns: str) -> dict:
        return self._kv(f"s3tables:{kind}:{bucket}:{ns}")

    def _missing(self, kind: str, ns: str, name: str) -> TablesError:
        noun, exc = self._NOT_FOUND[kind]
        return TablesError(404, exc, f"{noun} {ns}.{name} not found")

    def _check_identifier_free(
        self, bucket: str, ns: str, name: str, skip: tuple = ()
    ) -> None:
        """Spec invariant: a table and a view can never share an
        identifier. skip: (kind, ns, name) of the record being moved,
        so a same-name rename does not collide with itself."""
        for kind in ("tables", "views"):
            if (kind, ns, name) == skip:
                continue
            if name in self._registry(kind, bucket, ns):
                noun, _ = self._NOT_FOUND[kind]
                raise TablesError(
                    409,
                    "AlreadyExistsException",
                    f"a {noun} named {name} exists in {ns}",
                )

    def _drop_locked(self, kind: str, bucket: str, ns: str, name: str) -> None:
        reg = self._registry(kind, bucket, ns)
        if name not in reg:
            raise self._missing(kind, ns, name)
        reg.pop(name)
        self._kv_put(f"s3tables:{kind}:{bucket}:{ns}", reg)

    def _rename_locked(
        self, kind: str, bucket: str,
        src_ns: str, src: str, dst_ns: str, dst: str,
    ) -> None:
        self.require_namespace(bucket, dst_ns)
        src_reg = self._registry(kind, bucket, src_ns)
        rec = src_reg.get(src)
        if rec is None:
            raise self._missing(kind, src_ns, src)
        self._check_identifier_free(
            bucket, dst_ns, dst, skip=(kind, src_ns, src)
        )
        src_reg.pop(src)
        self._kv_put(f"s3tables:{kind}:{bucket}:{src_ns}", src_reg)
        dst_reg = self._registry(kind, bucket, dst_ns)
        dst_reg[dst] = rec
        self._kv_put(f"s3tables:{kind}:{bucket}:{dst_ns}", dst_reg)

    def drop_table(self, bucket: str, ns: str, name: str) -> None:
        with self._lock:
            self._drop_locked("tables", bucket, ns, name)

    def rename_table(
        self, bucket: str, src_ns: str, src: str, dst_ns: str, dst: str
    ) -> None:
        _check_name("table", dst)
        with self._lock:
            self._rename_locked("tables", bucket, src_ns, src, dst_ns, dst)


    # ------------------------------------------------------------ views

    def views(self, bucket: str, ns: str) -> dict:
        return self._kv(f"s3tables:views:{bucket}:{ns}")

    def create_view(
        self,
        bucket: str,
        ns: str,
        name: str,
        schema: dict,
        view_version: dict,
        props: dict,
    ) -> dict:
        """Iceberg view (spec view metadata v1): versions carry the SQL
        representations; reference weed/s3api/iceberg view routes."""
        _check_name("view", name)
        with self._lock:
            self.require_namespace(bucket, ns)
            self._check_identifier_free(bucket, ns, name)
            views = self.views(bucket, ns)
            schema = schema or {
                "type": "struct", "schema-id": 0, "fields": [],
            }
            schema.setdefault("schema-id", 0)
            version = dict(view_version or {})
            version.setdefault("version-id", 1)
            version.setdefault("timestamp-ms", int(time.time() * 1000))
            version.setdefault("schema-id", schema["schema-id"])
            version.setdefault("summary", {})
            version.setdefault("representations", [])
            version.setdefault("default-namespace", ns.split("."))
            vuid = str(uuid.uuid4())
            metadata = {
                "view-uuid": vuid,
                "format-version": 1,
                "location": f"s3://{bucket}/{ns}/{name}",
                "schemas": [schema],
                "current-version-id": version["version-id"],
                "versions": [version],
                "version-log": [
                    {
                        "timestamp-ms": version["timestamp-ms"],
                        "version-id": version["version-id"],
                    }
                ],
                "properties": props or {},
            }
            loc = self._write_metadata(bucket, ns, name, metadata, 0)
            views[name] = {
                "uuid": vuid,
                "metadata_location": loc,
                "version": 0,
                "createdAt": time.time(),
            }
            self._kv_put(f"s3tables:views:{bucket}:{ns}", views)
            return {"metadata-location": loc, "metadata": metadata}

    def view_exists(self, bucket: str, ns: str, name: str) -> bool:
        return name in self.views(bucket, ns)

    def load_view(self, bucket: str, ns: str, name: str) -> dict:
        return self._load_metadata_doc("views", bucket, ns, name)

    def drop_view(self, bucket: str, ns: str, name: str) -> None:
        with self._lock:
            self._drop_locked("views", bucket, ns, name)

    def rename_view(
        self, bucket: str, src_ns: str, src: str, dst_ns: str, dst: str
    ) -> None:
        _check_name("view", dst)
        with self._lock:
            self._rename_locked("views", bucket, src_ns, src, dst_ns, dst)

    def commit_view(
        self,
        bucket: str,
        ns: str,
        name: str,
        updates: list,
        requirements: list | None = None,
    ) -> dict:
        with self._lock:
            metadata = self.load_view(bucket, ns, name)["metadata"]
            for req in requirements or []:
                typ = req.get("type", "")
                if typ == "assert-view-uuid":
                    want = req.get("uuid")
                    if metadata.get("view-uuid") != want:
                        raise TablesError(
                            409,
                            "CommitFailedException",
                            f"requirement assert-view-uuid: expected "
                            f"{want}, view has {metadata.get('view-uuid')}",
                        )
                else:
                    raise TablesError(
                        400,
                        "BadRequestException",
                        f"unknown view requirement type {typ!r}",
                    )
            for u in updates or []:
                _apply_view_update(metadata, u)
            views = self.views(bucket, ns)
            rec = views[name]
            version = rec.get("version", 0) + 1
            loc = self._write_metadata(bucket, ns, name, metadata, version)
            rec["metadata_location"] = loc
            rec["version"] = version
            rec["uuid"] = metadata.get("view-uuid", rec.get("uuid"))
            self._kv_put(f"s3tables:views:{bucket}:{ns}", views)
            return {"metadata-location": loc, "metadata": metadata}


def _apply_view_update(metadata: dict, u: dict) -> None:
    """One Iceberg ViewUpdate (the spec's kinds for view commits).
    Unknown kinds fail loudly, mirroring _apply_metadata_update."""
    action = u.get("action", "")
    if action == "assign-uuid":
        metadata["view-uuid"] = u.get("uuid", metadata["view-uuid"])
    elif action == "set-properties":
        metadata["properties"].update(u.get("updates", {}))
    elif action == "remove-properties":
        for k in u.get("removals", []):
            metadata["properties"].pop(k, None)
    elif action == "set-location":
        metadata["location"] = u.get("location", metadata["location"])
    elif action == "add-schema":
        schema = u.get("schema") or {}
        metadata.setdefault("schemas", []).append(schema)
    elif action == "add-view-version":
        version = dict(u.get("view-version") or {})
        if "version-id" not in version:
            raise TablesError(
                400, "BadRequestException",
                "add-view-version needs a version-id",
            )
        if any(
            v.get("version-id") == version["version-id"]
            for v in metadata.get("versions", [])
        ):
            raise TablesError(
                409, "ConflictException",
                f"view version {version['version-id']} already exists",
            )
        version.setdefault("timestamp-ms", int(time.time() * 1000))
        metadata.setdefault("versions", []).append(version)
    elif action == "set-current-view-version":
        vid = int(u.get("view-version-id", -1))
        if vid == -1:  # spec: -1 = the version added in this commit
            vid = metadata["versions"][-1].get("version-id")
        if not any(
            v.get("version-id") == vid
            for v in metadata.get("versions", [])
        ):
            raise TablesError(
                400, "BadRequestException", f"unknown view version {vid}"
            )
        metadata["current-version-id"] = vid
        metadata.setdefault("version-log", []).append(
            {"timestamp-ms": int(time.time() * 1000), "version-id": vid}
        )
    else:
        raise TablesError(
            400, "BadRequestException", f"unknown view update {action!r}"
        )


def _max_field_id(node) -> int:
    """Largest field/element/key/value id anywhere in an Iceberg schema
    tree (struct fields, list element-id, map key-id/value-id)."""
    best = 0
    if isinstance(node, dict):
        for k in ("id", "element-id", "key-id", "value-id"):
            v = node.get(k)
            if isinstance(v, int):
                best = max(best, v)
        for v in node.values():
            if isinstance(v, (dict, list)):
                best = max(best, _max_field_id(v))
    elif isinstance(node, list):
        for item in node:
            best = max(best, _max_field_id(item))
    return best


# requirement type -> (request key, metadata key): all five "assert this
# id matches" kinds are one compare
_ID_REQUIREMENTS = {
    "assert-last-assigned-field-id": (
        "last-assigned-field-id", "last-column-id",
    ),
    "assert-current-schema-id": ("current-schema-id", "current-schema-id"),
    "assert-last-assigned-partition-id": (
        "last-assigned-partition-id", "last-partition-id",
    ),
    "assert-default-spec-id": ("default-spec-id", "default-spec-id"),
    "assert-default-sort-order-id": (
        "default-sort-order-id", "default-sort-order-id",
    ),
}


def _check_table_requirement(metadata: dict, req: dict) -> None:
    """One Iceberg TableRequirement (the commit's optimistic-concurrency
    precondition, reference weed/s3api iceberg catalog + Iceberg REST
    spec). Violations raise 409 CommitFailedException so the writer
    rebases; unknown kinds fail loudly like unknown updates do."""

    def fail(what: str) -> None:
        raise TablesError(409, "CommitFailedException", what)

    typ = req.get("type", "")
    if typ == "assert-create":
        # commit of an existing table can never satisfy assert-create
        fail("requirement assert-create: table already exists")
    elif typ == "assert-table-uuid":
        want = req.get("uuid")
        if metadata.get("table-uuid") != want:
            fail(
                f"requirement assert-table-uuid: expected {want}, "
                f"table has {metadata.get('table-uuid')}"
            )
    elif typ == "assert-ref-snapshot-id":
        ref = req.get("ref", "")
        want = req.get("snapshot-id")  # null = ref must not exist
        have = metadata.get("refs", {}).get(ref)
        have_id = have.get("snapshot-id") if have else None
        if want is None:
            if have is not None:
                fail(f"requirement assert-ref-snapshot-id: ref {ref} exists")
        elif have is None or have_id != want:
            fail(
                f"requirement assert-ref-snapshot-id: ref {ref} is at "
                f"{have_id}, expected {want}"
            )
    elif typ in _ID_REQUIREMENTS:
        req_key, md_key = _ID_REQUIREMENTS[typ]
        want = req.get(req_key)
        if metadata.get(md_key) != want:
            fail(
                f"requirement {typ}: table has {metadata.get(md_key)}, "
                f"expected {want}"
            )
    else:
        raise TablesError(
            400, "BadRequestException", f"unknown requirement type {typ!r}"
        )


def _apply_metadata_update(metadata: dict, u: dict) -> None:
    """One Iceberg TableUpdate against the v2 metadata JSON (the kinds
    real writers — pyiceberg, Spark — emit in commits). Unknown kinds
    fail loudly: silently dropping an update would corrupt the table's
    history invisibly."""
    action = u.get("action", "")
    if action == "set-properties":
        metadata["properties"].update(u.get("updates", {}))
    elif action == "remove-properties":
        for k in u.get("removals", []):
            metadata["properties"].pop(k, None)
    elif action == "assign-uuid":
        metadata["table-uuid"] = u.get("uuid", metadata["table-uuid"])
    elif action == "upgrade-format-version":
        fv = int(u.get("format-version", metadata["format-version"]))
        if fv < metadata["format-version"]:
            raise TablesError(
                400, "BadRequestException", "cannot downgrade format-version"
            )
        if fv > 2:
            # this catalog writes v2 metadata; CLAIMING v3 without its
            # required fields (next-row-id, ...) would persist files
            # spec-compliant readers reject
            raise TablesError(
                400,
                "UnsupportedOperationException",
                f"format-version {fv} not supported (v2 catalog)",
            )
        metadata["format-version"] = fv
    elif action == "set-location":
        metadata["location"] = u.get("location", metadata["location"])
    elif action == "add-schema":
        schema = u.get("schema") or {}
        metadata.setdefault("schemas", []).append(schema)
        lc = u.get("last-column-id")
        if lc is None:
            # the highest field id can live inside a nested struct /
            # list / map — a top-level-only scan would persist a
            # too-low last-column-id and 409 correct writers later
            lc = max(
                _max_field_id(schema),
                metadata.get("last-column-id", 0),
            )
        metadata["last-column-id"] = max(
            metadata.get("last-column-id", 0), int(lc)
        )
    elif action == "set-current-schema":
        sid = int(u.get("schema-id", -1))
        if sid == -1:  # spec: -1 = the schema added in this commit
            sid = metadata["schemas"][-1].get("schema-id", 0)
        if not any(
            sc.get("schema-id") == sid for sc in metadata.get("schemas", [])
        ):
            raise TablesError(
                400, "BadRequestException", f"unknown schema-id {sid}"
            )
        metadata["current-schema-id"] = sid
    elif action == "add-spec":
        metadata.setdefault("partition-specs", []).append(u.get("spec") or {})
        fields = (u.get("spec") or {}).get("fields", [])
        metadata["last-partition-id"] = max(
            metadata.get("last-partition-id", 999),
            max((f.get("field-id", 0) for f in fields), default=0),
        )
    elif action == "set-default-spec":
        sid = int(u.get("spec-id", -1))
        if sid == -1:
            sid = metadata["partition-specs"][-1].get("spec-id", 0)
        if not any(
            sp.get("spec-id") == sid
            for sp in metadata.get("partition-specs", [])
        ):
            raise TablesError(
                400, "BadRequestException", f"unknown spec-id {sid}"
            )
        metadata["default-spec-id"] = sid
    elif action == "add-sort-order":
        metadata.setdefault("sort-orders", []).append(
            u.get("sort-order") or {}
        )
    elif action == "set-default-sort-order":
        oid = int(u.get("sort-order-id", -1))
        if oid == -1:
            oid = metadata["sort-orders"][-1].get("order-id", 0)
        if not any(
            so.get("order-id") == oid
            for so in metadata.get("sort-orders", [])
        ):
            raise TablesError(
                400, "BadRequestException", f"unknown sort-order-id {oid}"
            )
        metadata["default-sort-order-id"] = oid
    elif action == "add-snapshot":
        snap = u.get("snapshot") or {}
        if "snapshot-id" not in snap:
            raise TablesError(
                400, "BadRequestException", "snapshot needs snapshot-id"
            )
        metadata.setdefault("snapshots", []).append(snap)
        metadata["last-sequence-number"] = max(
            metadata.get("last-sequence-number", 0),
            int(snap.get("sequence-number", 0)),
        )
    elif action == "set-snapshot-ref":
        ref = u.get("ref-name", "main")
        sid = int(u.get("snapshot-id", -1))
        if not any(
            sn.get("snapshot-id") == sid
            for sn in metadata.get("snapshots", [])
        ):
            raise TablesError(
                400, "BadRequestException", f"unknown snapshot-id {sid}"
            )
        metadata.setdefault("refs", {})[ref] = {
            "snapshot-id": sid,
            "type": u.get("type", "branch"),
        }
        if ref == "main":
            metadata["current-snapshot-id"] = sid
            metadata.setdefault("snapshot-log", []).append(
                {
                    "timestamp-ms": int(time.time() * 1000),
                    "snapshot-id": sid,
                }
            )
    elif action == "remove-snapshot-ref":
        ref = u.get("ref-name", "")
        metadata.get("refs", {}).pop(ref, None)
        if ref == "main":
            # removing the main branch leaves no current snapshot
            metadata["current-snapshot-id"] = -1
    elif action == "remove-snapshots":
        gone = set(u.get("snapshot-ids", []))
        metadata["snapshots"] = [
            sn
            for sn in metadata.get("snapshots", [])
            if sn.get("snapshot-id") not in gone
        ]
        # nothing may keep POINTING at an expired snapshot: drop refs,
        # log entries, and the current pointer with it
        metadata["refs"] = {
            rn: rv
            for rn, rv in metadata.get("refs", {}).items()
            if rv.get("snapshot-id") not in gone
        }
        metadata["snapshot-log"] = [
            e
            for e in metadata.get("snapshot-log", [])
            if e.get("snapshot-id") not in gone
        ]
        if metadata.get("current-snapshot-id") in gone:
            metadata["current-snapshot-id"] = -1
    else:
        raise TablesError(
            400,
            "UnsupportedOperationException",
            f"unsupported metadata update {action!r}",
        )


# ------------------------------------------------------------ handlers


def _json_resp(h, code: int, doc: dict | list | None = None) -> None:
    body = b"" if doc is None else json.dumps(doc).encode()
    h.send_response(code)
    h.send_header("Content-Type", "application/json")
    h.send_header("Content-Length", str(len(body)))
    h.end_headers()
    if body and h.command != "HEAD":
        h.wfile.write(body)


def _err(h, e: TablesError) -> None:
    _json_resp(
        h,
        e.code,
        {"error": {"message": str(e), "type": e.typ, "code": e.code}},
    )


def _ns_of(part: str) -> str:
    # Iceberg multipart namespaces join on the 0x1F unit separator
    return urllib.parse.unquote(part).replace("\x1f", ".")


def handle_iceberg(h, catalog: TablesCatalog, path: str) -> None:
    """Route /iceberg/v1/... (optionally /iceberg/v1/{prefix}/... where
    prefix names a table bucket)."""
    parts = [p for p in path.split("/") if p][2:]  # drop iceberg, v1
    m = h.command
    try:
        if parts == ["config"]:
            warehouse = urllib.parse.parse_qs(
                urllib.parse.urlparse(h.path).query
            ).get("warehouse", [DEFAULT_BUCKET])[0]
            return _json_resp(
                h,
                200,
                {
                    "defaults": {"prefix": warehouse},
                    "overrides": {},
                },
            )
        # optional {prefix} segment = table bucket
        bucket = DEFAULT_BUCKET
        if parts and parts[0] not in (
            "namespaces", "tables", "views", "transactions", "maintenance",
        ):
            bucket = urllib.parse.unquote(parts[0])
            parts = parts[1:]
        body = {}
        if m == "POST":
            raw = h._read_body()
            if raw:
                body = json.loads(raw)
        if parts == ["transactions", "commit"] and m == "POST":
            catalog.commit_transaction(
                bucket, body.get("table-changes", [])
            )
            return _json_resp(h, 204)
        if parts == ["maintenance"] and m == "POST":
            # catalog maintenance: snapshot expiry (operators post here;
            # the worker's `iceberg` task comes with ROADMAP.md item 18)
            older = body.get("older-than-ms")
            if older is None:
                days = float(body.get("older-than-days", 30))
                older = int(time.time() * 1000) - int(days * 86400_000)
            out = catalog.expire_snapshots(
                int(older),
                bucket="" if body.get("all-buckets") else bucket,
                dry_run=bool(body.get("dry-run")),
            )
            return _json_resp(h, 200, out)
        if parts == ["namespaces"]:
            if m == "GET":
                return _json_resp(
                    h,
                    200,
                    {
                        "namespaces": [
                            ns.split(".")
                            for ns in sorted(catalog.namespaces(bucket))
                        ]
                    },
                )
            if m == "POST":
                ns = ".".join(body.get("namespace", []))
                if not ns:
                    raise TablesError(
                        400, "BadRequestException", "namespace required"
                    )
                if bucket == DEFAULT_BUCKET and not catalog.buckets().get(
                    bucket
                ):
                    catalog.create_bucket(bucket)
                catalog.create_namespace(
                    bucket, ns, body.get("properties", {})
                )
                return _json_resp(
                    h,
                    200,
                    {
                        "namespace": ns.split("."),
                        "properties": body.get("properties", {}),
                    },
                )
        if len(parts) == 2 and parts[0] == "namespaces":
            ns = _ns_of(parts[1])
            if m in ("GET", "HEAD"):
                rec = catalog.require_namespace(bucket, ns)
                if m == "HEAD":
                    return _json_resp(h, 204)
                return _json_resp(
                    h,
                    200,
                    {
                        "namespace": ns.split("."),
                        "properties": rec["properties"],
                    },
                )
            if m == "DELETE":
                catalog.drop_namespace(bucket, ns)
                return _json_resp(h, 204)
        if (
            len(parts) == 3
            and parts[0] == "namespaces"
            and parts[2] == "properties"
            and m == "POST"
        ):
            ns = _ns_of(parts[1])
            out = catalog.update_namespace_props(
                bucket, ns, body.get("removals", []), body.get("updates", {})
            )
            return _json_resp(h, 200, out)
        if len(parts) == 3 and parts[0] == "namespaces" and parts[2] == "tables":
            ns = _ns_of(parts[1])
            if m == "GET":
                catalog.require_namespace(bucket, ns)
                return _json_resp(
                    h,
                    200,
                    {
                        "identifiers": [
                            {"namespace": ns.split("."), "name": t}
                            for t in sorted(catalog.tables(bucket, ns))
                        ]
                    },
                )
            if m == "POST":
                out = catalog.create_table(
                    bucket,
                    ns,
                    body.get("name", ""),
                    body.get("schema"),
                    body.get("properties", {}),
                )
                return _json_resp(h, 200, out)
        if len(parts) == 4 and parts[0] == "namespaces" and parts[2] == "tables":
            ns, table = _ns_of(parts[1]), urllib.parse.unquote(parts[3])
            if m == "HEAD":
                if not catalog.table_exists(bucket, ns, table):
                    raise TablesError(
                        404, "NoSuchTableException", f"{ns}.{table}"
                    )
                return _json_resp(h, 204)
            if m == "GET":
                return _json_resp(
                    h, 200, catalog.load_table(bucket, ns, table)
                )
            if m == "DELETE":
                catalog.drop_table(bucket, ns, table)
                return _json_resp(h, 204)
            if m == "POST":  # commit
                out = catalog.commit_table(
                    bucket,
                    ns,
                    table,
                    body.get("updates", []),
                    body.get("requirements", []),
                )
                return _json_resp(h, 200, out)
        if len(parts) == 3 and parts[0] == "namespaces" and parts[2] == "views":
            ns = _ns_of(parts[1])
            if m == "GET":
                catalog.require_namespace(bucket, ns)
                return _json_resp(
                    h,
                    200,
                    {
                        "identifiers": [
                            {"namespace": ns.split("."), "name": v}
                            for v in sorted(catalog.views(bucket, ns))
                        ]
                    },
                )
            if m == "POST":
                out = catalog.create_view(
                    bucket,
                    ns,
                    body.get("name", ""),
                    body.get("schema"),
                    body.get("view-version"),
                    body.get("properties", {}),
                )
                return _json_resp(h, 200, out)
        if len(parts) == 4 and parts[0] == "namespaces" and parts[2] == "views":
            ns, view = _ns_of(parts[1]), urllib.parse.unquote(parts[3])
            if m == "HEAD":
                if not catalog.view_exists(bucket, ns, view):
                    raise TablesError(
                        404, "NoSuchViewException", f"{ns}.{view}"
                    )
                return _json_resp(h, 204)
            if m == "GET":
                return _json_resp(h, 200, catalog.load_view(bucket, ns, view))
            if m == "DELETE":
                catalog.drop_view(bucket, ns, view)
                return _json_resp(h, 204)
            if m == "POST":  # commit (replace view)
                out = catalog.commit_view(
                    bucket,
                    ns,
                    view,
                    body.get("updates", []),
                    body.get("requirements", []),
                )
                return _json_resp(h, 200, out)
        if parts == ["views", "rename"] and m == "POST":
            src, dst = body.get("source", {}), body.get("destination", {})
            catalog.rename_view(
                bucket,
                ".".join(src.get("namespace", [])),
                src.get("name", ""),
                ".".join(dst.get("namespace", [])),
                dst.get("name", ""),
            )
            return _json_resp(h, 204)
        if parts == ["tables", "rename"] and m == "POST":
            src, dst = body.get("source", {}), body.get("destination", {})
            catalog.rename_table(
                bucket,
                ".".join(src.get("namespace", [])),
                src.get("name", ""),
                ".".join(dst.get("namespace", [])),
                dst.get("name", ""),
            )
            return _json_resp(h, 204)
        raise TablesError(404, "NotFoundException", f"no route {m} {path}")
    except TablesError as e:
        return _err(h, e)
    except NotFound as e:
        return _err(h, TablesError(404, "NotFoundException", str(e)))
    except (ValueError, KeyError, TypeError) as e:
        # TypeError: JSON null / wrong-shaped values hitting int()/float()
        return _err(h, TablesError(400, "BadRequestException", str(e)))


def _arn_bucket(arn: str) -> str:
    return urllib.parse.unquote(arn).rsplit("/", 1)[-1]


def handle_s3tables(h, catalog: TablesCatalog) -> None:
    """AWS S3Tables ops: X-Amz-Target JSON posts AND the CLI's ARN REST
    paths (reference s3api_tables.go)."""
    target = h.headers.get("X-Amz-Target", "")
    u = urllib.parse.urlparse(h.path)
    path = urllib.parse.unquote(u.path)
    m = h.command
    try:
        body = {}
        if m in ("POST", "PUT"):
            raw = h._read_body()
            if raw:
                body = json.loads(raw)
        op = target[len("S3Tables.") :] if target else ""
        if not op:  # REST routing; the ARN itself contains a slash, so
            # split AROUND it with the reference's regex
            # (s3api_tables.go tableBucketARNRegex)
            kind = path.split("/", 2)[1] if path.count("/") else ""
            arn_m = _ARN_RE.search(path)
            arn = arn_m.group(0) if arn_m else ""
            rest = (
                [s for s in path[arn_m.end() :].split("/") if s]
                if arn_m
                else []
            )
            if kind == "buckets":
                if m == "PUT" and not arn:
                    op = "CreateTableBucket"
                elif m == "GET" and not arn:
                    op = "ListTableBuckets"
                elif m == "GET":
                    op, body = "GetTableBucket", {"tableBucketARN": arn}
                elif m == "DELETE":
                    op, body = "DeleteTableBucket", {"tableBucketARN": arn}
            elif kind == "namespaces" and arn:
                if m == "PUT":
                    body = {**body, "tableBucketARN": arn}
                    op = "CreateNamespace"
                elif m == "GET" and not rest:
                    op, body = "ListNamespaces", {"tableBucketARN": arn}
                elif m == "GET" and rest:
                    op = "GetNamespace"
                    body = {"tableBucketARN": arn, "namespace": rest[0]}
                elif m == "DELETE" and rest:
                    op = "DeleteNamespace"
                    body = {"tableBucketARN": arn, "namespace": rest[0]}
            elif kind == "tables" and arn:
                if m == "PUT" and rest:
                    body = {
                        **body,
                        "tableBucketARN": arn,
                        "namespace": rest[0],
                    }
                    op = "CreateTable"
                elif m == "GET" and not rest:
                    op, body = "ListTables", {"tableBucketARN": arn}
                elif m == "GET" and len(rest) >= 2:
                    op = "GetTable"
                    body = {
                        "tableBucketARN": arn,
                        "namespace": rest[0],
                        "name": rest[1],
                    }
                elif m == "DELETE" and len(rest) >= 2:
                    op = "DeleteTable"
                    body = {
                        "tableBucketARN": arn,
                        "namespace": rest[0],
                        "name": rest[1],
                    }
        if not op:
            raise TablesError(400, "BadRequestException", "unroutable request")

        if op == "CreateTableBucket":
            rec = catalog.create_bucket(body.get("name", ""))
            return _json_resp(h, 200, {"arn": rec["arn"]})
        if op == "ListTableBuckets":
            return _json_resp(
                h,
                200,
                {
                    "tableBuckets": [
                        {"arn": rec["arn"], "name": name}
                        for name, rec in sorted(catalog.buckets().items())
                    ]
                },
            )
        if op == "GetTableBucket":
            name = _arn_bucket(body["tableBucketARN"])
            rec = catalog.require_bucket(name)
            return _json_resp(h, 200, {"arn": rec["arn"], "name": name})
        if op == "DeleteTableBucket":
            catalog.delete_bucket(_arn_bucket(body["tableBucketARN"]))
            return _json_resp(h, 204)
        if op == "CreateNamespace":
            bucket = _arn_bucket(body["tableBucketARN"])
            ns = body.get("namespace", [])
            ns = ns[0] if isinstance(ns, list) else ns
            catalog.create_namespace(bucket, ns, {})
            return _json_resp(
                h, 200, {"namespace": [ns], "tableBucketARN": body["tableBucketARN"]}
            )
        if op == "ListNamespaces":
            bucket = _arn_bucket(body["tableBucketARN"])
            catalog.require_bucket(bucket)
            return _json_resp(
                h,
                200,
                {
                    "namespaces": [
                        {"namespace": [ns]}
                        for ns in sorted(catalog.namespaces(bucket))
                    ]
                },
            )
        if op == "GetNamespace":
            bucket = _arn_bucket(body["tableBucketARN"])
            ns = body["namespace"]
            catalog.require_namespace(bucket, ns)
            return _json_resp(h, 200, {"namespace": [ns]})
        if op == "DeleteNamespace":
            catalog.drop_namespace(
                _arn_bucket(body["tableBucketARN"]), body["namespace"]
            )
            return _json_resp(h, 204)
        if op == "CreateTable":
            bucket = _arn_bucket(body["tableBucketARN"])
            out = catalog.create_table(
                bucket,
                body["namespace"],
                body.get("name", ""),
                None,
                {},
            )
            tables = catalog.tables(bucket, body["namespace"])
            rec = tables[body["name"]]
            return _json_resp(
                h,
                200,
                {
                    "tableARN": f"arn:aws:s3tables:local:000000000000:"
                    f"bucket/{bucket}/table/{rec['uuid']}",
                    "versionToken": str(rec["version"]),
                    "metadataLocation": out["metadata-location"],
                },
            )
        if op == "ListTables":
            bucket = _arn_bucket(body["tableBucketARN"])
            catalog.require_bucket(bucket)
            out = []
            for ns in sorted(catalog.namespaces(bucket)):
                for t in sorted(catalog.tables(bucket, ns)):
                    out.append({"namespace": [ns], "name": t})
            return _json_resp(h, 200, {"tables": out})
        if op == "GetTable":
            bucket = _arn_bucket(body["tableBucketARN"])
            loaded = catalog.load_table(
                bucket, body["namespace"], body["name"]
            )
            return _json_resp(
                h,
                200,
                {
                    "name": body["name"],
                    "namespace": [body["namespace"]],
                    "metadataLocation": loaded["metadata-location"],
                    "format": "ICEBERG",
                },
            )
        if op == "DeleteTable":
            catalog.drop_table(
                _arn_bucket(body["tableBucketARN"]),
                body["namespace"],
                body["name"],
            )
            return _json_resp(h, 204)
        raise TablesError(
            400, "UnsupportedOperationException", f"unsupported op {op}"
        )
    except TablesError as e:
        return _err(h, e)
    except NotFound as e:
        return _err(h, TablesError(404, "NotFoundException", str(e)))
    except (ValueError, KeyError, TypeError) as e:
        # TypeError: JSON null / wrong-shaped values hitting int()/float()
        return _err(h, TablesError(400, "BadRequestException", str(e)))
