"""Lazy remote mounts: a filer directory backed by a cloud bucket.

Reference: weed/filer/read_remote.go + filer_lazy_remote*.go and the
shell's remote.configure/mount/cache/uncache/unmount commands —
metadata is materialized at mount time (names, sizes, etags; no data),
reads stream through from the remote on demand, and `cache` pins a
file's bytes into local chunks (uncache drops them again).

Storage conventions (all inside the filer itself, like the reference's
filer-conf):
  KV  remote.conf:<name>    -> JSON client config
  KV  remote.mount:<dir>    -> JSON {remote, bucket, prefix}
  entry.extended["sw-remote"] -> JSON {remote, bucket, key, size, etag}

Port of seaweedfs_tpu/remote/mount.py: the KV records and the
`sw-remote` JSON are byte-equal to the JAX package's. Where the two
differ, on purpose: the JAX `get_client` builds a new client, and so a
new connection, for every read through a mount; the port's hands out one
client per stored configuration (`_CLIENTS`, keyed by its raw bytes, so
`configure` with other values takes a new one), whose connections stay
alive between reads.
"""

from __future__ import annotations

import json
import threading

from ..filer.entry import Entry, new_entry, normalize_path
from ..filer.filer import Filer, FilerError
from .s3_client import RemoteS3Client

REMOTE_ATTR = "sw-remote"

# one client per stored remote configuration (its raw KV bytes), at most
# _MAX_CLIENTS, the oldest closed first
_CLIENTS: dict[bytes, RemoteS3Client] = {}
_CLIENTS_LOCK = threading.Lock()
_MAX_CLIENTS = 64


def configure(filer: Filer, name: str, conf: dict) -> None:
    """conf: {endpoint, access_key, secret_key, region}."""
    filer.store.kv_put(f"remote.conf:{name}".encode(), json.dumps(conf).encode())


def get_client(filer: Filer, name: str) -> RemoteS3Client:
    raw = filer.store.kv_get(f"remote.conf:{name}".encode())
    if raw is None:
        raise FilerError(f"remote storage {name!r} not configured")
    with _CLIENTS_LOCK:
        client = _CLIENTS.get(raw)
    if client is not None:
        return client
    conf = json.loads(raw)
    client = RemoteS3Client(
        endpoint=conf["endpoint"],
        access_key=conf.get("access_key", ""),
        secret_key=conf.get("secret_key", ""),
        region=conf.get("region", "us-east-1"),
    )
    with _CLIENTS_LOCK:
        if raw in _CLIENTS:
            client = _CLIENTS[raw]  # another thread's, made meanwhile
        else:
            _CLIENTS[raw] = client
            if len(_CLIENTS) > _MAX_CLIENTS:
                _CLIENTS.pop(next(iter(_CLIENTS))).close()
    return client


def list_mounts(filer: Filer) -> dict[str, dict]:
    out = {}
    raw = filer.store.kv_get(b"remote.mounts")
    if raw:
        out = json.loads(raw)
    return out


def _save_mounts(filer: Filer, mounts: dict) -> None:
    filer.store.kv_put(b"remote.mounts", json.dumps(mounts).encode())


def mount(
    filer: Filer, directory: str, remote_name: str, bucket: str, prefix: str = ""
) -> int:
    """Materialize the remote listing as entries under `directory`;
    returns how many objects were mapped."""
    directory = normalize_path(directory)
    client = get_client(filer, remote_name)
    mounts = list_mounts(filer)
    if directory in mounts:
        raise FilerError(f"{directory} is already a remote mount")
    objs = client.list_objects(bucket, prefix)
    n = 0
    for obj in objs:
        rel = obj.key[len(prefix) :].lstrip("/")
        if not rel or rel.endswith("/"):
            continue
        path = f"{directory}/{rel}"
        entry = new_entry(path, mode=0o644)
        entry.attr.file_size = obj.size
        entry.extended[REMOTE_ATTR] = json.dumps(
            {
                "remote": remote_name,
                "bucket": bucket,
                "key": obj.key,
                "size": obj.size,
                "etag": obj.etag,
            }
        ).encode()
        filer.create_entry(entry)
        n += 1
    mounts[directory] = {
        "remote": remote_name,
        "bucket": bucket,
        "prefix": prefix,
    }
    _save_mounts(filer, mounts)
    return n


def mount_buckets(
    filer: Filer, directory: str, remote_name: str, prefix_filter: str = ""
) -> dict[str, int]:
    """Mount EVERY bucket of a configured remote under
    directory/<bucket> (reference remote.mount.buckets); returns
    {bucket: objects_mapped}. Already-mounted buckets are skipped."""
    directory = normalize_path(directory)
    client = get_client(filer, remote_name)
    mounts = list_mounts(filer)
    out: dict[str, int] = {}
    for bucket in client.list_buckets():
        if prefix_filter and not bucket.startswith(prefix_filter):
            continue
        target = f"{directory}/{bucket}"
        if target in mounts:
            continue
        out[bucket] = mount(filer, target, remote_name, bucket)
        mounts = list_mounts(filer)  # mount() persisted a new entry
    return out


def meta_sync(filer: Filer, directory: str) -> tuple[int, int, int]:
    """Refresh a mount's metadata from the remote listing (reference
    remote.meta.sync): new objects appear, changed sizes/etags update,
    objects gone remotely drop their local entries. Returns
    (added, updated, removed)."""
    directory = normalize_path(directory)
    mounts = list_mounts(filer)
    conf = mounts.get(directory)
    if conf is None:
        raise FilerError(f"{directory} is not a remote mount")
    client = get_client(filer, conf["remote"])
    prefix = conf.get("prefix", "")
    remote_objs = {
        obj.key[len(prefix):].lstrip("/"): obj
        for obj in client.list_objects(conf["bucket"], prefix)
        if obj.key[len(prefix):].lstrip("/") and not obj.key.endswith("/")
    }
    local: dict[str, Entry] = {}

    def walk(d: str, rel: str = ""):
        for e in filer.list_entries(d, limit=1_000_000):
            if e.is_directory:
                walk(e.full_path, f"{rel}{e.name}/")
            elif REMOTE_ATTR in e.extended:
                local[f"{rel}{e.name}"] = e

    walk(directory)
    added = updated = removed = 0
    for rel, obj in remote_objs.items():
        meta = {
            "remote": conf["remote"],
            "bucket": conf["bucket"],
            "key": obj.key,
            "size": obj.size,
            "etag": obj.etag,
        }
        have = local.get(rel)
        if have is None:
            entry = new_entry(f"{directory}/{rel}", mode=0o644)
            entry.attr.file_size = obj.size
            entry.extended[REMOTE_ATTR] = json.dumps(meta).encode()
            filer.create_entry(entry)
            added += 1
            continue
        old_meta = json.loads(have.extended[REMOTE_ATTR])
        if (old_meta.get("etag"), old_meta.get("size")) != (obj.etag, obj.size):
            old_chunks: list = []

            def mutate(e, _m=meta, _o=obj, _oc=old_chunks):
                _oc.extend(e.chunks)
                e.attr.file_size = _o.size
                e.chunks = []  # cached bytes are stale: drop them
                e.extended[REMOTE_ATTR] = json.dumps(_m).encode()

            filer.mutate_entry(have.full_path, mutate)
            if old_chunks:
                # the dropped cache chunks must be reclaimed (same
                # discipline as uncache), or every sync cycle over a
                # cached mount leaks volume space
                filer.gc_chunks(old_chunks)
            updated += 1
    for rel, e in local.items():
        if rel not in remote_objs:
            filer.delete_entry(e.full_path, gc_chunks=True)
            removed += 1
    return added, updated, removed


def unmount(filer: Filer, directory: str) -> None:
    directory = normalize_path(directory)
    mounts = list_mounts(filer)
    if directory not in mounts:
        raise FilerError(f"{directory} is not a remote mount")
    # local-cache chunks under the mount ARE reclaimed; remote data is
    # untouched (the mount is a view)
    filer.delete_entry(directory, recursive=True)
    del mounts[directory]
    _save_mounts(filer, mounts)


def read_remote(
    filer: Filer, entry: Entry, offset: int = 0, size: int = -1
) -> bytes:
    """Read-through for an uncached remote entry."""
    meta = json.loads(entry.extended[REMOTE_ATTR])
    client = get_client(filer, meta["remote"])
    return client.get_object(
        meta["bucket"], meta["key"], offset=offset, size=size
    )


def cache(filer: Filer, path: str) -> Entry:
    """Pin a remote file's bytes into local chunks (remote.cache)."""
    entry = filer.find_entry(path)
    raw = entry.extended.get(REMOTE_ATTR)
    if raw is None:
        raise FilerError(f"{path} is not remote-mounted")
    if entry.chunks or entry.content:
        return entry  # already cached
    data = read_remote(filer, entry)
    cached = filer.write_file(
        path, data, mime=entry.attr.mime, extended={REMOTE_ATTR: raw}
    )
    return cached


def uncache(filer: Filer, path: str) -> Entry:
    """Drop the local copy, keep the remote mapping (remote.uncache)."""
    entry = filer.find_entry(path)
    raw = entry.extended.get(REMOTE_ATTR)
    if raw is None:
        raise FilerError(f"{path} is not remote-mounted")
    old_chunks = list(entry.chunks)

    def strip(e: Entry) -> None:
        e.chunks = []
        e.content = b""
        e.attr.file_size = json.loads(raw)["size"]

    out = filer.mutate_entry(path, strip)
    if old_chunks:
        filer.gc_chunks(old_chunks)
    return out
