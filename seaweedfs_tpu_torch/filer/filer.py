"""Filer core: a POSIX-ish namespace over a FilerStore, with file
content chunked across the blob store.

Port of seaweedfs_tpu/filer/filer.py, whole: an entry of a remote mount
with no local chunks (its `sw-remote` marker) reads through the cloud
object (remote/mount.py `read_remote`, imported on the first such read,
so the filer loads nothing of remote/ until then). One difference, on
purpose: a recursive delete reads each directory's listing whole before
it deletes, where the JAX Filer deletes under the store's open cursor;
on a SQL store a write committed meanwhile by another connection then
fails the JAX delete ("database is locked"). Chunks go up and come
back through the port's Operations, so a chunk in an EC volume
reads back through the holder's degraded GET, whatever it raises
propagating as in the JAX Filer.

Reference: weed/filer/filer.go (CreateEntry :217 with parent mkdirs),
filer_deletion.go (async chunk GC), filer_rename.go (2-phase move),
filer_server_handlers_write_upload.go:32 (chunked upload path).
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
import time
from typing import Iterator, Optional

from ..client.operations import Operations
from .chunks import read_chunk_views, total_size
from ..pb import filer_pb2 as fpb
from ..utils import trace
from .entry import Entry, new_entry, normalize_path, split_path
from .filer_store import FilerStore, NotFound

DEFAULT_CHUNK_SIZE = 4 * 1024 * 1024  # reference filer -maxMB default
INLINE_LIMIT = 512  # small files live in the entry itself (reference
# filer small-content inlining): no volume round-trip to read them


class FilerError(Exception):
    pass


class Filer:
    def __init__(
        self,
        store: FilerStore,
        master: str = "localhost:9333",
        collection: str = "",
        replication: str = "",
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        jwt_key: str = "",
        chunk_cache_bytes: int = 64 * 1024 * 1024,
        entry_cache_bytes: int | None = None,
    ):
        self.store = store
        self.ops = Operations(master, jwt_key=jwt_key)
        from ..utils.chunk_cache import ChunkCache

        # read-path LRU (reference chunk_cache memory tier); fids are
        # immutable so cached bytes can never go stale. The hot tier of
        # the gateway read path: misses are singleflight-collapsed, so
        # N concurrent GETs of one cold (possibly degraded) chunk cost
        # ONE volume fetch/reconstruction.
        self.chunk_cache = ChunkCache(chunk_cache_bytes, tier="filer_chunk")
        # Entry-lookup cache: path -> serialized Entry proto,
        # so a warm GET's `filer.lookup` stage stops hitting store.find
        # (and the hardlink KV overlay) on every request. Values are
        # PROTO BYTES, decoded per hit — callers mutate their Entry
        # copies freely without corrupting the cache, and a hit is
        # bit-identical to a fresh store read by construction.
        # Singleflight via get_or_load: N concurrent warm misses on one
        # path collapse to ONE store.find. Invalidated by every local
        # mutator and by replicated meta-log events (_entry_cache_drop
        # call sites); hardlinked entries are NEVER admitted — a
        # sibling name's write changes their content without touching
        # this path. 0 disables (pass-through, no collapsing).
        if entry_cache_bytes is None:
            try:
                entry_cache_bytes = int(
                    os.environ.get("SEAWEED_FILER_ENTRY_CACHE_MB", "8")
                ) << 20
            except ValueError:
                entry_cache_bytes = 8 << 20
        self.entry_cache = ChunkCache(entry_cache_bytes, tier="filer_entry")
        self.collection = collection
        self.replication = replication
        self.chunk_size = chunk_size
        # async chunk GC (reference filer_deletion.go)
        self._gc_queue: "queue.Queue[tuple[str, int]]" = queue.Queue()
        self._gc_stop = threading.Event()
        self._gc_thread = threading.Thread(target=self._gc_loop, daemon=True)
        self._gc_thread.start()
        self._listeners: list = []
        # serializes metadata read-modify-write (tagging, xattr-style
        # updates) against entry replacement; reentrant so composite
        # ops (recursive delete, hardlink) can nest the primitives
        self._mutate_lock = threading.RLock()
        # chunk-list size beyond which create_entry manifestizes
        # (reference filechunk_manifest.go ManifestBatch)
        self.manifest_threshold = 1000
        # strictly-increasing event timestamps: subscription resume and
        # LWW merge both break on equal tsNs (watermarks use strict >)
        self._ts_lock = threading.Lock()
        self._last_ts = 0
        # POSIX advisory byte-range locks (filer_grpc_server_posix_lock)
        from .locks import PosixLockManager

        self.lock_manager = PosixLockManager()

    # ------------------------------------------------------------- meta log

    def subscribe(self, fn) -> None:
        """fn(FullEventNotification) on every mutation."""
        self._listeners.append(fn)

    def _notify(
        self,
        directory: str,
        old: Optional[Entry],
        new: Optional[Entry],
        delete_chunks: bool = False,
        ts_ns: int = 0,
        remote: bool = False,
    ) -> None:
        if not self._listeners:
            return
        ev = fpb.FullEventNotification(
            directory=directory, ts_ns=ts_ns or self._next_ts()
        )
        if old is not None:
            ev.event.old_entry.CopyFrom(old.to_proto())
        if new is not None:
            ev.event.new_entry.CopyFrom(new.to_proto())
        ev.event.delete_chunks = delete_chunks
        ev.event.is_from_other_cluster = remote
        for fn in list(self._listeners):
            try:
                fn(ev)
            except Exception:
                pass

    def _next_ts(self) -> int:
        with self._ts_lock:
            self._last_ts = max(self._last_ts + 1, time.time_ns())
            return self._last_ts

    def _stamp(self, entry: Entry) -> int:
        """Nanosecond metadata timestamp persisted on the entry: the
        multi-filer aggregator's last-writer-wins comparisons need finer
        resolution than attr.mtime's seconds (meta_aggregator.py).
        Strictly increasing per filer so no two events share a tsNs."""
        ts = self._next_ts()
        entry.extended["sw-mts"] = str(ts).encode()
        return ts

    @staticmethod
    def meta_ts(entry: Optional[Entry]) -> int:
        if entry is None:
            return 0
        raw = entry.extended.get("sw-mts")
        if raw:
            try:
                return int(raw)
            except ValueError:
                pass
        return entry.attr.mtime * 1_000_000_000

    # ----------------------------------------------------------- namespace

    def create_entry(
        self,
        entry: Entry,
        ensure_parents: bool = True,
        collection: str | None = None,
    ) -> None:
        if ensure_parents:
            self._ensure_parents(entry.directory)
        if len(entry.chunks) > self.manifest_threshold:
            # huge chunk lists become manifest blobs so every metadata
            # read doesn't deserialize thousands of chunks
            from .manifest import maybe_manifestize

            col = self.collection if collection is None else collection
            entry.chunks = maybe_manifestize(
                lambda blob: self.ops.upload(
                    blob, collection=col, replication=self.replication
                ),
                entry.chunks,
                self.manifest_threshold,
            )
        with self._mutate_lock:
            # stamp inside the lock: racing writers must insert in the
            # same order as their LWW timestamps or peers diverge
            ts = self._stamp(entry)
            old = self._try_find(entry.directory, entry.name)
            if old is not None and old.is_directory != entry.is_directory:
                raise FilerError(
                    f"{entry.full_path}: type conflict with existing entry"
                )
            if old is not None and old.hard_link_id and not entry.hard_link_id:
                # a content commit through an open handle doesn't know
                # about the link identity: inherit it, or the write
                # would silently sever this name from its siblings
                entry.hard_link_id = old.hard_link_id
                entry.hard_link_counter = old.hard_link_counter
            self.store.insert(entry)
            self._hl_publish(entry)
            self._entry_cache_drop(entry.directory, entry.name)
        self._notify(entry.directory, old, entry, ts_ns=ts)

    def mutate_entry(self, full_path: str, fn) -> Entry:
        """Read-modify-write an entry's metadata atomically w.r.t. other
        metadata mutations, and notify subscribers. `fn(entry)` mutates
        in place. A stale pre-read entry must never be written back —
        that would revert a concurrent content overwrite."""
        directory, name = split_path(full_path)
        with self._mutate_lock:
            # overlay FIRST: for a hardlinked name the per-name record
            # can hold a stale content snapshot (a sibling may have
            # written since); republishing it via _hl_publish would
            # revert the sibling's write across every name
            entry = self._hl_overlay(self.store.find(directory, name))
            old = Entry(
                directory=entry.directory,
                name=entry.name,
                is_directory=entry.is_directory,
                chunks=list(entry.chunks),
                content=entry.content,
            )
            old.attr.CopyFrom(entry.attr)
            old.extended = dict(entry.extended)
            fn(entry)
            ts = self._stamp(entry)
            self.store.update(entry)
            self._hl_publish(entry)
            self._entry_cache_drop(directory, name)
        self._notify(directory, old, entry, ts_ns=ts)
        return entry

    def _ensure_parents(self, directory: str) -> None:
        directory = normalize_path(directory)
        if directory == "/":
            return
        parts = directory.strip("/").split("/")
        path = ""
        for part in parts:
            parent = path or "/"
            path = f"{path}/{part}"
            existing = self._try_find(parent, part)
            if existing is None:
                made = new_entry(path, is_directory=True, mode=0o755)
                self.store.insert(made)
                self._entry_cache_drop(parent, part)
                self._notify(parent, None, made)
            elif not existing.is_directory:
                raise FilerError(f"{path} exists and is not a directory")

    def _try_find(self, directory: str, name: str) -> Optional[Entry]:
        try:
            return self.store.find(directory, name)
        except NotFound:
            return None

    # --------------------------------------------------- path-based rules

    def path_conf(self, full_path: str) -> dict:
        """Longest-prefix storage rule for a path (reference
        fs.configure / filer_conf.go): {collection, replication,
        ttl_sec} chosen by location_prefix."""
        raw = self.store.kv_get(b"fs.configure")
        if not raw:
            return {}
        try:
            rules = (__import__("json").loads(raw)).get("locations", [])
        except ValueError:
            return {}
        best: dict = {}
        best_len = -1
        for r in rules:
            p = r.get("location_prefix", "")
            if p and full_path.startswith(p) and len(p) > best_len:
                best, best_len = r, len(p)
        return best

    def _gc_overwritten(self, old: Optional[Entry]) -> None:
        """Release the entry an overwrite replaced. For a hardlinked
        name the NAME survives in its link group (create_entry
        inherited the id and republished hlmeta), so the shared counter
        must not move — only the superseded shared chunks (resolved by
        the caller's pre-republish overlay) are freed."""
        if old is None:
            return
        if old.hard_link_id:
            if old.chunks:
                self.gc_chunks(old.chunks)
            return
        self._release_entry_chunks(old)

    def _hl_publish(self, entry: Entry) -> None:
        """Hardlinked names share ONE content/attr record — the inode
        (reference filer_hardlink.go stores it once, keyed by the link
        id). Every commit through ANY name republishes the shared
        record so all the other names observe the write."""
        if entry.hard_link_id:
            self.store.kv_put(
                b"hlmeta:" + entry.hard_link_id, entry.to_bytes()
            )

    def _hl_overlay(self, entry: Entry) -> Entry:
        """Resolve a hardlinked name against the shared inode record:
        chunks/content/attrs come from hlmeta; only directory+name are
        the entry's own."""
        if not entry.hard_link_id:
            return entry
        raw = self.store.kv_get(b"hlmeta:" + entry.hard_link_id)
        if raw is None:
            return entry
        shadow = Entry.from_bytes(entry.directory, raw)
        entry.chunks = list(shadow.chunks)
        entry.content = shadow.content
        entry.attr.CopyFrom(shadow.attr)
        return entry

    def find_entry(self, full_path: str) -> Entry:
        directory, name = split_path(full_path)
        if name == "":
            root = Entry(directory="/", name="", is_directory=True)
            root.attr.file_mode = 0o755
            return root
        # gateway read-path stage: where a slow GET's metadata-lookup
        # time shows up (ambient span = the server's HTTP root span)
        with trace.stage(trace.current(), "filer.lookup"):
            entry = self._lookup_cached(directory, name)
        if self._is_expired(entry):
            # read-triggered expiry (reference filer TTL): the name
            # vanishes and its chunks are reclaimed asynchronously.
            # Expiry is evaluated on EVERY return (hits included), so a
            # cached entry can never outlive its TTL.
            self.delete_entry(entry.full_path)
            raise NotFound(entry.full_path)
        return entry

    @staticmethod
    def _entry_key(directory: str, name: str) -> str:
        return f"{directory}\x00{name}"

    def _lookup_cached(self, directory: str, name: str) -> Entry:
        """store.find + hardlink overlay through the entry cache.
        Misses singleflight-collapse; a NotFound raised by the loader
        propagates to every collapsed waiter and caches nothing."""
        cache = self.entry_cache
        if cache.capacity <= 0:
            return self._hl_overlay(self.store.find(directory, name))
        hardlinked = [False]

        def load() -> bytes:
            e = self._hl_overlay(self.store.find(directory, name))
            hardlinked[0] = bool(e.hard_link_id)
            return e.to_bytes()

        raw, _src = cache.get_or_load(
            self._entry_key(directory, name),
            load,
            # never admit hardlinked entries (sibling writes mutate
            # them without touching this path), nor entries big enough
            # to flush the hot set (huge inlined content/chunk lists)
            admit=lambda b: not hardlinked[0]
            and len(b) <= cache.capacity // 8,
        )
        return Entry.from_bytes(directory, raw)

    def _entry_cache_drop(self, directory: str, name: str) -> None:
        """Invalidate one path's cached entry. Called by every mutator
        (local writes, renames, deletes, hardlinks, replicated meta-log
        events); an in-flight load for the path is fenced by the cache
        (doomed, never admitted), so a lookup racing the write cannot
        repopulate the stale entry."""
        if name:
            self.entry_cache.drop(
                self._entry_key(normalize_path(directory), name)
            )

    @staticmethod
    def _is_expired(entry: Entry) -> bool:
        ttl = entry.attr.ttl_sec
        return (
            ttl > 0
            and not entry.is_directory
            and entry.attr.crtime + ttl <= int(time.time())
        )

    def exists(self, full_path: str) -> bool:
        try:
            self.find_entry(full_path)
            return True
        except NotFound:
            return False

    def list_entries(
        self, directory: str, start_from: str = "", limit: int = 1024,
        prefix: str = "",
    ) -> Iterator[Entry]:
        """Yields up to `limit` LIVE entries: expired ones are reaped
        and replaced by refetching past them, so a page of expired
        names can never mask live entries behind it."""
        directory = normalize_path(directory)
        yielded = 0
        cursor = start_from
        while yielded < limit:
            batch = list(self.store.list(directory, cursor, limit, prefix))
            if not batch:
                return
            for e in batch:
                if self._is_expired(e):
                    self.delete_entry(e.full_path)
                    continue
                yield self._hl_overlay(e)
                yielded += 1
                if yielded >= limit:
                    return
            if len(batch) < limit:
                return  # store exhausted
            cursor = batch[-1].name

    def delete_entry(
        self, full_path: str, recursive: bool = False, gc_chunks: bool = True
    ) -> None:
        # the whole find→delete→release sequence runs under the
        # (reentrant) mutate lock: two racing deletes of one hardlinked
        # name must not double-decrement the shared counter
        with self._mutate_lock:
            directory, name = split_path(full_path)
            entry = self._try_find(directory, name)
            if entry is None:
                return
            if entry.is_directory:
                children = list(self.store.list(entry.full_path, limit=2))
                if children and not recursive:
                    raise FilerError(f"{full_path} not empty")
                # the listing is read whole before the first delete: a
                # SQL store's open cursor would hold a read snapshot that
                # another connection's commit makes stale, and the next
                # delete would fail at once ("database is locked")
                for child in list(self.store.list(
                    entry.full_path, limit=1_000_000
                )):
                    self.delete_entry(
                        child.full_path, recursive=True, gc_chunks=gc_chunks
                    )
                self.store.delete_folder_children(entry.full_path)
            self.store.delete(directory, name)
            self._entry_cache_drop(directory, name)
            if gc_chunks:
                self._release_entry_chunks(entry)
        self._notify(directory, entry, None, delete_chunks=gc_chunks)

    def _release_entry_chunks(self, entry: Entry) -> None:
        """GC an entry's chunks — unless other hardlink names still
        reference them (reference filer_hardlink.go: counter in KV,
        data reclaimed only with the last name). The counter is
        maintained even for chunk-less (inlined/remote) entries so hl:
        rows never leak."""
        if entry.hard_link_id:
            key = b"hl:" + entry.hard_link_id
            with self._mutate_lock:
                n = int(self.store.kv_get(key) or b"1") - 1
                if n > 0:
                    self.store.kv_put(key, str(n).encode())
                    return
                self.store.kv_delete(key)
                # last name gone: the SHARED record is authoritative
                # for which chunks the inode holds (a write through a
                # sibling may have replaced this entry's snapshot)
                entry = self._hl_overlay(entry)
                self.store.kv_delete(b"hlmeta:" + entry.hard_link_id)
        if entry.chunks:
            self.gc_chunks(entry.chunks)

    def hard_link(self, src_path: str, dst_path: str) -> Entry:
        """Create another name for src's content (filer_hardlink.go).
        Both names share one chunk list; deleting either decrements the
        shared KV counter and the chunks outlive all but the last."""
        src_dir, src_name = split_path(src_path)
        dst_dir, dst_name = split_path(dst_path)
        notify: list = []
        with self._mutate_lock:
            src = self.store.find(src_dir, src_name)
            if src.is_directory:
                raise FilerError("cannot hardlink a directory")
            if self._try_find(dst_dir, dst_name) is not None:
                raise FilerError(f"{dst_path} exists")
            # anything that can fail happens BEFORE the counter bump —
            # a bumped counter with no inserted name would leak the
            # chunks forever
            self._ensure_parents(dst_dir)
            if not src.hard_link_id:
                old_src = Entry(
                    directory=src.directory,
                    name=src.name,
                    chunks=list(src.chunks),
                    content=src.content,
                )
                old_src.attr.CopyFrom(src.attr)
                old_src.extended = dict(src.extended)
                src.hard_link_id = os.urandom(16)
                src.hard_link_counter = 1
                self.store.kv_put(b"hl:" + src.hard_link_id, b"1")
                ts_src = self._stamp(src)
                self.store.update(src)
                self._hl_publish(src)  # the shared inode record
                # src just BECAME hardlinked: its cached (cacheable,
                # pre-link) entry is now stale and must not be served
                self._entry_cache_drop(src_dir, src_name)
                # peers must learn src's hardlink marker or their
                # delete path would GC the shared chunks
                notify.append((src_dir, old_src, src, ts_src))
            key = b"hl:" + src.hard_link_id
            n = int(self.store.kv_get(key) or b"1") + 1
            self.store.kv_put(key, str(n).encode())
            dst = Entry(
                directory=dst_dir,
                name=dst_name,
                chunks=list(src.chunks),
                content=src.content,
                hard_link_id=src.hard_link_id,
                hard_link_counter=n,
            )
            dst.attr.CopyFrom(src.attr)
            # extended attrs travel with the link: remote-mount markers
            # (sw-remote) and user xattrs must survive, or the new name
            # reads as empty ("sw-mts" is re-stamped below)
            dst.extended = dict(src.extended)
            ts_dst = self._stamp(dst)
            try:
                self.store.insert(dst)
            except BaseException:
                self.store.kv_put(key, str(n - 1).encode())
                raise
            self._entry_cache_drop(dst_dir, dst_name)
            notify.append((dst_dir, None, dst, ts_dst))
        for d, old, new, ts in notify:
            self._notify(d, old, new, ts_ns=ts)
        return dst

    def rename(self, old_path: str, new_path: str) -> None:
        """2-phase move (reference filer_rename.go): insert at the new
        location, then remove the old key. Chunks move by reference.
        An existing destination file is overwritten (chunks GC'd); a
        destination directory is never clobbered."""
        if normalize_path(old_path) == normalize_path(new_path):
            # inserting-then-deleting the same key would destroy the entry
            raise FilerError(f"rename source and destination are the same: {old_path}")
        old_dir, old_name = split_path(old_path)
        entry = self.store.find(old_dir, old_name)
        dest = self._try_find(*split_path(new_path))
        if dest is not None:
            if dest.is_directory:
                raise FilerError(f"{new_path} exists and is a directory")
            if entry.is_directory:
                raise FilerError(f"cannot rename directory over file {new_path}")
            self._release_entry_chunks(dest)
        if entry.is_directory:
            # move the whole subtree
            for child in list(self.store.list(entry.full_path, limit=1_000_000)):
                self.rename(
                    child.full_path, f"{normalize_path(new_path)}/{child.name}"
                )
        new_dir, new_name = split_path(new_path)
        self._ensure_parents(new_dir)
        moved = Entry(
            directory=new_dir,
            name=new_name,
            is_directory=entry.is_directory,
            chunks=entry.chunks,
            content=entry.content,
            hard_link_id=entry.hard_link_id,
            hard_link_counter=entry.hard_link_counter,
        )
        moved.attr.CopyFrom(entry.attr)
        moved.extended = entry.extended
        # two distinct timestamps: a subscriber resuming between the
        # delete and the create (strict > watermark) must not lose the
        # create half of the rename
        ts_del = self._next_ts()
        ts_cre = self._stamp(moved)
        self.store.insert(moved)
        self.store.delete(old_dir, old_name)
        self._entry_cache_drop(old_dir, old_name)
        self._entry_cache_drop(new_dir, new_name)
        self._notify(old_dir, entry, None, ts_ns=ts_del)
        self._notify(new_dir, None, moved, ts_ns=ts_cre)

    # ----------------------------------------------------------- multi-filer

    def apply_remote_event(self, ev: fpb.FullEventNotification) -> bool:
        """Apply a peer filer's metadata event to the local store
        (MetaAggregator entry point; reference meta_aggregator.go).

        Last-writer-wins: an event older than the local entry's
        nanosecond meta timestamp is dropped, so two filers replaying
        each other's logs converge on the newest write. Chunk GC is the
        originating filer's job — a remote delete never touches blobs.
        Returns True if the event mutated the local store."""
        directory = ev.directory
        new_p, old_p = ev.event.new_entry, ev.event.old_entry
        has_new, has_old = bool(new_p.name), bool(old_p.name)
        if has_new:
            self._ensure_parents(directory)
        with self._mutate_lock:
            if has_new:
                entry = Entry.from_proto(directory, new_p)
                local = self._try_find(directory, entry.name)
                if local is not None and self.meta_ts(local) >= ev.ts_ns:
                    return False
                if local is not None and local.is_directory != entry.is_directory:
                    return False  # type conflict: keep local
                self.store.insert(entry)
                if entry.hard_link_id:
                    # replicated hardlink writes must refresh the local
                    # shared-inode record too, or the overlay would keep
                    # serving this peer's stale content over the newer
                    # replicated chunks
                    self._hl_publish(entry)
                self._entry_cache_drop(directory, entry.name)
                applied_old, applied_new = local, entry
            elif has_old:
                local = self._try_find(directory, old_p.name)
                if local is None or self.meta_ts(local) > ev.ts_ns:
                    return False
                if local.is_directory:
                    # remote recursive deletes arrive child-first; an
                    # already-emptied dir deletes cleanly, a non-empty
                    # one means local writes raced — keep it
                    if list(self.store.list(local.full_path, limit=1)):
                        return False
                self.store.delete(directory, old_p.name)
                self._entry_cache_drop(directory, old_p.name)
                applied_old, applied_new = local, None
            else:
                return False
        # re-log with a LOCAL timestamp: the meta log must stay
        # monotonic (watermark resume + sealed-segment naming depend on
        # it); the origin's LWW timestamp still rides the entry's
        # sw-mts extended attr
        self._notify(directory, applied_old, applied_new, remote=True)
        return True

    # -------------------------------------------------------------- content

    def write_file(
        self,
        full_path: str,
        data: bytes,
        mime: str = "",
        mode: int = 0o644,
        collection: str | None = None,
        inline: bool = True,
        extended: dict | None = None,
        ttl_sec: int = 0,
    ) -> Entry:
        """inline=False forces chunked storage even for tiny payloads —
        chunk-splicing consumers (S3 multipart parts) require chunks."""
        """Slice into chunk_size pieces, assign+upload each, create the
        entry (reference uploadRequestToChunks)."""
        full_path = normalize_path(full_path)
        # fs.configure path rules fill in what the caller left default
        rule = self.path_conf(full_path)
        if rule:
            if collection is None and rule.get("collection"):
                collection = rule["collection"]
            if not ttl_sec and rule.get("ttl_sec"):
                ttl_sec = int(rule["ttl_sec"])
        replication = (
            rule.get("replication") or self.replication
            if rule
            else self.replication
        )
        old = self._try_find(*split_path(full_path))
        if old is not None and old.is_directory:
            # fail BEFORE uploading chunks that create_entry would orphan
            raise FilerError(f"{full_path}: type conflict with existing entry")
        if old is not None and old.hard_link_id:
            # resolve the SHARED record now (pre-republish): those are
            # the chunks this overwrite supersedes, not the per-name
            # snapshot (which may be stale after a sibling's write)
            self._hl_overlay(old)
        if inline and len(data) <= INLINE_LIMIT:
            entry = new_entry(full_path, mode=mode, mime=mime)
            entry.attr.ttl_sec = ttl_sec
            if extended:
                entry.extended.update(extended)
            entry.content = data
            entry.attr.file_size = len(data)
            entry.attr.md5 = hashlib.md5(data).digest()
            self.create_entry(entry)
            self._gc_overwritten(old)
            return entry
        chunks = []
        ts = time.time_ns()
        for off in range(0, len(data), self.chunk_size) or [0]:
            piece = data[off : off + self.chunk_size]
            if not piece and off > 0:
                break
            fid = self.ops.upload(
                piece,
                name=full_path.rsplit("/", 1)[-1],
                collection=self.collection if collection is None else collection,
                replication=replication,
            )
            chunks.append(
                fpb.FileChunk(
                    fid=fid,
                    offset=off,
                    size=len(piece),
                    modified_ts_ns=ts,
                    etag=hashlib.md5(piece).hexdigest(),
                )
            )
        entry = new_entry(full_path, mode=mode, mime=mime)
        entry.attr.ttl_sec = ttl_sec
        if extended:
            entry.extended.update(extended)
        entry.chunks = chunks
        entry.attr.file_size = len(data)
        entry.attr.md5 = hashlib.md5(data).digest()
        try:
            self.create_entry(entry)
        except BaseException:
            # a losing race still must not leak the uploaded chunks
            self.gc_chunks(chunks)
            raise
        self._gc_overwritten(old)
        return entry

    def read_file(
        self, full_path: str, offset: int = 0, size: int = -1
    ) -> bytes:
        entry = self.find_entry(full_path)
        return self.read_entry(entry, offset, size)

    def read_entry(self, entry: Entry, offset: int = 0, size: int = -1) -> bytes:
        # Flight-recorder child span for the filer data-plane layer:
        # inside an S3/filer HTTP root span this is where lookup-vs-
        # chunk-fetch time splits; the chunk fetches propagate the trace
        # over HTTP to the volume servers (TracingSession).
        sp = trace.start(
            "filer.read", name=entry.full_path,
            offset=offset, size=size,
        )
        if sp is not None:
            # the filer data-plane layer is its own logical server even
            # when embedded (S3/WebDAV gateways construct a Filer
            # in-process): label it so a trace shows the layer hop
            sp.server = "filer"
        try:
            with trace.activate(sp):
                return self._read_entry_traced(entry, offset, size, sp)
        finally:
            trace.finish(sp)

    def _read_entry_traced(
        self, entry: Entry, offset: int, size: int, sp
    ) -> bytes:
        if entry.is_directory:
            raise FilerError(f"{entry.full_path} is a directory")
        if entry.content:
            end = len(entry.content) if size < 0 else offset + size
            return entry.content[offset:end]
        if not entry.chunks and "sw-remote" in entry.extended:
            # lazy remote mount: stream through from the cloud object
            # (reference read_remote.go); `remote.cache` pins it local
            from ..remote.mount import read_remote

            return read_remote(self, entry, offset=offset, size=size)
        file_size = entry.file_size
        if size < 0:
            size = max(file_size - offset, 0)
        size = min(size, max(file_size - offset, 0))
        if size == 0:
            return b""
        chunks = entry.chunks
        from .manifest import has_manifests, resolve_manifests

        if has_manifests(chunks):
            chunks = resolve_manifests(self._read_chunk_cached, chunks)
        buf = bytearray(size)
        for view in read_chunk_views(chunks, offset, size):
            chunk_data, src = self.chunk_cache.get_or_load(
                view.fid,
                lambda fid=view.fid: self._fetch_chunk_traced(fid, sp),
                # admit only modest chunks: one large streaming read
                # must not flush the whole hot set out of the LRU
                admit=lambda d: len(d) <= self.chunk_cache.capacity // 8,
            )
            if src != "load" and sp is not None:
                sp.event(
                    "chunk_cache_hit" if src == "hit"
                    else "chunk_singleflight_wait",
                    fid=view.fid,
                )
            piece = chunk_data[view.offset_in_chunk : view.offset_in_chunk + view.size]
            lo = view.logical_offset - offset
            buf[lo : lo + len(piece)] = piece
        return bytes(buf)

    def _fetch_chunk_traced(self, fid: str, sp) -> bytes:
        with trace.stage(sp, "chunk.fetch"):
            return self.ops.read(fid)

    def _read_chunk_cached(self, fid: str) -> bytes:
        data, _src = self.chunk_cache.get_or_load(
            fid,
            lambda: self._fetch_chunk_traced(fid, trace.current()),
            admit=lambda d: len(d) <= self.chunk_cache.capacity // 8,
        )
        return data

    def resolve_chunks(self, entry: Entry):
        """Entry's chunk list with manifest chunks expanded (callers
        that stream views themselves: mount, webdav)."""
        from .manifest import has_manifests, resolve_manifests

        if has_manifests(entry.chunks):
            return resolve_manifests(self._read_chunk_cached, entry.chunks)
        return entry.chunks

    # ------------------------------------------------------------------ gc

    def gc_chunks(self, chunks) -> None:
        """Enqueue chunk fids for async deletion on the volume servers.
        Manifest chunks expand to their referenced chunks plus the
        manifest blob itself."""
        from .manifest import gc_expand, has_manifests

        if has_manifests(chunks):
            chunks = gc_expand(self.ops.read, chunks)
        for c in chunks:
            self.chunk_cache.drop(c.fid)  # dead bytes must not pin the LRU
            self._gc_queue.put((c.fid, 0))

    _GC_MAX_ATTEMPTS = 5

    def _gc_loop(self) -> None:
        while not self._gc_stop.is_set():
            try:
                fid, attempts = self._gc_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                self.ops.delete(fid)
            except Exception:
                # transient outage must not leak blobs: requeue with
                # backoff (reference filer_deletion.go retries)
                if attempts + 1 < self._GC_MAX_ATTEMPTS:
                    t = threading.Timer(
                        2.0 * (attempts + 1),
                        self._gc_queue.put,
                        args=((fid, attempts + 1),),
                    )
                    t.daemon = True
                    t.start()

    def flush_gc(self, timeout: float = 10.0) -> None:
        deadline = time.time() + timeout
        while not self._gc_queue.empty() and time.time() < deadline:
            time.sleep(0.05)

    def close(self) -> None:
        self._gc_stop.set()
        self._gc_thread.join(timeout=2)
        self.ops.close()
        self.store.close()
