"""gRPC filer metadata service + streaming metadata subscription.

Port of seaweedfs_tpu/filer/grpc_service.py: every RPC of the JAX
service, answering as it does. RunLifecycle applies the S3 lifecycle
rules with the port's scanner (s3/lifecycle.py). DistributedLock
goes to the lock ring (filer/lock_ring.py) the filer server sets on the
service; without one it answers "lock ring not configured", as the JAX
service does.

Reference: weed/pb/filer.proto service SeaweedFiler (Lookup/List/
Create/Update/Delete/AtomicRename, SubscribeMetadata at
weed/server/filer_grpc_server_sub_meta.go). The mount layer, peer
filers (MetaAggregator) and filer.sync all ride this surface; the HTTP
file API stays the byte data plane.
"""

from __future__ import annotations

import grpc

from ..pb import filer_pb2 as fpb
from .entry import Entry, normalize_path
from .filer import Filer, FilerError
from .filer_store import NotFound
from .notification import json_to_event


class FilerGrpcService:
    """Servicer for rpc.FILER_SERVICE (hand-rolled table wiring)."""

    def __init__(self, filer: Filer, meta_log=None, lock_ring=None):
        self.filer = filer
        self.meta_log = meta_log
        # distributed lock ring (filer/lock_ring.py); a ring with no
        # peers serves single-filer deployments locally
        self.lock_ring = lock_ring

    def DistributedLock(self, request, context):
        if self.lock_ring is None:
            return fpb.DlmResponse(error="lock ring not configured")
        return self.lock_ring.handle(request)

    # ------------------------------------------------------------ metadata

    def LookupDirectoryEntry(self, request, context):
        try:
            e = self.filer.store.find(
                normalize_path(request.directory), request.name
            )
        except NotFound:
            return fpb.LookupEntryResponse(error="not found")
        e = self.filer._hl_overlay(e)  # shared-inode content/attrs
        proto = e.to_proto()
        if e.hard_link_id:
            # the per-entry counter is a snapshot from link time; the
            # LIVE name count lives in the shared hl: KV row (mounts
            # report it as st_nlink)
            n = self.filer.store.kv_get(b"hl:" + e.hard_link_id)
            if n is not None:
                proto.hard_link_counter = int(n)
        return fpb.LookupEntryResponse(entry=proto)

    def ListEntries(self, request, context):
        limit = request.limit or 1024
        for e in self.filer.list_entries(
            request.directory,
            start_from=request.start_from,
            limit=limit,
            prefix=request.prefix,
        ):
            yield fpb.ListEntriesResponse(entry=e.to_proto())

    def CreateEntry(self, request, context):
        try:
            entry = Entry.from_proto(
                normalize_path(request.directory), request.entry
            )
            self.filer.create_entry(entry)
        except FilerError as e:
            return fpb.FilerOpResponse(error=str(e))
        return fpb.FilerOpResponse()

    def UpdateEntry(self, request, context):
        directory = normalize_path(request.directory)
        try:
            self.filer.store.find(directory, request.entry.name)
        except NotFound:
            return fpb.FilerOpResponse(error="not found")
        try:
            entry = Entry.from_proto(directory, request.entry)
            self.filer.create_entry(entry, ensure_parents=False)
        except FilerError as e:
            return fpb.FilerOpResponse(error=str(e))
        return fpb.FilerOpResponse()

    def DeleteEntry(self, request, context):
        path = f"{normalize_path(request.directory)}/{request.name}"
        try:
            self.filer.delete_entry(
                path,
                recursive=request.is_recursive,
                gc_chunks=request.is_delete_data,
            )
        except FilerError as e:
            return fpb.FilerOpResponse(error=str(e))
        return fpb.FilerOpResponse()

    def AtomicRenameEntry(self, request, context):
        try:
            self.filer.rename(
                f"{normalize_path(request.old_directory)}/{request.old_name}",
                f"{normalize_path(request.new_directory)}/{request.new_name}",
            )
        except (FilerError, NotFound) as e:
            return fpb.FilerOpResponse(error=str(e))
        return fpb.FilerOpResponse()

    def AssignVolume(self, request, context):
        """Proxy an assign to the filer's master so mounts can place
        chunks without a master address (reference filer_pb
        AssignVolume; used by the mount page writer)."""
        try:
            a = self.filer.ops.master.assign(
                count=request.count or 1,
                collection=request.collection or self.filer.collection,
                replication=self.filer.replication,
                ttl=request.ttl,
            )
        except Exception as e:  # noqa: BLE001 — surfaced to the client
            return fpb.AssignVolumeResponse(error=str(e))
        return fpb.AssignVolumeResponse(fid=a.fid, url=a.url, jwt=a.jwt)

    def KvGet(self, request, context):
        v = self.filer.store.kv_get(bytes(request.key))
        if v is None:
            return fpb.FilerKvGetResponse(found=False)
        return fpb.FilerKvGetResponse(value=v, found=True)

    def KvPut(self, request, context):
        if request.value:
            self.filer.store.kv_put(bytes(request.key), bytes(request.value))
        else:
            self.filer.store.kv_delete(bytes(request.key))
        return fpb.FilerOpResponse()

    def LookupVolume(self, request, context):
        """Volume-location passthrough (reference filer_grpc_server.go
        LookupVolume): mounts resolve fids to volume-server URLs here
        so chunk reads can go DIRECT (and peer-to-peer) instead of
        proxying every byte through the filer."""
        from ..pb import cluster_pb2 as cpb

        resp = cpb.LookupVolumeResponse()
        for vid in request.volume_ids:
            vl = resp.volume_locations.add()
            vl.volume_id = vid
            try:
                for loc in self.filer.ops.master.lookup(vid):
                    vl.locations.add().CopyFrom(loc)
            except Exception as e:  # noqa: BLE001 — per-vid error
                vl.error = str(e)
        return resp

    def RunLifecycle(self, request, context):
        """Apply stored S3 lifecycle rules here, where the metadata
        lives — the execution half of the worker fleet's s3_lifecycle
        task kind (reference weed/worker/tasks registry)."""
        from ..s3.lifecycle import LifecycleScanner

        try:
            stats = LifecycleScanner(self.filer).run_once(
                bucket=request.bucket
            )
        except Exception as e:  # noqa: BLE001 — surfaced to the worker
            return fpb.LifecycleRunResponse(error=str(e))
        return fpb.LifecycleRunResponse(
            expired=stats.get("expired", 0),
            noncurrent_expired=stats.get("noncurrent_expired", 0),
            aborted_uploads=stats.get("aborted_uploads", 0),
        )

    def HardLink(self, request, context):
        """Create another name for src's content (reference
        filer_hardlink.go); FUSE link() rides this. Error strings are
        prefixed so clients can map them to errno."""
        try:
            self.filer.hard_link(
                normalize_path(request.src_path),
                normalize_path(request.dst_path),
            )
        except NotFound as e:
            return fpb.FilerOpResponse(error=f"not found: {e}")
        except FilerError as e:
            return fpb.FilerOpResponse(error=str(e))
        return fpb.FilerOpResponse()

    def LockRange(self, request, context):
        """POSIX advisory locks (filer_grpc_server_posix_lock.go):
        op 0 = lock, 1 = unlock, 2 = test, 3 = renew lease."""
        lm = self.filer.lock_manager
        lease = float(request.lease_seconds or 0)
        if request.op == 0:
            granted, who = lm.lock(
                request.path,
                request.owner,
                request.start,
                request.end,
                exclusive=request.exclusive,
                lease=lease,
            )
            return fpb.LockRangeResponse(granted=granted, conflict_owner=who)
        if request.op == 1:
            n = lm.unlock(
                request.path, request.owner, request.start, request.end
            )
            return fpb.LockRangeResponse(granted=True, count=n)
        if request.op == 2:
            who = lm.test(
                request.path,
                request.start,
                request.end,
                exclusive=request.exclusive,
                owner=request.owner,
            )
            return fpb.LockRangeResponse(granted=not who, conflict_owner=who)
        if request.op == 3:
            n = lm.renew(request.path, request.owner, lease=lease)
            return fpb.LockRangeResponse(granted=n > 0, count=n)
        return fpb.LockRangeResponse(error=f"bad op {request.op}")

    # --------------------------------------------------------- subscription

    def SubscribeMetadata(self, request, context):
        """Long-lived event stream from the persisted meta log
        (reference filer_grpc_server_sub_meta.go). Replays history from
        since_ns, then follows live appends."""
        if self.meta_log is None:
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED, "filer runs without a meta log"
            )
        watermark = request.since_ns
        if 0 < watermark < self.meta_log.dropped_before_ts:
            # events in (since_ns, dropped_before_ts] were rotated away:
            # continuing silently would present a complete-looking but
            # gapped stream (HTTP tail exposes droppedBeforeTsNs for the
            # same reason)
            context.abort(
                grpc.StatusCode.OUT_OF_RANGE,
                f"resync required: events before "
                f"{self.meta_log.dropped_before_ts} were rotated away",
            )
        prefix = request.path_prefix
        while context.is_active():
            records = self.meta_log.read_since(watermark, limit=1000)
            for rec in records:
                watermark = max(watermark, rec.get("tsNs", 0))
                if request.local_only and rec.get("remote"):
                    continue
                if prefix and not (
                    rec.get("directory", "").startswith(prefix.rstrip("/"))
                    or prefix.rstrip("/").startswith(rec.get("directory", ""))
                ):
                    continue
                ev = json_to_event(rec)
                if ev is None:
                    continue  # legacy record without full payload
                yield ev
            if not records:
                self.meta_log.wait_for_events(watermark, timeout=1.0)
