"""Volume server: the gRPC service with its EC RPCs, and the cluster half.

Port of seaweedfs_tpu/server/volume_server.py, the parts the data plane
(server/volume_server.py) left out, trimmed to what the EC paths need
(reference volume_grpc_erasure_coding.go, store_replicate.go:32,
volume_grpc_client_to_master.go):

- `VolumeService`, the `sw.VolumeServer` servicer over one Store, with
  every RPC of the JAX servicer: AllocateVolume, VolumeMount,
  VolumeUnmount, VolumeDelete; the admin RPCs of plain volumes
  (VolumeCopy, VolumeConfigure, VolumeMarkReadonly, VolumeMarkWritable,
  VacuumVolume, ScrubVolume, VolumeTierUpload, VolumeTierDownload,
  VolumeTailSender, VolumeTailReceiver, VolumeIncrementalCopy,
  ReadVolumeFileStatus; reference volume_grpc_admin.go, _copy.go,
  _vacuum.go, _scrub.go, _tier_*.go, _tail.go); WriteNeedle, ReadNeedle
  and DeleteNeedle as adapters over the server's plain `write_needle` and
  `delete_needle` and the Store's read; the EC RPCs
  VolumeEcShardsGenerate, VolumeEcShardsRebuild (with `from_peers`),
  VolumeEcShardsCopy (the shard net plane first, `CopyFile` second, each
  landed shard checked against the `.ecsum`), VolumeEcShardsDelete,
  VolumeEcShardsMount, VolumeEcShardsUnmount, VolumeEcShardRead,
  VolumeEcBlobDelete, VolumeEcShardsToVolume, ScrubEcVolume; CopyFile and
  VolumeServerStatus.
- `ClusterHalf`: the master client and its lookups, the heartbeat
  stream, the replica fan-out, the remote shard reader of the Store's EC
  volumes, peer-fetch rebuild and the hand-off of regenerated shards that
  the cluster lost. `VolumeServer` builds it and reaches it under the
  JAX server's names (`peer_fetch_rebuild`, `replicate_write`,
  `notify_new_ec_shards`, ...).

Where the port and the JAX server differ, on purpose:

- The fan-out goes to the holders the master names, the plane leg first
  and the gRPC leg second, with the same error summary; failed replica
  deletes are ignored, as there. So where the master answers but names
  fewer holders than the placement asks for (a replica that has not
  heartbeated yet, or that the master dropped), both packages acknowledge
  a write with the copies they reached. Where the master lookup itself
  fails, the JAX `_replica_locations` answers no holder, and a replicated
  write or delete is acknowledged with one copy. The port refuses it then
  (`FAN_OUT_REFUSED`), unless the volume's placement asks for one copy.
- A server built without a master (`master=""`, the port's default)
  sends no heartbeat, and every lookup fails at once.
- RPCs with an empty `backend` field, and VolumeEcShardsToVolume, run on
  the server's `ec_backend` (default `cuda`, which raises without a
  card), where the JAX decode takes `auto`.
- `_cluster_ec_telemetry` reads the master's /cluster/status over
  `urllib`; the JAX server uses `requests`, and without it (as on the
  card's host) it would return {}.
- ScrubVolume scans the .dat with the host library's `scan_dat` only.
  Where the library does not build or load, the RPC fails; the JAX
  server falls back to the Python walk on any error of the native scan.
- A stopped server ends its open VolumeTailSender streams at their next
  poll, where the JAX server's follow loop runs on until its idle
  timeout (forever at 0).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from concurrent import futures

import grpc

from .. import faults
from ..client.master_client import MasterClient
from ..client.master_client import grpc_addr as master_grpc_addr
from ..client.volume_sync import tail_volume
from ..ec import context as ec_context
from ..ec import fleet, native_io
from ..ec import net_plane as _netp
from ..ec.backend import get_backend
from ..ec.bitrot import BitrotError, BitrotProtection
from ..ec.chip_pool import chip_load_hint
from ..ec.context import ECError
from ..ec.decoder import ec_decode_volume
from ..ec.device_queue import residency_snapshot
from ..ec.encoder import DEFAULT_BATCH, ec_encode_volume
from ..ec.peer_rebuild import PeerFetchTransient, rebuild_from_peers
from ..ec.placement import node_view_for, plan_shard_placement
from ..ec.rebuild import rebuild_ec_files
from ..ec.repair_journal import patched_byte_ranges, recover_volume_journals
from ..ec.volume_info import VolumeInfo
from ..pb import cluster_pb2 as pb
from ..pb import rpc
from ..storage.needle import CrcError
from ..storage.store import EC_BACKENDS
from ..storage.volume import CookieMismatch, NotFoundError, Volume, VolumeError
from ..utils import metrics as M
from ..utils import native
from ..utils import request_id as _rid
from ..utils import trace, urls
from ..utils.glog import logger
from ..utils.security import JwtError, sign_jwt, verify_jwt
from ..utils.urls import service_url
from .volume_server import FAN_OUT_REFUSED

log = logger("volume")

_EC_STREAM_CHUNK = 256 * 1024


def _shard_bits(ids) -> int:
    bits = 0
    for i in ids:
        bits |= 1 << i
    return bits


def _volume_msgs(st: dict) -> list:
    return [
        pb.VolumeInfoMsg(
            id=v["id"], collection=v["collection"], size=v["size"],
            file_count=v["file_count"], deleted_count=v["deleted_count"],
            deleted_bytes=v["deleted_bytes"], read_only=v["read_only"],
            replica_placement=v["replica_placement"], version=v["version"],
            ttl=v.get("ttl", ""), disk_type=v.get("disk_type", "hdd"),
        )
        for v in st["volumes"]
    ]


def _ec_shard_msgs(st: dict) -> list:
    return [
        pb.EcShardInfoMsg(
            id=e["id"], collection=e["collection"], shard_bits=_shard_bits(e["shards"]),
            shard_size=e["shard_size"], data_shards=e["data_shards"],
            parity_shards=e["parity_shards"], generation=e["generation"],
        )
        for e in st["ec_volumes"]
    ]


class VolumeService:
    """gRPC servicer over one Store."""

    _TAIL_POLL_S = 0.25  # VolumeTailSender's follow-loop poll (the reference polls every 2 s)

    def __init__(self, server):
        self.server = server
        # set by ClusterHalf.stop(): open VolumeTailSender streams end at
        # their next poll
        self.stopping = threading.Event()

    @property
    def store(self):
        return self.server.store

    def _rpc_span(self, op: str, request, context, **attrs):
        """Server-side end of cross-RPC tracing: adopt the caller's
        X-Request-ID (minting one at chain start) and, when the flight
        recorder is armed, continue the caller's trace as a local root, so
        a peer-fetch rebuild and every peer shard read it triggers share
        one trace id. None when the tracer is disarmed."""
        md = trace.metadata_dict(context)
        _rid.ensure(md.get(trace.REQUEST_ID_KEY))
        return trace.start_from_metadata(
            op, md, server=f"{self.server.ip}:{self.server.port}", volume=request.volume_id,
            **attrs,
        )

    # ------------------------------------------------------------ admin

    def AllocateVolume(self, request, context):
        self.store.allocate_volume(
            request.volume_id, collection=request.collection,
            replica_placement=request.replication or "000", ttl=request.ttl,
            disk_type=request.disk_type,
        )
        self.server.notify_new_volume(request.volume_id)
        return pb.AllocateVolumeResponse()

    def VolumeDelete(self, request, context):
        try:
            self.store.delete_volume(request.volume_id)
            self.server.notify_deleted_volume(request.volume_id)
            return pb.VolumeCommandResponse()
        except NotFoundError as e:
            return pb.VolumeCommandResponse(error=str(e))

    def VolumeMount(self, request, context):
        """Load an existing .dat/.idx pair from disk into the store."""
        try:
            self.store.mount_volume(request.volume_id, request.collection)
        except NotFoundError as e:
            return pb.VolumeCommandResponse(error=str(e))
        self.server.notify_new_volume(request.volume_id)
        return pb.VolumeCommandResponse()

    def VolumeUnmount(self, request, context):
        """Release the volume, keep its files (reference
        volume_grpc_admin.go VolumeUnmount)."""
        try:
            self.store.unmount_volume(request.volume_id)
        except NotFoundError as e:
            return pb.VolumeCommandResponse(error=str(e))
        self.server.notify_deleted_volume(request.volume_id)
        return pb.VolumeCommandResponse()

    def VolumeCopy(self, request, context):
        """Pull a whole volume (.dat, .idx and the optional .vif) from a
        peer of either package over its CopyFile, then mount it (reference
        volume_grpc_copy.go). Every file lands as a fsynced temp and they
        are published together, so a half-copied volume never mounts."""
        if self.store.find_volume(request.volume_id) is not None:
            return pb.VolumeCommandResponse(error="volume already here")
        loc = self.store._pick_location()
        base = Volume.base_file_name(loc.directory, request.collection, request.volume_id)
        tmps: dict[str, str] = {}
        try:
            with grpc.insecure_channel(request.source_url) as ch:
                stub = rpc.volume_stub(ch)
                for ext in (".dat", ".idx", ".vif"):
                    tmp = base + ext + ".copying"
                    try:
                        with open(tmp, "wb") as f:
                            for chunk in stub.CopyFile(pb.CopyFileRequest(
                                    volume_id=request.volume_id, collection=request.collection,
                                    ext=ext)):
                                f.write(chunk.data)
                            f.flush()
                            os.fsync(f.fileno())
                        tmps[ext] = tmp
                    except grpc.RpcError as e:
                        if os.path.exists(tmp):
                            os.unlink(tmp)
                        if ext == ".vif":  # an optional sidecar
                            continue
                        raise RuntimeError(f"copy {ext}: {e.details()}") from None
            for ext, tmp in tmps.items():
                os.replace(tmp, base + ext)
            tmps.clear()
        except RuntimeError as e:
            return pb.VolumeCommandResponse(error=str(e))
        finally:
            for tmp in tmps.values():
                if os.path.exists(tmp):
                    os.unlink(tmp)
        self.store.mount_volume(request.volume_id, request.collection)
        self.server.notify_new_volume(request.volume_id)
        return pb.VolumeCommandResponse()

    def VolumeConfigure(self, request, context):
        """Rewrite the replica placement in place (reference
        VolumeConfigure); the heartbeat reports the new value."""
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return pb.VolumeCommandResponse(error="volume not found")
        try:
            v.set_replica_placement(request.replication)
        except (ValueError, VolumeError) as e:
            return pb.VolumeCommandResponse(error=str(e))
        self.server.notify_new_volume(request.volume_id)
        return pb.VolumeCommandResponse()

    def VolumeMarkReadonly(self, request, context):
        # no heartbeat here: the next periodic one reports the flag
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return pb.VolumeCommandResponse(error="not found")
        v.set_read_only(True)
        return pb.VolumeCommandResponse()

    def VolumeMarkWritable(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return pb.VolumeCommandResponse(error="not found")
        v.set_read_only(False)
        return pb.VolumeCommandResponse()

    def VacuumVolume(self, request, context):
        """Compact the volume when its garbage ratio reaches the
        threshold (reference volume_grpc_vacuum.go)."""
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        ratio = v.garbage_ratio()
        if request.garbage_threshold and ratio < request.garbage_threshold:
            return pb.VacuumResponse(reclaimed_bytes=0, garbage_ratio=ratio)
        reclaimed = v.vacuum()
        return pb.VacuumResponse(reclaimed_bytes=reclaimed, garbage_ratio=ratio)

    # --------------------------------------------------------------- io

    def _grpc_jwt_ok(self, context, vid: int, needle_id: int) -> bool:
        """gRPC writes do not bypass the HTTP JWT gate: on a keyed cluster
        peers attach a volume-scoped token in the metadata. `context`
        None is an in-process call."""
        if not self.server.jwt_key or context is None:
            return True
        token = ""
        for k, v in context.invocation_metadata():
            if k == "authorization":
                token = v[7:] if v.startswith("Bearer ") else v
        try:
            verify_jwt(self.server.jwt_key, token, str(vid))
            return True
        except JwtError:
            return False

    def WriteNeedle(self, request, context):
        if not self._grpc_jwt_ok(context, request.volume_id, request.needle_id):
            return pb.WriteNeedleResponse(error="unauthorized")
        size, err = self.server.write_needle(
            request.volume_id, request.needle_id, request.cookie, request.data,
            name=request.name, mime=request.mime, flags=request.flags,
            is_replicate=request.is_replicate,
        )
        if err:
            return pb.WriteNeedleResponse(error=err)
        return pb.WriteNeedleResponse(size=size)

    def ReadNeedle(self, request, context):
        with M.request_seconds.time(server="volume", op="read"):
            resp = self._read_needle(request)
        M.request_total.inc(server="volume", op="read", code="err" if resp.error else "ok")
        return resp

    def _read_needle(self, request):
        try:
            n = self.store.read_needle(request.volume_id, request.needle_id,
                                       request.cookie or None)
        except (NotFoundError, ECError) as e:
            return pb.ReadNeedleResponse(error=f"not found: {e}")
        except (CookieMismatch, CrcError, VolumeError, ValueError, OSError) as e:
            return pb.ReadNeedleResponse(error=str(e))
        return pb.ReadNeedleResponse(
            data=n.data, name=n.name.decode(errors="replace"),
            mime=n.mime.decode(errors="replace"), last_modified=n.last_modified,
        )

    def DeleteNeedle(self, request, context):
        if not self._grpc_jwt_ok(context, request.volume_id, request.needle_id):
            return pb.DeleteNeedleResponse(error="unauthorized")
        freed, err = self.server.delete_needle(request.volume_id, request.needle_id,
                                               is_replicate=request.is_replicate)
        return pb.DeleteNeedleResponse(freed_bytes=freed, error=err)

    # ---------------------------------------------------------------- ec

    def _backend(self, name: str, ctx, impl: str = "cuda"):
        return get_backend(name or self.store.ec_backend, ctx.data_shards, ctx.parity_shards,
                           impl=impl)

    def VolumeEcShardsGenerate(self, request, context):
        """Reference volume_grpc_erasure_coding.go:45: wipe stale EC
        artifacts, mark the volume readonly, encode (.ecx first), persist
        the sidecars."""
        sp = self._rpc_span("rpc.ec_shards_generate", request, context)
        try:
            with trace.activate(sp):
                return self._ec_shards_generate(request, context)
        finally:
            trace.finish(sp)

    def _ec_shards_generate(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        if request.collection and v.collection != request.collection:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, "collection mismatch")
        base = v.dat_path[:-4]
        for i in range(ec_context.MAX_SHARD_COUNT):
            stale = base + f".ec{i:02d}"
            if os.path.exists(stale):
                os.unlink(stale)
        v.set_read_only(True)
        v.flush()
        ctx = ec_context.ECContext(request.data_shards or ec_context.DATA_SHARDS,
                                   request.parity_shards or ec_context.PARITY_SHARDS)
        backend = self._backend(request.backend, ctx)
        backend_name = request.backend or self.store.ec_backend
        dat_size = os.path.getsize(base + ".dat")
        batch = (request.batch_mb << 20) if request.batch_mb else DEFAULT_BATCH
        with M.request_seconds.time(server="volume", op="ec_encode"):
            vi = ec_encode_volume(base, ctx, backend, batch_size=batch,
                                  scheduler=self.store.ec_scheduler)
        M.ec_ops_total.inc(op="encode", backend=backend_name)
        M.ec_bytes_total.inc(dat_size, op="encode", backend=backend_name)
        return pb.EcShardsGenerateResponse(generation=vi.encode_ts_ns)

    def VolumeEcShardsRebuild(self, request, context):
        sp = self._rpc_span("rpc.ec_shards_rebuild", request, context,
                            from_peers=bool(request.from_peers))
        try:
            with trace.activate(sp):
                return self._ec_shards_rebuild(request, context)
        finally:
            trace.finish(sp)

    def _ec_shards_rebuild(self, request, context):
        loc_base = self._ec_base(request.volume_id, request.collection)
        if loc_base is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "ec volume not found")
        if request.from_peers:
            # a subset holder (< k local shards) fetches siblings from peer
            # holders, rebuilds on its device and hands regenerated shards
            # the cluster lost to their planned holders
            try:
                out = self.server.peer_fetch_rebuild(request.volume_id,
                                                     collection=request.collection,
                                                     backend_name=request.backend)
            except ECError as e:
                context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
            return pb.EcShardsRebuildResponse(
                rebuilt_shard_ids=out["rebuilt"], fetched_shard_ids=out["fetched"],
                distributed_shard_ids=out["distributed"], repaired_shard_ids=out["repaired"],
            )
        vi = VolumeInfo.maybe_load(loc_base + ".vif")
        ctx = (vi.ec_ctx if vi else None) or ec_context.ECContext()
        backend = self._backend(request.backend, ctx)
        # Regenerate absent shards only within this server's legitimate set
        # (mounted + quarantined) plus the shards the master knows no
        # location for: a shard alive on a peer is not minted here, since
        # that would be a duplicate the master never placed. Corrupt
        # present shards are always replaced. An unmounted volume or an
        # unreachable master keeps the unrestricted file-level rebuild.
        ev = self.store.find_ec_volume(request.volume_id)
        only = None
        if ev is not None:
            try:
                located = self.server.cluster._master_client().lookup_ec(request.volume_id,
                                                                          refresh=True)
                lost = {sid for sid in range(ctx.total) if not located.get(sid)}
            except Exception:  # noqa: BLE001 — no topology: the file-level rebuild
                lost = set(range(ctx.total))
            only = sorted(set(ev.legitimate_shards()) | lost)
        try:
            with M.request_seconds.time(server="volume", op="ec_rebuild"):
                rebuilt = rebuild_ec_files(loc_base, backend=backend, only_shards=only,
                                           scheduler=self.store.ec_scheduler)
        except ECError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        M.ec_ops_total.inc(op="rebuild", backend=request.backend or self.store.ec_backend)
        # move a mounted volume's fds onto the regenerated inodes: the old
        # fds still read the old (possibly corrupt) bytes
        if ev is not None and rebuilt:
            ev.reopen_shards(rebuilt)
        return pb.EcShardsRebuildResponse(rebuilt_shard_ids=rebuilt)

    def VolumeEcShardsCopy(self, request, context):
        """Pull shards (and index files) from a peer.

        The metadata files (.ecx/.ecj/.vif/.ecsum) land first over the
        CopyFile stream, so the generation fence and the bitrot sidecar
        are local before any shard byte moves. Shard files then take the
        source's shard net plane (sendfile egress, fenced by the .vif's
        encode_ts_ns) with CopyFile as the bit-identical fallback. Every
        landed shard is checked against the local .ecsum when one covers
        this generation: a mismatch unlinks the file and aborts the copy
        with DATA_LOSS."""
        _rid.ensure(trace.metadata_dict(context).get(trace.REQUEST_ID_KEY))
        loc = self.store._pick_location()
        base = Volume.base_file_name(loc.directory, request.collection, request.volume_id)
        meta_exts = []
        if request.copy_ecx:
            meta_exts.append(".ecx")
        if request.copy_ecj:
            meta_exts.append(".ecj")
        if request.copy_vif:
            meta_exts.append(".vif")
        if request.copy_ecsum:
            meta_exts.append(".ecsum")
        with grpc.insecure_channel(request.source_url) as ch:
            stub = rpc.volume_stub(ch)

            def copy_file(ext: str) -> None:
                tmp = base + ext + ".copying"
                try:
                    with open(tmp, "wb") as f:
                        for chunk in stub.CopyFile(
                            pb.CopyFileRequest(volume_id=request.volume_id,
                                               collection=request.collection, ext=ext),
                            metadata=trace.grpc_metadata(),
                        ):
                            f.write(chunk.data)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, base + ext)
                except grpc.RpcError as e:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    if ext == ".ecj":  # the journal may not exist
                        return
                    context.abort(grpc.StatusCode.UNAVAILABLE, f"copy {ext}: {e.details()}")

            for ext in meta_exts:
                copy_file(ext)
            # the generation fence and the sidecar, from whatever .vif and
            # .ecsum are local now (just copied, or from an earlier shard)
            generation = 0
            vi = VolumeInfo.maybe_load(base + ".vif")
            if vi is not None:
                generation = vi.encode_ts_ns
            prot = None
            try:
                prot = BitrotProtection.load(base + ".ecsum")
                if generation and prot.generation not in (0, generation):
                    prot = None  # a stale sidecar is no ground truth
            except Exception:  # noqa: BLE001 — absent or unreadable: no check
                prot = None
            for sid in request.shard_ids:
                ext = f".ec{sid:02d}"
                if not self._copy_shard_native(request, base, ext, sid, generation):
                    copy_file(ext)
                if prot is not None and 0 <= sid < len(prot.shard_crcs):
                    if prot.verify_shard_file(base + ext, sid, stop_early=True):
                        os.unlink(base + ext)
                        context.abort(
                            grpc.StatusCode.DATA_LOSS,
                            f"shard {sid} from {request.source_url} fails .ecsum "
                            f"verification; copy refused",
                        )
        return pb.EcShardsCopyResponse()

    def _copy_shard_native(self, request, base: str, ext: str, sid: int, generation: int) -> bool:
        """Land one shard file over the source's shard net plane
        (sendfile -> pooled buffer -> local file, atomic replace). False:
        the caller takes CopyFile (plane off, armed faults, a peer without
        the plane, a refusal)."""
        if not native_io.enabled() or faults.active():
            return False
        tmp = base + ext + ".copying"
        try:
            client = self.server.cluster._net_plane_client()
            with open(tmp, "wb") as f:
                n = client.fetch_shard_to_file(_netp.net_addr(request.source_url),
                                               request.volume_id, sid, generation, f)
                f.flush()
                os.fsync(f.fileno())
            if n <= 0:
                os.unlink(tmp)
                return False
            os.replace(tmp, base + ext)
            return True
        except (_netp.NetPlaneError, _netp.NetPlaneUnavailable, OSError):
            try:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            except OSError:
                pass
            return False

    def VolumeEcShardsDelete(self, request, context):
        for loc in self.store.locations:
            base = Volume.base_file_name(loc.directory, request.collection, request.volume_id)
            for sid in request.shard_ids:
                p = base + f".ec{sid:02d}"
                if os.path.exists(p):
                    os.unlink(p)
            # the index files go when no shard is left here
            if not any(os.path.exists(base + f".ec{i:02d}")
                       for i in range(ec_context.MAX_SHARD_COUNT)):
                for ext in (".ecx", ".ecj", ".ecsum", ".heat"):
                    if os.path.exists(base + ext):
                        os.unlink(base + ext)
        self.server.notify_deleted_ec_shards(request.volume_id, request.collection,
                                             list(request.shard_ids))
        return pb.EcShardsDeleteResponse()

    def VolumeEcShardsMount(self, request, context):
        try:
            self.store.mount_ec_volume(request.volume_id, request.collection)
        except NotFoundError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        self.server.notify_new_ec_shards(request.volume_id, request.collection)
        return pb.EcShardsMountResponse()

    def VolumeEcShardsUnmount(self, request, context):
        self.store.unmount_ec_shards(request.volume_id, list(request.shard_ids))
        return pb.EcShardsUnmountResponse()

    def VolumeEcShardRead(self, request, context):
        # The span covers the whole response stream, and because the trace
        # id arrives in the metadata, a peer-fetch rebuild's every shard
        # read lands in the dispatcher's trace.
        sp = self._rpc_span("rpc.ec_shard_read", request, context, shard=request.shard_id,
                            offset=request.offset, size=request.size)
        t0 = time.perf_counter()
        try:
            ev = self.store.find_ec_volume(request.volume_id)
            if ev is None:
                context.abort(grpc.StatusCode.NOT_FOUND, "ec volume not mounted")
            if request.generation and ev.encode_ts_ns != request.generation:
                # the generation fence (reference store_ec.go:627)
                context.abort(grpc.StatusCode.FAILED_PRECONDITION, "stale generation")
            fd = ev.shard_fds.get(request.shard_id)
            if fd is None:
                context.abort(grpc.StatusCode.NOT_FOUND, "shard not local")
            try:
                # peer-read chaos: a raised IOError aborts the stream; a
                # mutate tears or corrupts the streamed bytes, which the
                # client must catch (short read, needle CRC, verified
                # reconstruction)
                faults.fire("server.ec_shard_read", volume=request.volume_id,
                            shard=request.shard_id)
            except IOError as e:
                context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
            remaining = request.size
            off = request.offset
            while remaining > 0:
                # the Python-plane stream: every chunk becomes bytes for the
                # protobuf message; ShardNetPlane is its sendfile twin
                chunk = os.pread(fd, min(_EC_STREAM_CHUNK, remaining), off)
                if not chunk:
                    break
                orig_len = len(chunk)
                M.net_bytes_copied_total.inc(orig_len, plane="python", direction="read")
                chunk = faults.mutate("server.ec_shard_read", chunk, volume=request.volume_id,
                                      shard=request.shard_id, offset=off)
                if chunk:
                    yield pb.EcShardReadChunk(data=chunk)
                    M.net_bytes_sent_total.inc(len(chunk), plane="python", direction="read")
                if len(chunk) < orig_len:
                    break  # a torn stream: the client sees a short read
                off += orig_len
                remaining -= orig_len
        finally:
            trace.add_stage(sp, "stream", time.perf_counter() - t0)
            trace.finish(sp)

    def VolumeEcBlobDelete(self, request, context):
        # a mutation: on a keyed cluster it needs the peer token
        if not self._grpc_jwt_ok(context, request.volume_id, request.needle_id):
            context.abort(grpc.StatusCode.PERMISSION_DENIED, "unauthorized")
        ev = self.store.find_ec_volume(request.volume_id)
        if ev is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "ec volume not mounted")
        ev.delete_needle(request.needle_id)
        return pb.EcBlobDeleteResponse()

    def VolumeEcShardsToVolume(self, request, context):
        sp = self._rpc_span("rpc.ec_shards_to_volume", request, context)
        try:
            with trace.activate(sp):
                return self._ec_shards_to_volume(request, context)
        finally:
            trace.finish(sp)

    def _ec_shards_to_volume(self, request, context):
        base = self._ec_base(request.volume_id, request.collection)
        if base is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "ec volume not found")
        self.store.unmount_ec_volume(request.volume_id)
        vi = VolumeInfo.maybe_load(base + ".vif")
        ctx = (vi.ec_ctx if vi else None) or ec_context.ECContext()
        name = self.store.ec_backend
        try:
            ec_decode_volume(base, ctx, backend=self._backend(name, ctx, EC_BACKENDS[name]),
                             scheduler=self.store.ec_scheduler)
        except ECError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        self.store.mount_volume(request.volume_id, request.collection)
        self.server.notify_new_volume(request.volume_id)
        return pb.EcShardsToVolumeResponse()

    def CopyFile(self, request, context):
        """Stream a volume or EC file, from `start_offset` to `stop_offset`
        (0: its size)."""
        base = self._ec_base(request.volume_id, request.collection, require=False)
        path = (base or "") + request.ext
        if base is None or not os.path.exists(path):
            context.abort(grpc.StatusCode.NOT_FOUND, f"no {request.ext}")
        v = self.store.find_volume(request.volume_id)
        if v is not None and request.ext in (".dat", ".idx"):
            v.flush()  # a tail read sees every acknowledged write
        stop = request.stop_offset or os.path.getsize(path)
        with open(path, "rb") as f:
            sent = request.start_offset
            f.seek(sent)
            while sent < stop:
                chunk = f.read(min(_EC_STREAM_CHUNK, stop - sent))
                if not chunk:
                    break
                yield pb.CopyFileChunk(data=chunk)
                sent += len(chunk)

    def VolumeTierUpload(self, request, context):
        """Move a sealed volume's .dat to the cold tier (reference
        volume_grpc_tier_upload.go); the .idx stays local, so lookups never
        reach the tier."""
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return pb.TierResponse(error="volume not found")
        try:
            moved = v.tier_upload(request.dest_url, keep_local=request.keep_local)
        except Exception as e:  # noqa: BLE001 — the caller gets the reason
            return pb.TierResponse(error=str(e))
        return pb.TierResponse(moved_bytes=moved)

    def VolumeTierDownload(self, request, context):
        """Bring a cold-tiered .dat back to local disk (reference
        volume_grpc_tier_download.go)."""
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return pb.TierResponse(error="volume not found")
        try:
            moved = v.tier_download(delete_remote=request.delete_remote)
        except Exception as e:  # noqa: BLE001 — the caller gets the reason
            return pb.TierResponse(error=str(e))
        return pb.TierResponse(moved_bytes=moved)

    # ---------------------------------------- tail and incremental sync
    # Reference weed/server/volume_grpc_tail.go and
    # weed/storage/volume_backup.go: a replica that was down pulls only the
    # records appended after its own last appendAtNs.

    def VolumeTailSender(self, request, context):
        """Stream the needle records appended after since_ns, following
        new appends until none came for idle_timeout_seconds (0: until the
        caller or the server stops)."""
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {request.volume_id} not found")
        try:
            v._require_v3()  # v2 has no appendAtNs to follow
            # position once (a binary search of the .idx); each poll then
            # compares the position with the append end
            pos = v._walk_start_for(request.since_ns)
        except VolumeError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        draining = float(request.idle_timeout_seconds)
        while True:
            end = v._append_end()
            progressed = False
            if pos < end:
                for _n, raw, ts in v.scan_records_between(pos, end):
                    if ts <= request.since_ns:
                        continue  # the first segment may start at an older put
                    header, rest = raw[:16], raw[16:]
                    for i in range(0, max(len(rest), 1), _EC_STREAM_CHUNK):
                        yield pb.VolumeTailChunk(needle_header=header if i == 0 else b"",
                                                 needle_body=rest[i : i + _EC_STREAM_CHUNK],
                                                 version=v.version)
                    progressed = True
                pos = end
            # the heartbeat completes the client's pending needle and shows
            # the stream alive while idle
            yield pb.VolumeTailChunk(is_last_chunk=True, version=v.version)
            if request.idle_timeout_seconds:
                if progressed:
                    draining = float(request.idle_timeout_seconds)
                else:
                    draining -= self._TAIL_POLL_S
                    if draining <= 0:
                        return
            if self.stopping.wait(self._TAIL_POLL_S) or not context.is_active():
                return

    def VolumeTailReceiver(self, request, context):
        """Pull the tail from a source server into the local replica (the
        server side of `volume.sync`). since_ns 0 resumes from the local
        volume's own last appendAtNs."""
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return pb.VolumeTailReceiverResponse(error=f"volume {request.volume_id} not found")
        since = request.since_ns or v.last_append_at_ns()
        count = 0
        try:
            for n in tail_volume(request.source_volume_server, request.volume_id, since,
                                 request.idle_timeout_seconds or 3):
                if n.is_tombstone or (not n.data and not n.flags and n.cookie == 0):
                    # the source's tombstone bytes, verbatim: the 0x40 flag,
                    # or the legacy marker Needle(cookie=0, data=b""); an
                    # empty body with a nonzero cookie is a put
                    v.delete_needle(n.needle_id, tombstone=n)
                else:
                    v.write_needle(n)  # appendAtNs kept: the same bytes
                count += 1
        except Exception as e:  # noqa: BLE001 — the caller gets the reason
            return pb.VolumeTailReceiverResponse(received=count, error=str(e))
        return pb.VolumeTailReceiverResponse(received=count)

    def VolumeIncrementalCopy(self, request, context):
        """The raw .dat bytes from the first record newer than since_ns to
        the append end. The first chunk carries start_offset, so a
        byte-prefix follower (the weed backup analog) checks its alignment
        before it appends."""
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {request.volume_id} not found")
        try:
            off = v.offset_after_ns(request.since_ns)
        except VolumeError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        end = v._append_end()
        if off >= end:
            yield pb.VolumeIncrementalCopyChunk(has_start=True, start_offset=end)
            return
        with open(v.dat_path, "rb") as f:
            f.seek(off)
            sent = off
            while sent < end:
                data = f.read(min(_EC_STREAM_CHUNK, end - sent))
                if not data:
                    break
                first = sent == off
                yield pb.VolumeIncrementalCopyChunk(file_content=data,
                                                    start_offset=off if first else 0,
                                                    has_start=first)
                sent += len(data)

    def ReadVolumeFileStatus(self, request, context):
        """Sizes, compaction revision, version and last appendAtNs of a
        volume's files (reference volume_grpc_admin.go): the handshake of
        an incremental backup."""
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return pb.VolumeFileStatusResponse(error="volume not found")
        v.flush()
        try:
            last_ns = v.last_append_at_ns()
        except VolumeError:
            last_ns = 0  # a v2 volume has no appendAtNs footer
        return pb.VolumeFileStatusResponse(
            dat_size=os.path.getsize(v.dat_path), idx_size=os.path.getsize(v.idx_path),
            compaction_revision=v.super_block.compaction_revision, version=v.version,
            last_append_at_ns=last_ns, collection=v.collection,
        )

    def ScrubVolume(self, request, context):
        """CRC-check every live needle (reference volume_grpc_scrub.go)
        with one native scan of the .dat; dead and superseded records are
        skipped. The volume stays online."""
        # a task RPC: adopt the dispatcher's request id, so this holder's
        # log lines carry the fleet task's
        _rid.ensure(trace.metadata_dict(context).get(trace.REQUEST_ID_KEY))
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return pb.ScrubResponse(error="volume not found")
        v.flush()
        ids, offs, sizes, ok = native.scan_dat(v.dat_path)
        checked = 0
        bad: list[int] = []
        for nid, stored_off, body_size, crc_ok in zip(ids.tolist(), offs.tolist(),
                                                      sizes.tolist(), ok.tolist()):
            if body_size <= 0:
                continue
            nv = v.needle_map.get(nid)
            if nv is None or nv.is_deleted:
                continue  # a dead record: vacuum's work
            if nv.offset != stored_off:
                continue  # a superseded copy; the live one is elsewhere
            checked += 1
            if not crc_ok:
                bad.append(nid)
        return pb.ScrubResponse(checked=checked, bad_needles=bad)

    def ScrubEcVolume(self, request, context):
        """Verify the local shards against the .ecsum sidecar (reference
        ec_volume_scrub.go / store_ec_scrub.go)."""
        sp = self._rpc_span("rpc.scrub_ec_volume", request, context)
        try:
            with trace.activate(sp):
                return self._scrub_ec_volume(request, context)
        finally:
            trace.finish(sp)

    def _scrub_ec_volume(self, request, context):
        base = self._ec_base(request.volume_id, request.collection)
        if base is None:
            return pb.ScrubResponse(error="ec volume not found")
        if not os.path.exists(base + ".ecsum"):
            return pb.ScrubResponse(error="no bitrot sidecar")
        try:
            prot = BitrotProtection.load(base + ".ecsum")
        except BitrotError as e:
            return pb.ScrubResponse(error=f"sidecar unreadable: {e}")
        # recover (replay or roll back) pending leaf-repair journals first,
        # so this pass judges fully old or fully new bytes
        rec = recover_volume_journals(base, prot.ctx, prot)
        journal_recovered = len(rec["replayed"]) + len(rec["rolled_back"])
        if rec["replayed"]:
            ev = self.store.find_ec_volume(request.volume_id)
            if ev is not None and prot.has_leaves:
                # in-place patches keep the inode: no fd swap, but cached
                # reconstructions over the patched bytes are stale
                for sid, leaves in rec["replayed"].items():
                    ev.invalidate_shard_ranges(sid, patched_byte_ranges(prot, sid, leaves))
        checked: list[int] = []
        bad: list[int] = []
        for i in range(prot.ctx.total):
            p = base + prot.ctx.to_ext(i)
            if not os.path.exists(p):
                continue
            checked.append(i)
            try:
                if prot.verify_shard_file(p, i):
                    bad.append(i)
            except OSError:
                bad.append(i)
        # A quarantine whose shard is back and verified good this pass is
        # healed: its .bad file stays for forensics but is not reported,
        # or the fleet loop would rebuild this holder every period.
        healed = set(checked) - set(bad)
        quarantined = [
            i for i in range(prot.ctx.total)
            if i not in healed
            and os.path.exists(base + prot.ctx.to_ext(i) + ec_context.QUARANTINE_SUFFIX)
        ]
        return pb.ScrubResponse(
            checked=len(checked), bad_shards=bad, checked_shards=checked,
            quarantined_shards=quarantined, repair_journal_recovered=journal_recovered,
        )

    def VolumeServerStatus(self, request, context):
        st = self.store.status()
        return pb.VolumeServerStatusResponse(volumes=_volume_msgs(st), ec_shards=_ec_shard_msgs(st))

    # ------------------------------------------------------------ helpers

    def _ec_base(self, vid: int, collection: str, require: bool = True):
        """The directory base of a volume's EC artifacts on this server."""
        for loc in self.store.locations:
            base = Volume.base_file_name(loc.directory, collection, vid)
            if (
                os.path.exists(base + ".ecx")
                or os.path.exists(base + ".dat")
                or any(os.path.exists(base + f".ec{i:02d}")
                       for i in range(ec_context.MAX_SHARD_COUNT))
            ):
                return base
        return None


class ClusterHalf:
    """The volume server's cluster half: the gRPC server on `grpc_port`,
    the master client, heartbeats, the replica fan-out, the remote shard
    reader and peer-fetch rebuild with its hand-off. `server` is the
    `VolumeServer`; its store exists by the time any method here runs."""

    def __init__(self, server, master: str, data_center: str, rack: str):
        self.server = server
        # `master` may be a comma-separated HA group; heartbeats follow the
        # leader through HeartbeatResponse.leader redirects. "" = none.
        self.master_addrs = [m.strip() for m in master.split(",") if m.strip()]
        self.data_center = data_center
        self.rack = rack
        self._mc = None
        self._mc_lock = threading.Lock()
        self._np_client = None
        self._peer_channels: dict[str, grpc.Channel] = {}
        # vid -> Lock: one peer-fetch rebuild per volume at a time (the
        # staging dir is per volume)
        self._peer_rebuild_busy: dict[int, threading.Lock] = {}
        # the master's volume size limit, from HeartbeatResponse: the
        # denominator of capacity-aware shard placement (0: not known yet)
        self.volume_size_limit = 0
        self.service = VolumeService(server)
        self._grpc = grpc.server(futures.ThreadPoolExecutor(max_workers=32))
        rpc.add_service(self._grpc, rpc.VOLUME_SERVICE, self.service)
        self._grpc.add_insecure_port(f"{server.ip}:{server.grpc_port}")
        self._hb_queue: "queue.Queue[pb.Heartbeat | None]" = queue.Queue()
        self._hb_stop = threading.Event()
        self._hb_channel: grpc.Channel | None = None
        self._hb_thread = threading.Thread(target=self._heartbeat_loop, daemon=True)

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._grpc.start()
        if self.master_addrs:
            self._hb_thread.start()

    def stop(self) -> None:
        """End the open tail streams and the heartbeat stream (the master
        sees the node leave), stop the gRPC server, and close the master
        client and every peer channel."""
        self.service.stopping.set()  # ends open VolumeTailSender streams
        self._hb_stop.set()
        self._hb_queue.put(None)  # wakes the heartbeat iterator
        with self._mc_lock:
            if self._hb_channel is not None:
                self._hb_channel.close()
        if self._hb_thread.is_alive():
            self._hb_thread.join(timeout=5)
        self._grpc.stop(grace=0.5).wait(5)
        with self._mc_lock:
            if self._mc is not None:
                self._mc.close()
            if self._np_client is not None:
                self._np_client.close()
            for ch in self._peer_channels.values():
                ch.close()
            self._peer_channels.clear()

    # ------------------------------------------------------ remote shards

    def _master_client(self):
        """The server's one MasterClient (vid and EC lookup caches, one
        channel), built at first use. LookupError where the server has no
        master."""
        with self._mc_lock:
            if not self.master_addrs:
                raise LookupError("this volume server has no master")
            if self._mc is None:
                self._mc = MasterClient(",".join(self.master_addrs))
            return self._mc

    def _net_plane_client(self):
        """The shared NetPlaneClient of pull-side shard copies and plane
        replication legs: pooled connections, no-plane refusals memoized."""
        with self._mc_lock:
            if self._np_client is None:
                self._np_client = _netp.NetPlaneClient()
            return self._np_client

    def _cluster_ec_telemetry(self) -> dict:
        """Per-node device telemetry from the master's /cluster/status
        (`EcTelemetry`: node id -> chips, breakers, stage EWMAs), the live
        signal shard placement scores beside slots and headroom.
        Best-effort: any failure gives {} and the static scoring."""
        try:
            mc = self._master_client()
            addr = getattr(mc, "_leader", "") or getattr(mc, "http_addr", "")
            if not addr:
                return {}
            with urls.urlopen(service_url(addr, "/cluster/status"), timeout=2) as r:
                tele = json.loads(r.read()).get("EcTelemetry")
            return tele if isinstance(tele, dict) else {}
        except Exception:  # noqa: BLE001 — telemetry is advisory
            return {}

    def _peer_stub(self, peer: str):
        with self._mc_lock:
            ch = self._peer_channels.get(peer)
            if ch is None:
                ch = grpc.insecure_channel(peer)
                self._peer_channels[peer] = ch
            return rpc.volume_stub(ch)

    def _remote_reader_factory(self, vid: int, collection: str):
        """The Store's `ec_remote_reader_factory`: a reader of shard
        intervals from the peers the master names, over VolumeEcShardRead.
        None where no peer answers the whole interval."""
        def read(shard_id: int, offset: int, size: int, generation: int):
            try:
                locs = self._master_client().lookup_ec(vid).get(shard_id, [])
            except (LookupError, grpc.RpcError):
                return None
            my_url = f"{self.server.ip}:{self.server.grpc_port}"
            for loc in locs:
                peer = f"{loc.url.split(':')[0]}:{loc.grpc_port}"
                if peer == my_url:
                    continue
                try:
                    buf = b"".join(
                        c.data
                        for c in self._peer_stub(peer).VolumeEcShardRead(
                            pb.EcShardReadRequest(volume_id=vid, shard_id=shard_id, offset=offset,
                                                  size=size, generation=generation),
                            timeout=30,
                            # the request id and trace context ride to the
                            # peer: its reads join the reader's trace
                            metadata=trace.grpc_metadata(),
                        )
                    )
                    if len(buf) == size:
                        return buf
                except grpc.RpcError:
                    continue
            return None

        return read

    # -------------------------------------------------- peer-fetch rebuild

    def peer_fetch_rebuild(self, vid: int, collection: str = "", backend_name: str = "") -> dict:
        """Cluster-level EC self-heal of one volume on this server: with
        fewer than k verified-good local source shards, stream siblings
        from peer holders (VolumeEcShardRead or the shard net plane,
        generation-fenced, verified against the sidecar, ec/peer_rebuild.py),
        rebuild on the server's device, mount the regenerated shards this
        server owns, and hand regenerated shards the cluster lost to their
        planned holders (ec/placement.py). Idempotent: a re-run after any
        crash converges without minting duplicate copies. One run per
        volume at a time: a second concurrent call is refused."""
        busy = self._peer_rebuild_busy.setdefault(vid, threading.Lock())
        if not busy.acquire(blocking=False):
            raise ECError(f"peer-fetch rebuild for ec volume {vid} is already running on this "
                          f"server; re-run after it finishes")
        try:
            return self._peer_fetch_rebuild_locked(vid, collection, backend_name)
        finally:
            busy.release()

    def _peer_fetch_rebuild_locked(self, vid: int, collection: str, backend_name: str) -> dict:
        store = self.server.store
        loc_base = self.service._ec_base(vid, collection)
        if loc_base is None:
            raise ECError(f"ec volume {vid} not found on this server")
        vi = VolumeInfo.maybe_load(loc_base + ".vif")
        ctx = (vi.ec_ctx if vi else None) or ec_context.ECContext()
        generation = vi.encode_ts_ns if vi else 0
        ev = store.find_ec_volume(vid)
        if ev is None:
            # an unmounted volume has no legitimate set to scope the
            # targets by: the hand-off would ship this server's own shards
            raise ECError(f"ec volume {vid} is not mounted here; peer-fetch rebuild needs the "
                          f"serving mount")
        legit = set(ev.legitimate_shards())
        # a fresh holder map; without the master there is no safe notion
        # of "lost" against "lives on a peer"
        try:
            located = self._master_client().lookup_ec(vid, refresh=True)
        except (LookupError, grpc.RpcError) as e:
            raise ECError(f"peer-fetch rebuild needs the master: {e}") from e
        me = f"{self.server.ip}:{self.server.port}"
        holders: dict[int, list[str]] = {}
        for sid, locs in located.items():
            peers = [fleet.grpc_addr(loc) for loc in locs if loc.url != me]
            if peers:
                holders[sid] = peers
        lost = {sid for sid in range(ctx.total) if not located.get(sid)}
        present = {i for i in range(ctx.total) if os.path.exists(loc_base + ctx.to_ext(i))}
        # this server's legitimate set plus what the master knows no
        # location for; corrupt present shards are replaced regardless
        targets = sorted((legit | lost) - present)

        def fetch(peer: str, sid: int, off: int, size: int) -> bytes:
            try:
                buf = bytearray()
                for c in self._peer_stub(peer).VolumeEcShardRead(
                    pb.EcShardReadRequest(volume_id=vid, shard_id=sid, offset=off, size=size,
                                          generation=generation),
                    timeout=60,
                    # one trace id across the whole heal
                    metadata=trace.grpc_metadata(),
                ):
                    buf += c.data
                    M.net_bytes_copied_total.inc(len(c.data), plane="python", direction="read")
            except grpc.RpcError as e:
                # a peer dying mid-stream, a stale generation, no route:
                # retry-then-replan material
                raise PeerFetchTransient(f"{peer}: {e.code().name}: {e.details()}") from e
            M.net_bytes_received_total.inc(len(buf), plane="python", direction="read")
            M.net_bytes_copied_total.inc(len(buf), plane="python", direction="read")
            return bytes(buf)

        # native ingress: sibling streams land in pooled aligned buffers
        # from the peer's shard net plane; peers without one are memoized
        # and their streams take the gRPC fetch above
        np_client = _netp.NetPlaneClient()
        fetch_into = _netp.make_fetch_into(np_client, vid, generation)
        backend = get_backend(backend_name or store.ec_backend, ctx.data_shards,
                              ctx.parity_shards)
        try:
            with M.request_seconds.time(server="volume", op="ec_peer_rebuild"):
                report = rebuild_from_peers(
                    loc_base, holders, fetch, ctx=ctx, targets=targets, backend=backend,
                    scheduler=store.ec_scheduler, fetch_into=fetch_into,
                )
        finally:
            np_client.close()
        M.ec_ops_total.inc(op="peer_rebuild", backend=backend_name or store.ec_backend)
        # Regenerated shards this server owns re-enter service: the fds move
        # onto the fresh inodes and the next heartbeat advertises them. A
        # corrupt shard outside the legitimate set is a rotten hand-off
        # leftover: mounting it would advertise a holder the hand-off below
        # then unlinks.
        owned = sorted(sid for sid in report.rebuilt if sid in legit)
        if owned:
            ev.reopen_shards(owned)
            self.notify_new_ec_shards(vid, collection)
        # leaf repairs patched the canonical inode in place: the fd stays,
        # but cached reconstructions over those ranges are stale
        for sid, ranges in report.patched_ranges.items():
            ev.invalidate_shard_ranges(sid, ranges)
        distributed = self._distribute_lost_shards(vid, collection, loc_base, ctx, legit)
        return {
            "rebuilt": sorted(report.rebuilt),
            "fetched": sorted(report.fetched),
            "distributed": distributed,
            "repaired": sorted(report.leaf_repaired),
        }

    def _distribute_lost_shards(self, vid: int, collection: str, base: str, ctx, legit) -> list[int]:
        """Ship regenerated cluster-lost shards this server does not own to
        planned holders (copy and mount there, then delete the local
        hand-off copy). The inventory is the disk (every canonical shard
        file outside the legitimate set), so a re-run after a crash during
        the hand-off finishes it; the holder map is fetched here again, so
        a shard a crashed run already mounted elsewhere is only deleted
        locally. The local copies are never mounted here, so the master
        never sees a duplicate holder."""
        inventory = [sid for sid in range(ctx.total)
                     if sid not in legit and os.path.exists(base + ctx.to_ext(sid))]
        if not inventory:
            return []
        try:
            located = self._master_client().lookup_ec(vid, refresh=True)
        except (LookupError, grpc.RpcError) as e:
            raise ECError(f"rebuilt shards are mounted, but distributing cluster-lost shards "
                          f"needs the master: {e}; re-run ec.rebuild -fromPeers to finish the "
                          f"handoff") from e
        me = f"{self.server.ip}:{self.server.port}"
        done: list[int] = []
        pending: list[int] = []
        for sid in inventory:
            if any(loc.url != me for loc in located.get(sid, [])):
                # a holder already serves it: finish the hand-off by
                # dropping the local copy
                os.unlink(base + ctx.to_ext(sid))
                done.append(sid)
            else:
                pending.append(sid)
        if not pending:
            return done
        try:
            topo = self._master_client().topology()
        except (LookupError, grpc.RpcError) as e:
            raise ECError(f"rebuilt shards are mounted, but placing cluster-lost shards needs the "
                          f"master topology: {e}; re-run ec.rebuild -fromPeers to finish the "
                          f"handoff") from e
        nodes = {n.id: n for n in topo.nodes}
        # the heartbeat-learned chip loads rank otherwise equal
        # destinations by queue headroom
        cluster_tele = self._cluster_ec_telemetry()
        sp = trace.current()
        if sp is not None:
            sp.event(
                "placement_signals",
                source=("live" if cluster_tele else "static"),
                node_loads={
                    nid: t.get("chips", {}) and sum(c.get("load", 0)
                                                    for c in t.get("chips", {}).values())
                    for nid, t in cluster_tele.items()
                },
            )
        # capacity-aware views: used bytes from the topology, the
        # denominator the master's volume size limit; either unknown
        # keeps slot-only planning
        views = [
            node_view_for(
                n.id, n.rack, n.data_center, n.max_volume_count, len(n.volumes), n.ec_shards,
                ec_telemetry=cluster_tele.get(n.id),
                used_bytes=(sum(int(v.size) for v in n.volumes)
                            + sum(int(e.shard_size) * bin(e.shard_bits).count("1")
                                  for e in n.ec_shards)),
                capacity_bytes=(int(n.max_volume_count or 8) * self.volume_size_limit
                                if self.volume_size_limit > 0 else -1),
            )
            for n in topo.nodes
        ]
        try:
            shard_bytes = os.path.getsize(base + ctx.to_ext(pending[0]))
        except OSError:
            shard_bytes = 0
        shard_count = {n.id: {e.id: bin(e.shard_bits).count("1") for e in n.ec_shards}
                       for n in topo.nodes}
        faults.fire("ec.peer_rebuild.before_distribute", volume=vid)
        adopted: list[int] = []
        # In-pass re-planning: a destination that dies or refuses is
        # excluded and the remaining shards are planned again against the
        # survivors in this run. Each failed round excludes a node, so the
        # rounds are bounded by the topology's size.
        remaining = list(pending)
        dead_nodes: set[str] = set()
        for _round in range(max(len(views), 1) + 1):
            if not remaining:
                break
            candidates = [v for v in views if v.id not in dead_nodes]
            plan = plan_shard_placement(candidates, vid, remaining, shard_bytes=shard_bytes)
            if _round and plan:
                log.warning("re-planned ec %d distribution for shards %s after excluding dead "
                            "destinations %s", vid, remaining, sorted(dead_nodes))
            next_round: list[int] = []
            for sid in remaining:
                node = nodes.get(plan.get(sid, ""))
                if node is not None and node.id in dead_nodes:
                    # planned this round before the node died on an earlier
                    # shard: straight to the next round's plan
                    next_round.append(sid)
                    continue
                if node is None or node.location.url == me:
                    if _round:
                        # no surviving alternate: keep the hand-off copy on
                        # disk (unmounted, unadvertised) for the next run
                        log.warning("ec %d.%02d: no surviving alternate destination; handoff "
                                    "deferred to the next run", vid, sid)
                        continue
                    # the first plan found no room anywhere, or chose this
                    # server: adopt the shard here
                    adopted.append(sid)
                    done.append(sid)
                    continue
                dest = fleet.grpc_addr(node.location)
                first_on_dst = shard_count.get(node.id, {}).get(vid, 0) == 0
                try:
                    stub = self._peer_stub(dest)
                    stub.VolumeEcShardsCopy(
                        pb.EcShardsCopyRequest(
                            volume_id=vid, collection=collection, shard_ids=[sid],
                            source_url=f"{self.server.ip}:{self.server.grpc_port}",
                            copy_ecx=first_on_dst, copy_ecj=first_on_dst,
                            copy_vif=first_on_dst, copy_ecsum=first_on_dst,
                        ),
                        timeout=600, metadata=trace.grpc_metadata(),
                    )
                    stub.VolumeEcShardsMount(
                        pb.EcShardsMountRequest(volume_id=vid, collection=collection),
                        timeout=60, metadata=trace.grpc_metadata(),
                    )
                except grpc.RpcError as e:
                    # the destination failed: exclude it and plan this shard
                    # again; the hand-off copy stays here either way. Delete
                    # what the copy may have landed there first, or a later
                    # mount on that node would advertise a duplicate holder.
                    log.warning("distribute ec %d.%02d -> %s failed: %s; excluding the "
                                "destination and re-planning", vid, sid, dest, e.code().name)
                    try:
                        self._peer_stub(dest).VolumeEcShardsDelete(
                            pb.EcShardsDeleteRequest(volume_id=vid, collection=collection,
                                                     shard_ids=[sid]),
                            timeout=15, metadata=trace.grpc_metadata(),
                        )
                    except grpc.RpcError:
                        pass  # unreachable: nothing landed, or beyond reach
                    dead_nodes.add(node.id)
                    next_round.append(sid)
                    continue
                faults.fire("ec.peer_rebuild.after_distribute", volume=vid, shard=sid)
                os.unlink(base + ctx.to_ext(sid))
                shard_count.setdefault(node.id, {})[vid] = shard_count.get(node.id, {}).get(vid, 0) + 1
                done.append(sid)
            remaining = next_round
        if adopted:
            # mount only the adopted ids: hand-off copies whose distribution
            # failed stay unmounted, so the next run retries them
            ev = self.server.store.find_ec_volume(vid)
            if ev is not None:
                ev.reopen_shards(adopted)
            self.notify_new_ec_shards(vid, collection)
        return done

    # --------------------------------------------------------- replication

    def _replica_locations(self, vid: int) -> list:
        """The other holders of `vid` the master names. Raises LookupError
        or grpc.RpcError where the lookup fails (the JAX server answers []
        there; the fan-out below decides)."""
        locs = self._master_client().lookup(vid)
        me = f"{self.server.ip}:{self.server.port}"
        return [loc for loc in locs if loc.url != me]

    def _lookup_refused(self, vid: int, op: str, e: Exception) -> str:
        """"" where a failed holder lookup still leaves the placement
        served (the volume asks for one copy), else the refusal."""
        v = self.server.store.find_volume(vid)
        copies = v.super_block.replica_placement.copy_count if v is not None else 1
        if copies <= 1:
            return ""
        return (f"replica {op} {FAN_OUT_REFUSED}: volume {vid} asks for {copies} copies and the "
                f"master lookup of its other holders failed: {e}")

    def _peer_metadata(self, vid: int):
        """Peer-auth metadata for gRPC writes on a keyed cluster."""
        if not self.server.jwt_key:
            return None
        return (("authorization", f"Bearer {sign_jwt(self.server.jwt_key, str(vid))}"),)

    def _plane_replicate(self, host: str, grpc_port: int, request) -> bool:
        """One replication leg over the native write plane. False (the
        caller takes gRPC) where the plane is off, chaos outside the write
        path is armed, the peer has no plane (memoized), or the write
        errs: the gRPC leg is the correctness path, this one the fast one."""
        try:
            if not native_io.enabled() or not _netp.write_plane_admissible():
                return False
            jwt = sign_jwt(self.server.jwt_key, str(request.volume_id)) if self.server.jwt_key else ""
            self._net_plane_client().write_needle(
                (host, _netp.derive_port(grpc_port)), request.volume_id, request.needle_id,
                request.cookie, bytes(request.data), flags=request.flags,
                name=request.name.encode() if request.name else b"",
                mime=request.mime.encode() if request.mime else b"",
                jwt=jwt, replicate=False,
            )
            return True
        except Exception:  # noqa: BLE001 — any plane failure takes the gRPC leg
            return False

    def replicate_write(self, vid: int, nid: int, cookie: int, data: bytes, name: str = "",
                        mime: str = "", flags: int = 0) -> str:
        """Synchronous fan-out of one write to the replica holders
        (reference store_replicate.go:32). Each leg tries the native write
        plane, then the gRPC WriteNeedle; both land the same record.
        Returns the error summary, "" when every holder took it."""
        try:
            locs = self._replica_locations(vid)
        except (LookupError, grpc.RpcError) as e:
            return self._lookup_refused(vid, "write", e)
        request = pb.WriteNeedleRequest(volume_id=vid, needle_id=nid, cookie=cookie, data=data,
                                        name=name, mime=mime, flags=flags)
        errors = []
        md = self._peer_metadata(vid)
        for loc in locs:
            host = loc.url.split(":")[0]
            if self._plane_replicate(host, loc.grpc_port, request):
                continue
            rep = pb.WriteNeedleRequest()
            rep.CopyFrom(request)
            rep.is_replicate = True
            try:
                r = self._peer_stub(f"{host}:{loc.grpc_port}").WriteNeedle(rep, timeout=30,
                                                                            metadata=md)
                if r.error:
                    errors.append(f"{loc.url}: {r.error}")
            except grpc.RpcError as e:
                errors.append(f"{loc.url}: {e.code().name}")
        return "; ".join(errors)

    def replicate_ec_delete(self, vid: int, collection: str, needle_id: int) -> str:
        """Journal the EC tombstone on every other shard holder. Returns
        the error summary ("" = all holders reached): a missed holder would
        bring the needle back."""
        try:
            # a fresh holder list: a balance move since the cached lookup
            # would otherwise be missed
            shard_locs = self._master_client().lookup_ec(vid, refresh=True)
        except (LookupError, grpc.RpcError) as e:
            return f"ec tombstone fan-out: holder lookup failed: {e}"
        me = f"{self.server.ip}:{self.server.port}"
        md = self._peer_metadata(vid)
        errors = []
        seen = set()
        for locs in shard_locs.values():
            for loc in locs:
                if loc.url == me or loc.url in seen:
                    continue
                seen.add(loc.url)
                try:
                    self._peer_stub(f"{loc.url.split(':')[0]}:{loc.grpc_port}").VolumeEcBlobDelete(
                        pb.EcBlobDeleteRequest(volume_id=vid, collection=collection,
                                               needle_id=needle_id),
                        timeout=30, metadata=md,
                    )
                except grpc.RpcError as e:
                    errors.append(f"{loc.url}: {e.code().name}")
        return "; ".join(errors)

    def replicate_delete(self, vid: int, nid: int) -> str:
        """Fan one delete out to the replica holders. A failed leg is
        ignored, as in the JAX server; a failed lookup is refused where the
        placement asks for more than one copy."""
        try:
            locs = self._replica_locations(vid)
        except (LookupError, grpc.RpcError) as e:
            return self._lookup_refused(vid, "delete", e)
        md = self._peer_metadata(vid)
        rep = pb.DeleteNeedleRequest(volume_id=vid, needle_id=nid, is_replicate=True)
        for loc in locs:
            try:
                self._peer_stub(f"{loc.url.split(':')[0]}:{loc.grpc_port}").DeleteNeedle(
                    rep, timeout=30, metadata=md)
            except grpc.RpcError:
                pass
        return ""

    # ---------------------------------------------------------- heartbeats

    def _ec_telemetry_json(self) -> str:
        """The device telemetry of every full heartbeat: per-chip queue
        load and breaker state over this server's own scheduler scope, the
        flight recorder's stage EWMAs and each EC volume's heat counters.
        The master aggregates it into /cluster/status and the placement
        signals."""
        store = self.server.store
        try:
            chips = chip_load_hint(store.ec_scheduler)
        except Exception:  # noqa: BLE001 — telemetry never breaks the heartbeat
            chips = {}
        breakers_open = sum(1 for c in chips.values() if c.get("breaker") == "open")
        ec_volumes: dict[str, dict] = {}
        try:
            for dloc in store.locations:
                for vid, ev in dloc.ec_volumes.items():
                    ec_volumes[str(vid)] = {"read_bytes": int(ev.bytes_read),
                                            "reconstructed_bytes": int(ev.bytes_reconstructed)}
        except Exception:  # noqa: BLE001 — heat is advisory
            ec_volumes = {}
        try:
            residency = residency_snapshot()
        except Exception:  # noqa: BLE001 — advisory
            residency = {}
        return json.dumps({
            "chips": chips,
            "breakers_open": breakers_open,
            "degraded": breakers_open > 0,
            "residency": residency,
            "stage_ewma_s": {k: round(v, 6) for k, v in trace.stage_ewmas().items()},
            "ec_volumes": ec_volumes,
            "ts": time.time(),
        })

    def _full_heartbeat(self) -> pb.Heartbeat:
        server = self.server
        st = server.store.status()
        server._refresh_volume_gauges(st)
        return pb.Heartbeat(
            ip=server.ip,
            port=server.port,
            public_url=server.store.public_url,
            grpc_port=server.grpc_port,
            max_volume_count=server.max_volume_count,
            data_center=self.data_center,
            rack=self.rack,
            volumes=_volume_msgs(st),
            ec_shards=_ec_shard_msgs(st),
            has_no_volumes=not st["volumes"],
            has_no_ec_shards=not st["ec_volumes"],
            ec_telemetry_json=self._ec_telemetry_json(),
        )

    def _notify(self) -> None:
        if self.master_addrs:
            self._hb_queue.put(self._full_heartbeat())

    def notify_new_volume(self, vid: int) -> None:
        self._notify()

    def notify_deleted_volume(self, vid: int) -> None:
        self._notify()

    def notify_new_ec_shards(self, vid: int, collection: str) -> None:
        self._notify()

    def notify_deleted_ec_shards(self, vid: int, collection: str, sids) -> None:
        self._notify()

    def _heartbeat_iter(self):
        yield self._full_heartbeat()
        while not self._hb_stop.is_set():
            try:
                hb = self._hb_queue.get(timeout=2.0)
            except queue.Empty:
                # the periodic full refresh is the liveness pulse, and the
                # reaper tick of expired TTL volumes
                reaped = self.server.store.reap_expired_volumes()
                if reaped:
                    log.info("reaped expired TTL volumes: %s", reaped)
                yield self._full_heartbeat()
                continue
            if hb is None:  # stop()
                return
            yield hb

    def _heartbeat_loop(self):
        target = self.master_addrs[0]
        fail_idx = 0
        while not self._hb_stop.is_set():
            redirect = None
            ch = grpc.insecure_channel(master_grpc_addr(target))
            with self._mc_lock:
                self._hb_channel = ch
            try:
                stream = rpc.master_stub(ch).SendHeartbeat(self._heartbeat_iter())
                for resp in stream:
                    if self._hb_stop.is_set():
                        return
                    if resp.volume_size_limit:
                        self.volume_size_limit = int(resp.volume_size_limit)
                    if resp.leader and resp.leader != target:
                        # a follower answered: move to the leader
                        redirect = resp.leader
                        break
            except (grpc.RpcError, ValueError):
                # ValueError: stop() closed the channel under the stream
                pass
            finally:
                ch.close()
            if self._hb_stop.is_set():
                return
            if redirect:
                target = redirect
                continue  # reconnect at once
            # a broken stream, or a follower with no known leader: the next
            # configured master after a short pause
            fail_idx += 1
            target = self.master_addrs[fail_idx % len(self.master_addrs)]
            if self._hb_stop.wait(1.0):
                return
