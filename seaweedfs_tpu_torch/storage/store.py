"""Store: every volume and EC volume of one server, across disk locations.

Port of seaweedfs_tpu/storage/store.py (reference weed/storage/store.go:60,
disk_location.go / disk_location_ec.go: per-directory volume discovery
and EC siblings): needle writes, reads and deletes, volume and EC-volume
mounts (whole and per shard), falling back from a plain volume to an EC
one on reads. The EC volumes share one reconstructed-interval cache and
one device-queue scope per store. `ec_backend` names the backend of the
mounted EC volumes: cuda (the default, as every entry point of the
port), cpu (the native `CpuBackend`) or auto. On the card they
reconstruct through the plane-stack kernel (`gf2_apply_planes`), the
port's read-path kernel: the JAX package's TPU default is its
bit-major kernel, which gives the same bytes.
"""

from __future__ import annotations

import os
import re
import threading
from dataclasses import dataclass, field
from typing import Optional

from ..ec.context import ECError
from ..ec.device_queue import QueueScope, default_scope
from ..ec.ec_volume import EcVolume
from ..utils.chunk_cache import ChunkCache
from .needle import Needle
from .volume import NotFoundError, Volume, VolumeError

# Default byte budget for the STORE-LEVEL reconstructed-interval cache
# shared by every EC volume on this server (one budget, not one slice
# per volume): a degraded hot volume can claim the whole allowance
# while cold volumes cost nothing. 4x the old per-volume default.
DEFAULT_EC_INTERVAL_CACHE_BYTES = 64 << 20
# the port's backend names (the JAX package's are cpu|tpu|auto), each
# with the kernel impl its EC volumes read through
EC_BACKENDS = {"cuda": "cuda_planes", "cpu": "cuda", "auto": "cuda_planes"}


def durable_writes_default() -> bool:
    """SEAWEED_VOLUME_FSYNC=1 makes every needle append power-loss
    durable before it is acked (fsync — per needle, or amortized over a
    group-commit window when SEAWEED_VOLUME_GROUP_COMMIT_MS > 0).
    Default 0 keeps the historical contract: an acked write survives
    SIGKILL (kernel flush) but not power loss. Read live per write, so a
    change takes effect without restarting servers."""
    return os.environ.get("SEAWEED_VOLUME_FSYNC", "0") == "1"


_DAT_RE = re.compile(r"^(?:(?P<col>[^_]+)_)?(?P<vid>\d+)\.dat$")
_ECX_RE = re.compile(r"^(?:(?P<col>[^_]+)_)?(?P<vid>\d+)\.ecx$")
_VIF_RE = re.compile(r"^(?:(?P<col>[^_]+)_)?(?P<vid>\d+)\.vif$")


@dataclass
class DiskLocation:
    """One storage directory, tagged with a disk type (reference
    per-disk-type hdd/ssd DiskLocations, weed/storage/store.go)."""

    directory: str
    max_volume_count: int = 0  # 0 = unlimited
    needle_map_kind: str = "memory"
    disk_type: str = "hdd"
    volumes: dict[int, Volume] = field(default_factory=dict)
    ec_volumes: dict[int, EcVolume] = field(default_factory=dict)

    def load_existing(
        self,
        ec_backend: str = "cuda",
        remote_reader_factory=None,
        ec_interval_cache: "ChunkCache | None | str" = "default",
        ec_scheduler: "QueueScope | None" = None,
    ) -> None:
        """`ec_interval_cache`: a ChunkCache = the Store-level shared
        budget; None = cache disabled (Store budget 0); "default"
        (direct callers) = each EcVolume keeps its own private default
        cache, the pre-store-cache behavior. `ec_scheduler` is the
        Store's device-queue scope (placement + admission config) for
        the mounted volumes' degraded reads."""
        if ec_interval_cache == "default":
            cache_kwargs = {}
        else:
            # store-managed: share the one budget, or (None) no cache
            # at all — never a private per-volume slice
            cache_kwargs = {
                "interval_cache": ec_interval_cache,
                "interval_cache_bytes": 0,
            }
        if ec_scheduler is not None:
            cache_kwargs["scheduler"] = ec_scheduler
        for name in sorted(os.listdir(self.directory)):
            m = _DAT_RE.match(name) or _VIF_RE.match(name)
            # a .vif with no local .dat is a cold-tiered volume: it must
            # still mount (Volume opens it in remote mode)
            if m and int(m.group("vid")) not in self.volumes:
                vid = int(m.group("vid"))
                col = m.group("col") or ""
                try:
                    self.volumes[vid] = Volume(
                        self.directory, vid, collection=col, create=False,
                        needle_map_kind=self.needle_map_kind,
                    )
                except VolumeError:
                    continue
            m = _ECX_RE.match(name)
            if m:
                vid = int(m.group("vid"))
                col = m.group("col") or ""
                base = Volume.base_file_name(self.directory, col, vid)
                # only mount when at least one shard is local
                if any(
                    os.path.exists(base + f".ec{i:02d}") for i in range(32)
                ):
                    try:
                        self.ec_volumes[vid] = EcVolume(
                            self.directory, vid, collection=col,
                            backend=ec_backend, impl=EC_BACKENDS.get(ec_backend, "cuda"),
                            remote_reader=remote_reader_factory(vid, col)
                            if remote_reader_factory
                            else None,
                            **cache_kwargs,
                        )
                    except ECError:
                        continue


class Store:
    def __init__(
        self,
        directories: list[str],
        ip: str = "localhost",
        port: int = 0,
        public_url: str = "",
        ec_backend: str = "cuda",
        ec_remote_reader_factory=None,
        needle_map_kind: str = "memory",
        ec_interval_cache_bytes: int | None = None,
        ec_device_queue: bool | None = None,
        ec_queue_window: int | None = None,
        ec_queue_shares: dict | None = None,
        ec_placement: str | None = None,
        ec_scheduler: "QueueScope | None" = None,
        ec_tenant: str | None = None,
    ):
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        if ec_backend not in EC_BACKENDS:
            raise ECError(f"unknown EC backend {ec_backend!r} (want cuda|cpu|auto)")
        self.ec_backend = ec_backend
        self.ec_remote_reader_factory = ec_remote_reader_factory
        self.needle_map_kind = needle_map_kind
        # Per-STORE device-queue scheduler/placement scope, threaded to
        # every EC producer touching this store's volumes exactly like
        # the interval cache is: a multi-tenant process embedding two
        # Stores no longer has configure() last-caller-wins — each
        # tenant's knobs live in its own scope. All knobs None (and no
        # explicit scope) = the process-wide default scope, so a bare
        # Store keeps today's behavior. `ec_tenant` names the scope's
        # fairness/shed accounting domain on the shared residency
        # ledger: config isolation stays per scope, while the PHYSICAL
        # per-chip budget spans every tenant (ec/device_queue.py
        # ResidencyLedger).
        if ec_scheduler is not None:
            self.ec_scheduler = ec_scheduler
        elif any(
            v is not None
            for v in (
                ec_device_queue, ec_queue_window, ec_queue_shares,
                ec_placement, ec_tenant,
            )
        ):
            from ..ec.device_queue import DEFAULT_WINDOW

            self.ec_scheduler = QueueScope(
                enabled=True if ec_device_queue is None else ec_device_queue,
                window=(
                    DEFAULT_WINDOW if ec_queue_window is None
                    else ec_queue_window
                ),
                shares=ec_queue_shares,
                placement=ec_placement or "auto",
                tenant=ec_tenant,
            )
        else:
            self.ec_scheduler = default_scope()
        # ONE reconstructed-interval cache budget for the whole store,
        # shared by every EC volume (keys are volume-namespaced; see
        # EcVolume). None = the store default; 0 disables the
        # degraded-read cache entirely.
        if ec_interval_cache_bytes is None:
            ec_interval_cache_bytes = DEFAULT_EC_INTERVAL_CACHE_BYTES
        self.ec_interval_cache_bytes = ec_interval_cache_bytes
        self.ec_interval_cache: ChunkCache | None = (
            ChunkCache(ec_interval_cache_bytes, tier="ec_interval")
            if ec_interval_cache_bytes > 0
            else None
        )
        self._lock = threading.RLock()
        # a directory spec may carry a type tag: "/data1:ssd"
        # (reference -dir=/d1 -disk=ssd); bare paths default to hdd
        self.locations = []
        for d in directories:
            dtype = "hdd"
            if ":" in d:
                path, _, tag = d.rpartition(":")
                if tag and "/" not in tag:
                    d, dtype = path, tag
            self.locations.append(
                DiskLocation(
                    d, needle_map_kind=needle_map_kind, disk_type=dtype
                )
            )
        for loc in self.locations:
            os.makedirs(loc.directory, exist_ok=True)
            loc.load_existing(
                ec_backend, ec_remote_reader_factory, self.ec_interval_cache,
                ec_scheduler=self.ec_scheduler,
            )

    # ----------------------------------------------------------- lookup

    def find_volume(self, vid: int) -> Optional[Volume]:
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def find_ec_volume(self, vid: int) -> Optional[EcVolume]:
        for loc in self.locations:
            ev = loc.ec_volumes.get(vid)
            if ev is not None:
                return ev
        return None

    def location_of(self, vid: int) -> Optional[DiskLocation]:
        for loc in self.locations:
            if vid in loc.volumes:
                return loc
        return None

    def volume_ids(self) -> list[int]:
        return sorted(vid for loc in self.locations for vid in loc.volumes)

    def ec_volume_ids(self) -> list[int]:
        return sorted(vid for loc in self.locations for vid in loc.ec_volumes)

    # ----------------------------------------------------------- manage

    def _pick_location(self, disk_type: str = "") -> DiskLocation:
        if disk_type:
            typed = [l for l in self.locations if l.disk_type == disk_type]
            if not typed:
                raise VolumeError(f"no {disk_type!r} disk location here")
            return min(
                typed, key=lambda l: len(l.volumes) + len(l.ec_volumes)
            )
        return self._pick_any_location()

    def _pick_any_location(self) -> DiskLocation:
        # fewest volumes first (the reference scores free slots per disk)
        return min(self.locations, key=lambda l: len(l.volumes) + len(l.ec_volumes))

    def allocate_volume(
        self,
        vid: int,
        collection: str = "",
        replica_placement: str = "000",
        ttl: str = "",
        disk_type: str = "",
    ) -> Volume:
        with self._lock:
            if self.find_volume(vid) is not None:
                raise VolumeError(f"volume {vid} already exists")
            loc = self._pick_location(disk_type)
            v = Volume(
                loc.directory,
                vid,
                collection=collection,
                replica_placement=replica_placement,
                ttl=ttl,
                needle_map_kind=self.needle_map_kind,
            )
            loc.volumes[vid] = v
            return v

    def reap_expired_volumes(self) -> list[int]:
        """Delete TTL'd volumes idle past their window (reference
        periodic expired-volume reaping)."""
        with self._lock:
            expired = [
                vid
                for loc in self.locations
                for vid, v in loc.volumes.items()
                if v.is_expired()
            ]
        for vid in expired:
            try:
                self.delete_volume(vid)
            except NotFoundError:
                pass
        return expired

    def delete_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    v.close()
                    base = v.dat_path[:-4]
                    exts = [
                        ".dat", ".idx", ".cpd", ".cpx",
                        ".idx.ldb", ".idx.ldb-wal", ".idx.ldb-shm",
                    ]
                    # .vif/.ecsum describe the EC artifacts too: keep them
                    # while EC files coexist (reference Destroy behavior,
                    # volume_destroy_ec_vif_test.go).
                    has_ec = os.path.exists(base + ".ecx") or any(
                        os.path.exists(base + f".ec{i:02d}") for i in range(32)
                    )
                    if not has_ec:
                        exts += [".vif", ".ecsum"]
                    for ext in exts:
                        if os.path.exists(base + ext):
                            os.unlink(base + ext)
                    return
        raise NotFoundError(f"volume {vid} not found")

    def unmount_volume(self, vid: int) -> None:
        """Release a volume WITHOUT touching its files (reference
        volume.unmount): the inverse of mount_volume, for moving a
        volume's files or taking them offline for repair."""
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    v.close()
                    return
        raise NotFoundError(f"volume {vid} not found")

    def mount_volume(self, vid: int, collection: str = "") -> Volume:
        """Load an existing .dat/.idx pair from disk (post-copy/restart)."""
        with self._lock:
            v = self.find_volume(vid)
            if v is not None:
                return v
            for loc in self.locations:
                base = Volume.base_file_name(loc.directory, collection, vid)
                if os.path.exists(base + ".dat"):
                    v = Volume(
                        loc.directory, vid, collection=collection,
                        create=False, needle_map_kind=self.needle_map_kind,
                    )
                    loc.volumes[vid] = v
                    return v
        raise NotFoundError(f"no volume files for {vid} in any location")

    def mount_ec_volume(self, vid: int, collection: str = "") -> EcVolume:
        with self._lock:
            ev = self.find_ec_volume(vid)
            if ev is not None:
                ev.refresh_shards()  # pick up freshly copied shard files
                return ev
            for loc in self.locations:
                base = Volume.base_file_name(loc.directory, collection, vid)
                if os.path.exists(base + ".ecx"):
                    ev = EcVolume(
                        loc.directory,
                        vid,
                        collection,
                        backend=self.ec_backend,
                        impl=EC_BACKENDS[self.ec_backend],
                        remote_reader=self.ec_remote_reader_factory(vid, collection)
                        if self.ec_remote_reader_factory
                        else None,
                        interval_cache=self.ec_interval_cache,
                        interval_cache_bytes=0,
                        scheduler=self.ec_scheduler,
                    )
                    loc.ec_volumes[vid] = ev
                    return ev
        raise NotFoundError(f"ec volume {vid} not found in any location")

    def unmount_ec_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                ev = loc.ec_volumes.pop(vid, None)
                if ev is not None:
                    ev.close()
                    return

    def unmount_ec_shards(self, vid: int, shard_ids: list[int]) -> None:
        """Partial unmount: stop serving just these shards; the volume
        stays mounted while any shard remains."""
        if not shard_ids:
            return self.unmount_ec_volume(vid)
        with self._lock:
            for loc in self.locations:
                ev = loc.ec_volumes.get(vid)
                if ev is None:
                    continue
                if ev.unmount_shards(shard_ids) == 0:
                    loc.ec_volumes.pop(vid, None)
                    ev.close()
                return

    # --------------------------------------------------------------- io

    def write_needle(
        self, vid: int, n: Needle, fsync: bool | None = None
    ) -> int:
        """Append `n` to volume `vid`. `fsync=None` (the transports'
        default — neither the gRPC proto nor the HTTP upload carries a
        per-write durability flag) resolves to the store-wide
        :func:`durable_writes_default`; an explicit bool wins."""
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        if fsync is None:
            fsync = durable_writes_default()
        _, size = v.write_needle(n, fsync=fsync)
        return size

    def read_needle(
        self, vid: int, needle_id: int, cookie: Optional[int] = None
    ) -> Needle:
        v = self.find_volume(vid)
        if v is not None:
            return v.read_needle(needle_id, cookie)
        ev = self.find_ec_volume(vid)
        if ev is not None:
            return ev.read_needle(needle_id, cookie)
        raise NotFoundError(f"volume {vid} not found")

    def delete_needle(self, vid: int, needle_id: int) -> int:
        v = self.find_volume(vid)
        if v is not None:
            return v.delete_needle(needle_id)
        ev = self.find_ec_volume(vid)
        if ev is not None:
            return ev.delete_needle(needle_id)
        raise NotFoundError(f"volume {vid} not found")

    # ---------------------------------------------------------- status

    def status(self) -> dict:
        vols = []
        for loc in self.locations:
            for vid, v in sorted(loc.volumes.items()):
                st = v.stat()
                vols.append(
                    {
                        "id": vid,
                        "collection": st.collection,
                        "size": st.size,
                        "file_count": st.file_count,
                        "deleted_count": st.deleted_count,
                        "deleted_bytes": st.deleted_bytes,
                        "read_only": st.read_only,
                        "replica_placement": st.replica_placement,
                        "version": st.version,
                        "ttl": str(v.ttl),
                        "disk_type": loc.disk_type,
                    }
                )
        ecs = []
        for loc in self.locations:
            for vid, ev in sorted(loc.ec_volumes.items()):
                ecs.append(
                    {
                        "id": vid,
                        "collection": ev.collection,
                        "shards": ev.shard_ids,
                        "shard_size": ev.shard_size(),
                        "data_shards": ev.ctx.data_shards,
                        "parity_shards": ev.ctx.parity_shards,
                        "generation": ev.encode_ts_ns,
                    }
                )
        return {"volumes": vols, "ec_volumes": ecs}

    def close(self) -> None:
        with self._lock:
            for loc in self.locations:
                for v in loc.volumes.values():
                    v.close()
                for ev in loc.ec_volumes.values():
                    ev.close()
                loc.volumes.clear()
                loc.ec_volumes.clear()
