"""Volume: one .dat (superblock + appended needles) and its .idx.

Port of seaweedfs_tpu/storage/volume.py (reference weed/storage/volume.go,
volume_write.go:167 writeNeedle2, volume_read.go readNeedle,
volume_vacuum.go, volume_tier.go, volume_backup.go), byte for byte the
same files:
- append-only writes, 8-byte aligned records;
- overwrite = a new append and an index update (vacuum reclaims the old
  space); delete = a tombstone needle appended to the .dat and an .idx
  tombstone;
- the cookie checked on read; TTL expiry per needle and per volume;
- fsync per needle, or a group-commit window of concurrent durable
  writes (SEAWEED_VOLUME_GROUP_COMMIT_MS, `_GroupCommitter`);
- vacuum: live needles copied to .cpd/.cpx while writes continue, then
  an atomic commit behind a durable .cpm marker;
- cold tiering of a sealed .dat through storage/backend.py;
- the append-time scans of incremental copy (v3 `appendAtNs`).
The fault points keep the JAX package's names
(`volume.write.{before_fsync,after_fsync,before_ack}`).
"""

from __future__ import annotations

import contextlib
import os
import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional

from .needle import CURRENT_VERSION, FLAG_IS_TOMBSTONE, Needle, footer_size
from .ttl import TTL
from .. import faults
from .needle_map import MemoryNeedleMap
from .super_block import SUPER_BLOCK_SIZE, ReplicaPlacement, SuperBlock
from ..utils.fs import fsync_dir
from .types import (
    NEEDLE_CHECKSUM_SIZE,
    NEEDLE_HEADER_SIZE,
    NEEDLE_MAP_ENTRY_SIZE,
    NEEDLE_PADDING_SIZE,
    NeedleValue,
    actual_offset,
    padded_record_size,
    to_stored_offset,
)


def _group_commit_window_s() -> float:
    """SEAWEED_VOLUME_GROUP_COMMIT_MS as seconds (0 = fsync-per-needle,
    the default). Read live per write, so a change takes effect without
    reopening volumes."""
    try:
        ms = float(os.environ.get("SEAWEED_VOLUME_GROUP_COMMIT_MS", "0"))
    except ValueError:
        ms = 0.0
    return max(0.0, ms) / 1000.0


class _GroupCommitter:
    """Amortizes fsync over a bounded window of concurrent durable
    appends: writers append + kernel-flush under the volume lock, take
    a WINDOW TICKET, and block until one fsync covering their window
    completes — N writers inside one window cost one .dat fsync plus
    one needle-map flush instead of N of each.

    Ordering argument (why a ticket-w writer's bytes are always covered
    by window w's fsync): the ticket is read under the condition lock
    BEFORE the committer bumps ``_open_window`` (also under it), and the
    bump happens-before the fsync starts — so any append that took
    ticket w was handed to the kernel before window w's fsync began.
    The durability contract is unchanged from fsync-per-needle: an
    acked write has survived power loss; only the LATENCY of the ack is
    traded against fsync amortization (bounded by the window).

    A failed fsync fails every writer waiting on that window (and the
    error names the window, not a single needle — none of the cohort's
    bytes are certified durable)."""

    def __init__(self, volume: "Volume", window_s: float):
        self._volume = volume
        self._window_s = window_s
        self._cv = threading.Condition()
        self._open_window = 0
        self._completed = -1
        self._error_upto = -1
        self._last_error: BaseException | None = None
        self._pending = 0
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"group-commit-{volume.volume_id}",
        )
        self._thread.start()

    @property
    def window_s(self) -> float:
        return self._window_s

    def wait_durable(self) -> None:
        """Block the calling writer (which has already appended and
        kernel-flushed) until an fsync covering its bytes completes;
        raise if that fsync failed."""
        with self._cv:
            w = self._open_window
            self._pending += 1
            self._cv.notify_all()
            while self._completed < w:
                if self._stop and not self._thread.is_alive():
                    raise OSError(
                        f"volume {self._volume.volume_id} group "
                        "committer stopped with writes in flight"
                    )
                self._cv.wait(timeout=0.5)
            failed = self._error_upto >= w
            err = self._last_error if failed else None
        if failed:
            raise OSError(f"group commit fsync failed: {err!r}") from err

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending == 0 and not self._stop:
                    self._cv.wait(timeout=0.5)
                if self._pending == 0 and self._stop:
                    return
                stopping = self._stop
            # accumulate the window OUTSIDE any lock: appends keep
            # landing and taking tickets for this window meanwhile
            if not stopping and self._window_s > 0:
                time.sleep(self._window_s)
            with self._cv:
                w = self._open_window
                self._open_window += 1
                self._pending = 0
            err: BaseException | None = None
            try:
                self._volume._fsync_all()
            except OSError as e:
                err = e
            with self._cv:
                self._completed = w
                if err is not None:
                    self._error_upto = w
                    self._last_error = err
                self._cv.notify_all()

    def stop(self) -> None:
        """Drain pending writers with a final commit, then exit."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)


class VolumeError(Exception):
    pass


class NotFoundError(VolumeError):
    pass


class CookieMismatch(VolumeError):
    pass


class ReadOnlyError(VolumeError):
    pass


@dataclass
class VolumeStat:
    volume_id: int
    size: int
    file_count: int
    deleted_count: int
    deleted_bytes: int
    read_only: bool
    version: int
    collection: str
    replica_placement: str
    compaction_revision: int


class Volume:
    def __init__(
        self,
        directory: str,
        volume_id: int,
        collection: str = "",
        replica_placement: str = "000",
        version: int = CURRENT_VERSION,
        create: bool = True,
        ttl: str = "",
        needle_map_kind: str = "memory",
    ):
        """needle_map_kind: "memory" (reference default — replay .idx
        into RAM) or "sqlite" (LevelDB-class durable map: O(delta)
        reopen, bounded RAM; reference needle_map_leveldb.go)."""
        self.volume_id = volume_id
        self.collection = collection
        self.directory = directory
        self.needle_map_kind = needle_map_kind
        self.read_only = False
        # Poisoned by an unfinishable vacuum commit (half-swapped pair
        # on disk): all IO refuses until the volume is reopened, at
        # which point _reconcile_vacuum_marker heals from the durable
        # marker + temps.
        self.broken = False
        self._lock = threading.RLock()
        base = self.base_file_name(directory, collection, volume_id)
        self.dat_path = base + ".dat"
        self.idx_path = base + ".idx"
        self.vif_path = base + ".vif"
        self._remote = None  # BackendStorageFile when cold-tiered
        self._tiering = False  # a tier transfer is in flight
        self._vacuuming = False  # a live vacuum is in flight
        self._vacuum_ro_override = None  # set_read_only during vacuum
        self._reconcile_vacuum_marker(base)
        exists = os.path.exists(self.dat_path)
        if not exists:
            # a .vif with tier info and no local .dat = cold-tiered
            # volume: serve reads from the backend, .idx stays local
            from ..ec.volume_info import VolumeInfo

            vif = VolumeInfo.maybe_load(self.vif_path)
            if vif is not None and vif.tier_url:
                self._open_remote(vif)
                return
        if not exists and not create:
            raise VolumeError(f"volume {volume_id} not found at {self.dat_path}")
        if exists:
            with open(self.dat_path, "rb") as f:
                self.super_block = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
        else:
            self.super_block = SuperBlock(
                version=version,
                replica_placement=ReplicaPlacement.parse(replica_placement),
                ttl=TTL.parse(ttl).to_bytes(),
            )
            with open(self.dat_path, "wb") as f:
                f.write(self.super_block.to_bytes())
                f.flush()
                os.fsync(f.fileno())
        self.version = self.super_block.version
        self.ttl = TTL.from_bytes(self.super_block.ttl)
        # expiry clock for whole-volume reaping; reopen restarts the
        # window (conservative: never reaps early)
        self._last_write_ts = time.time()
        self.needle_map = self._new_map()
        self._dat = open(self.dat_path, "r+b")
        self._dat.seek(0, os.SEEK_END)
        self._append_at = self._pad_tail()
        self._committer: _GroupCommitter | None = None

    def _open_remote(self, vif) -> None:
        """Cold-tier mode: reads ride ranged GETs against the backend
        (reference volume_tier.go LoadRemoteFile)."""
        from .backend import open_backend_file

        self._remote = open_backend_file(vif.tier_url)
        self.super_block = SuperBlock.from_bytes(
            self._remote.read_at(0, SUPER_BLOCK_SIZE)
        )
        self.version = self.super_block.version
        self.ttl = TTL.from_bytes(self.super_block.ttl)
        self._last_write_ts = time.time()
        self.needle_map = self._new_map()
        self._dat = None
        self._append_at = vif.tier_size
        self._committer = None
        self.read_only = True  # tiered volumes are sealed

    @property
    def is_tiered(self) -> bool:
        return self._remote is not None

    def _new_map(self):
        if self.needle_map_kind == "sqlite":
            from .needle_map import SqliteNeedleMap

            return SqliteNeedleMap(
                self.idx_path,
                generation=self.super_block.compaction_revision,
            )
        return MemoryNeedleMap(self.idx_path)

    @staticmethod
    def base_file_name(directory: str, collection: str, volume_id: int) -> str:
        name = f"{collection}_{volume_id}" if collection else str(volume_id)
        return os.path.join(directory, name)

    @staticmethod
    def _reconcile_vacuum_marker(base: str) -> None:
        """Heal a crashed/failed vacuum commit (volume_vacuum.go:316).

        The commit marker `.cpm` is written (fsynced) after `.cpd`/`.cpx`
        are durable and before the swaps. Marker present => the commit
        point was passed: finish any remaining swap (idempotent; replace
        order in vacuum() is dat-then-idx, so `.cpd` can never be the
        one left behind alone). Marker absent => any temps are from a
        compaction that never reached its commit point: abort them.
        """
        marker, cpd, cpx = base + ".cpm", base + ".cpd", base + ".cpx"
        if os.path.exists(marker):
            if os.path.exists(cpd):
                os.replace(cpd, base + ".dat")
            if os.path.exists(cpx):
                os.replace(cpx, base + ".idx")
            fsync_dir(base + ".dat")
            os.unlink(marker)
            fsync_dir(marker)
        else:
            for p in (cpd, cpx):
                if os.path.exists(p):
                    os.unlink(p)

    def _pad_tail(self) -> int:
        """Ensure the append offset is 8-byte aligned (crash padding)."""
        end = self._dat.tell()
        rem = end % NEEDLE_PADDING_SIZE
        if rem:
            self._dat.write(b"\x00" * (NEEDLE_PADDING_SIZE - rem))
            end += NEEDLE_PADDING_SIZE - rem
        return end

    # ------------------------------------------------------------------ io

    def _group_committer(self) -> "_GroupCommitter | None":
        """The active group committer, (re)built lazily from the live
        SEAWEED_VOLUME_GROUP_COMMIT_MS value — a window change mid-life
        swaps the committer instead of
        freezing the open-time value. None when the window is 0
        (fsync-per-needle)."""
        w = _group_commit_window_s()
        c = self._committer
        if c is not None and c.window_s == w:
            return c
        with self._lock:
            c = self._committer
            if w <= 0:
                if c is not None:
                    self._committer = None
                    c.stop()
                return None
            if c is None or c.window_s != w:
                if c is not None:
                    c.stop()
                c = _GroupCommitter(self, w)
                self._committer = c
            return c

    def _fsync_all(self) -> None:
        """One fsync covering every append already handed to the
        kernel, with the needle-map idx flush riding the same window —
        the group committer's commit step."""
        with self._lock:
            if self._dat is not None:
                os.fsync(self._dat.fileno())
            self.needle_map.flush()

    def write_needle(self, n: Needle, fsync: bool = False) -> tuple[int, int]:
        """Append; returns (byte_offset, body_size).

        Reference behavior: volume_write.go:167 writeNeedle2 — dedupe
        identical overwrites is NOT done; every write appends.

        With fsync, the write is power-loss durable before returning:
        either its own fsync (window 0) or a group-commit window fsync
        covering it (SEAWEED_VOLUME_GROUP_COMMIT_MS > 0). The chaos
        kill points volume.write.{before_fsync,after_fsync,before_ack}
        bracket the durability step — a SIGKILL at any of them must
        leave the needle fully-acked-durable or clean-unacked, never
        acked-but-lost (tests/test_group_commit.py)."""
        committer = self._group_committer() if fsync else None
        with self._lock:
            self._check_not_broken()
            if self.read_only:
                raise ReadOnlyError(f"volume {self.volume_id} is read-only")
            if self.ttl and not n.last_modified:
                n.set_last_modified()  # expiry clock for TTL'd volumes
            raw = n.to_bytes(self.version)
            offset = self._append_at
            self._dat.seek(offset)
            self._dat.write(raw)
            faults.fire(
                "volume.write.before_fsync",
                volume=self.volume_id, needle=n.needle_id,
            )
            # ALWAYS hand the bytes to the kernel before acknowledging:
            # an acked write must survive SIGKILL of this process (page
            # cache). fsync additionally survives power loss.
            self._dat.flush()
            if fsync and committer is None:
                os.fsync(self._dat.fileno())
            self._append_at = offset + len(raw)
            self._last_write_ts = time.time()
            _, _, size = Needle.parse_header(raw)
            self.needle_map.put(n.needle_id, to_stored_offset(offset), size)
            if fsync and committer is None:
                # power-loss durability covers the INDEX entry too:
                # recovery replays only the .idx
                self.needle_map.flush()
        if fsync and committer is not None:
            # ticket wait OUTSIDE the volume lock: the window
            # accumulates sibling appends while this writer blocks
            committer.wait_durable()
        faults.fire(
            "volume.write.after_fsync",
            volume=self.volume_id, needle=n.needle_id,
        )
        faults.fire(
            "volume.write.before_ack",
            volume=self.volume_id, needle=n.needle_id,
        )
        return offset, size

    def _check_not_broken(self) -> None:
        if self.broken:
            raise VolumeError(
                f"volume {self.volume_id} has a pending vacuum commit; "
                "reopen to heal"
            )

    def read_needle(self, needle_id: int, cookie: Optional[int] = None) -> Needle:
        with self._lock:
            self._check_not_broken()
            nv = self.needle_map.get(needle_id)
            if nv is None or nv.is_deleted:
                raise NotFoundError(f"needle {needle_id:x} not found")
            remote = self._remote
            if remote is None:
                raw = self._pread_record(actual_offset(nv.offset), nv.size)
        if remote is not None:
            # cold-tier GET outside the lock: a 60s remote read must not
            # serialize every other read of this volume behind it (the
            # tiered volume is sealed, so the record can't move)
            raw = remote.read_at(
                actual_offset(nv.offset), self._record_disk_len(nv.size)
            )
        n = Needle.from_bytes(raw, self.version)
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatch(
                f"needle {needle_id:x} cookie mismatch"
            )
        if self.ttl and n.last_modified:
            if self.ttl.expired(n.last_modified, time.time()):
                raise NotFoundError(f"needle {needle_id:x} expired")
        return n

    def _pread_record(self, byte_offset: int, body_size: int) -> bytes:
        if self._dat is None:
            return self._remote.read_at(
                byte_offset, self._record_disk_len(body_size)
            )
        self._dat.seek(byte_offset)
        return self._dat.read(self._record_disk_len(body_size))

    def delete_needle(self, needle_id: int, tombstone: Needle | None = None) -> int:
        """Tombstone both .dat (empty needle append) and .idx.

        `tombstone` lets a tail follower append the SOURCE's tombstone
        record verbatim (its appendAtNs included) so a resynced replica
        stays bit-identical to the source."""
        with self._lock:
            self._check_not_broken()
            if self.read_only:
                raise ReadOnlyError(f"volume {self.volume_id} is read-only")
            nv = self.needle_map.get(needle_id)
            if nv is None or nv.is_deleted:
                return 0
            tomb = tombstone or Needle(cookie=0, needle_id=needle_id)
            tomb.flags |= FLAG_IS_TOMBSTONE
            raw = tomb.to_bytes(self.version)
            self._dat.seek(self._append_at)
            self._dat.write(raw)
            self._dat.flush()  # acked deletes survive SIGKILL too
            self._append_at += len(raw)
            return self.needle_map.delete(needle_id)

    def locate_payload(
        self, needle_id: int, cookie: Optional[int] = None
    ) -> tuple[str, int, int, int]:
        """(dat_path, absolute_offset, size, crc32c) of a needle's DATA
        bytes — the control-plane half of the bulk-read fast path (the
        RDMA sidecar analog): callers pull the range over the native
        Unix-socket server and MUST verify the crc (the sidecar serves
        raw ranges with no lock, so a vacuum commit between locate and
        read, or a replayed locate against the wrong host, surfaces as
        a checksum mismatch instead of silent wrong bytes). Tiered and
        TTL'd volumes raise — they need the locked, validated path."""
        with self._lock:
            self._check_not_broken()
            if self._remote is not None:
                raise VolumeError(
                    f"volume {self.volume_id} is cold-tiered"
                )
            if self.ttl:
                # per-needle expiry lives in the body's optional fields;
                # the HTTP path enforces it, so TTL volumes stay there
                raise VolumeError(
                    f"volume {self.volume_id} is TTL'd; use the HTTP path"
                )
            nv = self.needle_map.get(needle_id)
            if nv is None or nv.is_deleted:
                raise NotFoundError(f"needle {needle_id:x} not found")
            base = actual_offset(nv.offset)
            # header(16) + dataSize(4) prefix locates the payload
            self._dat.seek(base)
            head = self._dat.read(NEEDLE_HEADER_SIZE + 4)
            n_cookie, _nid, body_size = Needle.parse_header(head)
            crc = 0
            if body_size > 0:
                # the footer's crc32c sits right after the body
                self._dat.seek(base + NEEDLE_HEADER_SIZE + body_size)
                (crc,) = struct.unpack(">I", self._dat.read(4))
        if cookie is not None and n_cookie != cookie:
            raise CookieMismatch(f"needle {needle_id:x} cookie mismatch")
        if body_size == 0:
            return self.dat_path, base + NEEDLE_HEADER_SIZE, 0, 0
        (data_size,) = struct.unpack(
            ">I", head[NEEDLE_HEADER_SIZE : NEEDLE_HEADER_SIZE + 4]
        )
        return self.dat_path, base + NEEDLE_HEADER_SIZE + 4, data_size, crc

    def has_needle(self, needle_id: int) -> bool:
        nv = self.needle_map.get(needle_id)
        return nv is not None and not nv.is_deleted

    # ---------------------------------------------------------------- state

    @property
    def size(self) -> int:
        return self._append_at

    def content_size(self) -> int:
        return self._append_at - SUPER_BLOCK_SIZE

    def set_replica_placement(self, replication: str) -> None:
        """Rewrite the superblock's replica placement in place
        (reference volume_super_block.go MaybeWriteSuperBlock /
        volume.configure.replication)."""
        with self._lock:
            self._check_not_broken()
            rp = ReplicaPlacement.parse(replication)
            self.super_block.replica_placement = rp
            self._dat.seek(0)
            self._dat.write(self.super_block.to_bytes())
            self._dat.flush()
            os.fsync(self._dat.fileno())
            self._dat.seek(self._append_at)

    def set_read_only(self, ro: bool = True) -> None:
        with self._lock:
            if self._remote is not None and not ro:
                raise VolumeError(
                    f"volume {self.volume_id} is cold-tiered; "
                    "tier.download before making it writable"
                )
            if self._vacuuming:
                # remember the operator's intent: vacuum's finally
                # restores this instead of the pre-vacuum state
                self._vacuum_ro_override = ro
                if not ro:
                    # never un-freeze mid-vacuum: vacuum may be in its
                    # final frozen drain, and a write acked after its
                    # last .idx-tail check would be discarded by the
                    # .cpd/.cpx swap; the override applies on finish
                    return
            self.flush()
            self.read_only = ro

    def stat(self) -> VolumeStat:
        return VolumeStat(
            volume_id=self.volume_id,
            size=self.size,
            file_count=self.needle_map.file_counter,
            deleted_count=self.needle_map.deleted_counter,
            deleted_bytes=self.needle_map.deleted_bytes,
            read_only=self.read_only,
            version=self.version,
            collection=self.collection,
            replica_placement=str(self.super_block.replica_placement),
            compaction_revision=self.super_block.compaction_revision,
        )

    def is_expired(self) -> bool:
        """Whole-volume expiry: TTL'd and idle past the TTL window
        (reference expired() reaping of sealed TTL buckets). Uses the
        in-memory last-write clock — file mtime lags buffered writes."""
        if not self.ttl:
            return False
        return self._last_write_ts + self.ttl.seconds < time.time()

    def garbage_ratio(self) -> float:
        cs = self.content_size()
        if cs <= 0:
            return 0.0
        return self.needle_map.deleted_bytes / cs

    def flush(self) -> None:
        with self._lock:
            if self._dat is not None:
                self._dat.flush()
                os.fsync(self._dat.fileno())
            self.needle_map.flush()

    def close(self) -> None:
        # stop the committer BEFORE taking the volume lock: its commit
        # step takes that lock, and a stop() under it would deadlock
        c = self._committer
        if c is not None:
            self._committer = None
            c.stop()
        with self._lock:
            self.flush()
            if self._dat is not None:
                self._dat.close()
            if self._remote is not None:
                self._remote.close()
            self.needle_map.close()

    # -------------------------------------------------------------- tiering

    def tier_upload(self, dest_url: str, keep_local: bool = False) -> int:
        """Move the sealed .dat to a cold backend; the .idx stays local
        (reference volume_grpc_tier_upload.go). Returns bytes moved.

        The network transfer runs OUTSIDE the volume lock — the volume
        is sealed, so the .dat cannot change underneath it, and reads
        keep flowing during a potentially hour-long upload."""
        from ..ec.volume_info import VolumeInfo
        from .backend import put_object

        with self._lock:
            self._check_not_broken()
            if self._tiering:
                raise VolumeError(
                    f"volume {self.volume_id}: tier transfer in progress"
                )
            if self._vacuuming:
                raise VolumeError(
                    f"volume {self.volume_id}: vacuum in progress"
                )
            if self._remote is not None:
                raise VolumeError(f"volume {self.volume_id} already tiered")
            if not self.read_only:
                raise VolumeError(
                    f"volume {self.volume_id} must be readonly to tier"
                )
            self._tiering = True
            self.flush()
            size = self._append_at
        try:
            with open(self.dat_path, "rb") as f:  # unlocked: sealed volume
                put_object(dest_url, f, size)
            with self._lock:
                if self._remote is not None or not self.read_only:
                    raise VolumeError(
                        f"volume {self.volume_id} changed state during tiering"
                    )
                vif = VolumeInfo.maybe_load(self.vif_path) or VolumeInfo(
                    version=self.version
                )
                vif.tier_url = dest_url
                vif.tier_size = size
                vif.save(self.vif_path)
                if not keep_local:
                    self._dat.close()
                    os.unlink(self.dat_path)
                    fsync_dir(self.dat_path)
                    self.needle_map.close()
                    self._open_remote(vif)
                return size
        finally:
            with self._lock:
                self._tiering = False

    def tier_download(self, delete_remote: bool = False) -> int:
        """Bring a cold-tiered .dat back to local disk (reference
        volume_grpc_tier_download.go). Returns bytes fetched. The fetch
        streams outside the lock (remote reads keep serving); only the
        handle switchover is locked."""
        from ..ec.volume_info import VolumeInfo
        from .backend import delete_object, fetch_object

        with self._lock:
            if self._tiering:
                raise VolumeError(
                    f"volume {self.volume_id}: tier transfer in progress"
                )
            if self._vacuuming:
                raise VolumeError(
                    f"volume {self.volume_id}: vacuum in progress"
                )
            if self._remote is None:
                raise VolumeError(f"volume {self.volume_id} is not tiered")
            self._tiering = True
            vif = VolumeInfo.maybe_load(self.vif_path)
            url = vif.tier_url if vif else self._remote.name
        try:
            n = fetch_object(url, self.dat_path)  # unlocked: cold object sealed
            if vif and vif.tier_size and n != vif.tier_size:
                os.unlink(self.dat_path)
                raise VolumeError(
                    f"cold-tier download size mismatch: {n} != {vif.tier_size}"
                )
            with self._lock:
                # drop the reference without closing: an in-flight
                # unlocked cold read may still be reading from it
                self._remote = None
                if vif:
                    vif.tier_url, vif.tier_size = "", 0
                    vif.save(self.vif_path)
                self.needle_map.close()
                self.needle_map = self._new_map()
                self._dat = open(self.dat_path, "r+b")
                self._dat.seek(0, os.SEEK_END)
                self._append_at = self._pad_tail()
        finally:
            with self._lock:
                self._tiering = False
        if delete_remote:
            delete_object(url)
        return n

    # --------------------------------------------------------------- vacuum

    def vacuum(self) -> int:
        """Compact: copy live needles to .cpd/.cpx, then atomically commit.

        Returns bytes reclaimed. Mirrors volume_vacuum.go:74
        CompactByVolumeData + :162 CommitCompact: the volume stays
        WRITABLE during the bulk copy; writes that land meanwhile are
        caught up from the .idx journal tail (makeupDiff), with a brief
        freeze only for the final sliver + the atomic swap.
        """
        with self._lock:
            self._check_not_broken()
            if self._remote is not None:
                raise VolumeError(
                    f"volume {self.volume_id} is cold-tiered; "
                    "tier.download before vacuuming"
                )
            if os.path.exists(self.dat_path[:-4] + ".cpm"):
                # A durable commit marker means an earlier vacuum's swap
                # is pending: truncating .cpd/.cpx now would let a crash
                # reconcile partial garbage over the live pair.
                raise VolumeError(
                    f"volume {self.volume_id} has a pending vacuum "
                    "commit; reopen to heal before vacuuming"
                )
            if self._vacuuming:
                raise VolumeError(
                    f"volume {self.volume_id} vacuum already running"
                )
            if self._tiering:
                # vacuum no longer holds the lock for its duration, so
                # it must exclude tier transfers explicitly (and they
                # check _vacuuming symmetrically)
                raise VolumeError(
                    f"volume {self.volume_id}: tier transfer in progress"
                )
            self._vacuuming = True
            self._vacuum_ro_override = None  # set_read_only during vacuum
            was_ro = self.read_only
            # snapshot the live set + journal watermark while locked;
            # the bulk copy then runs WITHOUT the lock and writes keep
            # flowing (reference CompactByVolumeData : the volume stays
            # writable; CommitCompact catches up from the .idx tail)
            self.flush()
            # sqlite maps offer a memory-bounded paginated scan; the
            # memory map is O(live needles) resident anyway, so a list
            # snapshot adds nothing to its footprint
            snap_fn = getattr(self.needle_map, "snapshot_batches", None)
            snapshot = (
                snap_fn() if snap_fn else list(self.needle_map.ascending_visit())
            )
            idx_watermark = os.path.getsize(self.idx_path)
            old_size = self.size
            new_sb = SuperBlock(
                version=self.super_block.version,
                replica_placement=self.super_block.replica_placement,
                ttl=self.super_block.ttl,
                compaction_revision=self.super_block.compaction_revision + 1,
            )
        cpd = self.dat_path[:-4] + ".cpd"
        cpx = self.idx_path[:-4] + ".cpx"
        marker = self.dat_path[:-4] + ".cpm"
        try:
            rfd = os.open(self.dat_path, os.O_RDONLY)
            frozen = False
            try:
                with open(cpd, "wb") as df, open(cpx, "wb") as xf:
                    df.write(new_sb.to_bytes())
                    pos = df.tell()
                    for nv in snapshot:  # phase 1: unlocked bulk copy
                        rec_len = self._record_disk_len(nv.size)
                        raw = os.pread(rfd, rec_len, actual_offset(nv.offset))
                        df.write(raw)
                        xf.write(
                            NeedleValue(
                                nv.needle_id, to_stored_offset(pos), nv.size
                            ).to_bytes()
                        )
                        pos += rec_len
                    # phase 2: replay the .idx tail written during the
                    # copy (volume_vacuum.go makeupDiff catch-up); the
                    # volume stays writable until the delta is small,
                    # then freezes only for the final sliver
                    rounds = 0
                    while True:
                        idx_end = os.path.getsize(self.idx_path)
                        if idx_end == idx_watermark:
                            if frozen:
                                break
                            with self._lock:
                                self.flush()
                                self.read_only = True
                            frozen = True
                            continue
                        rounds += 1
                        if not frozen and (
                            idx_end - idx_watermark < 4096 or rounds > 16
                        ):
                            # small remaining delta (or a firehose
                            # writer): freeze, drain, finish
                            with self._lock:
                                self.flush()
                                self.read_only = True
                            frozen = True
                            idx_end = os.path.getsize(self.idx_path)
                        pos, idx_watermark = self._replay_idx_tail(
                            rfd, idx_watermark, idx_end, df, xf, pos
                        )
                    df.flush()
                    os.fsync(df.fileno())
                    xf.flush()
                    os.fsync(xf.fileno())
            except BaseException:
                for tmp in (cpd, cpx):
                    with contextlib.suppress(OSError):
                        os.unlink(tmp)
                raise
            finally:
                os.close(rfd)
            with self._lock:
                # Commit point: once the marker is durable, the swap is
                # completable by _reconcile_vacuum_marker (here on
                # failure, or at next open after a crash). The closes
                # are best-effort — the compacted pair no longer
                # depends on the old handles.
                with open(marker, "wb") as mf:
                    mf.flush()
                    os.fsync(mf.fileno())
                fsync_dir(marker)
                with contextlib.suppress(OSError):
                    self._dat.close()
                with contextlib.suppress(OSError):
                    self.needle_map.close()
                try:
                    os.replace(cpd, self.dat_path)
                    os.replace(cpx, self.idx_path)
                    fsync_dir(self.dat_path)
                except OSError:
                    if os.path.exists(cpd):
                        # .dat never swapped: the old pair is intact and
                        # consistent — roll back and keep serving it.
                        # The unlinks MUST be made durable: the marker
                        # was fsync'd durable before the swap, so a
                        # crash that resurrects it (+ temps) would make
                        # the next open reconcile the stale compacted
                        # pair over acked post-rollback writes.
                        for p in (cpd, cpx, marker):
                            with contextlib.suppress(OSError):
                                os.unlink(p)
                        fsync_dir(marker)
                        self.needle_map = self._new_map()
                        self._dat = open(self.dat_path, "r+b")
                        self._dat.seek(0, os.SEEK_END)
                        self._append_at = self._pad_tail()
                        raise
                    # .dat swapped: rollback is impossible, so the
                    # commit MUST complete. Retry via the reconcile
                    # path; if the disk still refuses, the marker +
                    # temps stay behind and the next open heals — do
                    # not reopen a diverged new-.dat/old-.idx pair,
                    # and poison the object so no IO (or re-vacuum,
                    # which would truncate the committed .cpx) can
                    # touch it.
                    try:
                        self._reconcile_vacuum_marker(self.dat_path[:-4])
                    except OSError:
                        self.broken = True
                        raise
                else:
                    with contextlib.suppress(OSError):
                        os.unlink(marker)
                        fsync_dir(marker)
                self.super_block = new_sb
                self.needle_map = self._new_map()
                self._dat = open(self.dat_path, "r+b")
                self._dat.seek(0, os.SEEK_END)
                self._append_at = self._pad_tail()
                # writes accepted during the live vacuum inflate the
                # new file; never report negative reclaim
                return max(old_size - self.size, 0)
        finally:
            with self._lock:
                self._vacuuming = False
                if self.broken:
                    # a poisoned volume stays read-only until reopened
                    self.read_only = True
                elif self._vacuum_ro_override is not None:
                    # an operator's set_read_only during the unlocked
                    # compaction window must not be clobbered
                    self.read_only = self._vacuum_ro_override
                else:
                    self.read_only = was_ro
                self._vacuum_ro_override = None

    def _replay_idx_tail(
        self, rfd: int, start: int, end: int, df, xf, pos: int
    ) -> tuple[int, int]:
        """Apply .idx entries in [start, end) to the compacted pair:
        puts copy their .dat record, tombstones append a tombstone
        needle. Returns (new cpd position, consumed idx offset) —
        a torn trailing entry is left for the next round."""
        from .types import NEEDLE_MAP_ENTRY_SIZE, TOMBSTONE_FILE_SIZE

        with open(self.idx_path, "rb") as f:
            f.seek(start)
            raw = f.read(end - start)
        usable = len(raw) - len(raw) % NEEDLE_MAP_ENTRY_SIZE
        for i in range(0, usable, NEEDLE_MAP_ENTRY_SIZE):
            nv = NeedleValue.from_bytes(raw[i : i + NEEDLE_MAP_ENTRY_SIZE])
            if nv.is_deleted:
                tomb = Needle(cookie=0, needle_id=nv.needle_id).to_bytes(
                    self.version
                )
                df.write(tomb)
                pos += len(tomb)
                xf.write(
                    NeedleValue(
                        nv.needle_id, 0, TOMBSTONE_FILE_SIZE
                    ).to_bytes()
                )
            else:
                rec_len = self._record_disk_len(nv.size)
                data = os.pread(rfd, rec_len, actual_offset(nv.offset))
                df.write(data)
                xf.write(
                    NeedleValue(
                        nv.needle_id, to_stored_offset(pos), nv.size
                    ).to_bytes()
                )
                pos += rec_len
        return pos, start + usable

    def _record_disk_len(self, body_size: int) -> int:
        return padded_record_size(
            NEEDLE_HEADER_SIZE + body_size + footer_size(self.version)
        )

    # ------------------------------------------- incremental follow/tail
    # Reference: weed/storage/volume_backup.go (findLastAppendAtNs,
    # BinarySearchByAppendAtNs) — the .idx is the search array; each
    # probe reads the record's v3 footer appendAtNs from the .dat.
    # Divergence from the reference (deliberate): the search pins the
    # LAST put <= since and then walks .dat records forward, so
    # tombstones — which live between puts and carry their own ts —
    # are never skipped; the reference starts at the first put > since
    # and silently loses any delete not followed by a newer put.

    def _require_v3(self) -> None:
        if self.version != 3:
            raise VolumeError(
                f"volume {self.volume_id} is v{self.version}: "
                "tail/incremental sync needs the v3 appendAtNs footer"
            )

    def _read_append_at_ns_at(self, byte_offset: int) -> int:
        """appendAtNs of the record starting at `byte_offset` (v3)."""
        header = self._pread_raw(byte_offset, NEEDLE_HEADER_SIZE)
        _, _, body_size = Needle.parse_header(header)
        ts_off = (
            byte_offset + NEEDLE_HEADER_SIZE + body_size + NEEDLE_CHECKSUM_SIZE
        )
        raw = self._pread_raw(ts_off, 8)
        return struct.unpack(">Q", raw)[0]

    def _pread_raw(self, offset: int, length: int) -> bytes:
        with self._lock:
            self._dat.seek(offset)
            got = self._dat.read(length)
        if len(got) != length:
            raise VolumeError(
                f"short read at {offset} ({len(got)}/{length})"
            )
        return got

    def _live_idx_entries(self) -> list[NeedleValue]:
        """All PUT entries of the .idx in append order (tombstone
        entries have offset 0 — their .dat record is located by the
        forward walk instead). Flushes the map so the journal is
        current."""
        self.needle_map.flush()
        out: list[NeedleValue] = []
        with open(self.idx_path, "rb") as f:
            while True:
                b = f.read(NEEDLE_MAP_ENTRY_SIZE)
                if len(b) < NEEDLE_MAP_ENTRY_SIZE:
                    break
                nv = NeedleValue.from_bytes(b)
                if nv.offset != 0 and not nv.is_deleted:
                    out.append(nv)
        return out

    def _append_end(self) -> int:
        with self._lock:
            self._dat.flush()
            return self._append_at

    def _walk_start_for(self, since_ns: int) -> int:
        """.dat offset of the last PUT with appendAtNs <= since_ns (or
        the superblock end): walking forward from here visits every
        record — put or tombstone — newer than since_ns."""
        entries = self._live_idx_entries()
        lo, hi = 0, len(entries)
        while lo < hi:
            mid = (lo + hi) // 2
            ts = self._read_append_at_ns_at(actual_offset(entries[mid].offset))
            if ts > since_ns:
                hi = mid
            else:
                lo = mid + 1
        if lo == 0:
            return SUPER_BLOCK_SIZE
        return actual_offset(entries[lo - 1].offset)

    def last_append_at_ns(self) -> int:
        """appendAtNs of the newest record — tombstones included, so a
        follower's resume point never re-spans its own trailing
        deletes; 0 for an empty volume."""
        self._require_v3()
        entries = self._live_idx_entries()
        start = (
            actual_offset(entries[-1].offset) if entries else SUPER_BLOCK_SIZE
        )
        last = 0
        for _n, _raw, ts in self.scan_records_between(start, self._append_end()):
            last = max(last, ts)
        return last

    def offset_after_ns(self, since_ns: int) -> int:
        """First .dat byte offset whose record has appendAtNs >
        since_ns (== the append end when nothing is newer). This is the
        byte-level resume point for VolumeIncrementalCopy."""
        self._require_v3()
        end = self._append_end()
        offset = self._walk_start_for(since_ns)
        for _n, raw, ts in self.scan_records_between(offset, end):
            if ts > since_ns:
                return offset
            offset += padded_record_size(len(raw))
        return end

    def scan_records_between(self, start: int, end: int):
        """Yield (needle, record_without_padding, append_at_ns) for
        every record in [start, end) — puts AND tombstones. Reads use
        an independent fd so a concurrent writer can't move this scan's
        file position; `end` must be a snapshot of _append_end()."""
        fd = os.open(self.dat_path, os.O_RDONLY)
        try:
            offset = start
            while offset + NEEDLE_HEADER_SIZE <= end:
                header = os.pread(fd, NEEDLE_HEADER_SIZE, offset)
                if len(header) < NEEDLE_HEADER_SIZE:
                    return
                _, _, body_size = Needle.parse_header(header)
                rec_len = self._record_disk_len(body_size)
                if offset + rec_len > end:
                    return  # racing append: stop at the snapshot
                raw = os.pread(fd, rec_len, offset)
                n = Needle.from_bytes(raw, self.version)
                unpadded = NEEDLE_HEADER_SIZE + body_size + footer_size(
                    self.version
                )
                yield n, raw[:unpadded], n.append_at_ns
                offset += rec_len
        finally:
            os.close(fd)

    def scan_raw_since(self, since_ns: int):
        """Yield (needle, record_without_padding, append_at_ns) for
        every record appended after since_ns, up to a stable size
        snapshot."""
        self._require_v3()
        end = self._append_end()
        start = self._walk_start_for(since_ns)
        for n, raw, ts in self.scan_records_between(start, end):
            if ts > since_ns:
                yield n, raw, ts
