"""EcVolume: serve needle reads from mounted EC shards, with on-the-fly
Reed-Solomon recovery of the intervals whose shard is absent.

Port of seaweedfs_tpu/ec/ec_volume.py (reference
weed/storage/erasure_coding/ec_volume.go: sealed .ecx binary search, the
.ecj deletion journal; store_ec.go ReadEcShardNeedle: recover by
reconstruction). What it keeps: the CRC-error retry through verified
reconstruction; sibling sources and the reconstructed output verified
against the .ecsum leaves (fail closed); the generation-keyed interval
cache with singleflight; single-shot and staged reconstruction on the
backend; the .ecj tombstones; shard unmount, reopen and refresh; the
`bytes_read` and `bytes_reconstructed` counters; repair-journal recovery
before any shard fd opens (ec/repair_journal.py); the
`ec.volume.shard_read` fault point around the shard pread; sibling reads
through the native plane (ec/native_io.py) and the parallel remote
sibling fetch; the `.heat` sidecar, which carries `bytes_read` and
`bytes_reconstructed` across a close and a remount (JSON keys `gen`,
`read_bytes`, `reconstructed_bytes`, fenced by the encode generation,
the JAX package's file); the flight recorder's `ec.degraded_read` span
per reconstructed interval (stages `sibling_read`, `crc_verify`,
`reconstruct`, `admission_wait`, or the staged pipeline's; events
`cache_hit` and `singleflight_wait`); both reconstruction paths as
foreground clients of the per-chip scheduler (ec/device_queue.py): the
single-shot one under one-shot `admission`, the staged one as a placed
foreground stream, under the volume's `scheduler` (a QueueScope; None =
the process-wide default).

`stage_seconds` accumulates the wall time of every degraded read's
stages: "sibling_read" (preads of the sources), "crc_verify" (sidecar
checks of sources and output) and "reconstruct" (the backend call, whose
own `stage_seconds` splits it into pin, h2d, kernel and d2h).
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import struct
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Optional

import numpy as np

from .. import faults
from ..storage.needle import CrcError, Needle
from ..storage.needle_map import SortedFileNeedleMap
from ..storage.types import actual_offset
from ..utils import trace
from ..utils.chunk_cache import ChunkCache
from . import native_io
from .backend import _BackendBase, _decode_coeffs, get_backend
from .bitrot import BitrotError, BitrotProtection
from .context import DEFAULT_EC_CONTEXT, QUARANTINE_SUFFIX, ECContext, ECError
from .decoder import record_actual_size
from .device_queue import admission, batch_cost, resolve_scope
from .locate import locate_data
from .pipeline import run_staged_apply
from .repair_journal import recover_volume_journals
from .volume_info import VolumeInfo

log = logging.getLogger(__name__)

# Column-batch width for staged reconstruction: extents at least two
# batches wide go through the backend's staged apply (H2D, kernel and
# D2H overlapped per batch); smaller extents, the needle-read shape,
# take one single-shot reconstruct.
STAGED_RECOVERY_BATCH = 4 << 20

# Byte budget of the verified reconstructed-interval cache.
DEFAULT_INTERVAL_CACHE_BYTES = 16 << 20

READ_STAGES = ("sibling_read", "crc_verify", "reconstruct")


class EcNotFoundError(ECError):
    pass


class EcCookieMismatch(ECError):
    pass


def base_file_name(directory: str, collection: str, volume_id: int) -> str:
    """<dir>/<collection>_<vid>, or <dir>/<vid> without a collection
    (seaweedfs_tpu/storage/volume.py Volume.base_file_name)."""
    name = f"{collection}_{volume_id}" if collection else str(volume_id)
    return os.path.join(directory, name)


class EcVolume:
    def __init__(
        self,
        directory: str,
        volume_id: int,
        collection: str = "",
        backend: _BackendBase | str = "cuda",
        impl: str = "cuda",
        remote_reader=None,
        interval_cache_bytes: int = DEFAULT_INTERVAL_CACHE_BYTES,
        interval_cache: ChunkCache | None = None,
        scheduler=None,
    ):
        """`backend` is a backend object (`TorchBackend`, `CpuBackend`), or
        a name that the port's `get_backend(name, k, m, impl=impl)`
        resolves: "cuda" (the card, through kernel `impl`) or "cpu" (the
        native `CpuBackend`, which takes no impl).

        remote_reader(shard_id, offset, size, generation) -> bytes|None
        lets a cluster layer serve shards held by peers (the generation
        is the EncodeTsNs fence); local reconstruction stays the
        fallback.

        `interval_cache_bytes` bounds the LRU of verified reconstructed
        extents (0 disables); `interval_cache` hands in a cache shared
        by several volumes (keys are volume-namespaced, and close() drops
        only this volume's extents).

        `scheduler` is the QueueScope whose admission and placement the
        degraded reconstructions run under (None = the process-wide
        default scope)."""
        self.volume_id = volume_id
        self.collection = collection
        self.base = base_file_name(directory, collection, volume_id)
        self._lock = threading.RLock()

        vi = VolumeInfo.maybe_load(self.base + ".vif") or VolumeInfo()
        self.version = vi.version
        self.ctx: ECContext = vi.ec_ctx or DEFAULT_EC_CONTEXT
        self.encode_ts_ns = vi.encode_ts_ns  # generation fence

        self._ecx = SortedFileNeedleMap(self.base + ".ecx")
        self._deleted: set[int] = set()
        self._ecj = open(self.base + ".ecj", "ab+")
        self._ecj.seek(0)
        while len(b := self._ecj.read(8)) == 8:
            self._deleted.add(struct.unpack(">Q", b)[0])

        # Crash recovery BEFORE serving: a pending <shard>.repair journal
        # means a leaf repair was interrupted mid-protocol; replay (or
        # roll back) it now, so no fd ever opens over a half-applied
        # patch. What it did stays in `journal_recovery` (None when it
        # failed: a failed recovery is logged and never blocks a mount).
        self.journal_recovery: dict | None = None
        try:
            self.journal_recovery = recover_volume_journals(self.base, self.ctx)
        except Exception as e:
            log.error("repair-journal recovery for %s failed: %s", self.base, e)

        self.shard_fds: dict[int, int] = {}
        self._shard_size = 0
        for i in range(self.ctx.total):
            p = self.base + self.ctx.to_ext(i)
            if os.path.exists(p):
                self.shard_fds[i] = os.open(p, os.O_RDONLY)
                self._shard_size = os.path.getsize(p)

        # Layout from the encode-time .dat size; a .vif-less volume falls
        # back to the reference's shard-size-1 disambiguation.
        if vi.dat_file_size > 0:
            self._locate_shard_size = vi.dat_file_size // self.ctx.data_shards
        else:
            self._locate_shard_size = max(self._shard_size - 1, 0)

        if isinstance(backend, str):
            backend = get_backend(
                backend, self.ctx.data_shards, self.ctx.parity_shards, impl=impl
            )
        self.backend = backend
        self.scheduler = scheduler
        self.remote_reader = remote_reader
        # .ecsum, loaded at the first degraded read; False = not loaded
        # yet (absence is probed again on every degraded read, so a
        # sidecar that lands late arms verification).
        self._prot: BitrotProtection | bool = False
        # Verified-reconstruction LRU; None = disabled. Keys are
        # "<ns><sid>:<gen>:<lo>:<hi>": each shard id has its own
        # generation, bumped on its unmount/reopen, so a build racing an
        # invalidation parks its bytes under a key no reader looks up.
        self._cache_ns = f"{collection}_{volume_id}:" if collection else f"{volume_id}:"
        self._shared_cache = interval_cache is not None
        if interval_cache is not None:
            self.interval_cache: ChunkCache | None = interval_cache
        else:
            self.interval_cache = (
                ChunkCache(interval_cache_bytes, tier="ec_interval")
                if interval_cache_bytes > 0
                else None
            )
        self._shard_gen: dict[int, int] = {}
        self._coeff_cache: dict[tuple, np.ndarray] = {}
        # bytes pread or fetched to serve reads, and bytes produced by
        # reconstruction
        self.bytes_read = 0
        self.bytes_reconstructed = 0
        # The heat counters survive a clean close: the sidecar is fenced
        # by the encode generation, so counters of a volume re-encoded
        # under the same id are never resurrected; absent or corrupt, the
        # volume starts cold.
        self._heat_path = self.base + ".heat"
        try:
            with open(self._heat_path, encoding="utf-8") as f:
                blob = json.load(f)
            if blob.get("gen") == self.encode_ts_ns:
                self.bytes_read = int(blob.get("read_bytes", 0))
                self.bytes_reconstructed = int(blob.get("reconstructed_bytes", 0))
        except (OSError, ValueError):
            pass
        self._stats_lock = threading.Lock()
        self.stage_seconds = dict.fromkeys(READ_STAGES, 0.0)

    def _add_stage(self, stage: str, seconds: float) -> None:
        with self._stats_lock:
            self.stage_seconds[stage] += seconds

    def _count_read(self, n: int) -> None:
        with self._stats_lock:
            self.bytes_read += n

    # ------------------------------------------------------------- lookup

    def find_needle(self, needle_id: int):
        nv = self._ecx.get(needle_id)
        if nv is None or needle_id in self._deleted:
            return None
        return nv

    def has_needle(self, needle_id: int) -> bool:
        nv = self.find_needle(needle_id)
        return nv is not None and not nv.is_deleted

    # --------------------------------------------------------------- read

    def read_needle(self, needle_id: int, cookie: Optional[int] = None) -> Needle:
        with self._lock:
            nv = self.find_needle(needle_id)
        if nv is None or nv.is_deleted:
            raise EcNotFoundError(f"needle {needle_id:x} not found")
        off = actual_offset(nv.offset)
        rec_size = record_actual_size(nv.size, self.version)
        try:
            return self._parse(self._read_extent(off, rec_size), cookie, needle_id)
        except CrcError:
            # The local bytes are rotten: re-derive every interval by
            # sidecar-verified reconstruction, bypassing the local shard
            # copies. The record comes back bit-exact or this raises.
            return self._parse(
                self._read_extent(off, rec_size, prefer_recovery=True),
                cookie, needle_id,
            )

    def _parse(self, raw: bytes, cookie: Optional[int], needle_id: int) -> Needle:
        n = Needle.from_bytes(raw, self.version)
        if cookie is not None and n.cookie != cookie:
            raise EcCookieMismatch(f"needle {needle_id:x} cookie mismatch")
        return n

    def _read_extent(self, offset: int, size: int, prefer_recovery: bool = False) -> bytes:
        parts = []
        k = self.ctx.data_shards
        for iv in locate_data(offset, size, self._locate_shard_size, k):
            shard_id, shard_off = iv.to_shard_and_offset(k)
            if prefer_recovery:
                parts.append(self._recover_interval(shard_id, shard_off, iv.size))
            else:
                parts.append(self._read_shard_interval(shard_id, shard_off, iv.size))
        return b"".join(parts)

    def _read_shard_interval(self, shard_id: int, offset: int, size: int) -> bytes:
        fd = self.shard_fds.get(shard_id)
        if fd is not None:
            try:
                faults.fire(
                    "ec.volume.shard_read", shard=shard_id, offset=offset, size=size
                )
                got = os.pread(fd, size, offset)
            except OSError:  # a racing unmount closed the fd (or injected)
                got = b""
            got = faults.mutate(
                "ec.volume.shard_read", got, shard=shard_id, offset=offset, size=size
            )
            if len(got) == size:
                self._count_read(size)
                return got
            # short read = truncated shard; recover instead
        if self.remote_reader is not None:
            got = self.remote_reader(shard_id, offset, size, self.encode_ts_ns)
            if got is not None and len(got) == size:
                self._count_read(size)
                return got
        return self._recover_interval(shard_id, offset, size)

    # ---------------------------------------------------------- recovery

    def _bitrot(self) -> Optional[BitrotProtection]:
        """The .ecsum sidecar; None for this read when it is absent or
        unreadable (only a successful load is cached)."""
        if self._prot is False:
            try:
                self._prot = BitrotProtection.load(self.base + ".ecsum")
            except (BitrotError, OSError):
                return None
        return self._prot

    def _recover_interval(self, shard_id: int, offset: int, size: int) -> bytes:
        """Reconstruct [offset, offset+size) of one shard and, when the
        .ecsum sidecar is there, verify the granules that cover it
        before returning a byte: the sources are checked (a rotten
        sibling is excluded) and so is the output (a mismatch raises).
        With a v2 sidecar a needle read reconstructs only the 64 KiB
        leaves covering its extent. Verified output lands in the
        interval cache."""
        # one flight-recorder root per degraded-read op
        sp = trace.start(
            "ec.degraded_read",
            name=f"v{self.volume_id}.{shard_id:02d}",
            volume=self.volume_id, shard=shard_id, offset=offset, size=size,
        )
        try:
            with trace.activate(sp):
                return self._recover_interval_traced(shard_id, offset, size, sp)
        finally:
            trace.finish(sp)

    def _recover_interval_traced(self, shard_id: int, offset: int, size: int, sp) -> bytes:
        prot = self._bitrot()
        if prot is None or not (0 <= shard_id < len(prot.shard_crcs)):
            return self._reconstruct_range(shard_id, offset, size)
        bs, _ = prot.verify_granularity(shard_id)
        ssize = prot.shard_sizes[shard_id]
        if offset + size > ssize:
            # beyond the sidecar's recorded shard there is no ground
            # truth: serve unverified, as for pre-sidecar volumes
            return self._reconstruct_range(shard_id, offset, size)
        lo = (offset // bs) * bs
        hi = min(-(-(offset + size) // bs) * bs, ssize)
        key = f"{self._cache_ns}{shard_id}:{self._shard_gen.get(shard_id, 0)}:{lo}:{hi}"

        def range_ok(sid: int, data) -> bool:
            t0 = time.perf_counter()
            with trace.stage(sp, "crc_verify"):
                ok = prot.verify_range(sid, lo, data)
            self._add_stage("crc_verify", time.perf_counter() - t0)
            return ok

        def build() -> bytes:
            data = self._reconstruct_range(shard_id, lo, hi - lo, source_ok=range_ok)
            if not range_ok(shard_id, data):
                raise ECError(
                    f"reconstructed shard {shard_id} [{lo}:{hi}) fails "
                    f".ecsum verification; refusing to serve"
                )
            return data

        if self.interval_cache is None:
            return build()[offset - lo : offset - lo + size]
        # N concurrent misses on one extent run build() once; a leader's
        # refusal reaches every waiter. Only verified bytes are cached.
        data, src = self.interval_cache.get_or_load(key, build)
        if src == "hit":
            trace.event(sp, "cache_hit", lo=lo, hi=hi)
        elif src == "wait":
            trace.event(sp, "singleflight_wait", lo=lo, hi=hi)
        return data[offset - lo : offset - lo + size]

    def _reconstruct_range(
        self, shard_id: int, offset: int, size: int, source_ok=None
    ) -> bytes:
        """On-the-fly RS decode of one interval from >= k sibling shards
        (reference store_ec.go:656-747). Local siblings land in numpy
        buffers through the native plane (one positioned read each),
        unless SEAWEED_EC_NATIVE=0 or an armed fault registry (its
        `ec.volume.shard_read` seams want bytes) keeps os.pread. Remote
        siblings, when the local ones are too few, are fetched in
        parallel, as the reference does: remote fetches set the latency."""
        k = self.ctx.data_shards
        sp = trace.current()  # the ec.degraded_read root, when armed
        sources: dict[int, np.ndarray] = {}
        use_native = native_io.enabled() and not faults.active()
        local = [(i, fd) for i, fd in self.shard_fds.items() if i != shard_id]
        for i, fd in local:
            t0 = time.perf_counter()
            try:
                with trace.stage(sp, "sibling_read"):
                    if use_native:
                        got = np.empty(size, dtype=np.uint8)
                        native_io.read_exact_into(fd, got, offset)
                    else:
                        got = os.pread(fd, size, offset)
            except OSError:  # short read (a truncated shard) or a closed fd
                continue
            finally:
                self._add_stage("sibling_read", time.perf_counter() - t0)
            self._count_read(len(got))
            if len(got) == size and (source_ok is None or source_ok(i, got)):
                sources[i] = got if use_native else np.frombuffer(got, dtype=np.uint8)
                if len(sources) == k:
                    break
        if len(sources) < k and self.remote_reader is not None:
            self._fetch_remote(shard_id, offset, size, sources, source_ok, sp)
        if len(sources) < k:
            raise ECError(
                f"shard {shard_id} unavailable and only {len(sources)} "
                f"sibling shards readable (need {k})"
            )
        if len(sources) > k:
            sources = {i: sources[i] for i in sorted(sources)[:k]}
        t0 = time.perf_counter()
        if size >= 2 * STAGED_RECOVERY_BATCH:
            out = self._reconstruct_staged(shard_id, sources, size, sp)
        else:
            # the needle-read shape: still a client of the shared per-chip
            # scheduler, a foreground window slot for the call, so a
            # serving read goes ahead of colocated recovery and scrub
            queue = resolve_scope(self.scheduler).for_backend(self.backend)
            with admission(queue, "foreground", batch_cost(1, size), span=sp):
                with trace.stage(sp, "reconstruct"):
                    rec = self.backend.reconstruct(sources, want=[shard_id])
            out = np.asarray(rec[shard_id], dtype=np.uint8).tobytes()
        self._add_stage("reconstruct", time.perf_counter() - t0)
        with self._stats_lock:
            self.bytes_reconstructed += size
        return out

    def _fetch_remote(
        self, shard_id: int, offset: int, size: int, sources: dict, source_ok, sp
    ) -> None:
        """Fetch the siblings that are not local from `remote_reader`, at
        most 8 at once, into `sources` until k of them are there. A hung
        peer does not hold the read: it returns as soon as k sources
        exist. "sibling_read" times only the submits and the blocked
        waits; `source_ok` times its own CRC checks as "crc_verify".
        Each fetch runs in a copy of the caller's context, so it sees the
        active span and request id."""
        k = self.ctx.data_shards
        missing = [i for i in range(self.ctx.total) if i != shard_id and i not in sources]
        if not missing:
            return

        def fetch(i):
            return i, self.remote_reader(i, offset, size, self.encode_ts_ns)

        ex = ThreadPoolExecutor(max_workers=min(len(missing), 8))
        try:
            with trace.stage(sp, "sibling_read"):
                futures = {
                    ex.submit(contextvars.copy_context().run, fetch, i) for i in missing
                }
            while futures and len(sources) < k:
                t0 = time.perf_counter()
                with trace.stage(sp, "sibling_read"):
                    done, futures = wait(futures, return_when=FIRST_COMPLETED)
                self._add_stage("sibling_read", time.perf_counter() - t0)
                for f in done:
                    i, got = f.result()
                    if got is None:
                        continue
                    self._count_read(len(got))
                    if len(got) == size and (source_ok is None or source_ok(i, got)):
                        sources[i] = np.frombuffer(got, dtype=np.uint8)
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _reconstruct_staged(self, shard_id: int, sources: dict, size: int, sp) -> bytes:
        """Wide extents: the decode-coefficient apply runs per column
        batch through run_staged_apply, so H2D, kernel and D2H overlap
        (the rebuild's shape). Batches are stacked one at a time, never
        the whole (k, size) extent."""
        src_ids = tuple(sorted(sources))
        coeffs = self._coeff_cache.get((shard_id, src_ids))
        if coeffs is None:
            coeffs = _decode_coeffs(self.backend.matrix, (shard_id,), src_ids)
            if len(self._coeff_cache) >= 64:
                self._coeff_cache.clear()
            self._coeff_cache[(shard_id, src_ids)] = coeffs
        srcs = [sources[i] for i in src_ids]
        out = np.empty(size, dtype=np.uint8)

        def produce():
            for off in range(0, size, STAGED_RECOVERY_BATCH):
                yield off, np.stack([s[off : off + STAGED_RECOVERY_BATCH] for s in srcs])

        def consume(off, rec):
            out[off : off + rec.shape[1]] = rec[0]

        run_staged_apply(
            self.backend, coeffs, produce, consume,
            describe="ec degraded reconstruction",
            # degraded reads are serving traffic: they go ahead of any
            # colocated recovery or scrub stream at batch granularity
            priority="foreground",
            scheduler=self.scheduler,
            cost_hint=size,
            span=sp, read_stage="stage_batch",
        )
        return out.tobytes()

    # ------------------------------------------------------------- delete

    def delete_needle(self, needle_id: int) -> int:
        """Journal an EC tombstone in .ecj (reference ec_volume_delete.go);
        returns the deleted needle's size, 0 if there was none."""
        with self._lock:
            nv = self._ecx.get(needle_id)
            if nv is None or nv.is_deleted or needle_id in self._deleted:
                return 0
            self._ecj.write(struct.pack(">Q", needle_id))
            self._ecj.flush()
            os.fsync(self._ecj.fileno())
            self._deleted.add(needle_id)
            self._drop_interval_cache()  # cached extents may cover it
            return nv.size

    # -------------------------------------------------------------- state

    def _drop_interval_cache(self, shard_ids: list[int] | None = None) -> None:
        """Invalidate cached reconstructed extents: those of `shard_ids`
        (whose generations are bumped, so an in-flight build cannot
        repopulate the old key), or all of this volume's."""
        ids = range(self.ctx.total) if shard_ids is None else shard_ids
        for sid in ids:
            self._shard_gen[sid] = self._shard_gen.get(sid, 0) + 1
        if self.interval_cache is None:
            return
        if shard_ids is None:
            self.interval_cache.drop_prefix(self._cache_ns)
        else:
            for sid in shard_ids:
                self.interval_cache.drop_prefix(f"{self._cache_ns}{sid}:")

    def invalidate_shard_ranges(self, shard_id: int, ranges: list[tuple[int, int]]) -> None:
        """Drop cached extents of one shard that overlap the given byte
        ranges (those bytes were patched in place), keeping its other
        cached extents."""
        if self.interval_cache is None or not ranges:
            return
        prefix = f"{self._cache_ns}{shard_id}:{self._shard_gen.get(shard_id, 0)}:"

        def overlaps(key: str) -> bool:
            try:
                lo, hi = (int(x) for x in key[len(prefix):].split(":"))
            except ValueError:
                return True  # unparseable = assume stale
            return any(lo < rhi and rlo < hi for rlo, rhi in ranges)

        with self._lock:
            self.interval_cache.drop_matching(prefix, overlaps)

    @property
    def shard_ids(self) -> list[int]:
        return sorted(self.shard_fds)

    def quarantined_shards(self) -> list[int]:
        """Shards whose scrub-quarantine file (<shard>.bad) is on disk."""
        return [
            i
            for i in range(self.ctx.total)
            if os.path.exists(self.base + self.ctx.to_ext(i) + QUARANTINE_SUFFIX)
        ]

    def refresh_shards(self) -> list[int]:
        """Open shard files that appeared on disk since mount; returns the
        mounted ids."""
        with self._lock:
            return self.reopen_shards(
                [i for i in range(self.ctx.total) if i not in self.shard_fds]
            )

    def reopen_shards(self, shard_ids: Optional[list[int]] = None) -> list[int]:
        """Re-open shard fds from the current directory entries: an fd
        opened before a rebuild renamed a new file into place still reads
        the old inode. Returns the mounted ids."""
        with self._lock:
            ids = list(self.shard_fds) if shard_ids is None else shard_ids
            self._drop_interval_cache(ids)
            for sid in ids:
                p = self.base + self.ctx.to_ext(sid)
                old = self.shard_fds.pop(sid, None)
                if old is not None:
                    os.close(old)
                if os.path.exists(p):
                    self.shard_fds[sid] = os.open(p, os.O_RDONLY)
                    self._shard_size = max(self._shard_size, os.path.getsize(p))
            return sorted(self.shard_fds)

    def unmount_shards(self, shard_ids: list[int]) -> int:
        """Stop serving specific local shards; returns how many remain
        mounted."""
        with self._lock:
            self._drop_interval_cache(shard_ids)
            for sid in shard_ids:
                fd = self.shard_fds.pop(sid, None)
                if fd is not None:
                    os.close(fd)
            return len(self.shard_fds)

    def _save_heat(self) -> None:
        """Persist the heat counters beside the volume (tmp + atomic
        rename); advisory, so a failure never fails the close."""
        try:
            tmp = self._heat_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {
                        "gen": self.encode_ts_ns,
                        "read_bytes": int(self.bytes_read),
                        "reconstructed_bytes": int(self.bytes_reconstructed),
                    },
                    f,
                )
            os.replace(tmp, self._heat_path)
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            self._save_heat()
            for fd in self.shard_fds.values():
                os.close(fd)
            self.shard_fds.clear()
            self._ecj.close()
            self._ecx.close()
            if self._shared_cache and self.interval_cache is not None:
                self.interval_cache.drop_prefix(self._cache_ns)
