"""EC decode: shard files -> normal volume (.dat + .idx).

Port of seaweedfs_tpu/ec/decoder.py (reference
weed/storage/erasure_coding/ec_decoder.go): .ecj tombstones folded into
.ecx, .ecx(+.ecj) -> .idx, the live extent from the largest live .ecx
entry, de-striping that honours the encode-time layout, and
temp+fsync+rename+dir-fsync publication throughout. A missing or rotten
data shard is regenerated first by the port's `rebuild_ec_files`, on the
backend the caller passes. The fault points and the flight recorder of
the JAX package are not part of the port yet.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Iterator

import numpy as np

from ..storage.needle import footer_size
from ..storage.super_block import SUPER_BLOCK_SIZE
from ..storage.types import (
    NEEDLE_HEADER_SIZE,
    NEEDLE_MAP_ENTRY_SIZE,
    TOMBSTONE_FILE_SIZE,
    NeedleValue,
    actual_offset,
    padded_record_size,
)
from ..utils.fs import fsync_dir
from . import native_io
from .context import DEFAULT_EC_CONTEXT, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, ECError
from .pipeline import run_pipeline
from .volume_info import VolumeInfo

# Read size of one de-stripe piece (the JAX decoder's 4 MiB).
DESTRIPE_PIECE = 4 << 20


def iterate_ecx(base: str) -> Iterator[NeedleValue]:
    with open(base + ".ecx", "rb") as f:
        while True:
            b = f.read(NEEDLE_MAP_ENTRY_SIZE)
            if not b:
                return
            if len(b) != NEEDLE_MAP_ENTRY_SIZE:
                raise ECError(f"{base}.ecx: partial trailing record (corrupt)")
            yield NeedleValue.from_bytes(b)


def iterate_ecj(base: str) -> Iterator[int]:
    path = base + ".ecj"
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            b = f.read(8)
            if len(b) < 8:
                return
            yield struct.unpack(">Q", b)[0]


def has_live_needles(base: str) -> bool:
    """True if .ecx holds at least one non-deleted entry (reference
    HasLiveNeedles). Deletes still in .ecj count only after
    `rebuild_ecx_file` has folded them in."""
    return any(not nv.is_deleted for nv in iterate_ecx(base))


def rebuild_ecx_file(base: str) -> None:
    """Fold the .ecj deletion journal into .ecx as in-place tombstones,
    then drop the journal (reference RebuildEcxFile,
    ec_volume_delete.go:103)."""
    ecj = base + ".ecj"
    if not os.path.exists(ecj):
        return
    count = os.path.getsize(base + ".ecx") // NEEDLE_MAP_ENTRY_SIZE
    with open(base + ".ecx", "r+b") as f:

        def search(nid: int) -> int:
            lo, hi = 0, count
            while lo < hi:
                mid = (lo + hi) // 2
                f.seek(mid * NEEDLE_MAP_ENTRY_SIZE)
                entry = NeedleValue.from_bytes(f.read(NEEDLE_MAP_ENTRY_SIZE))
                if entry.needle_id == nid:
                    return mid
                if entry.needle_id < nid:
                    lo = mid + 1
                else:
                    hi = mid
            return -1

        for nid in iterate_ecj(base):
            i = search(nid)
            if i < 0:
                continue
            # the size field follows needleId(8) + offset(4)
            f.seek(i * NEEDLE_MAP_ENTRY_SIZE + 12)
            f.write(struct.pack(">i", TOMBSTONE_FILE_SIZE))
        f.flush()
        os.fsync(f.fileno())
    os.unlink(ecj)
    fsync_dir(ecj)


def record_actual_size(size: int, version: int) -> int:
    """Full on-disk record length for an idx `size` (GetActualSize)."""
    return padded_record_size(NEEDLE_HEADER_SIZE + size + footer_size(version))


def write_idx_from_ecx(base: str) -> None:
    """.ecx + .ecj -> .idx (sorted entries, then journaled tombstones),
    atomically published."""
    idx_path = base + ".idx"
    tmp = idx_path + ".tmp"
    try:
        with open(tmp, "wb") as out, open(base + ".ecx", "rb") as ecx:
            while chunk := ecx.read(1 << 20):
                out.write(chunk)
            for nid in iterate_ecj(base):
                out.write(NeedleValue(nid, 0, TOMBSTONE_FILE_SIZE).to_bytes())
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, idx_path)
        fsync_dir(idx_path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def find_dat_file_size(base: str, version: int) -> int:
    """Live data extent: the largest record end over live .ecx entries,
    at least the superblock (reference FindDatFileSize)."""
    dat_size = SUPER_BLOCK_SIZE
    for nv in iterate_ecx(base):
        if not nv.is_deleted:
            end = actual_offset(nv.offset) + record_actual_size(nv.size, version)
            dat_size = max(dat_size, end)
    return dat_size


def write_dat_file(
    base: str,
    dat_file_size: int,
    encoded_dat_file_size: int,
    shard_paths: list[str],
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
    stages: dict | None = None,
) -> None:
    """De-stripe the k data shards back into base.dat (its first
    dat_file_size bytes). encoded_dat_file_size fixes the block layout;
    0 infers it from the physical shard size, which is ambiguous when
    that is a whole number of large blocks, and then this fails closed
    (reference writeDatFile).

    Shard preads run in the pipeline's reader thread and overlap the
    sequential .dat writes in its writer thread; there is nothing to
    compute (run_pipeline with an identity transform). `stages`, when
    given, receives the wall seconds of "disk_read", "write" and
    "fsync_publish"."""
    if not shard_paths:
        raise ECError("no data shard files")
    k = len(shard_paths)
    record = _recorder(stages)
    fds = [os.open(p, os.O_RDONLY) for p in shard_paths]
    dat_path = base + ".dat"
    tmp = dat_path + ".tmp"
    try:
        if encoded_dat_file_size <= 0:
            shard_size = os.fstat(fds[0]).st_size
            if (
                shard_size % large_block_size == 0
                and dat_file_size
                > (shard_size // large_block_size - 1) * large_block_size * k
            ):
                raise ECError(
                    f"shard size {shard_size} does not identify the block "
                    f"layout; re-encode to record the dat size in .vif"
                )
            encoded_dat_file_size = k * shard_size
        if dat_file_size > encoded_dat_file_size:
            raise ECError(
                f"dat size {dat_file_size} exceeds encoded size {encoded_dat_file_size}"
            )
        large_rows = encoded_dat_file_size // (k * large_block_size)

        def read_plan():
            """(fd, offset, length) pieces in .dat order: large rows,
            then small rows; within a row, shard order."""
            remaining = dat_file_size
            row = 0
            while remaining > 0:
                if row < large_rows:
                    block = large_block_size
                    off = row * large_block_size
                else:
                    block = small_block_size
                    off = large_rows * large_block_size + (row - large_rows) * small_block_size
                for fd in fds:
                    if remaining <= 0:
                        break
                    take = min(remaining, block)
                    for pos in range(0, take, DESTRIPE_PIECE):
                        yield fd, off + pos, min(DESTRIPE_PIECE, take - pos)
                    remaining -= take
                row += 1

        def produce():
            # each piece lands in a numpy buffer (one native read, or a
            # preadv loop with SEAWEED_EC_NATIVE=0) and goes to the
            # writer as it is
            for fd, off, want in read_plan():
                buf = np.empty(want, dtype=np.uint8)
                try:
                    native_io.read_exact_into(fd, buf, off)
                except OSError as e:
                    raise ECError(f"short shard read at {off}: {e}") from e
                yield buf

        with open(tmp, "wb", buffering=0) as out:

            def consume(chunk: np.ndarray) -> None:
                t0 = time.perf_counter()
                mv = memoryview(chunk)
                while mv:  # raw FileIO may short-write
                    mv = mv[out.write(mv) :]
                record("write", time.perf_counter() - t0)

            run_pipeline(
                produce, lambda chunk: chunk, consume,
                describe="ec decode pipeline", record=record,
            )
            t0 = time.perf_counter()
            os.fsync(out.fileno())
        os.replace(tmp, dat_path)
        fsync_dir(dat_path)
        record("fsync_publish", time.perf_counter() - t0)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    finally:
        for fd in fds:
            os.close(fd)


def _recorder(stages: dict | None):
    def record(stage: str, seconds: float) -> None:
        if stages is not None:
            stages[stage] = stages.get(stage, 0.0) + seconds

    return record


def ec_decode_volume(base: str, ctx=None, backend=None, stages: dict | None = None) -> bool:
    """Shards -> normal volume. Returns False (a no-op) when no live
    needle remains. Layout and needle version come from the .vif.

    `rebuild_ec_files(only_shards=<missing data shards>)` always runs
    first, on `backend`: it regenerates absent data shards and replaces
    present ones that fail the .ecsum sidecar, so the de-stripe reads k
    verified data shards; fewer than k good shards fails closed there.
    `stages`, when given, receives wall seconds per stage: "rebuild",
    "disk_read", "write" and "fsync_publish"."""
    from .rebuild import rebuild_ec_files

    vi = VolumeInfo.maybe_load(base + ".vif") or VolumeInfo()
    if ctx is None:
        ctx = vi.ec_ctx or DEFAULT_EC_CONTEXT
    rebuild_ecx_file(base)
    if not has_live_needles(base):
        return False
    write_idx_from_ecx(base)
    dat_size = find_dat_file_size(base, vi.version)
    shard_paths = [base + ctx.to_ext(i) for i in range(ctx.data_shards)]
    missing_ids = [i for i, p in enumerate(shard_paths) if not os.path.exists(p)]
    t0 = time.perf_counter()
    rebuild_ec_files(base, ctx, backend=backend, only_shards=missing_ids)
    _recorder(stages)("rebuild", time.perf_counter() - t0)
    write_dat_file(base, dat_size, vi.dat_file_size, shard_paths, stages=stages)
    return True
