"""EC encode: volume (.dat + .idx) -> .ec00.. shards, .ecx, .ecsum, .vif.

Port of seaweedfs_tpu/ec/encoder.py (reference ec_encoder.go WriteEcFiles
/ encodeDatFile and VolumeEcShardsGenerate, which writes the .ecx BEFORE
the shards to close a write race, then persists .ecsum and .vif).

The .dat is striped row by row: rows of `large_block_size` per data
shard while at least one whole large row remains, then rows of
`small_block_size`. Parity is columnwise-independent, so each row is fed
to the device in batches of at most `batch_size` columns and the shard
files and CRC builders are appended in offset order; any batch split
gives bit-identical shards.

The byte path is the native plane (ec/native_io.py): each batch lands
through one batched native read in a pooled aligned matrix (page-locked
when the backend is on cuda, so the device copy starts from it), with
the next batch's extents hinted for readahead first, and the fused
native sink writes the 14 shard streams and rolls their CRCs. With
SEAWEED_EC_NATIVE=0, or an armed fault registry, a preadv loop and
`PyShardSink` give the same bytes.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import faults
from ..storage.needle_map import MemDb
from ..utils.fs import fsync_dir
from . import native_io
from .backend import TorchBackend, get_backend
from .bitrot import BitrotProtection
from .context import (
    BITROT_LEAF_SIZE,
    DEFAULT_EC_CONTEXT,
    LARGE_BLOCK_SIZE,
    SMALL_BLOCK_SIZE,
    ECContext,
    ECError,
)
from .pipeline import make_shard_sink, run_pipeline
from .volume_info import VolumeInfo

DEFAULT_BATCH = 16 * 1024 * 1024


def _pread_padded(fd: int, buf: np.ndarray, offset: int) -> None:
    """Fill `buf` from fd at `offset` in place, zero-padding past EOF."""
    mv = memoryview(buf)
    filled = 0
    want = len(buf)
    while filled < want:
        got = os.preadv(fd, [mv[filled:]], offset + filled)
        if got == 0:
            break
        filled += got
    if filled < want:
        buf[filled:] = 0


def write_sorted_file_from_idx(base: str) -> None:
    """Convert write-ordered .idx -> sorted sealed .ecx (reference
    WriteSortedFileFromIdx, ec_encoder.go:32-59)."""
    db = MemDb()
    db.load_idx(base + ".idx")
    db.write_sorted_file(base + ".ecx")


def batch_plan(
    dat_size: int, k: int, batch_size: int,
    large_block_size: int, small_block_size: int,
):
    """(row_offset, block_size, chunk_off, width) for every batch."""
    large_row = large_block_size * k
    small_row = small_block_size * k
    processed, remaining = 0, dat_size
    rows = []
    while remaining >= large_row:
        rows.append((processed, large_block_size))
        processed += large_row
        remaining -= large_row
    while remaining > 0:
        rows.append((processed, small_block_size))
        processed += small_row
        remaining -= small_row
    for row_offset, block_size in rows:
        batch = min(batch_size, block_size)
        for chunk_off in range(0, block_size, batch):
            yield row_offset, block_size, chunk_off, min(batch, block_size - chunk_off)


def write_ec_files(
    base: str,
    ctx: ECContext = DEFAULT_EC_CONTEXT,
    backend: TorchBackend | None = None,
    batch_size: int = DEFAULT_BATCH,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
    leaf_size: int = BITROT_LEAF_SIZE,
) -> BitrotProtection:
    """Stripe and encode base.dat into base.ec00..; returns the bitrot
    CRCs rolled in the same pass. `leaf_size` > 0 also rolls the v2
    sidecar's per-leaf CRCs; 0 gives a v1 (block-level) sidecar."""
    if backend is None:
        backend = get_backend("cuda", ctx.data_shards, ctx.parity_shards)
    k, total = ctx.data_shards, ctx.total

    dat_fd = os.open(base + ".dat", os.O_RDONLY)
    outputs: list = []
    try:
        for i in range(total):
            # buffering=0: whole >= 1 MiB batches, where a userspace
            # buffer adds a copy and saves nothing
            outputs.append(open(base + ctx.to_ext(i), "wb", buffering=0))
        sink = make_shard_sink(outputs, leaf_size=leaf_size)
        plan = list(batch_plan(
            os.fstat(dat_fd).st_size, k, batch_size,
            large_block_size, small_block_size,
        ))
        pool = None
        if native_io.enabled() and not faults.active():
            pool = native_io.BufferPool(k, device=getattr(backend, "device", None))

        def produce():
            for n, (row_offset, block_size, chunk_off, width) in enumerate(plan):
                offsets = [row_offset + i * block_size + chunk_off for i in range(k)]
                if pool is None:
                    data = np.empty((k, width), dtype=np.uint8)
                    for i in range(k):
                        _pread_padded(dat_fd, data[i], offsets[i])
                else:
                    if n + 1 < len(plan):
                        nro, nbs, nco, nw = plan[n + 1]
                        for i in range(k):
                            native_io.prefetch(dat_fd, nro + i * nbs + nco, nw)
                    data = pool.get(width)
                    native_io.read_batch([dat_fd] * k, offsets, data, pad_eof=True)
                yield data

        def transform(data):
            # H2D + kernel launch, both asynchronous on a device
            return data, backend.encode_staged(backend.to_device(data))

        def consume(item):
            data, handle = item
            # Blocks until this batch's parity is on the host; meanwhile
            # the calling thread dispatches the batches queued behind it.
            parity = np.ascontiguousarray(backend.to_host(handle), dtype=np.uint8)
            t0 = time.perf_counter()
            sink.append_rows([*data, *parity])
            backend.add_stage("write", time.perf_counter() - t0)
            if pool is not None:
                # the batch is written and its H2D copy long done: its
                # matrix may carry a later batch
                pool.put(data)

        run_pipeline(
            produce,
            transform,
            consume,
            # up to ~4 batches can still be draining: allow each 16 MiB/s
            # of slow-disk write plus a fixed device-fetch allowance
            join_timeout=60.0 + 4.0 * batch_size / (16 << 20),
            describe="ec encode pipeline",
            record=backend.add_stage,
        )
        # Durability barrier before the sidecar may name these shards,
        # issued in parallel so the shard files drain concurrently.
        with ThreadPoolExecutor(max_workers=len(outputs)) as ex:
            list(ex.map(lambda f: os.fsync(f.fileno()), outputs))
    finally:
        os.close(dat_fd)
        for f in outputs:
            f.close()
    fsync_dir(base + ".dat")
    return sink.to_protection(ctx)


def ec_encode_volume(
    base: str,
    ctx: ECContext = DEFAULT_EC_CONTEXT,
    backend: TorchBackend | None = None,
    batch_size: int = DEFAULT_BATCH,
    version: int = 3,
    leaf_size: int = BITROT_LEAF_SIZE,
) -> VolumeInfo:
    """Full encode of one volume's files. Order matters: .ecx first
    (write-race close, volume_grpc_erasure_coding.go:107-116), then the
    shards, fsync'd, then .ecsum and .vif."""
    if not os.path.exists(base + ".dat"):
        raise ECError(f"{base}.dat not found")
    if not os.path.exists(base + ".idx"):
        raise ECError(f"{base}.idx not found")
    encode_ts_ns = time.time_ns()
    write_sorted_file_from_idx(base)
    prot = write_ec_files(base, ctx, backend, batch_size, leaf_size=leaf_size)
    prot.generation = encode_ts_ns
    prot.save(base + ".ecsum")
    vi = VolumeInfo(
        version=version,
        ec_ctx=ctx,
        dat_file_size=os.path.getsize(base + ".dat"),
        encode_ts_ns=encode_ts_ns,
    )
    vi.save(base + ".vif")
    return vi
