"""Native read plane of the EC byte path: pooled landing matrices,
batched positioned reads, readahead.

Port of seaweedfs_tpu/ec/native_io.py, network half included:
`landing_pool` holds the 1-row landing buffers of the shard net plane's
ingress (ec/net_plane.py, ec/peer_rebuild.py). Batches land through one
GIL-releasing `sn_batch_pread` call per batch in caller-owned aligned
matrices that flow produce -> transform -> consume untouched and then
go back to a small pool. The write half is the stateful native sink
(utils/native.py `NativeSink`, used by pipeline.FusedShardSink).

The port's idiom: `BufferPool(rows, device)` on a `cuda` device hands
out matrices in page-locked memory (numpy views of pinned torch
tensors), so a batch the reader lands there is copied straight to the
card: `TorchBackend.to_device` sees that it is pinned and skips its own
copy into a pinned buffer. On the CPU the pool is plain aligned numpy.
torch is imported where a matrix is pinned: the filer's client, which
reads chunks through this plane, imports no torch.

Buffer ownership:

- A pooled matrix belongs to one in-flight batch from `get` until the
  consume stage calls `put`, after the sink has written the batch. On
  the card that is also after the batch's H2D copy has finished: consume
  runs after `to_host`, which waits on the D2H event, ordered after the
  kernel, which is ordered after the H2D copy on the same stream. So
  `put` must stay after the sink's append.
- The pipeline's bounded queues cap the batches in flight (about
  2 * queue_size + one per stage), and the pool allocates on demand, so
  its population stays within that cap per width.
- Rows handed to the native sink must stay alive until the append
  returns (the C side writes straight from them).
- Pool matrices are 4096-aligned, as O_DIRECT wants.

`enabled()` is the one switch: SEAWEED_EC_NATIVE=0 sends callers to
their Python source and sink, which give the same bytes. A failure to
build or load the host library raises; it never turns the plane off.
Callers also take the Python plane while the fault registry is armed:
byte-mutating fault points need materialized bytes at the read and
write seams.
"""

from __future__ import annotations

import os
import threading
from typing import Sequence

import numpy as np

from ..utils import native

_ALIGN = 4096

# Work the plane carried, counted where it does it (never on the Python
# fallback): batched reads, single-row reads, fused sink appends, and
# the pool's allocations and their bytes. chip_smoke.py zeroes and reads
# these around each path to show that the path went through the plane.
COUNTS = {"read_batch": 0, "read_exact": 0, "sink_append": 0, "pool_alloc": 0, "pool_bytes": 0}
_counts_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
    with _counts_lock:
        COUNTS[name] += n


def reset_counts() -> None:
    with _counts_lock:
        for name in COUNTS:
            COUNTS[name] = 0


def enabled() -> bool:
    """True unless SEAWEED_EC_NATIVE=0 (read live, so a caller can flip
    it per call)."""
    return os.environ.get("SEAWEED_EC_NATIVE", "1") != "0"


def aligned_matrix(rows: int, width: int, align: int = _ALIGN) -> np.ndarray:
    """(rows, width) C-contiguous uint8 matrix whose base address is
    `align`-aligned (over-allocate and offset)."""
    raw = np.empty(rows * width + align, dtype=np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off : off + rows * width].reshape(rows, width)


def pinned_matrix(rows: int, width: int, align: int = _ALIGN) -> np.ndarray:
    """(rows, width) uint8 matrix in page-locked host memory, `align`-
    aligned: a numpy view of a pinned torch tensor, which the view keeps
    alive. Over-allocates when the allocator's block is not aligned."""
    import torch

    n = rows * width
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True).numpy()
    if host.ctypes.data % align:
        host = torch.empty(n + align, dtype=torch.uint8, pin_memory=True).numpy()
        off = (-host.ctypes.data) % align
        host = host[off : off + n]
    if host.ctypes.data % align:
        raise RuntimeError(f"pinned matrix at {host.ctypes.data:#x} is not {align}-aligned")
    return host.reshape(rows, width)


class BufferPool:
    """Reusable aligned (rows, width) matrices cycling through a
    pipeline, free-listed by exact width (an encode plan yields a few
    width classes: full batches, the small-block phase, ragged tails).
    On a `cuda` device the matrices are page-locked. Allocation is on
    demand; `put` is cooperative, and a batch dropped by an aborting
    pipeline strands its matrix for the GC (the pool keeps no list of
    what it handed out)."""

    def __init__(self, rows: int, device=None):
        self.rows = rows
        self.pinned = False
        if device is not None:
            import torch

            self.pinned = torch.device(device).type == "cuda"
        self._free: dict[int, list[np.ndarray]] = {}
        self._lock = threading.Lock()

    def get(self, width: int) -> np.ndarray:
        with self._lock:
            lst = self._free.get(width)
            if lst:
                return lst.pop()
        count("pool_alloc")
        count("pool_bytes", self.rows * width)
        if self.pinned:
            return pinned_matrix(self.rows, width)
        return aligned_matrix(self.rows, width)

    def put(self, buf: np.ndarray) -> None:
        with self._lock:
            self._free.setdefault(buf.shape[1], []).append(buf)


_landing_pool: "BufferPool | None" = None
_landing_pool_lock = threading.Lock()


def landing_pool() -> BufferPool:
    """Process-wide width-keyed pool of 1-row aligned landing buffers,
    shared by every single-stream ingress (the peer-fetch net-plane
    landings), so steady state allocates once per width and reuses
    forever. Plain 4096-aligned host memory, not page-locked: these
    buffers feed the disk (the fetched stream goes to staging), not the
    card."""
    global _landing_pool
    with _landing_pool_lock:
        if _landing_pool is None:
            _landing_pool = BufferPool(rows=1)
        return _landing_pool


def read_batch(
    fds: Sequence[int],
    offsets: Sequence[int],
    dst: np.ndarray,
    *,
    width: int | None = None,
    pad_eof: bool = True,
    granule: int = 0,
    crc_state: np.ndarray | None = None,
    filled_state: np.ndarray | None = None,
    out_crcs: np.ndarray | None = None,
    out_counts: np.ndarray | None = None,
) -> None:
    """One native batched positioned read into the rows of `dst` (the
    contract of utils/native.batch_pread)."""
    native.batch_pread(
        list(fds), list(offsets), dst, width=width, pad_eof=pad_eof, granule=granule,
        crc_state=crc_state, filled_state=filled_state,
        out_crcs=out_crcs, out_counts=out_counts,
    )
    count("read_batch")


def read_exact_into(fd: int, buf: np.ndarray, offset: int) -> None:
    """Fill 1-D `buf` from fd at `offset`; a short read raises OSError.
    One native read when the plane is enabled, a preadv loop otherwise:
    the same in-place contract either way."""
    if enabled():
        native.batch_pread([fd], [offset], buf.reshape(1, -1), pad_eof=False)
        count("read_exact")
        return
    mv = memoryview(buf)
    filled = 0
    want = len(buf)
    while filled < want:
        got = os.preadv(fd, [mv[filled:]], offset + filled)
        if got == 0:
            raise OSError(f"short read at offset {offset + filled}")
        filled += got


def prefetch(fd: int, offset: int, length: int) -> None:
    """Readahead hint for the next batch's extent, issued before the
    current batch is read, so the kernel pages in batch N+1 while batch N
    computes and N-1 drains."""
    if length > 0:
        native.fadvise_willneed(fd, offset, length)
