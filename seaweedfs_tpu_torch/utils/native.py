"""ctypes bindings of the port's host byte plane (csrc/seaweed_native.cpp).

Port of seaweedfs_tpu/utils/native.py, trimmed to what encode, rebuild,
decode and degraded reads call: CRC32C and its combine, the batched
positioned read with an inline rolling CRC, the readahead hint, and the
stateful shard sink. ops/_build.py builds the library with g++ at first
use into seaweedfs_tpu_torch/build/ and loads it. A failed build or load
raises at the first call that needs the library; nothing here turns it
into a quiet fallback (SEAWEED_EC_NATIVE=0, read by ec/native_io.py, is
the one way to the Python plane).

Every call releases the GIL for its whole length (ctypes.CDLL), so the
sink's and the reader's worker threads run beside the interpreter.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build


def _lib() -> ctypes.CDLL:
    return _build.load("seaweed_native")


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of `data` (bytes, bytearray, memoryview or a numpy array,
    read as its raw bytes), optionally continuing from a previous value.
    No byte is copied."""
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        buf = np.frombuffer(data, dtype=np.uint8)
    return int(_lib().sn_crc32c(crc & 0xFFFFFFFF, buf.ctypes.data, buf.nbytes))


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32C of A ++ B from crc(A), crc(B) and len(B): the C twin of
    utils/crc.crc32c_combine (the sink folds leaf CRCs into block CRCs
    with it)."""
    return int(_lib().sn_crc32c_combine(crc1, crc2, len2))


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def batch_pread(
    fds: list[int],
    offsets: list[int],
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
    """Fill row i of `dst` (2-D C-contiguous uint8, or 1-D for one row)
    with `width` bytes read from fds[i] at offsets[i]: one call, worker
    threads draining the rows, no intermediate bytes objects.

    `dst` is the caller's: rows land in place. `width` defaults to the
    whole row; a narrower one fills a left-aligned slice of each row.
    pad_eof zero-fills past EOF (encode); pad_eof=False raises OSError on
    any short row (rebuild), with the failed row's index in `err.sn_row`.

    With granule > 0, each row's rolling CRC32C (crc_state u32[n],
    filled_state u64[n], kept across calls) advances over the bytes read;
    completed granule CRCs land in out_crcs (u32[n, max_out]) and their
    counts in out_counts (i32[n]): the fused read and verify of the
    rebuild's sources.
    """
    n = len(fds)
    _require(len(offsets) == n, "one offset per fd")
    if dst.ndim == 1:
        dst = dst.reshape(1, -1)
    _require(dst.dtype == np.uint8 and dst.flags.c_contiguous, "dst must be C-contiguous uint8")
    _require(dst.shape[0] == n, "one dst row per fd")
    stride = dst.shape[1]
    width = stride if width is None else width
    _require(0 < width <= stride, f"width {width} outside (0, {stride}]")
    max_out = 0
    if granule:
        _require(
            crc_state is not None and crc_state.dtype == np.uint32 and crc_state.shape == (n,)
            and filled_state is not None and filled_state.dtype == np.uint64
            and filled_state.shape == (n,)
            and out_crcs is not None and out_crcs.dtype == np.uint32
            and out_crcs.flags.c_contiguous and out_crcs.ndim == 2 and out_crcs.shape[0] == n
            and out_counts is not None and out_counts.dtype == np.int32
            and out_counts.shape == (n,),
            "granule needs crc_state u32[n], filled_state u64[n], "
            "out_crcs u32[n, max_out] and out_counts i32[n]",
        )
        max_out = out_crcs.shape[1]
    rc = _lib().sn_batch_pread(
        (ctypes.c_int * n)(*fds),
        (ctypes.c_uint64 * n)(*offsets),
        n,
        _ptr(dst),
        width,
        stride,
        1 if pad_eof else 0,
        granule,
        _ptr(crc_state) if granule else None,
        _ptr(filled_state) if granule else None,
        _ptr(out_crcs) if granule else None,
        _ptr(out_counts) if granule else None,
        max_out,
    )
    if rc != 0:
        row = -rc - 1
        err = OSError(f"sn_batch_pread failed on row {row} (fd {fds[row]} offset {offsets[row]})")
        err.sn_row = row  # callers map the row back to a shard id
        raise err


def fadvise_willneed(fd: int, offset: int, length: int) -> None:
    """Readahead hint; a filesystem that rejects it only loses the
    prefetch."""
    _lib().sn_fadvise_willneed(fd, offset, length)


class NativeSink:
    """Handle of the stateful shard sink (sn_sink_*): appends pwrite at
    offsets the sink tracks, straight from the caller's rows, with both
    sidecar CRC levels rolled in the same pass. The caller owns the fds
    and destroys the sink before closing them; the sink owns only its
    offsets and CRC state."""

    EARLY_WB = 1
    DIRECT = 2

    def __init__(
        self,
        fds: list[int],
        block_size: int,
        leaf_size: int = 0,
        early_writeback: bool = False,
        direct: bool = False,
    ):
        n = len(fds)
        self.n = n
        self.block_size = block_size
        self.leaf_size = leaf_size
        flags = (self.EARLY_WB if early_writeback else 0) | (self.DIRECT if direct else 0)
        self._h = _lib().sn_sink_create((ctypes.c_int * n)(*fds), n, block_size, leaf_size, flags)
        if not self._h:
            raise OSError("sn_sink_create failed (bad block or leaf size?)")

    def _handle(self):
        if self._h is None:
            raise OSError("sink already destroyed")
        return self._h

    def direct_flags(self) -> np.ndarray:
        """Per-shard O_DIRECT state (u8[n], 1: still writing O_DIRECT)."""
        out = np.zeros(self.n, np.uint8)
        _lib().sn_sink_direct_flags(self._handle(), _ptr(out))
        return out

    def append(
        self,
        row_ptrs: list[int],
        width: int,
        out_block_crcs: np.ndarray,
        out_block_counts: np.ndarray,
        out_leaf_crcs: np.ndarray,
        out_leaf_counts: np.ndarray,
    ) -> None:
        h = self._handle()
        _require(len(row_ptrs) == self.n, f"expected {self.n} rows")
        rc = _lib().sn_sink_append(
            h,
            (ctypes.c_void_p * self.n)(*row_ptrs),
            width,
            _ptr(out_block_crcs),
            _ptr(out_block_counts),
            _ptr(out_leaf_crcs),
            _ptr(out_leaf_counts),
            out_block_crcs.shape[1],
        )
        if rc != 0:
            raise OSError(f"sn_sink_append failed on shard {-rc - 1}")

    def finish(self) -> tuple:
        """-> (tail_block_crc, tail_block_valid, tail_leaf_crc,
        tail_leaf_valid, sizes) arrays: flushes the partial-tail CRCs."""
        h = self._handle()
        n = self.n
        tb, tl = np.zeros(n, np.uint32), np.zeros(n, np.uint32)
        tbv, tlv = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
        sizes = np.zeros(n, np.uint64)
        _lib().sn_sink_finish(h, _ptr(tb), _ptr(tbv), _ptr(tl), _ptr(tlv), _ptr(sizes))
        return tb, tbv, tl, tlv, sizes

    def destroy(self) -> None:
        if self._h is not None:
            _lib().sn_sink_destroy(self._h)
            self._h = None

    def __del__(self):  # the caller's destroy is the rule; this is a backstop
        try:
            self.destroy()
        except Exception:
            pass
