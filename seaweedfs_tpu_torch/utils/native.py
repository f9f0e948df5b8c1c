"""ctypes bindings of the port's host library (csrc/seaweed_native.cpp).

Port of seaweedfs_tpu/utils/native.py, trimmed to what encode, rebuild,
decode, degraded reads, the native CPU backend and the shard net plane
call: CRC32C and its combine, the batched positioned read with an inline
rolling CRC, the readahead hint, the stateful shard sink, the GF(2^8)
matrix apply (`rs_apply`, `rs_apply_mt`, `gf_mul`, `has_avx2`), and the
socket egress and ingress of the network byte plane (`send_file`,
`sendv`, `recv_into`, `recv_overlap_active`, `recv_file`). ops/_build.py builds
the library with g++ at first use into seaweedfs_tpu_torch/build/ and
loads it. A failed build or load raises at the first call that needs the
library; nothing here turns it into a quiet fallback (SEAWEED_EC_NATIVE=0,
read by ec/native_io.py, is the one way to the Python plane, and the CPU
backend has none).

Every call releases the GIL for its whole length (ctypes.CDLL), so the
sink's and the reader's worker threads run beside the interpreter.
"""

from __future__ import annotations

import ctypes
import os

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


def _apply_operands(coeffs: np.ndarray, data: np.ndarray):
    """Contiguous uint8 operands (the library reads row j at data + j*n
    and writes row r at out + r*n) and the output they fill. The caller
    holds `data` while the library reads it: a strided input's
    contiguous copy lives only as long as this reference."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    out_rows, in_rows = coeffs.shape
    if data.shape[0] != in_rows:
        raise ValueError(f"coeffs expect {in_rows} rows, got {data.shape[0]}")
    return coeffs, data, np.empty((out_rows, data.shape[1]), dtype=np.uint8)


def _apply_args(coeffs, data, out) -> tuple:
    return coeffs.tobytes(), out.shape[0], coeffs.shape[1], _ptr(data), _ptr(out), data.shape[1]


def rs_apply(coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
    """out[r] = XOR_j gf_mul(coeffs[r,j], data[j]) over contiguous rows."""
    coeffs, data, out = _apply_operands(coeffs, data)
    _lib().sn_rs_apply(*_apply_args(coeffs, data, out))
    return out


def rs_apply_mt(coeffs: np.ndarray, data: np.ndarray, threads: int = 0) -> np.ndarray:
    """rs_apply with the columns split into `threads` windows (0 = one per
    CPU) that run on the library's worker pool. Bit-exact vs rs_apply:
    parity is columnwise-independent."""
    if threads <= 0:
        threads = os.cpu_count() or 1
    coeffs, data, out = _apply_operands(coeffs, data)
    _lib().sn_rs_apply_mt(*_apply_args(coeffs, data, out), threads)
    return out


BODIES = ("scalar", "ssse3", "avx2")


def rs_apply_body(body: str, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray | None:
    """rs_apply through one named multiply body (a name in BODIES), or
    None where the CPU lacks it. For tests: the apply itself picks the
    widest body the CPU has."""
    coeffs, data, out = _apply_operands(coeffs, data)
    if _lib().sn_rs_apply_body(BODIES.index(body), *_apply_args(coeffs, data, out)) != 0:
        return None
    return out


def gf_mul(a: int, b: int) -> int:
    return _lib().sn_gf_mul(a, b)


def has_avx2() -> bool:
    return bool(_lib().sn_has_avx2())


def pool_threads() -> int:
    """Threads that run the library's pooled work: its workers and the
    calling thread (one per CPU)."""
    return int(_lib().sn_pool_threads())


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


# ---------------------------------------------------------------- network
# Socket egress and ingress of the shard net plane (ec/net_plane.py). All
# release the GIL for the whole transfer; `timeout_ms` bounds each poll()
# wait on a Python-timeout (O_NONBLOCK) socket, -1 blocks forever.


def send_file(out_fd: int, in_fd: int, offset: int, length: int, timeout_ms: int = -1) -> int:
    """sendfile(2) `length` bytes of in_fd@offset into out_fd: kernel to
    kernel, no userspace copy (one, through the C side's buffer, where
    the kernel path is unsupported). Returns bytes sent; SHORT only when
    in_fd hits EOF. Raises OSError on socket errors or timeout."""
    sent = _lib().sn_send_file(out_fd, in_fd, offset, length, timeout_ms)
    if sent < 0:
        raise OSError(-sent, f"sn_send_file: {os.strerror(-sent)}")
    return int(sent)


def _part_ptr_len(part, keepalive: list):
    """(address, nbytes) of a bytes-like without copying it; appends what
    must outlive the call to `keepalive`."""
    if isinstance(part, np.ndarray):
        _require(part.dtype == np.uint8 and part.flags.c_contiguous,
                 "ndarray parts must be C-contiguous uint8")
        keepalive.append(part)
        return part.ctypes.data, part.nbytes
    if isinstance(part, bytes):
        p = ctypes.cast(ctypes.c_char_p(part), ctypes.c_void_p)
        keepalive.append((part, p))
        return p.value or 0, len(part)
    a = np.frombuffer(part, dtype=np.uint8)  # zero-copy view
    keepalive.append((part, a))
    return a.ctypes.data, a.nbytes


def sendv(out_fd: int, parts, timeout_ms: int = -1) -> int:
    """Scatter-gather write of `parts` (bytes, memoryview or uint8
    ndarray) to out_fd through writev: no Python-side join, no per-chunk
    GIL round trips. Returns the bytes sent (the sum of the lengths);
    raises OSError on failure, ETIMEDOUT included, since a partial body
    is a broken connection, not a result."""
    n = len(parts)
    keep: list = []
    ptrs = (ctypes.c_void_p * n)()
    lens = (ctypes.c_uint64 * n)()
    total = 0
    for i, part in enumerate(parts):
        addr, ln = _part_ptr_len(part, keep)
        ptrs[i] = addr
        lens[i] = ln
        total += ln
    sent = _lib().sn_sendv(out_fd, ptrs, lens, n, timeout_ms)
    if sent < 0:
        raise OSError(-sent, f"sn_sendv: {os.strerror(-sent)}")
    if sent != total:  # the C side shorts only on error
        raise OSError(f"sn_sendv short write: {sent}/{total}")
    return int(sent)


def recv_overlap_active(length: int) -> bool:
    """Whether a fused recv+CRC of `length` bytes would run the
    overlapped core (socket reads on a helper thread, the CRC chasing
    the landed bytes) under the current host and env. Auto: at least 4
    hardware threads and 256 KiB; SEAWEED_EC_NET_OVERLAP=1 or 0 forces
    the core gate on or off (the size floor always applies). Read live."""
    return bool(_lib().sn_recv_overlap_active(length))


def _overlap_mode() -> int:
    """SEAWEED_EC_NET_OVERLAP as sn_recv_into's overlap_mode, read here
    under the GIL (where os.environ changes too) and passed down: a
    getenv on the C hot path would race a concurrent setenv."""
    env = os.environ.get("SEAWEED_EC_NET_OVERLAP", "")
    if env == "1":
        return 1
    if env == "0":
        return 0
    return -1


def recv_into(
    fd: int,
    dst: np.ndarray,
    length: int | None = None,
    *,
    timeout_ms: int = -1,
    granule: int = 0,
    crc_state: np.ndarray | None = None,
    filled_state: np.ndarray | None = None,
    out_crcs: np.ndarray | None = None,
    out_counts: np.ndarray | None = None,
) -> int:
    """Land up to `length` bytes from fd DIRECTLY in `dst` (1-D
    C-contiguous uint8, e.g. a pooled landing row): the ingress half of
    the network plane. Returns bytes received; SHORT means the peer
    closed mid-stream (the caller's torn-stream contract). With
    granule > 0 the rolling granule CRC32C (crc_state u32[1],
    filled_state u64[1]) advances over the bytes during the copy-in;
    completed granule CRCs land in out_crcs, their count in
    out_counts[0]: the fused sidecar verify, no extra byte pass."""
    _require(dst.dtype == np.uint8 and dst.ndim == 1 and dst.flags.c_contiguous,
             "dst must be a 1-D C-contiguous uint8 array")
    if length is None:
        length = dst.nbytes
    _require(0 <= length <= dst.nbytes, f"length {length} outside [0, {dst.nbytes}]")
    max_out = 0
    if granule:
        _require(
            crc_state is not None and crc_state.dtype == np.uint32
            and filled_state is not None and filled_state.dtype == np.uint64
            and out_crcs is not None and out_crcs.dtype == np.uint32
            and out_crcs.flags.c_contiguous
            and out_counts is not None and out_counts.dtype == np.int32,
            "granule needs crc_state u32[1], filled_state u64[1], out_crcs u32[max_out] "
            "and out_counts i32[1]",
        )
        max_out = out_crcs.shape[-1]
    got = _lib().sn_recv_into(
        fd,
        _ptr(dst),
        length,
        timeout_ms,
        granule,
        _ptr(crc_state) if granule else None,
        _ptr(filled_state) if granule else None,
        _ptr(out_crcs) if granule else None,
        _ptr(out_counts) if granule else None,
        max_out,
        _overlap_mode(),
    )
    if got < 0:
        raise OSError(-got, f"sn_recv_into: {os.strerror(-got)}")
    return int(got)


def recv_file(fd: int, out_fd: int, offset: int, length: int, *,
              timeout_ms: int = -1) -> tuple[int, int]:
    """Land `length` bytes from socket `fd` straight into file `out_fd`
    at `offset`: the write opcode's blob ingress (socket, bounce buffer,
    pwrite(2)) with one CRC32C rolled over the payload while each chunk
    is cache-hot, no byte handled in Python. Returns (bytes_landed,
    crc32c); SHORT means the peer closed mid-stream (the partial extent
    is on disk, but callers must not ACK it). Raises OSError on a socket
    or pwrite failure."""
    crc_out = np.zeros(1, np.uint32)
    got = _lib().sn_recv_file(fd, out_fd, offset, length, timeout_ms, _ptr(crc_out))
    if got < 0:
        raise OSError(-got, f"sn_recv_file: {os.strerror(-got)}")
    return int(got), int(crc_out[0])
