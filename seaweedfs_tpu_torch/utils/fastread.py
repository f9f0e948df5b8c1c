"""Bulk-read fast path (the RDMA-sidecar analog, SURVEY §2.10).

Port of seaweedfs_tpu/utils/fastread.py. Control plane: the volume
server's `GET /<fid>?locate=true` returns {path, offset, size, crc32c,
socket} for a needle's payload. Data plane: this module's client sends
(path, offset, size) over the C++ server's Unix socket
(csrc/fastread.cpp) and the kernel sendfile()s the bytes: no HTTP
framing, no Python server-side byte handling.

Server side: start_server() runs the blocking C accept loop in a daemon
thread (ctypes releases the GIL for the call). The library is built by
ops/_build.py into seaweedfs_tpu_torch/build/ at first use. Where the two
packages differ, on purpose: a library that fails to build or load
raises, as the port's other host libraries do, where the JAX module logs
once and leaves the server on HTTP only; and a socket that cannot be
bound raises OSError from start_server, so the volume server logs it and
leaves that location on HTTP only, where the JAX server advertises the
socket all the same.

Client side: `FastReadClient.read_into` lands a payload in a caller's
buffer through the host library's `recv_into` with the granule CRC fused
into the copy-in (a Python recv loop and CRC where SEAWEED_EC_NATIVE=0);
`read_fid_fast` lands it in the process's landing pool
(ec/native_io.landing_pool) and checks the CRC, which is mandatory.
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
import threading
import time

import numpy as np


class FastReadError(Exception):
    pass


def lib() -> ctypes.CDLL:
    """The sidecar library, built at first use; a failed build or load
    raises."""
    from ..ops import _build

    return _build.load("fastread")


def start_server(socket_path: str, root_dir: str) -> threading.Thread:
    """Serve `root_dir` on `socket_path` until stop_server(). OSError
    where the socket cannot be set up (a path over the AF_UNIX limit, a
    failed bind)."""
    l = lib()
    rc = []

    def run() -> None:
        rc.append(l.sn_fastread_serve(socket_path.encode(), root_dir.encode()))
        if rc[0] != 0:
            from .glog import logger

            logger("fastread").warning("server on %s exited rc=%d", socket_path, rc[0])

    t = threading.Thread(target=run, daemon=True, name="fastread")
    t.start()
    # wait for the socket to appear so callers can advertise it
    for _ in range(100):
        if os.path.exists(socket_path) or rc:
            break
        time.sleep(0.01)
    if rc and rc[0] < 0:
        raise OSError(-rc[0], f"fastread socket {socket_path}: {os.strerror(-rc[0])}")
    return t


def stop_server(socket_path: str) -> None:
    """Unlink the socket, then poke the accept loop so it notices."""
    try:
        os.unlink(socket_path)
    except OSError:
        return
    try:
        s = socket.socket(socket.AF_UNIX)
        s.settimeout(0.5)
        s.connect(socket_path)
        s.close()
    except OSError:
        pass


def _request_bytes(path: str, offset: int, size: int) -> bytes:
    pb = path.encode()
    return struct.pack("<H", len(pb)) + pb + struct.pack("<QQ", offset, size)


class FastReadClient:
    """Persistent connection to a fast-read socket."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self._sock = socket.socket(socket.AF_UNIX)
        self._sock.settimeout(30.0)
        self._sock.connect(socket_path)
        self._lock = threading.Lock()

    def read(self, path: str, offset: int, size: int) -> bytes:
        with self._lock:
            self._sock.sendall(_request_bytes(path, offset, size))
            status, n = self._head()
            body = self._recv_exact_py(n)
        if status != 0:
            raise FastReadError(body.decode(errors="replace"))
        return body

    def read_into(self, path: str, offset: int, size: int, dst, *, granule: int = 0):
        """Land the payload DIRECTLY in caller-owned `dst` (1-D uint8
        ndarray, e.g. a pooled aligned buffer): no intermediate bytes
        object. With granule>0, returns the granule CRCs rolled during the
        copy-in (ndarray u32; granule == size gives the whole-payload CRC
        the ?locate contract demands, for free). Raises FastReadError on
        any server-side error or torn stream."""
        from ..ec import native_io

        with self._lock:
            self._sock.sendall(_request_bytes(path, offset, size))
            status, n = self._head()
            if status != 0:
                raise FastReadError(self._recv_exact_py(n).decode(errors="replace"))
            if n != size:
                # n payload bytes are in flight on this persistent
                # connection; close rather than desync the framing
                self.close()
                raise FastReadError(f"short response: {n}/{size} bytes")
            if not native_io.enabled():
                return self._land_py(dst, size, granule)
            from . import native

            crc_state = np.zeros(1, np.uint32)
            filled = np.zeros(1, np.uint64)
            out_crcs = np.zeros((size // granule + 2) if granule else 1, np.uint32)
            out_counts = np.zeros(1, np.int32)
            got = native.recv_into(
                self._sock.fileno(), dst, size,
                timeout_ms=int((self._sock.gettimeout() or 30.0) * 1000),
                granule=granule, crc_state=crc_state, filled_state=filled,
                out_crcs=out_crcs, out_counts=out_counts,
            )
            if got != size:
                self.close()  # mid-payload: the framing is gone
                raise FastReadError(f"fastread server closed connection ({got}/{size})")
            if not granule:
                return None
            crcs = list(out_crcs[: int(out_counts[0])])
            if size % granule:
                crcs.append(int(crc_state[0]))  # partial tail granule
            return np.array(crcs, dtype=np.uint32)

    def _land_py(self, dst, size: int, granule: int):
        """recv_into the caller's buffer from Python, then the granule
        CRCs in a second pass."""
        view = memoryview(dst)[:size]
        got = 0
        while got < size:
            r = self._sock.recv_into(view[got:], size - got)
            if r == 0:
                raise FastReadError("fastread server closed connection")
            got += r
        if not granule:
            return None
        from .crc import crc32c

        return np.array([crc32c(dst[i : min(i + granule, size)]) for i in range(0, size, granule)],
                        dtype=np.uint32)

    def _head(self) -> tuple[int, int]:
        head = self._recv_exact_py(9)
        return head[0], struct.unpack("<Q", head[1:])[0]

    def _recv_exact_py(self, n: int) -> bytes:
        # recv_into a preallocated buffer: bytes concatenation would be
        # quadratic on multi-MB bodies
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            r = self._sock.recv_into(view[got:], n - got)
            if r == 0:
                raise FastReadError("fastread server closed connection")
            got += r
        return bytes(buf)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def read_fid_fast(locate: dict) -> bytes:
    """One-shot convenience: `locate` is the volume server's ?locate=true
    JSON ({path, offset, size, crc32c, socket}). The CRC is MANDATORY
    validation: the sidecar serves raw unlocked ranges, so a vacuum
    racing the read, or a stale locate replayed against the wrong host's
    sidecar, must fail loudly, never return wrong bytes. The payload lands
    in a pooled aligned buffer with the CRC rolled DURING the copy-in
    (granule = whole payload), so the verify costs no second byte pass."""
    from ..ec.native_io import landing_pool

    size = int(locate["size"])
    c = FastReadClient(locate["socket"])
    try:
        if size == 0:
            return c.read(locate["path"], locate["offset"], 0)
        pool = landing_pool()
        buf = pool.get(size)
        try:
            crcs = c.read_into(locate["path"], locate["offset"], size, buf[0], granule=size)
            if int(crcs[0]) != locate.get("crc32c", -1):
                raise FastReadError("payload checksum mismatch (stale locate?)")
            return buf[0].tobytes()
        finally:
            pool.put(buf)
    finally:
        c.close()
