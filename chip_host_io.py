#!/usr/bin/env python3
"""The host byte plane alone, on the card's host: what encode's reads and
writes cost there, native plane against Python plane.

    python3 chip_host_io.py

Writes a seeded 1 GiB file in a fresh directory under
seaweedfs_tpu_torch/build/ (where chip_smoke.py keeps its volume), then
times, twice each and in turns:

- encode's read shape, 103 batches of (10, 1 MiB) rows from the page
  cache: encode's Python preadv loop, one native batched read per batch,
  and the same with the next batch's readahead hint first;
- encode's write shape, 14 shard files of 103 appends of 1 MiB with
  64 KiB leaf CRCs rolled, through `PyShardSink` and `FusedShardSink`,
  then the parallel fsync of the 14 files; in that directory and in
  /dev/shm (memory, no disk behind it), to tell the filesystem's cost
  from the plane's.

- the shard net plane's read path over loopback, from a file of one
  shard's size (108,003,328 bytes, the smoke's) in each directory:
  the floor (one `send_file` in a thread, one `recv_into` of the whole
  file, no granule CRC), the same with the 64 KiB granule CRC fused
  (overlapped core forced off and on), and a `ShardNetPlane` read
  through `NetPlaneClient` as peer-fetch rebuild reads it: `read_into`
  in 4 MiB requests (native plane) and `read_bytes` in 1 MiB requests
  (Python plane).

It also times the start and join of one Python thread, the unit the
host library's worker pool saves on every call. Prints the filesystem
type of each directory and the card's name and power limit; the last
line is the times as JSON. It touches only the
host; the card is named because the numbers belong to its machine.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 20261017
K, TOTAL, ROW, BATCHES = 10, 14, 1 << 20, 103
LEAF = 64 << 10


def fs_type(path: str) -> str:
    out = subprocess.run(["stat", "-f", "-c", "%T", path], capture_output=True, text=True)
    return out.stdout.strip() or "unknown"


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no card"


def read_seconds(path: str, how: str) -> float:
    """The whole file in encode's (10, 1 MiB) batches: "python" (encode's
    preadv loop), "native" (one batched read a batch) or "prefetch"
    (native, after the next batch's readahead hint)."""
    from seaweedfs_tpu_torch.ec import native_io
    from seaweedfs_tpu_torch.ec.encoder import _pread_padded

    fd = os.open(path, os.O_RDONLY)
    pool = native_io.BufferPool(K)
    try:
        t0 = time.perf_counter()
        for b in range(BATCHES):
            offsets = [(b * K + i) * ROW for i in range(K)]
            if how == "python":
                data = np.empty((K, ROW), np.uint8)
                for i in range(K):
                    _pread_padded(fd, data[i], offsets[i])
                continue
            if how == "prefetch" and b + 1 < BATCHES:
                for i in range(K):
                    native_io.prefetch(fd, offsets[i] + K * ROW, ROW)
            data = pool.get(ROW)
            native_io.read_batch([fd] * K, offsets, data, pad_eof=True)
            pool.put(data)
        return time.perf_counter() - t0
    finally:
        os.close(fd)


def write_seconds(directory: str, fused: bool, rows: np.ndarray) -> dict:
    """14 shard streams of BATCHES appends of `rows` through one sink,
    then their fsync in parallel (as encode does)."""
    from seaweedfs_tpu_torch.ec.pipeline import FusedShardSink, PyShardSink

    paths = [os.path.join(directory, f"s{i:02d}") for i in range(TOTAL)]
    files = [open(p, "wb", buffering=0) for p in paths]
    try:
        sink = (FusedShardSink if fused else PyShardSink)(files, leaf_size=LEAF)
        t0 = time.perf_counter()
        for _ in range(BATCHES):
            sink.append_rows(list(rows))
        t1 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=TOTAL) as ex:
            list(ex.map(lambda f: os.fsync(f.fileno()), files))
        t2 = time.perf_counter()
        sink.block_crcs()
    finally:
        for f in files:
            f.close()
        for p in paths:
            os.unlink(p)
    return {"append_s": t1 - t0, "fsync_s": t2 - t1}


SHARD = 108_003_328  # one shard of the smoke's 1 GiB 10+4 volume


def net_seconds(path: str, how: str) -> float:
    """The whole file over loopback: "floor" / "crc0" / "crc1" (one
    send_file in a thread into one recv_into; crc0/crc1 with the 64 KiB
    granule CRC fused, overlap forced off / on), or "plane_native" /
    "plane_python" (a ShardNetPlane read by a NetPlaneClient in 4 MiB
    read_into / 1 MiB read_bytes requests)."""
    import socket

    from seaweedfs_tpu_torch.ec import native_io, net_plane
    from seaweedfs_tpu_torch.utils import native

    size = os.path.getsize(path)
    fd = os.open(path, os.O_RDONLY)
    dst = native_io.aligned_matrix(1, size)[0]
    try:
        if how.startswith("plane"):
            srv = net_plane.ShardNetPlane("127.0.0.1", 0, lambda vid, sid, gen: (fd, size))
            srv.start()
            client = net_plane.NetPlaneClient(timeout=60.0)
            addr = ("127.0.0.1", srv.port)
            chunk = 4 << 20 if how == "plane_native" else 1 << 20
            try:
                t0 = time.perf_counter()
                for off in range(0, size, chunk):
                    n = min(chunk, size - off)
                    if how == "plane_native":
                        client.read_into(addr, 1, 0, 0, off, n, dst[off : off + n], granule=LEAF)
                    else:
                        client.read_bytes(addr, 1, 0, 0, off, n)
                return time.perf_counter() - t0
            finally:
                client.close()
                srv.stop()
        listener = socket.create_server(("127.0.0.1", 0))
        a = socket.create_connection(listener.getsockname())
        b, _ = listener.accept()
        prev = os.environ.get("SEAWEED_EC_NET_OVERLAP")
        try:
            granule = 0 if how == "floor" else LEAF
            if granule:
                os.environ["SEAWEED_EC_NET_OVERLAP"] = how[-1]
            sender = threading.Thread(target=native.send_file, args=(a.fileno(), fd, 0, size, 60000))
            t0 = time.perf_counter()
            sender.start()
            got = native.recv_into(
                b.fileno(), dst, size, timeout_ms=60000, granule=granule,
                crc_state=np.zeros(1, np.uint32), filled_state=np.zeros(1, np.uint64),
                out_crcs=np.zeros(size // LEAF + 2, np.uint32), out_counts=np.zeros(1, np.int32),
            )
            sender.join()
            dt = time.perf_counter() - t0
            if got != size:
                raise OSError(f"loopback landed {got} of {size} bytes")
            return dt
        finally:
            if prev is None:
                os.environ.pop("SEAWEED_EC_NET_OVERLAP", None)
            else:
                os.environ["SEAWEED_EC_NET_OVERLAP"] = prev
            for s_ in (a, b, listener):
                s_.close()
    finally:
        os.close(fd)


def thread_start_us(n: int = 200) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        t = threading.Thread(target=int)
        t.start()
        t.join()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    from seaweedfs_tpu_torch.ops import _build

    print(f"card: {card_line()}; host cpus {os.cpu_count()}")
    _build.build_all(("seaweed_native",))
    rng = np.random.default_rng(SEED)
    work = tempfile.mkdtemp(prefix="host-io-", dir=str(_build.BUILD_DIR))
    dirs = {"build": work}
    if os.path.isdir("/dev/shm"):
        dirs["shm"] = tempfile.mkdtemp(prefix="host-io-", dir="/dev/shm")
    result: dict = {"fs": {name: fs_type(d) for name, d in dirs.items()},
                    "thread_start_us": thread_start_us()}
    try:
        path = os.path.join(work, "1.dat")
        with open(path, "wb") as f:
            for _ in range(BATCHES * K):
                f.write(rng.bytes(ROW))
        reads: dict = {how: [] for how in ("python", "native", "prefetch")}
        for _ in range(2):
            for how in reads:
                reads[how].append(read_seconds(path, how))
        result["read_s"] = reads
        os.unlink(path)
        rows = rng.integers(0, 256, (TOTAL, ROW), dtype=np.uint8)
        writes: dict = {}
        for name, d in dirs.items():
            for _ in range(2):
                for label, fused in (("python", False), ("native", True)):
                    writes.setdefault(f"{name} {label}", []).append(write_seconds(d, fused, rows))
        result["write"] = writes
        nets: dict = {}
        for name, d in dirs.items():
            path = os.path.join(d, "1.ec05")
            with open(path, "wb") as f:
                for off in range(0, SHARD, ROW):
                    f.write(rng.bytes(min(ROW, SHARD - off)))
            for _ in range(2):
                for how in ("floor", "crc0", "crc1", "plane_native", "plane_python"):
                    dt = net_seconds(path, how)
                    nets.setdefault(f"{name} {how}", []).append({"s": dt, "gb_per_s": SHARD / dt / 1e9})
            os.unlink(path)
        result["net"] = nets
    finally:
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    print(card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
