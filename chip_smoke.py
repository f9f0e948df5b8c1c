#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main paths at the size the project names, a seeded
1 GiB RS 10+4 volume of real needles, through the entry points a user
calls (`ec_encode_volume`, `rebuild_ec_files`, `EcVolume`,
`ec_decode_volume`, `TorchBackend`). Phases:

1. print the card (`nvidia-smi` name and power limit) and the host's
   CPU count, and build from csrc/ the CUDA kernel (nvcc) and the host
   byte plane (g++: CRC32C, batched reads, the shard sink), both at once;
2. hold `gf2_apply` (the bit-major entry point) against its plain torch
   version on the card with the 4-row encode matrix and a 2-row decode
   matrix, at ragged widths, at the widths on its tiles' edges and on
   data 1 byte off alignment (the masked byte path), and against the
   numpy oracle on a sampled 64 KiB window (tolerance 0: exact integer GF
   arithmetic); time it at the encode and rebuild shapes, (10, 1 MiB) and
   (10, 16 MiB) with each matrix, beside the plain version,
   torch._int_mm on the same bit-plane product (a yardstick the port
   never calls), a device copy that moves the same bytes (the memory
   stream's time under the same method), and the host time of one
   wrapper call;
2b. the same for `gf2_apply_planes` (the plane-stack entry point) with
   m = 1, 2 and 4 at m_pad 32 (pack_width 1) and 16 (pack_width 2), also
   at the widths on its tiles' edges and on misaligned data; timed at
   m = 1 at the read path's widths, (10, 64 KiB), (10, 256 KiB),
   (10, 1 MiB) and the decode's (10, 16 MiB), beside `gf2_apply` (the
   table body) on the bit-major expansion of the same coefficients at
   (10, 1 MiB) and (10, 16 MiB), m = 1, timed in the same run;
3. write a seeded 1 GiB .dat of real version-3 needles (about 1 MiB
   random bodies, real CRC32C and append time) and its .idx;
4. encode through the native byte plane; every shard must verify
   against the new .ecsum, sampled parity windows must equal the
   oracle's, the kernel's launch count must equal the batch count, and
   so must the native batched reads, the fused sink's appends and the
   batches that `to_device` sent from their page-locked landing matrix
   without a copy; the landing pool may hold no more matrices than the
   pipeline has batches in flight. The same .dat is encoded once more
   with SEAWEED_EC_NATIVE=0 (the Python plane): its 14 shards must be
   sha256-identical and its block and leaf CRC lists equal;
5. delete shards 3 and 11 and rebuild; the rebuilt files must be
   sha256-identical to the deleted ones, and every batch must have come
   through one native read (CRCs rolled inline), the fused sink and a
   page-locked landing matrix;
6. degraded needle reads with `EcVolume(..., TorchBackend(ctx,
   impl="cuda_planes"))` and data shard 3 unmounted: every needle that
   touches shard 3 must read back bit-exact, cached re-reads must launch
   nothing and read no shard-3 sibling bytes, reads that avoid shard 3
   must launch nothing, a needle over a flipped byte of shard 5 must heal
   through verified reconstruction, the planes kernel's launch count
   must equal the reconstructions that missed the cache, and each of
   those must have read k siblings through the native plane;
6b. scrub with crash-safe leaf repair, on the same volume with every
   shard back in place: a clean `scrub_ec_volume` pass (wall s, GB/s of
   shard bytes verified, no launch); then bytes flipped in three leaves
   of data shard 3 (two of them adjacent) and one of parity shard 12 are
   found, rebuilt from k verified siblings through `gf2_apply` (one
   launch per leaf range) and patched in place under the repair journal,
   with nothing quarantined; then each journal window (and a crash of
   recovery itself) is hit in a child process that reconstructs on the
   card and dies with exit code 137, and the next `EcVolume` mount must
   replay or roll back its journal to a shard that is fully new (or
   fully old where the window allows it), with the needles over the
   patched leaves read back bit-exact; a closing scrub leaves shard 3
   bit-exact; last, shard 5 cut by 4 KiB is quarantined to `.bad` and
   rebuilt through `gf2_apply` and the native plane, sha256-identical.
   Every shard ends sha256-identical to its encode-time bytes;
7. `ec.decode` after 5 deletions, with shard 3 removed: the regenerated
   shard, the .dat (the original cut to the live extent) and the .idx
   must be identical to what they should be, the planes kernel must
   have launched once per rebuild batch, and the rebuild's and the
   de-stripe's reads must have gone through the native plane.

Any failure raises (exit code 1). It exits 2, printing no result, when
no CUDA device is available; run from a directory without the package,
the import fails. The last line is the device JSON.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20261016
VOLUME_BYTES = 1 << 30
K, M = 10, 4
LOST = (3, 11)
DEGRADED = 3  # data shard unmounted for the read phase
ROTTEN = 5  # shard whose byte is flipped under one needle
LEAF_DATA, LEAF_PARITY = 3, 12  # shards whose leaves rot in phase 6b
SIZE_ROT = 5  # shard cut short in phase 6b: quarantined and rebuilt
N_DELETED = 5
# batches alive at once in run_pipeline: two queues of 2, one per stage
IN_FLIGHT = 2 * 2 + 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same sheet


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of `fn()` over `reps` launches, each after
    overwriting a buffer larger than L2, so every launch reads its
    inputs cold from HBM, as a batch that was just copied in would at
    best find them. The overwrite leaves L2 full of dirty lines, which
    the launch's own traffic evicts and writes back. A device-side spin
    queued before the start event keeps the stream busy while the host
    enqueues `fn`, so the span holds the device work and not the host's
    launch latency."""
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_us(fn, reps: int) -> float:
    """Median host time, in microseconds, of one call of `fn`: the
    wrapper's checks, its output's allocation and the library's launch
    set-up. A device-side spin keeps the stream busy, so no call waits
    on the device. On an idle stream this time falls inside the read
    path's `kernel` span."""
    times = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def check_kernel(kind, coeffs, n, rng, flush, timed=True, pack_width=1, misaligned=False):
    """Kernel vs plain version vs numpy oracle at (K, n); returns the
    shape's row of measurements. `kind` is "gf2_apply" (bit-major
    operand) or "gf2_apply_planes" (plane stack of `pack_width`).
    `misaligned` puts the data 1 byte past a 16-byte boundary (a
    contiguous view of a larger buffer)."""
    from seaweedfs_tpu_torch.ops import gf256, rs_kernels, rs_torch

    m, k = coeffs.shape
    data_np = rng.integers(0, 256, size=(k, n), dtype=np.uint8)
    if misaligned:
        data = torch.empty(k * n + 1, dtype=torch.uint8, device="cuda")[1:].view(k, n)
        data.copy_(torch.from_numpy(data_np))
    else:
        data = torch.from_numpy(data_np).cuda()
    if kind == "gf2_apply":
        b = rs_torch.bits_from_numpy(rs_torch.bit_matrix_bitmajor(coeffs), "cuda")
        kernel = lambda: rs_kernels.gf2_apply(b, data, m=m)  # noqa: E731
        plain = lambda: rs_kernels.gf2_apply_plain(b, data, m)  # noqa: E731
        operand_bytes = 64 * m * k
    else:
        b = rs_torch.planes_from_numpy(rs_torch.bit_matrix_planes(coeffs, pack_width), "cuda")
        kernel = lambda: rs_kernels.gf2_apply_planes(b, data, m=m, pack_width=pack_width)  # noqa: E731
        plain = lambda: rs_kernels.gf2_apply_planes_plain(b, data, m)  # noqa: E731
        operand_bytes = b.numel()
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = int((out.to(torch.int16) - ref.to(torch.int16)).abs().max().item())
    if err != 0 or not torch.equal(out, ref):
        raise AssertionError(f"{kind} != plain at m={m}, n={n}: max_abs_err {err}")
    w = min(n, 1 << 16)
    off = int(rng.integers(0, n - w + 1))
    want = gf256.matrix_apply(coeffs, data_np[:, off : off + w])
    if not np.array_equal(out[:, off : off + w].cpu().numpy(), want):
        raise AssertionError(f"{kind} != numpy oracle at m={m}, n={n}, offset {off}")
    row = {"m": m, "k": k, "n": n, "max_abs_err": err}
    if misaligned:
        row["data_offset"] = data.data_ptr() % 16
    if kind == "gf2_apply_planes":
        row["m_pad"] = b.shape[2] // 8
    if not timed:
        return row
    row["ms"] = median_ms(kernel, 21, flush)
    row["host_us"] = host_us(kernel, 101)
    row["plain_ms"] = median_ms(plain, 5, flush)
    # Yardstick: the same GF(2) product (the m real rows) as one int8
    # GEMM with int32 accumulation (torch._int_mm, cuBLASLt), on
    # bit-planes made beforehand. It needs more than 16 rows, so a
    # matrix of 8m <= 16 bit rows is padded with zero rows to 32.
    bits8 = torch.from_numpy(rs_torch.bit_matrix_bitmajor(coeffs)).cuda().to(torch.int8)
    if bits8.shape[0] <= 16:
        bits8 = torch.cat([bits8, torch.zeros((32 - bits8.shape[0], 8 * k), dtype=torch.int8, device="cuda")])
    shifts = torch.arange(8, dtype=torch.uint8, device="cuda").view(8, 1, 1)
    planes = ((data.unsqueeze(0) >> shifts) & 1).reshape(8 * k, n).to(torch.int8)
    row["library_ms"] = median_ms(lambda: torch._int_mm(bits8, planes), 11, flush)
    del planes
    # The memory stream alone: one device copy that reads and writes as
    # many bytes, (k + m) * n in all, timed the same way.
    src = torch.empty((k + m) * n // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    row["copy_ms"] = median_ms(lambda: dst.copy_(src), 21, flush)
    del src, dst
    nbytes = (k + m) * n + operand_bytes
    ops = 2 * (8 * m) * (8 * k) * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_TENSOR_OPS_PER_S
    row["bound_ms"] = max(t_bytes, t_ops) * 1e3
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


# Widths on the edges of the ring bodies' tiles (4096 columns) and of their
# grid (132 x 4096: one wave of one-tile blocks on an H100's 132 SMs), one
# width that is not a multiple of 16 (the masked byte path), and one whose
# blocks walk several tiles, the last of them partial.
TILE_EDGES = (4080, 4096, 4112, 132 * 4096 - 16, 132 * 4096, 132 * 4096 + 16,
              132 * 4096 + 3, (16 << 20) + 48)


def kernel_name(mangled: str) -> str:
    """`gf2_table_kernel<4>` or `gf2_apply_kernel<4, bit-major>` from a
    mangled kernel name."""
    kern = re.search(r"(gf2_[a-z]+_kernel)", mangled)
    name = f"{kern.group(1) if kern else mangled}<{', '.join(re.findall(r'Li(\d+)E', mangled))}"
    if layout := re.search(r"LayoutE(\d)E", mangled):
        name += ", " + ("planes" if layout.group(1) == "1" else "bit-major")
    return name + ">"


def ptxas_lines(log: str) -> list[str]:
    """`kernel<M, layout>: <registers line>; <spill line>` for each
    kernel instantiation in the output of ptxas -v."""
    lines, name, spill = [], "", ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return lines


def build() -> None:
    """Phase 1: print the card, build the kernels from csrc/ (nvcc and
    g++ at once) and print ptxas's registers and spills per kernel."""
    from seaweedfs_tpu_torch.ops import _build

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
          f"host cpus {os.cpu_count()} (the host library's worker pool: one thread per CPU)")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc and g++ in parallel)")
    for line in ptxas_lines(logs["gf2_apply"]):
        print(f"  ptxas: {line}")


def rebuild_coeffs(lost: tuple[int, ...]) -> np.ndarray:
    """The (len(lost), K) rows that rebuild shards `lost` from the first
    K others, as the backend builds them."""
    from seaweedfs_tpu_torch.ec.backend import _decode_coeffs
    from seaweedfs_tpu_torch.ops import gf256

    src = tuple(i for i in range(K + M) if i not in lost)[:K]
    return _decode_coeffs(gf256.build_matrix(K, K + M), lost, src)


def kernel_phases(rng, flush):
    """Phases 2 and 2b; returns the timed rows of each entry point."""
    from seaweedfs_tpu_torch.ops import gf256

    encode_coeffs = gf256.parity_rows(K, M)
    decode_coeffs = rebuild_coeffs(LOST)
    read_coeffs = rebuild_coeffs((DEGRADED,))
    widths = (1, 7, 127, 1000, 4099, (1 << 20) + 3)
    for coeffs in (encode_coeffs, decode_coeffs):
        for n in widths + TILE_EDGES:
            check_kernel("gf2_apply", coeffs, n, rng, flush, timed=False)
        row = check_kernel("gf2_apply", coeffs, 1 << 20, rng, flush, timed=False, misaligned=True)
    print(f"gf2_apply exact at widths {list(widths + TILE_EDGES)} and on misaligned data "
          f"(offset {row['data_offset']}), encode m=4 and rebuild m=2 coefficients")
    rows = {}
    for label, coeffs, n in (
        ("encode 10x1MiB m=4", encode_coeffs, 1 << 20),
        ("decode 10x1MiB m=2", decode_coeffs, 1 << 20),
        ("encode 10x16MiB m=4", encode_coeffs, 16 << 20),
        ("decode 10x16MiB m=2", decode_coeffs, 16 << 20),
        ("leaf repair 10x64KiB m=1", read_coeffs, 64 << 10),
    ):
        rows[label] = check_kernel("gf2_apply", coeffs, n, rng, flush)
        print(f"gf2_apply {label} (tolerance 0, exact): " + json.dumps(rows[label]))

    # -- 2b. the plane-stack entry point -------------------------------------
    for pack_width in (1, 2):  # m_pad 32 and 16
        for m in (1, 2, 4):
            coeffs = rng.integers(0, 256, (m, K), dtype=np.uint8)
            for n in widths + TILE_EDGES:
                check_kernel("gf2_apply_planes", coeffs, n, rng, flush, timed=False,
                             pack_width=pack_width)
            row = check_kernel("gf2_apply_planes", coeffs, 1 << 20, rng, flush, timed=False,
                               pack_width=pack_width, misaligned=True)
    print(f"gf2_apply_planes exact at widths {list(widths + TILE_EDGES)} and on misaligned "
          f"data (offset {row['data_offset']}), m 1, 2, 4, m_pad 32 and 16")
    prows = {}
    for label, n in (
        ("degraded read 10x64KiB m=1", 64 << 10),
        ("degraded read 10x256KiB m=1", 256 << 10),
        ("degraded read 10x1MiB m=1", 1 << 20),
        ("decode 10x16MiB m=1", 16 << 20),
    ):
        prows[label] = check_kernel("gf2_apply_planes", read_coeffs, n, rng, flush)
        print(f"gf2_apply_planes {label} (tolerance 0, exact): " + json.dumps(prows[label]))
    for label, n in (("10x1MiB m=1", 1 << 20), ("10x16MiB m=1", 16 << 20)):
        row = check_kernel("gf2_apply", read_coeffs, n, rng, flush)
        print(f"yardstick: gf2_apply (the table body) on the same coefficients "
              f"{label}: " + json.dumps(row))
    return rows, prows


def write_volume(base: str, rng) -> list[tuple[int, int, int, int]]:
    """Seeded .dat of at most VOLUME_BYTES: the 8-byte superblock, then
    real version-3 needles (random body of 512 KiB to 1.5 MiB, about
    1 MiB on average, CRC32C, append time), and one .idx entry each.
    Returns (needle id, cookie, .dat offset, body length) per needle."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock
    from seaweedfs_tpu_torch.storage.types import NeedleValue, to_stored_offset

    ids = np.unique(rng.integers(1, 1 << 40, size=8192))
    rng.shuffle(ids)
    records = []
    entries = []
    with open(base + ".dat", "wb") as dat:
        dat.write(SuperBlock(version=3).to_bytes())
        off = dat.tell()
        while True:
            n = Needle(
                cookie=int(rng.integers(0, 1 << 32)),
                needle_id=int(ids[len(records)]),
                data=rng.bytes(int(rng.integers(512 << 10, 1536 << 10))),
                append_at_ns=time.time_ns(),
            )
            raw = n.to_bytes(3)
            if off + len(raw) > VOLUME_BYTES:
                break
            dat.write(raw)
            size = struct.unpack(">I", raw[12:16])[0]  # the header's body size
            entries.append(NeedleValue(n.needle_id, to_stored_offset(off), size).to_bytes())
            records.append((n.needle_id, n.cookie, off, len(n.data)))
            off += len(raw)
    with open(base + ".idx", "wb") as f:
        f.write(b"".join(entries))
    return records


def sha256(path: str, limit: int | None = None) -> str:
    """sha256 of the file, or of its first `limit` bytes."""
    h = hashlib.sha256()
    left = os.path.getsize(path) if limit is None else limit
    with open(path, "rb") as f:
        while left > 0 and (chunk := f.read(min(16 << 20, left))):
            h.update(chunk)
            left -= len(chunk)
    return h.hexdigest()


def percentile_ms(seconds: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def python_plane_encode(work, base, ctx, digests, prot) -> dict:
    """Phase 4, second half: the same .dat (hard-linked) encoded with
    SEAWEED_EC_NATIVE=0, the Python byte plane. Its 14 shards must be
    sha256-identical to the native plane's and its sidecar's block and
    leaf CRC lists equal (not the files: each carries a fresh uuid).
    Returns its wall and stage table."""
    from seaweedfs_tpu_torch.ec import BitrotProtection, TorchBackend, ec_encode_volume, native_io

    d = os.path.join(work, "python-plane")
    os.makedirs(d)
    pbase = os.path.join(d, "1")
    for ext in (".dat", ".idx"):
        os.link(base + ext, pbase + ext)
    backend = TorchBackend(ctx)
    native_io.reset_counts()
    before = os.environ.get("SEAWEED_EC_NATIVE")
    os.environ["SEAWEED_EC_NATIVE"] = "0"
    try:
        t0 = time.perf_counter()
        ec_encode_volume(pbase, ctx, backend=backend)
        dt = time.perf_counter() - t0
    finally:
        if before is None:
            del os.environ["SEAWEED_EC_NATIVE"]
        else:
            os.environ["SEAWEED_EC_NATIVE"] = before
    if any(native_io.COUNTS.values()) or backend.pin_skips:
        raise AssertionError(f"the Python plane used the native one: {native_io.COUNTS}")
    pprot = BitrotProtection.load(pbase + ".ecsum")
    lists = lambda pr: (pr.shard_sizes, pr.shard_crcs, pr.leaf_size, pr.shard_leaf_crcs)  # noqa: E731
    if lists(pprot) != lists(prot):
        raise AssertionError("the Python plane's block or leaf CRC lists differ from the native plane's")
    for i in range(ctx.total):
        if sha256(pbase + ctx.to_ext(i)) != digests[i]:
            raise AssertionError(f"shard {i} of the Python plane differs from the native plane's")
    shutil.rmtree(d)
    return {"seconds": dt, "stage_seconds": dict(backend.stage_seconds)}


def read_phase(work, base, ctx, records, dat_size, rng):
    """Phase 6: degraded needle reads with shard DEGRADED unmounted."""
    from seaweedfs_tpu_torch.ec import EcVolume, TorchBackend, native_io
    from seaweedfs_tpu_torch.ec.decoder import record_actual_size
    from seaweedfs_tpu_torch.ec.locate import locate_data
    from seaweedfs_tpu_torch.ops import rs_kernels

    def intervals(rec):
        _, _, off, body = rec
        # record size from the body length: data size(4) + data + flags(1)
        size = record_actual_size(4 + body + 1, 3)
        return [
            (*iv.to_shard_and_offset(K), iv.size)
            for iv in locate_data(off, size, dat_size // K, K)
        ]

    degraded = [r for r in records if any(sid == DEGRADED for sid, _, _ in intervals(r))]
    healthy = [
        r for r in records if all(sid not in (DEGRADED, ROTTEN) for sid, _, _ in intervals(r))
    ]
    dat_fd = os.open(base + ".dat", os.O_RDONLY)

    def original(rec) -> bytes:
        return os.pread(dat_fd, rec[3], rec[2] + 20)  # header(16) + data size(4)

    backend = TorchBackend(ctx, impl="cuda_planes")
    ev = EcVolume(work, 1, backend=backend)
    cache = ev.interval_cache
    try:
        ev.unmount_shards([DEGRADED])
        rs_kernels.reset_launches()
        native_io.reset_counts()
        lat, returned = [], 0
        b0, t_all = ev.bytes_read, time.perf_counter()
        for rec in degraded:
            t0 = time.perf_counter()
            n = ev.read_needle(rec[0], cookie=rec[1])
            lat.append(time.perf_counter() - t0)
            if n.data != original(rec):
                raise AssertionError(f"degraded read of needle {rec[0]:x} differs")
            returned += sum(s for _, _, s in intervals(rec))
        cold_s = time.perf_counter() - t_all
        cold_read = ev.bytes_read - b0
        cold_launches = rs_kernels.LAUNCHES["gf2_apply_planes"]
        if cold_launches != cache.loads or cache.hits:
            raise AssertionError(
                f"{cold_launches} launches for {cache.loads} cache misses, {cache.hits} hits"
            )

        # cached re-reads: no launch, and only the needles' healthy
        # intervals are read from disk
        lat_cached = []
        for rec in degraded[-8:]:
            b1 = ev.bytes_read
            t0 = time.perf_counter()
            n = ev.read_needle(rec[0], cookie=rec[1])
            lat_cached.append(time.perf_counter() - t0)
            healthy_bytes = sum(s for sid, _, s in intervals(rec) if sid != DEGRADED)
            if n.data != original(rec) or ev.bytes_read - b1 != healthy_bytes:
                raise AssertionError(f"cached re-read of needle {rec[0]:x} went wrong")
        if rs_kernels.LAUNCHES["gf2_apply_planes"] != cold_launches or cache.hits < 8:
            raise AssertionError("cached re-reads launched the kernel or missed the cache")

        # reads that avoid the lost shard launch nothing
        lat_healthy = []
        for i in rng.choice(len(healthy), size=min(100, len(healthy)), replace=False):
            rec = healthy[int(i)]
            t0 = time.perf_counter()
            n = ev.read_needle(rec[0], cookie=rec[1])
            lat_healthy.append(time.perf_counter() - t0)
            if n.data != original(rec):
                raise AssertionError(f"healthy read of needle {rec[0]:x} differs")
        if rs_kernels.LAUNCHES["gf2_apply_planes"] != cold_launches:
            raise AssertionError("a healthy read launched the kernel")

        # a flipped byte of shard ROTTEN under one needle: the CRC check
        # fails and the read heals through verified reconstruction
        rec = next(
            r for r in records
            if any(sid == ROTTEN for sid, _, _ in intervals(r))
            and all(sid != DEGRADED for sid, _, _ in intervals(r))
        )
        sid, shard_off, size = next(iv for iv in intervals(rec) if iv[0] == ROTTEN)
        at = shard_off + size // 2
        with open(base + ctx.to_ext(ROTTEN), "r+b") as f:
            f.seek(at)
            byte = f.read(1)
            f.seek(at)
            f.write(bytes([byte[0] ^ 0x5A]))
        loads0 = cache.loads
        n = ev.read_needle(rec[0], cookie=rec[1])
        if n.data != original(rec):
            raise AssertionError("self-heal read is not bit-exact")
        heal_launches = rs_kernels.LAUNCHES["gf2_apply_planes"] - cold_launches
        if heal_launches < 1 or heal_launches != cache.loads - loads0:
            raise AssertionError(f"self-heal: {heal_launches} launches, {cache.loads - loads0} misses")
        launches = rs_kernels.LAUNCHES["gf2_apply_planes"]
        if launches != cache.loads or rs_kernels.LAUNCHES["gf2_apply"]:
            raise AssertionError("read path launches do not match its cache misses")
        sibling_reads = native_io.COUNTS["read_exact"]
        if sibling_reads < K * cache.loads:
            raise AssertionError(f"{sibling_reads} native sibling reads for {cache.loads} reconstructions")
        result = {
            "degraded_reads": len(degraded),
            "cold_p50_ms": percentile_ms(lat, 50),
            "cold_p99_ms": percentile_ms(lat, 99),
            "cached_p50_ms": percentile_ms(lat_cached, 50),
            "cached_p99_ms": percentile_ms(lat_cached, 99),
            "healthy_reads": len(lat_healthy),
            "healthy_p50_ms": percentile_ms(lat_healthy, 50),
            "degraded_reads_per_s": len(degraded) / cold_s,
            "bytes_read_per_byte_returned": cold_read / returned,
            "reconstructions": launches,
            "native_sibling_reads": sibling_reads,
            "self_heal_launches": heal_launches,
            "read_stage_seconds": dict(ev.stage_seconds),
            "backend_stage_seconds": {
                k: v for k, v in backend.stage_seconds.items() if k in ("pin", "h2d", "kernel", "d2h")
            },
        }
        first = len(records) // 3
        deleted = [r[0] for r in records[first :: (len(records) - first) // N_DELETED]][:N_DELETED]
        if len(deleted) != N_DELETED or any(ev.delete_needle(nid) <= 0 for nid in deleted):
            raise AssertionError(f"deleting needles {deleted} failed")
    finally:
        ev.close()
        os.close(dat_fd)
    return result, launches, deleted


# Each window of the repair journal: (point the child dies at, mutate
# point torn at the same seam, whether recovery must roll forward), and
# last a crash of recovery itself, mid-replay.
WINDOWS = [
    ("ec.repair.journal_write", "ec.repair.journal_bytes", False),
    ("ec.repair.journal_write", None, False),
    ("ec.repair.after_journal", None, True),
    ("ec.repair.patch_write", "ec.repair.patch_bytes", True),
    ("ec.repair.patch_write", None, True),
    ("ec.repair.after_patch", None, True),
    ("ec.repair.after_sidecar", None, True),
    ("ec.repair.patch_write", None, True),  # recovery killed mid-replay
]

# The child of one crash window: arms the port's fault registry, then
# either repairs the rotten leaves of a shard (reconstructing on the
# card) or recovers a pending journal, and dies at the armed point.
CRASH_CHILD = r"""
import sys
from seaweedfs_tpu_torch import faults
from seaweedfs_tpu_torch.ec import ECContext, TorchBackend, reconstruct_leaves
from seaweedfs_tpu_torch.ec.bitrot import BitrotProtection
from seaweedfs_tpu_torch.ec.repair_journal import (
    apply_leaf_repair, leaf_verdict, recover_volume_journals,
)
from seaweedfs_tpu_torch.ops import rs_kernels

base, sid, point, mutate_point, mode = sys.argv[1:6]
sid, ctx = int(sid), ECContext(10, 4)
faults.inject(point, faults.hard_exit(137))
if mutate_point != "-":
    faults.inject(mutate_point, faults.truncate(0.5))
if mode == "recover":
    recover_volume_journals(base, ctx)
else:
    prot = BitrotProtection.load(base + ".ecsum")
    path = base + ctx.to_ext(sid)

    def read_range(s, lo, size):
        with open(base + ctx.to_ext(s), "rb") as f:
            f.seek(lo)
            return f.read(size)

    patches = reconstruct_leaves(
        prot, ctx, sid, leaf_verdict(path, sid, prot), read_range,
        [i for i in range(ctx.total) if i != sid], backend=TorchBackend(ctx),
    )
    print("leaves", [p.leaf for p in patches], "launches",
          rs_kernels.LAUNCHES["gf2_apply"], flush=True)
    apply_leaf_repair(path, sid, prot, patches)
sys.exit(3)  # the armed point never fired
"""


def flip(path: str, at: int) -> None:
    with open(path, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0xA5]))


def scrub_phase(work, base, ctx, records, dat_size, digests):
    """Phase 6b: scrub, leaf repair, crash windows healed at mount,
    quarantine and rebuild. Returns (result, gf2_apply launches)."""
    from seaweedfs_tpu_torch.ec import (
        BitrotProtection, EcVolume, LeafPatch, RepairJournal, TorchBackend, native_io, scrub_ec_volume,
    )
    from seaweedfs_tpu_torch.ec.decoder import record_actual_size
    from seaweedfs_tpu_torch.ec.locate import locate_data
    from seaweedfs_tpu_torch.ec.repair_journal import journal_path, leaf_ranges
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.utils.crc import crc32c
    from seaweedfs_tpu_torch.utils.fs import atomic_write

    shard = {i: base + ctx.to_ext(i) for i in range(ctx.total)}
    for i in range(ctx.total):
        if sha256(shard[i]) != digests[i]:
            raise AssertionError(f"phase 6b starts with shard {i} not as encoded")
    prot = BitrotProtection.load(base + ".ecsum")
    lsize, n_leaves = prot.leaf_size, len(prot.shard_leaf_crcs[LEAF_DATA])
    shard_bytes = sum(prot.shard_sizes)
    backend = TorchBackend(ctx)
    launches = 0
    result: dict = {}

    def kernel_stages() -> dict:
        return {k: v for k, v in backend.stage_seconds.items() if k in ("pin", "h2d", "kernel", "d2h")}

    # -- a clean pass: every leaf of every shard read and CRC'd -----------
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    r = scrub_ec_volume(base, ctx, backend=backend, repair=True)
    clean_s = time.perf_counter() - t0
    if not r.healthy or r.checked_bytes != shard_bytes or r.leaf_repaired or any(rs_kernels.LAUNCHES.values()):
        raise AssertionError(f"clean scrub pass is not clean: {r}")
    result["clean_pass"] = {"seconds": clean_s, "shard_bytes": shard_bytes,
                            "gb_per_s": shard_bytes / clean_s / 1e9, "leaves": r.checked_leaves}

    # -- leaf repair: three leaves of shard 3 (two adjacent), one of 12 ---
    a, b, c = n_leaves // 3, 2 * n_leaves // 3, n_leaves // 2
    rotten = {LEAF_DATA: [a, a + 1, b], LEAF_PARITY: [c]}
    for sid, leaves in rotten.items():
        for li in leaves:
            flip(shard[sid], li * lsize + 1000)
    n_ranges = sum(len(leaf_ranges(ls, lsize, prot.shard_sizes[s])) for s, ls in rotten.items())
    backend.reset_stages()
    rs_kernels.reset_launches()
    stages: dict = {}
    t0 = time.perf_counter()
    r = scrub_ec_volume(base, ctx, backend=backend, repair=True, stages=stages)
    repair_s = time.perf_counter() - t0
    repair_launches = rs_kernels.LAUNCHES["gf2_apply"]
    if r.leaf_repaired != rotten or r.quarantined or r.rebuilt or r.refused or r.corrupt_shards:
        raise AssertionError(f"leaf repair: {r}")
    if repair_launches != n_ranges or rs_kernels.LAUNCHES["gf2_apply_planes"]:
        raise AssertionError(f"leaf repair launched {rs_kernels.LAUNCHES} for {n_ranges} leaf ranges")
    for sid in rotten:
        if sha256(shard[sid]) != digests[sid]:
            raise AssertionError(f"leaf-repaired shard {sid} differs from its encode-time bytes")
    for i in range(ctx.total):
        if prot.verify_shard_file(shard[i], i):
            raise AssertionError(f"shard {i} fails .ecsum after leaf repair")
    launches += repair_launches
    per_range = sum(stages.values()) / n_ranges
    result["leaf_repair"] = {
        "leaves": rotten, "ranges": n_ranges, "launches": repair_launches,
        "scrub_seconds": repair_s, "ms_per_range": per_range * 1e3,
        "stage_seconds": stages, "backend_stage_seconds": kernel_stages(),
    }

    # -- crash windows, each healed by the next mount ----------------------
    def intervals(rec):
        _, _, off, body = rec
        size = record_actual_size(4 + body + 1, 3)
        return [(*iv.to_shard_and_offset(K), iv.size) for iv in locate_data(off, size, dat_size // K, K)]

    dat_fd = os.open(base + ".dat", os.O_RDONLY)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    jpath = journal_path(shard[LEAF_DATA])
    windows = []
    try:
        for w, (point, mutate_point, expect_new) in enumerate(WINDOWS):
            recovery_crash = w == len(WINDOWS) - 1
            leaf = n_leaves // 8 + 3 * w
            lo = leaf * lsize
            with open(shard[LEAF_DATA], "rb") as f:
                f.seek(lo)
                good = f.read(lsize)
            flip(shard[LEAF_DATA], lo + 77)
            pre = sha256(shard[LEAF_DATA])
            if recovery_crash:  # a pending journal that carries the right bytes
                atomic_write(jpath, RepairJournal(
                    LEAF_DATA, prot.generation, prot.uuid, lsize, prot.shard_sizes[LEAF_DATA],
                    [LeafPatch(leaf, lo, good, crc32c(good))],
                ).to_bytes())
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", CRASH_CHILD, base, str(LEAF_DATA), point,
                 mutate_point or "-", "recover" if recovery_crash else "repair"],
                cwd=repo, env=env, capture_output=True, text=True, timeout=60,
            )
            child_s = time.perf_counter() - t0
            if proc.returncode != 137 or not os.path.exists(jpath):
                raise AssertionError(
                    f"window {w} ({point}): child exit {proc.returncode}, journal "
                    f"{'present' if os.path.exists(jpath) else 'absent'}\n{proc.stdout}{proc.stderr}"
                )
            rs_kernels.reset_launches()
            t0 = time.perf_counter()
            ev = EcVolume(work, 1, backend=backend)
            mount_s = time.perf_counter() - t0
            try:
                rec = ev.journal_recovery
                after = sha256(shard[LEAF_DATA])
                fully_new, fully_old = after == digests[LEAF_DATA], after == pre
                if os.path.exists(jpath) or rec is None or not (fully_new or fully_old):
                    raise AssertionError(f"window {w} ({point}): mount left {rec}, "
                                         f"fully new {fully_new}, fully old {fully_old}")
                if expect_new and not (fully_new and rec["replayed"].get(LEAF_DATA)):
                    raise AssertionError(f"window {w} ({point}) did not roll forward: {rec}")
                if fully_old and rec["rolled_back"] != [jpath]:
                    raise AssertionError(f"window {w} ({point}) is fully old but {rec}")
                patched = rec["replayed"].get(LEAF_DATA, [leaf])
                over = [
                    needle for needle in records
                    if any(sid == LEAF_DATA and any(off < (p + 1) * lsize and p * lsize < off + n
                                                   for p in patched)
                           for sid, off, n in intervals(needle))
                ]
                for nid, cookie, off, body in over:
                    if ev.read_needle(nid, cookie=cookie).data != os.pread(dat_fd, body, off + 20):
                        raise AssertionError(f"window {w}: needle {nid:x} over the patched leaves differs")
            finally:
                ev.close()
            launches += rs_kernels.LAUNCHES["gf2_apply"]
            windows.append({
                "point": point + (f"+{mutate_point}" if mutate_point else "")
                + (" (recovery)" if recovery_crash else ""),
                "child": proc.stdout.strip(), "child_s": child_s, "mount_s": mount_s,
                "replayed": rec["replayed"].get(LEAF_DATA, []), "rolled_back": len(rec["rolled_back"]),
                "state": "new" if fully_new else "old", "needles_read": len(over),
            })
    finally:
        os.close(dat_fd)
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    r = scrub_ec_volume(base, ctx, backend=backend, repair=True)
    closing_s = time.perf_counter() - t0
    launches += rs_kernels.LAUNCHES["gf2_apply"]
    if not r.complete or r.refused or r.quarantined or sha256(shard[LEAF_DATA]) != digests[LEAF_DATA]:
        raise AssertionError(f"closing scrub did not restore shard {LEAF_DATA}: {r}")
    result["crash_windows"] = windows
    result["closing_scrub"] = {"seconds": closing_s, "leaf_repaired": r.leaf_repaired}

    # -- size rot: quarantine to .bad and rebuild through gf2_apply --------
    os.truncate(shard[SIZE_ROT], prot.shard_sizes[SIZE_ROT] - 4096)
    backend.reset_stages()
    rs_kernels.reset_launches()
    native_io.reset_counts()
    t0 = time.perf_counter()
    r = scrub_ec_volume(base, ctx, backend=backend, repair=True)
    quarantine_s = time.perf_counter() - t0
    q_launches = rs_kernels.LAUNCHES["gf2_apply"]
    bad = shard[SIZE_ROT] + ".bad"
    if r.quarantined != [bad] or r.rebuilt != [SIZE_ROT] or r.refused or q_launches < 1:
        raise AssertionError(f"quarantine and rebuild: {r}, {q_launches} launches")
    if sha256(shard[SIZE_ROT]) != digests[SIZE_ROT]:
        raise AssertionError(f"rebuilt shard {SIZE_ROT} differs from its encode-time bytes")
    q_plane = dict(native_io.COUNTS)
    if not q_plane["read_batch"] or q_plane["sink_append"] != q_plane["read_batch"]:
        raise AssertionError(f"the quarantine's rebuild did not run on the native plane: {q_plane}")
    os.unlink(bad)
    launches += q_launches
    result["quarantine_rebuild"] = {"seconds": quarantine_s, "launches": q_launches,
                                    "native_plane": q_plane,
                                    "backend_stage_seconds": kernel_stages()}
    for i in range(ctx.total):
        if sha256(shard[i]) != digests[i]:
            raise AssertionError(f"phase 6b leaves shard {i} not as encoded")
    result["gf2_apply_launches"] = launches
    return result, launches


def decode_phase(base, ctx, digest3, deleted):
    """Phase 7: ec.decode with shard DEGRADED removed (5 needles deleted)."""
    from seaweedfs_tpu_torch.ec import TorchBackend, ec_decode_volume, native_io
    from seaweedfs_tpu_torch.ec.decoder import find_dat_file_size
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.storage.types import NEEDLE_MAP_ENTRY_SIZE

    with open(base + ".ecx", "rb") as f:
        ecx = bytearray(f.read())
    for o in range(0, len(ecx), NEEDLE_MAP_ENTRY_SIZE):  # .ecj folded in place
        if int.from_bytes(ecx[o : o + 8], "big") in deleted:
            ecx[o + 12 : o + 16] = b"\xff\xff\xff\xff"
    shard_size = os.path.getsize(base + ctx.to_ext(DEGRADED))
    os.unlink(base + ctx.to_ext(DEGRADED))
    os.replace(base + ".dat", base + ".dat.orig")
    os.unlink(base + ".idx")
    stages: dict = {}
    backend = TorchBackend(ctx, impl="cuda_planes")
    rs_kernels.reset_launches()
    native_io.reset_counts()
    t0 = time.perf_counter()
    if not ec_decode_volume(base, ctx, backend=backend, stages=stages):
        raise AssertionError("decode found no live needle")
    dt = time.perf_counter() - t0
    launches = rs_kernels.LAUNCHES["gf2_apply_planes"]
    batches = -(-shard_size // DEFAULT_BATCH)
    if launches != batches or rs_kernels.LAUNCHES["gf2_apply"]:
        raise AssertionError(f"decode launched {launches} planes kernels for {batches} batches")
    plane = dict(native_io.COUNTS)
    if plane["read_batch"] != batches or plane["sink_append"] != batches or not plane["read_exact"]:
        raise AssertionError(f"decode's reads did not run on the native plane: {plane}")
    if sha256(base + ctx.to_ext(DEGRADED)) != digest3:
        raise AssertionError(f"regenerated shard {DEGRADED} differs from the original")
    live = find_dat_file_size(base, 3)
    if os.path.getsize(base + ".dat") != live or sha256(base + ".dat") != sha256(base + ".dat.orig", live):
        raise AssertionError("decoded .dat differs from the original cut to its live extent")
    with open(base + ".idx", "rb") as f:
        if f.read() != bytes(ecx):
            raise AssertionError(".idx differs from .ecx with the deletions as tombstones")
    stages.update({k: v for k, v in backend.stage_seconds.items() if k in ("pin", "h2d", "kernel", "d2h")})
    return {
        "deleted_needles": len(deleted),
        "dat_bytes": live,
        "seconds": dt,
        "gb_per_s": live / dt / 1e9,
        "launches": launches,
        "rebuild_batches": batches,
        "native_plane": plane,
        "stage_seconds": stages,
    }, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from seaweedfs_tpu_torch.ec import (
        BitrotProtection,
        ECContext,
        TorchBackend,
        ec_encode_volume,
        native_io,
        rebuild_ec_files,
    )
    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.ops import _build, gf256, rs_kernels

    kind = torch.cuda.get_device_name(0)
    build()

    # -- 2, 2b. both entry points vs plain version vs oracle, and timings ------
    rng = np.random.default_rng(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows, prows = kernel_phases(rng, flush)
    del flush
    torch.cuda.empty_cache()
    ctx = ECContext(K, M)
    encode_coeffs = gf256.parity_rows(K, M)

    work = tempfile.mkdtemp(prefix="smoke-", dir=str(_build.BUILD_DIR))
    try:
        # -- 3-5. encode, then rebuild, of a 1 GiB volume ------------------------
        base = os.path.join(work, "1")
        t0 = time.perf_counter()
        records = write_volume(base, rng)
        dat_size = os.path.getsize(base + ".dat")
        print(f"volume: {dat_size} bytes, {len(records)} needles, "
              f"written in {time.perf_counter() - t0:.3f} s")

        backend = TorchBackend(ctx)
        plan = list(batch_plan(dat_size, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE))
        n_batches = len(plan)
        rs_kernels.reset_launches()
        native_io.reset_counts()
        t0 = time.perf_counter()
        ec_encode_volume(base, ctx, backend=backend)
        enc_s = time.perf_counter() - t0
        enc_launches = rs_kernels.LAUNCHES["gf2_apply"]
        enc_plane = dict(native_io.COUNTS, pin_skips=backend.pin_skips)
        if enc_launches != n_batches:
            raise AssertionError(f"encode launched {enc_launches} kernels for {n_batches} batches")
        # only the native reader counts read_batch and only FusedShardSink
        # counts sink_append: equal to the batches, they carried them all
        if not (enc_plane["read_batch"] == enc_plane["sink_append"] == enc_plane["pin_skips"] == n_batches):
            raise AssertionError(f"encode's {n_batches} batches did not all take the native plane "
                                 f"and a page-locked landing matrix: {enc_plane}")
        widths = len({w for *_, w in plan})
        if enc_plane["pool_alloc"] > IN_FLIGHT * widths:
            raise AssertionError(f"the landing pool grew past {IN_FLIGHT} matrices per width: {enc_plane}")
        prot = BitrotProtection.load(base + ".ecsum")
        for i in range(ctx.total):
            bad = prot.verify_shard_file(base + ctx.to_ext(i), i)
            if bad:
                raise AssertionError(f"shard {i} fails .ecsum at blocks {bad}")
        # sampled oracle check: the data shards stripe the .dat, and the
        # parity shards hold its RS parity, at three random rows
        shard_size = prot.shard_sizes[0]
        n_rows = shard_size // SMALL_BLOCK_SIZE
        with open(base + ".dat", "rb") as dat:
            for row in rng.choice(n_rows, size=3, replace=False):
                col = int(rng.integers(0, SMALL_BLOCK_SIZE - (1 << 16) + 1))
                data = np.zeros((K, 1 << 16), np.uint8)
                for i in range(K):
                    dat.seek(int(row) * K * SMALL_BLOCK_SIZE + i * SMALL_BLOCK_SIZE + col)
                    got = np.frombuffer(dat.read(1 << 16), np.uint8)
                    data[i, : len(got)] = got
                shard_off = int(row) * SMALL_BLOCK_SIZE + col
                want = np.concatenate([data, gf256.matrix_apply(encode_coeffs, data)])
                for i in range(ctx.total):
                    with open(base + ctx.to_ext(i), "rb") as f:
                        f.seek(shard_off)
                        if f.read(1 << 16) != want[i].tobytes():
                            raise AssertionError(f"shard {i} row {row} differs from the oracle")
        enc_stages = dict(backend.stage_seconds)
        print(f"encode: {dat_size} bytes in {enc_s:.3f} s = {dat_size / enc_s / 1e9:.3f} GB/s; "
              f"{n_batches} batches, {enc_launches} launches; all 14 shards verify; "
              f"stage seconds {json.dumps(enc_stages)}; native plane {json.dumps(enc_plane)}")

        digests = {i: sha256(base + ctx.to_ext(i)) for i in range(ctx.total)}
        py_plane = python_plane_encode(work, base, ctx, digests, prot)
        print("encode, native plane against Python plane (SEAWEED_EC_NATIVE=0) on the same .dat: "
              "14 shards sha256-identical, block and leaf CRC lists equal: " + json.dumps({
                  "native": {"seconds": enc_s, "stage_seconds": enc_stages},
                  "python": py_plane,
              }))
        for i in LOST:
            os.unlink(base + ctx.to_ext(i))
        backend = TorchBackend(ctx)
        rs_kernels.reset_launches()
        native_io.reset_counts()
        t0 = time.perf_counter()
        rebuilt = rebuild_ec_files(base, backend=backend)
        reb_s = time.perf_counter() - t0
        reb_launches = rs_kernels.LAUNCHES["gf2_apply"]
        reb_plane = dict(native_io.COUNTS, pin_skips=backend.pin_skips)
        reb_batches = -(-shard_size // DEFAULT_BATCH)
        if not (reb_plane["read_batch"] == reb_plane["sink_append"] == reb_plane["pin_skips"]
                == reb_batches) or reb_plane["pool_alloc"] > 2 * IN_FLIGHT:
            raise AssertionError(f"rebuild's {reb_batches} batches did not all take the native "
                                 f"plane and a page-locked landing matrix: {reb_plane}")
        if rebuilt != list(LOST):
            raise AssertionError(f"rebuild regenerated {rebuilt}, expected {list(LOST)}")
        for i in LOST:
            if sha256(base + ctx.to_ext(i)) != digests[i]:
                raise AssertionError(f"rebuilt shard {i} differs from the original")
        if reb_launches < 1:
            raise AssertionError("rebuild never launched the kernel")
        src_bytes = K * shard_size
        print(f"rebuild: shards {list(LOST)} from {src_bytes} source bytes in {reb_s:.3f} s = "
              f"{src_bytes / reb_s / 1e9:.3f} GB/s; {reb_launches} launches; sha256 identical; "
              f"stage seconds {json.dumps(dict(backend.stage_seconds))}; "
              f"native plane {json.dumps(reb_plane)}")

        # -- 6. degraded needle reads ----------------------------------------------
        shutil.copy(base + ctx.to_ext(ROTTEN), base + ctx.to_ext(ROTTEN) + ".orig")
        read, read_launches, deleted = read_phase(work, base, ctx, records, dat_size, rng)
        print(f"degraded reads (shard {DEGRADED} unmounted, all bit-exact): {json.dumps(read)}")

        # -- 6b. scrub, leaf repair, crash windows, quarantine -------------------------
        os.replace(base + ctx.to_ext(ROTTEN) + ".orig", base + ctx.to_ext(ROTTEN))
        scrub, scrub_launches = scrub_phase(work, base, ctx, records, dat_size, digests)
        print(f"scrub and leaf repair (every check exact): {json.dumps(scrub)}")

        # -- 7. ec.decode ---------------------------------------------------------------
        decode, dec_launches = decode_phase(base, ctx, digests[DEGRADED], deleted)
        print(f"decode ({N_DELETED} deleted, shard {DEGRADED} regenerated; .dat, .idx and "
              f"shard identical): {json.dumps(decode)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_row = rows["encode 10x1MiB m=4"]
    read_row = prows["degraded read 10x1MiB m=1"]
    kernels = []
    for name, replaces, launches, row, all_rows in (
        ("gf2_apply", "seaweedfs_tpu/ops/rs_pallas.py:55",
         enc_launches + reb_launches + scrub_launches,
         main_row, rows),
        ("gf2_apply_planes", "seaweedfs_tpu/ops/rs_pallas.py:257", read_launches + dec_launches,
         read_row, prows),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/csrc/gf2_apply.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in all_rows.values()),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    # one card driven, whatever else the host shows
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
