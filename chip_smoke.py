#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main paths at the size the project names, a seeded
1 GiB RS 10+4 volume of real needles, through the entry points a user
calls (`ec_encode_volume`, `rebuild_ec_files`, `EcVolume`,
`ec_decode_volume`, `TorchBackend`, `CpuBackend`, `rebuild_from_peers`).
Phases:

1. print the card (`nvidia-smi` name and power limit), and build from
   csrc/ the CUDA kernel (nvcc) and the host library (g++: CRC32C,
   batched reads, the shard sink, the GF(2^8) apply of the native CPU
   backend), both at once; then print the host's CPU model and count,
   whether it has AVX2 and the host library's pool threads;
2. hold `gf2_apply` (the bit-major entry point) against its plain torch
   version on the card with the 4-row encode matrix and a 2-row decode
   matrix, at ragged widths, at the widths on its tiles' edges and on
   data 1 byte off alignment (the masked byte path), and against the
   numpy oracle on a sampled 64 KiB window (tolerance 0: exact integer GF
   arithmetic), and at k = 1 with one generator column of 10+4 (m = 4)
   and of 4+2 (m = 2), the streaming encoder's parity delta, at widths
   under, on and past one 16-byte word; time it at the encode and rebuild
   shapes, (10, 1 MiB) and (10, 16 MiB) with each matrix, and at the
   stream's (1, 256 KiB) and ragged (1, 8 KiB + 5), beside the plain version,
   torch._int_mm on the same bit-plane product (a yardstick the port
   never calls), a device copy that moves the same bytes (the memory
   stream's time under the same method), and the host time of one
   wrapper call, and the native CPU backend's apply of the same bytes on
   the host (`cpu_ms`, a median of host-timer runs after a warm-up; its
   output must equal the kernel's);
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
   de-stripe's reads must have gone through the native plane;
7a. streaming EC: the first 256 MiB of the same .dat appended in 8 KiB
   pieces to an `EcStreamEncoder` (10+4, 1 MiB blocks, 64 KiB small
   blocks), flushed whenever 256 KiB is pending, closed with finalize:
   the 14 shards must be sha256-identical to one `write_ec_files` over
   the same bytes, with equal CRC lists, and `gf2_apply` must have
   launched once per chunk processed plus once per finalize tail stripe;
   it prints time-to-durable-parity p50/p99 per append, appends/s, the
   batch encode's wall, the stage tables, the device's busy share and
   the launches on each body;
7b. the MQ durable-parity partition: `PartitionParity` at the broker's
   defaults (4+2, 1 MiB blocks, flush at 256 KiB or 200 ms, rotation at
   64 MiB) takes 144 MiB of 1 KB records (16-byte keys) at 50,000
   records/s while a flusher thread applies the policy every 100 ms;
   closed and recovered by a fresh partition, every record must come
   back byte-exact, no parity may be rewritten, and recovery must launch
   once per stripe it re-derives. Then, for `ec.stream.seal`,
   `ec.stream.before_fsync` and `ec.stream.before_journal`, a child
   partition appending 8 MiB of the same records dies at the point
   (exit code 137; a fresh interpreter, as `fork` does not mix with
   CUDA), and the parent must recover a dense, byte-exact prefix reaching
   the child's last completed flush, verify every generation clean on a
   second pass, and append densely after it.
8. the native CPU backend (`CpuBackend`, the host library's AVX2 GF(2^8)
   apply) on the card's host, each run beside its card counterpart and
   on the same inputs (hard links to what it only reads, copies of what
   it writes): encode of the same .dat through the native byte plane
   (14 shards sha256-identical to the card's, CRC lists equal), rebuild
   of the same lost shards (sha256-identical), every degraded needle of
   phase 6 read cold through `EcVolume(..., backend=CpuBackend(ctx))`
   (bit-exact), and decode of the same state (.dat, .idx and the
   regenerated shard identical to the card's). No kernel may launch
   during a CpuBackend run. One line gives each operation's card and CPU
   walls, their ratio and both stage tables (the CPU's are host wall
   time: its "kernel" is the wall of its applies, and it has no pin,
   h2d or d2h), beside the card and the host's CPU.
9. the flight recorder (seaweedfs_tpu_torch/utils/trace.py) armed, the
   only phase that arms it, in a directory of hard links to the same .dat
   and .idx: encode (two armed runs between two disarmed ones, for the
   tracer's cost), rebuild of shards 3 and 11, 20 cold degraded reads of
   shard 3 (the `.heat` sidecar written at close must hold the reads'
   counters, and a fresh mount must read them back), one rotten leaf of
   shard 3 leaf-repaired, decode with shard 3 removed, a 32 MiB phase 7a
   stream and phase 7b's partition at its own traffic for at least 4
   flushes; every output sha256-identical to its disarmed counterpart
   (stream records replayed byte-exact). Then `trace.traces()` must hold
   one root per op, as `sw_ec_traces_total{op}` counts, every span tree
   the JAX package's invariants (one trace id, children inside their
   root, no stage but queue_wait longer than its span), the device
   stages (`admission_wait`, `h2d_dispatch`, `device_drain`) one per
   launch, labeled as the JAX package's call sites label them (a
   `TorchBackend` has no chip label, so its scheduled dispatch carries
   its device queue's label), every overlap efficiency in [0, 1], the
   registry's text parse line by
   line with the leaf repair counted, and the Chrome trace load. One line
   gives each op's wall, stage totals and counts and overlap efficiency,
   the armed over the disarmed encode wall, the partition's stage ms per
   flush beside phase 7b's solo flush and the share of flush wall no
   stage names, and the Chrome trace's event count.
10. the device scheduler and the CPU failover, on the same .dat (hard
   links) with every path a client of the per-chip `DeviceQueue`:
   10a the bounded device probe (`utils/devices.py`, a subprocess) and
   its wall, and `get_backend("auto", 10, 4)`, which must be a
   `FallbackBackend` over a `TorchBackend` on cuda:0 with no CPU
   resolution counted; 10b an encode through it: 14 shards
   sha256-identical to phase 4's, no batch on the CPU, the breaker and
   its gauge closed, one launch and one foreground admission
   (`sw_ec_queue_admitted_total`) per batch; 10b' the scheduler's cost:
   the same encode and 30 cold degraded reads of shard 3 with the scope
   disabled and enabled, in turns (off, on, on, off) in one process,
   outputs identical, admissions only when enabled; 10c failover armed by the
   smoke itself: an encode with every `to_host` failing
   (`ec.backend.device.to_host`, threshold 3, a short reset timeout) is
   sha256-identical with every batch recomputed on the CPU, the launches
   equal the batches that reached the card, the gauge reads 1 while the
   breaker is open; after the timeout an unarmed encode closes the
   breaker through its half-open probe; a rebuild of shards 3 and 11
   through the staged-apply driver on a card that loses three batches
   (two at `apply_staged`, before they launch, one at `to_host`, after;
   an OSError each, raised by a `TorchBackend` subclass of the smoke,
   since an armed fault registry sends rebuild down the chaos byte path)
   is sha256-identical, with those three batches on the CPU, the
   breaker closed and the launches equal to the batches that reached the
   card; 10d a foreground encode alone, then again
   beside a concurrent `priority="recovery"` rebuild of shards 3 and 11
   on the same `auto` backend under one `QueueScope`: both outputs
   sha256-identical, per-class admitted batches, cost and admission
   wait, both foreground walls and the ratio the JAX package's bar reads
   (an observation); 10e a 32 MiB phase 7a stream through
   `place_stream` (its and its batch encode's foreground admissions
   equal their launches) and phase 7b's partition with
   `SEAWEED_EC_STREAM_BACKEND=auto` for at least 4 flushes, replayed
   byte-exact. Any batch served on the CPU, or any CPU resolution of
   `auto`, outside 10c fails the run; in 10c the count must equal what
   the smoke injected.
11. peer-fetch rebuild (`rebuild_from_peers`) over the shard net plane,
   from copies made right after phase 5: a local holder of shards 0, 1,
   2 and 4 (fewer than k; two non-adjacent 64 KiB leaves of shard 4
   rotten) and three peers in one child process (a fresh interpreter
   that touches no CUDA), a `ShardNetPlane` each with its own generation
   fence, one holder per shard of 5-10, 12 and 13, plus a fourth holder
   of shard 5, first in its list, serving one flipped byte outside shard
   4's rotten leaves. 11a, native plane (`fetch_into` =
   `make_fetch_into`, `fetch` = `NetPlaneClient.read_bytes`): shard 4
   leaf-repaired from 7 peers and 3 local sources per range with no
   re-read, the rotten holder excluded after one granule re-read, shards
   5-10 fetched, 3 and 11 rebuilt on `TorchBackend`, all sha256-identical;
   `gf2_apply` launches == the rebuild's batches + the 2 leaf ranges; the
   `sw_net_bytes_received_total` deltas exact per plane; no staging and
   no no-plane memo left. 11b: the same over the Python plane, outputs
   identical. 11c: two peers stopped, fewer than k sources reachable:
   `ECError`, every local file sha256-unchanged. One line gives per run
   the wall, the nested rebuild's wall, the fetched bytes and GB/s over
   loopback, each transport's calls, bytes and seconds, the backend's
   stages and the `sw_net_*` deltas, the peers' status and whether a 4
   MiB fused recv takes the overlapped core.

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


def cpu_ms(coeffs: np.ndarray, data: np.ndarray, want: np.ndarray) -> float:
    """Median host wall, in ms, of the native CPU backend's apply of
    `coeffs` to `data` (numpy, on the host) after one warm-up call, whose
    output must equal `want`, the kernel's."""
    from seaweedfs_tpu_torch.ec import CpuBackend, ECContext

    cpu = CpuBackend(ECContext(K, M))
    if not np.array_equal(cpu.apply(coeffs, data), want):
        raise AssertionError(f"CpuBackend != kernel at m={coeffs.shape[0]}, {data.shape}")
    times = []
    for _ in range(11 if data.nbytes >= (64 << 20) else 21):
        t0 = time.perf_counter()
        cpu.apply(coeffs, data)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def check_kernel(kind, coeffs, n, rng, flush, timed=True, pack_width=1, misaligned=False):
    """Kernel vs plain version vs numpy oracle at (K, n); returns the
    shape's row of measurements. `kind` is "gf2_apply" (bit-major
    operand) or "gf2_apply_planes" (plane stack of `pack_width`).
    `misaligned` puts the data 1 byte past a 16-byte boundary (a
    contiguous view of a larger buffer). A timed row also holds
    `cpu_ms`, the native CPU backend's apply of the same bytes on the
    host (checked equal to the kernel's output)."""
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
    row["cpu_ms"] = cpu_ms(coeffs, data_np, out.cpu().numpy())
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
    if n % 8:  # _int_mm takes a multiple of 8 columns: zero columns pad a ragged width
        planes = torch.cat([planes, torch.zeros((8 * k, 8 - n % 8), dtype=torch.int8, device="cuda")], 1)
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


# Chunk widths of the stream's k = 1 deltas: below one 16-byte word, on
# and off its edges, a ragged MQ flush, and 256 KiB (the flush threshold).
STREAM_WIDTHS = (1, 5, 15, 16, 17, 1062, 4099, (8 << 10) + 5, 256 << 10, (1 << 20) - 3, 1 << 20)


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


def host_info() -> dict:
    """The card's host as the native CPU backend sees it."""
    from seaweedfs_tpu_torch.utils import native

    fields: dict = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    # some hosts' /proc/cpuinfo says "unknown" for the model name: name the
    # part by its vendor, family and model numbers then
    model = fields.get("model name", "unknown")
    if model == "unknown":
        model = " ".join(
            f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model") if k in fields
        ) or "not reported"
    return {"cpu_model": model, "cpus": os.cpu_count(), "has_avx2": native.has_avx2(),
            "pool_threads": native.pool_threads()}


def build() -> None:
    """Phase 1: print the card, build the kernels from csrc/ (nvcc and
    g++ at once) and print ptxas's registers and spills per kernel."""
    from seaweedfs_tpu_torch.ops import _build

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc and g++ in parallel)")
    print("host: " + json.dumps(host_info()))
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
    # the stream's parity deltas: one generator column (k = 1) over a
    # chunk of any width, m = 4 (10+4 volumes) and m = 2 (4+2 MQ streams)
    column_coeffs = (gf256.parity_rows(K, M)[:, 3:4], gf256.parity_rows(4, 2)[:, 1:2])
    for coeffs in column_coeffs:
        for n in STREAM_WIDTHS:
            check_kernel("gf2_apply", coeffs, n, rng, flush, timed=False)
        check_kernel("gf2_apply", coeffs, (1 << 20) + 3, rng, flush, timed=False, misaligned=True)
    print(f"gf2_apply exact at k=1 (the stream's parity deltas), m=4 and m=2, at widths "
          f"{list(STREAM_WIDTHS)} and on misaligned data")
    rows = {}
    for label, coeffs, n in (
        ("encode 10x1MiB m=4", encode_coeffs, 1 << 20),
        ("decode 10x1MiB m=2", decode_coeffs, 1 << 20),
        ("encode 10x16MiB m=4", encode_coeffs, 16 << 20),
        ("decode 10x16MiB m=2", decode_coeffs, 16 << 20),
        ("leaf repair 10x64KiB m=1", read_coeffs, 64 << 10),
        ("stream delta 1x256KiB m=4", column_coeffs[0], 256 << 10),
        ("stream delta 1x(8KiB+5) m=4", column_coeffs[0], (8 << 10) + 5),
        ("stream delta 1x256KiB m=2", column_coeffs[1], 256 << 10),
        ("stream delta 1x(8KiB+5) m=2", column_coeffs[1], (8 << 10) + 5),
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


def needle_stream(rng):
    """The smoke's seeded needles, in write order: (needle id, cookie,
    random body of 512 KiB to 1.5 MiB, about 1 MiB on average)."""
    ids = np.unique(rng.integers(1, 1 << 40, size=8192))
    rng.shuffle(ids)
    for nid in ids:
        cookie = int(rng.integers(0, 1 << 32))
        yield int(nid), cookie, rng.bytes(int(rng.integers(512 << 10, 1536 << 10)))


def write_volume(base: str, rng) -> list[tuple[int, int, int, int]]:
    """Seeded .dat of at most VOLUME_BYTES: the 8-byte superblock, then
    real version-3 needles (`needle_stream`: CRC32C, append time), and one
    .idx entry each. Returns (needle id, cookie, .dat offset, body
    length) per needle."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock
    from seaweedfs_tpu_torch.storage.types import NeedleValue, to_stored_offset

    stream = needle_stream(rng)
    records = []
    entries = []
    with open(base + ".dat", "wb") as dat:
        dat.write(SuperBlock(version=3).to_bytes())
        off = dat.tell()
        while True:
            nid, cookie, body = next(stream)
            n = Needle(cookie=cookie, needle_id=nid, data=body, append_at_ns=time.time_ns())
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


def needle_intervals(rec, dat_size: int) -> list[tuple[int, int, int]]:
    """(shard id, shard offset, size) of each piece of a needle record."""
    from seaweedfs_tpu_torch.ec.decoder import record_actual_size
    from seaweedfs_tpu_torch.ec.locate import locate_data

    _, _, off, body = rec
    # record size from the body length: data size(4) + data + flags(1)
    size = record_actual_size(4 + body + 1, 3)
    return [(*iv.to_shard_and_offset(K), iv.size) for iv in locate_data(off, size, dat_size // K, K)]


def degraded_records(records, dat_size: int) -> list:
    """The needles with a piece on shard DEGRADED."""
    return [r for r in records if any(sid == DEGRADED for sid, _, _ in needle_intervals(r, dat_size))]


def read_phase(work, base, ctx, records, dat_size, rng):
    """Phase 6: degraded needle reads with shard DEGRADED unmounted."""
    from seaweedfs_tpu_torch.ec import EcVolume, TorchBackend, native_io
    from seaweedfs_tpu_torch.ops import rs_kernels

    def intervals(rec):
        return needle_intervals(rec, dat_size)

    degraded = degraded_records(records, dat_size)
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
            "cold_seconds": cold_s,
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
    # the JAX stage names: repair_patch's split keys ("repair_patch.*") are in it
    per_range = sum(v for k, v in stages.items() if "." not in k) / n_ranges
    result["leaf_repair"] = {
        "leaves": rotten, "ranges": n_ranges, "launches": repair_launches,
        "scrub_seconds": repair_s, "ms_per_range": per_range * 1e3,
        "stage_seconds": stages, "backend_stage_seconds": kernel_stages(),
    }

    # -- crash windows, each healed by the next mount ----------------------
    def intervals(rec):
        return needle_intervals(rec, dat_size)

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


# -- 8. the native CPU backend on the card's host --------------------------------
#
# Each run below sits next to its card counterpart in main() and works on
# the same inputs: a directory of hard links to the files the operation
# only reads, and copies of those it writes. CpuBackend has no CUDA
# events: its stage table is host wall time ("kernel" is the wall of its
# applies), and its pin, h2d and d2h stay 0.


def same_inputs(base: str, d: str, shards, copy=(".ecx", ".ecj", ".vif", ".ecsum")) -> str:
    """A directory `d` holding hard links to `shards` of volume `base`
    and copies of its small files `copy` (where they exist); returns the
    new base."""
    os.makedirs(d)
    nbase = os.path.join(d, os.path.basename(base))
    for i in shards:
        os.link(base + f".ec{i:02d}", nbase + f".ec{i:02d}")
    for ext in copy:
        if os.path.exists(base + ext):
            shutil.copy(base + ext, nbase + ext)
    return nbase


class NoLaunch:
    """Fails unless the kernels' launch counts stay where they were
    across the block: a CpuBackend run never reaches the card."""

    def __enter__(self):
        from seaweedfs_tpu_torch.ops import rs_kernels

        self.before = (dict(rs_kernels.LAUNCHES), dict(rs_kernels.MASKED))
        return self

    def __exit__(self, *exc):
        from seaweedfs_tpu_torch.ops import rs_kernels

        if exc[0] is None and (dict(rs_kernels.LAUNCHES), dict(rs_kernels.MASKED)) != self.before:
            raise AssertionError(f"a CpuBackend run launched a kernel: {self.before} -> "
                                 f"{rs_kernels.LAUNCHES}, {rs_kernels.MASKED}")


def cpu_encode(work, base, ctx, digests, prot, n_batches) -> dict:
    """Phase 8, encode: the same .dat (hard-linked) encoded on CpuBackend
    through the native byte plane; its 14 shards must be sha256-identical
    to the card's and its block and leaf CRC lists equal."""
    from seaweedfs_tpu_torch.ec import BitrotProtection, CpuBackend, ec_encode_volume, native_io

    d = os.path.join(work, "cpu-encode")
    os.makedirs(d)
    cbase = os.path.join(d, "1")
    for ext in (".dat", ".idx"):
        os.link(base + ext, cbase + ext)
    backend = CpuBackend(ctx)
    native_io.reset_counts()
    with NoLaunch():
        t0 = time.perf_counter()
        ec_encode_volume(cbase, ctx, backend=backend)
        dt = time.perf_counter() - t0
    plane = dict(native_io.COUNTS, pin_skips=backend.pin_skips)
    if not (plane["read_batch"] == plane["sink_append"] == n_batches) or plane["pin_skips"]:
        raise AssertionError(f"the CPU encode's {n_batches} batches did not all take the native plane: {plane}")
    lists = lambda pr: (pr.shard_sizes, pr.shard_crcs, pr.leaf_size, pr.shard_leaf_crcs)  # noqa: E731
    if lists(BitrotProtection.load(cbase + ".ecsum")) != lists(prot):
        raise AssertionError("the CPU encode's block or leaf CRC lists differ from the card's")
    for i in range(ctx.total):
        if sha256(cbase + ctx.to_ext(i)) != digests[i]:
            raise AssertionError(f"shard {i} of the CPU encode differs from the card's")
    shutil.rmtree(d)
    return {"seconds": dt, "stage_seconds": dict(backend.stage_seconds), "native_plane": plane}


def cpu_rebuild(work, base, ctx, digests) -> dict:
    """Phase 8, rebuild: shards LOST regenerated on CpuBackend from the
    same 12 shards; sha256-identical to the originals."""
    from seaweedfs_tpu_torch.ec import CpuBackend, rebuild_ec_files

    cbase = same_inputs(base, os.path.join(work, "cpu-rebuild"),
                        [i for i in range(ctx.total) if i not in LOST])
    backend = CpuBackend(ctx)
    with NoLaunch():
        t0 = time.perf_counter()
        rebuilt = rebuild_ec_files(cbase, backend=backend)
        dt = time.perf_counter() - t0
    if rebuilt != list(LOST):
        raise AssertionError(f"the CPU rebuild regenerated {rebuilt}, expected {list(LOST)}")
    for i in LOST:
        if sha256(cbase + ctx.to_ext(i)) != digests[i]:
            raise AssertionError(f"shard {i} rebuilt on the CPU differs from the original")
    shutil.rmtree(os.path.dirname(cbase))
    return {"seconds": dt, "stage_seconds": dict(backend.stage_seconds)}


def cpu_reads(work, base, ctx, records, dat_size) -> dict:
    """Phase 8, degraded reads: every needle on shard DEGRADED, cache
    cold, through EcVolume on CpuBackend with that shard unmounted, over
    the shards as encoded (before any needle is deleted); bit-exact."""
    from seaweedfs_tpu_torch.ec import CpuBackend, EcVolume

    cbase = same_inputs(base, os.path.join(work, "cpu-read"), range(ctx.total),
                        copy=(".ecx", ".vif", ".ecsum"))
    degraded = degraded_records(records, dat_size)
    backend = CpuBackend(ctx)
    lat = []
    dat_fd = os.open(base + ".dat", os.O_RDONLY)
    ev = EcVolume(os.path.dirname(cbase), 1, backend=backend)
    try:
        ev.unmount_shards([DEGRADED])
        with NoLaunch():
            t_all = time.perf_counter()
            for rec in degraded:
                t0 = time.perf_counter()
                n = ev.read_needle(rec[0], cookie=rec[1])
                lat.append(time.perf_counter() - t0)
                if n.data != os.pread(dat_fd, rec[3], rec[2] + 20):
                    raise AssertionError(f"degraded read of needle {rec[0]:x} on the CPU differs")
            cold_s = time.perf_counter() - t_all
        cache = ev.interval_cache
        if cache.hits or not cache.loads or backend.stage_seconds["kernel"] <= 0:
            raise AssertionError(f"CPU reads: {cache.loads} loads, {cache.hits} hits")
        result = {
            "degraded_reads": len(degraded), "cold_seconds": cold_s,
            "cold_p50_ms": percentile_ms(lat, 50), "cold_p99_ms": percentile_ms(lat, 99),
            "reconstructions": cache.loads,
            "read_stage_seconds": dict(ev.stage_seconds),
            "backend_stage_seconds": dict(backend.stage_seconds),
        }
    finally:
        ev.close()
        os.close(dat_fd)
    shutil.rmtree(os.path.dirname(cbase))
    return result


def cpu_decode(cbase, base, ctx) -> dict:
    """Phase 8, decode: the state the card decoded (the same deletions,
    shard DEGRADED removed), prepared in `cbase`'s directory before the
    card ran, decoded on CpuBackend; the .dat, the .idx and the
    regenerated shard must be identical to the card's."""
    from seaweedfs_tpu_torch.ec import CpuBackend, ec_decode_volume

    backend = CpuBackend(ctx)
    stages: dict = {}
    with NoLaunch():
        t0 = time.perf_counter()
        if not ec_decode_volume(cbase, ctx, backend=backend, stages=stages):
            raise AssertionError("the CPU decode found no live needle")
        dt = time.perf_counter() - t0
    for ext in (".dat", ".idx", ctx.to_ext(DEGRADED)):
        if sha256(cbase + ext) != sha256(base + ext):
            raise AssertionError(f"the CPU decode's {ext} differs from the card's")
    stages.update({k: v for k, v in backend.stage_seconds.items() if k in ("pin", "h2d", "kernel", "d2h")})
    shutil.rmtree(os.path.dirname(cbase))
    return {"seconds": dt, "stage_seconds": stages}


def versus(card_s: float, card_stages: dict, cpu: dict) -> dict:
    return {"card_seconds": card_s, "cpu_seconds": cpu["seconds"],
            "cpu_over_card": cpu["seconds"] / card_s,
            "card_stage_seconds": card_stages, "cpu_stage_seconds": cpu["stage_seconds"]}


# -- 7a, 7b. streaming EC and the MQ durable-parity partition -------------------

DEVICE = "cuda"
STREAM_BYTES = 256 << 20  # phase 7a: the first 256 MiB of the volume's .dat
APPEND_BYTES = 8 << 10  # one append
FLUSH_BYTES = 256 << 10  # the broker's flush threshold (SEAWEED_EC_STREAM_FLUSH_KB)
MQ_BYTES = 144 << 20  # phase 7b: records appended to one partition
MQ_ROTATE_BYTES = 64 << 20  # the broker's generation size (SEAWEED_EC_STREAM_ROTATE_MB)
MQ_KEY, MQ_VALUE = 16, 1024  # the OpenMessaging Benchmark's 1 KB message, 16-byte keys
MQ_RATE = 50_000  # records/s: the OpenMessaging Benchmark's 1 KB workload rate
MQ_FLUSH_EVERY_S = 0.1  # the flusher's cadence: half the 200 ms lag deadline
MQ_CRASH_BYTES = 8 << 20  # records a crash-window child appends
MQ_SEED = SEED + 7
# point -> the arrival the child dies at: the first seal (one 4 MiB stripe
# in), the twentieth flush's fsync or journal
MQ_CRASH_POINTS = {"ec.stream.seal": 1, "ec.stream.before_fsync": 20, "ec.stream.before_journal": 20}


def row_chunks(lo: int, hi: int, block: int) -> int:
    """Chunks (one k = 1 delta each) that processing the linear bytes
    [lo, hi) takes: one per block-sized row segment it touches."""
    return (hi - 1) // block - lo // block + 1 if hi > lo else 0


def stream_phase(work, src, ctx, nbytes: int = STREAM_BYTES, cards=None) -> tuple[dict, int]:
    """Phase 7a: the first `nbytes` of `src` appended in 8 KiB pieces
    to an `EcStreamEncoder` at its defaults (1 MiB blocks, 64 KiB small
    blocks), flushed at 256 KiB pending, closed with finalize; against
    one `write_ec_files` over the same bytes. Returns (result, launches):
    the stream's and the batch encode's, apart in the result. Both
    backends are appended to `cards` where it is given."""
    from seaweedfs_tpu_torch.ec import BitrotProtection, EcStreamEncoder, TorchBackend, write_ec_files
    from seaweedfs_tpu_torch.ops import gf256, rs_kernels

    d = os.path.join(work, "stream")
    os.makedirs(d)
    with open(src, "rb") as f:
        payload = f.read(nbytes)
    if len(payload) != nbytes:
        raise AssertionError(f"the .dat holds {len(payload)} bytes, fewer than {nbytes}")
    sbase, bbase = os.path.join(d, "s"), os.path.join(d, "b")
    backend = TorchBackend(ctx, device=DEVICE)
    rs_kernels.reset_launches()
    enc = EcStreamEncoder(sbase, ctx, backend=backend)
    block, small, k = enc.block_size, enc.small_block_size, ctx.data_shards
    if (block, small) != (1 << 20, 64 << 10) or backend.device.type != DEVICE:
        raise AssertionError(f"stream at block {block}, small {small}, on {backend.device}")
    n_app = len(payload) // APPEND_BYTES
    view = memoryview(payload)
    t_append = np.zeros(n_app)
    lags: list[float] = []
    covered = processed = chunks = flushes = 0

    def flushed(durable: int) -> None:
        nonlocal covered, processed, chunks, flushes
        now = time.perf_counter()
        chunks += row_chunks(processed, durable, block)
        processed = durable
        flushes += 1
        while covered < n_app and (covered + 1) * APPEND_BYTES <= durable:
            lags.append(now - t_append[covered])
            covered += 1

    t0 = time.perf_counter()
    for i in range(n_app):
        t_append[i] = time.perf_counter()
        enc.append(view[i * APPEND_BYTES : (i + 1) * APPEND_BYTES])
        if enc.pending_bytes >= FLUSH_BYTES:
            flushed(enc.flush())
    flushed(enc.flush())
    stream_s = time.perf_counter() - t0
    if covered != n_app or processed != len(payload):
        raise AssertionError(f"{covered} of {n_app} appends durable, {processed} bytes processed")
    flush_launches = rs_kernels.LAUNCHES["gf2_apply"]
    t0 = time.perf_counter()
    prot = enc.close()
    close_s = time.perf_counter() - t0
    stripe = block * k
    tail_stripes = -(-(len(payload) % stripe) // (small * k))
    launches = rs_kernels.LAUNCHES["gf2_apply"]
    masked = rs_kernels.MASKED["gf2_apply"]
    if flush_launches != chunks or launches != chunks + tail_stripes:
        raise AssertionError(f"stream launched {flush_launches} + {launches - flush_launches} kernels "
                             f"for {chunks} chunks + {tail_stripes} tail stripes")

    with open(bbase + ".dat", "wb") as f:
        f.write(payload)
    del payload, view
    bbackend = TorchBackend(ctx, device=DEVICE)
    if cards is not None:
        cards += [backend, bbackend]
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    bprot = write_ec_files(bbase, ctx, bbackend, large_block_size=block, small_block_size=small)
    batch_s = time.perf_counter() - t0
    batch_launches = rs_kernels.LAUNCHES["gf2_apply"]
    lists = lambda pr: (pr.shard_sizes, pr.shard_crcs, pr.leaf_size, pr.shard_leaf_crcs)  # noqa: E731
    if lists(prot) != lists(bprot) or lists(BitrotProtection.load(sbase + ".ecsum")) != lists(bprot):
        raise AssertionError("the stream's block or leaf CRC lists differ from the batch encode's")
    for i in range(ctx.total):
        if sha256(sbase + ctx.to_ext(i)) != sha256(bbase + ctx.to_ext(i)):
            raise AssertionError(f"stream shard {i} differs from the batch encode's")
    if os.path.exists(sbase + ".stream"):
        raise AssertionError("finalize left the stream's journal behind")
    shutil.rmtree(d)
    st = backend.stage_seconds
    device_s = st["h2d"] + st["kernel"] + st["d2h"]
    split = round_trip_split(backend, gf256.parity_rows(K, M)[:, :1])
    return {
        "bytes": nbytes, "appends": n_app, "append_bytes": APPEND_BYTES,
        "flush_bytes": FLUSH_BYTES, "flushes": flushes, "block": block, "small_block": small,
        "time_to_durable_parity_p50_ms": percentile_ms(lags, 50),
        "time_to_durable_parity_p99_ms": percentile_ms(lags, 99),
        "time_to_durable_parity_max_ms": percentile_ms(lags, 100),
        "appends_per_s": n_app / stream_s, "stream_seconds": stream_s,
        "close_finalize_seconds": close_s, "stream_mb_per_s": nbytes / (stream_s + close_s) / 1e6,
        "batch_encode_seconds": batch_s, "batch_launches": batch_launches,
        "launches": launches, "chunks": chunks, "tail_stripes": tail_stripes,
        "launches_table_body": launches - masked, "launches_masked_path": masked,
        "host_us_per_launch": (enc.stage_seconds["h2d_dispatch"] + enc.stage_seconds["device_drain"])
        / launches * 1e6,
        "device_busy_share": st["kernel"] / (stream_s + close_s),
        "device_h2d_kernel_d2h_share": device_s / (stream_s + close_s),
        "encoder_stage_seconds": dict(enc.stage_seconds), "backend_stage_seconds": dict(st),
        "round_trip_host_us": split,
    }, launches + batch_launches


def round_trip_split(backend, coeffs, reps: int = 200) -> dict:
    """Median host time, in microseconds, of each hook of one stream
    delta's round trip (a (1, 256 KiB) chunk, m = 4) on an idle stream:
    `to_device` (the pin copy and queueing the H2D copy), `apply_staged`
    (the launch) and `to_host` (the wait, the D2H copy and the wait for
    it). Not counted as main-path launches."""
    from seaweedfs_tpu_torch.ops import rs_kernels

    chunk = np.random.default_rng(SEED).integers(0, 256, (1, FLUSH_BYTES), dtype=np.uint8)
    launches, masked = dict(rs_kernels.LAUNCHES), dict(rs_kernels.MASKED)
    times = {"to_device": [], "apply_staged": [], "to_host": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        staged = backend.to_device(chunk)
        t1 = time.perf_counter()
        handle = backend.apply_staged(coeffs, staged)
        t2 = time.perf_counter()
        backend.to_host(handle)
        t3 = time.perf_counter()
        for key, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
            times[key].append(dt)
    rs_kernels.LAUNCHES.update(launches)
    rs_kernels.MASKED.update(masked)
    return {key: float(np.median(v) * 1e6) for key, v in times.items()}


def mq_source(n: int) -> tuple[bytes, bytes]:
    """The phase 7b records' keys and values, seeded: record i has key
    keys[16i:16i+16] and value values[1024i:1024i+1024]."""
    rng = np.random.default_rng(MQ_SEED)
    return rng.bytes(MQ_KEY * n), rng.bytes(MQ_VALUE * n)


def mq_record_bytes() -> int:
    from seaweedfs_tpu_torch.mq.stream_parity import encode_record

    return len(encode_record(0, 0, bytes(MQ_KEY), bytes(MQ_VALUE)))


def check_records(recs, keys, values, ts0: int, first: int = 0) -> None:
    """Raise unless `recs` are the records appended, dense from offset
    `first`."""
    for i, (off, ts, key, value) in enumerate(recs, first):
        if (off, ts) != (i, ts0 + i) or key != keys[i * MQ_KEY : (i + 1) * MQ_KEY] \
                or value != values[i * MQ_VALUE : (i + 1) * MQ_VALUE]:
            raise AssertionError(f"recovered record {i} (offset {off}) differs from the one appended")


def gens_of(d: str) -> list[int]:
    return sorted({int(n[4:].split(".", 1)[0]) for n in os.listdir(d) if n.startswith("gen-")})


def verify_gens(d: str, ctx, backend) -> int:
    """A second recovery pass over every generation of partition dir
    `d`: raises if any parity is rewritten. Returns the stripes checked."""
    from seaweedfs_tpu_torch.ec import load_stream_journal, recover_stream
    from seaweedfs_tpu_torch.mq.stream_parity import dense_frame_scan

    stripes = 0
    for g in gens_of(d):
        base = os.path.join(d, f"gen-{g:08d}")
        j = load_stream_journal(base)
        rec = recover_stream(base, ctx, backend, frame_scan=dense_frame_scan(j.meta))
        if rec.parity_rewritten:
            raise AssertionError(f"{base}: a second recovery pass rewrote {rec.parity_rewritten} stripes")
        stripes += -(-rec.head // (ctx.data_shards * j.block_size))
    return stripes


# A partition that appends the phase 7b records and flushes by the
# broker's policy, printing the records durable after each flush, until
# the armed point kills it.
MQ_CRASH_CHILD = r"""
import sys
from chip_smoke import MQ_KEY, MQ_VALUE, mq_source
from seaweedfs_tpu_torch import faults
from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity

root, point, nth, n, n_source, ts0 = sys.argv[1:7]
n, ts0 = int(n), int(ts0)
keys, values = mq_source(int(n_source))  # the parent's records, the first n of them appended
faults.inject(point, faults.hard_exit(137), when=faults.nth_call(int(nth)))
pp = PartitionParity(root, "bench", "crash", 0)
for i in range(n):
    pp.append_record(i, ts0 + i, keys[i * MQ_KEY:(i + 1) * MQ_KEY], values[i * MQ_VALUE:(i + 1) * MQ_VALUE])
    if pp.needs_flush():
        pp.flush()
        print("flushed", i + 1, flush=True)
pp.flush()
print("flushed", n, flush=True)
sys.exit(3)  # the armed point never fired
"""


def mq_publish(root: str, topic: str, n: int, keys: bytes, values: bytes, ts0: int,
               backend_name: str = DEVICE, after_flush=None) -> dict:
    """One partition at the broker's defaults takes the first `n` records
    at MQ_RATE from the calling thread while a flusher thread applies the
    policy every MQ_FLUSH_EVERY_S; then it closes. The kernel counters
    are reset first. Returns the partition's context and backend, each
    flush call's (start, end), each append's time, the append and close
    times and each generation's encoder. `backend_name` is the backend
    that SEAWEED_EC_STREAM_BACKEND names (the cached one the partition
    takes at its first generation). `after_flush(pp)`, where given, runs
    on the flusher thread after each of its flushes."""
    import threading

    from seaweedfs_tpu_torch.ec import get_backend
    from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity
    from seaweedfs_tpu_torch.ops import rs_kernels

    pp = PartitionParity(root, "bench", topic, 0)
    ctx = pp.ctx
    # the cached backend the partition builds at its first generation
    backend = get_backend(backend_name, ctx.data_shards, ctx.parity_shards)
    if ((ctx.data_shards, ctx.parity_shards), pp.block_size, pp.flush_bytes, pp.max_lag_s,
            pp.rotate_bytes, backend.device.type) != ((4, 2), 1 << 20, 256 << 10, 0.2, MQ_ROTATE_BYTES,
                                                      DEVICE):
        raise AssertionError("the partition is not at the broker's defaults on the card")
    backend.reset_stages()
    rs_kernels.reset_launches()
    stop = threading.Event()
    calls: list[tuple[float, float]] = []
    errors: list[BaseException] = []
    encoders = {}  # each generation's encoder, for its stage table

    def flusher() -> None:
        try:
            while not stop.wait(MQ_FLUSH_EVERY_S):
                if pp.needs_flush():
                    if pp._enc is not None:
                        encoders[id(pp._enc)] = pp._enc
                    t = time.perf_counter()
                    pp.flush()
                    calls.append((t, time.perf_counter()))
                    if after_flush is not None:
                        after_flush(pp)
        except BaseException as e:  # noqa: BLE001 - raised on the main thread
            errors.append(e)

    thread = threading.Thread(target=flusher, name="mq-parity-flusher")
    thread.start()
    t_append = np.zeros(n)
    t0 = time.perf_counter()
    try:
        for i in range(n):
            ahead = t0 + i / MQ_RATE - time.perf_counter()
            if ahead > 0.001:
                time.sleep(ahead)
            t_append[i] = time.perf_counter()
            pp.append_record(i, ts0 + i, keys[i * MQ_KEY : (i + 1) * MQ_KEY],
                             values[i * MQ_VALUE : (i + 1) * MQ_VALUE])
    finally:
        stop.set()
        thread.join()
    if errors:
        raise errors[0]
    if pp.backend is not backend:
        raise AssertionError(f"the partition runs on {pp.backend}, not on the card's backend")
    append_s = time.perf_counter() - t0
    if pp._enc is not None:
        encoders[id(pp._enc)] = pp._enc
    t_close = time.perf_counter()
    pp.close()
    t_end = time.perf_counter()
    return {"ctx": ctx, "backend": backend, "calls": calls, "t_append": t_append,
            "append_s": append_s, "t_close": t_close, "t_end": t_end, "encoders": encoders}


def mq_phase(work) -> tuple[dict, int]:
    """Phase 7b: one partition at the broker's defaults (4+2, 1 MiB
    blocks, flush at 256 KiB or 200 ms, rotation at 64 MiB) takes
    MQ_BYTES of 1 KB records at MQ_RATE from the main thread while a
    flusher thread applies the policy every 100 ms; closed, then
    recovered by a fresh partition; then each crash window, in a child.
    Returns (result, launches)."""
    from seaweedfs_tpu_torch.ec import load_stream_journal, stream_summary
    from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity
    from seaweedfs_tpu_torch.ops import rs_kernels

    root = os.path.join(work, "mq")
    rec_bytes = mq_record_bytes()
    n = MQ_BYTES // rec_bytes
    keys, values = mq_source(n)
    ts0 = time.time_ns()
    pub = mq_publish(root, "omb", n, keys, values, ts0)
    ctx, backend, calls, t_append = pub["ctx"], pub["backend"], pub["calls"], pub["t_append"]
    append_s, t_close, t_end, encoders = pub["append_s"], pub["t_close"], pub["t_end"], pub["encoders"]
    launches = rs_kernels.LAUNCHES["gf2_apply"]
    masked = rs_kernels.MASKED["gf2_apply"]
    st = dict(backend.stage_seconds)
    # an append's parity is durable once a flush called after it returns
    # (or the close): an upper bound on its time-to-durable-parity
    starts = np.array([c[0] for c in calls])
    ends = np.array([c[1] for c in calls] + [t_end])
    lags = ends[np.searchsorted(starts, t_append, side="left")] - t_append
    part = os.path.join(root, "bench", "omb", "0000")
    gens = gens_of(part)

    rs_kernels.reset_launches()
    rewritten0 = stream_summary()["recovered"].get("parity_rewritten", 0)
    t0 = time.perf_counter()
    recs = PartitionParity(root, "bench", "omb", 0).recover()
    recover_s = time.perf_counter() - t0
    rec_launches = rs_kernels.LAUNCHES["gf2_apply"]
    if len(recs) != n:
        raise AssertionError(f"recovered {len(recs)} of {n} records")
    check_records(recs, keys, values, ts0)
    del recs
    if stream_summary()["recovered"].get("parity_rewritten", 0) != rewritten0:
        raise AssertionError("recovery of a cleanly closed partition rewrote parity")
    stripes = 0
    for g in gens:
        j = load_stream_journal(os.path.join(part, f"gen-{g:08d}"))
        stripes += -(-j.durable // (ctx.data_shards * j.block_size))
    if rec_launches != stripes:
        raise AssertionError(f"recovery launched {rec_launches} kernels for {stripes} stripes")
    total_launches = launches + rec_launches

    # -- one flush as large as the mean flush above, with no publisher
    # running beside it: what the flush costs on its own
    per_flush = n // max(len(calls), 1)
    solo_root = os.path.join(work, "mq-solo")
    sp = PartitionParity(solo_root, "bench", "solo", 0)
    for i in range(per_flush):
        sp.append_record(i, ts0 + i, keys[i * MQ_KEY : (i + 1) * MQ_KEY],
                         values[i * MQ_VALUE : (i + 1) * MQ_VALUE])
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    sp.flush()
    solo = {"records": per_flush, "flush_ms": (time.perf_counter() - t0) * 1e3,
            "encoder_stage_seconds": dict(sp._enc.stage_seconds)}
    total_launches += rs_kernels.LAUNCHES["gf2_apply"]
    sp.close()
    shutil.rmtree(solo_root)

    # -- crash windows: a child dies at each point, the parent recovers --
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    n_crash = -(-MQ_CRASH_BYTES // rec_bytes)
    windows = []
    for point, nth in MQ_CRASH_POINTS.items():
        croot = os.path.join(work, "mq-crash-" + point.rsplit(".", 1)[1])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", MQ_CRASH_CHILD, croot, point, str(nth), str(n_crash), str(n),
             str(ts0)],
            cwd=repo, env=env, capture_output=True, text=True, timeout=60,
        )
        child_s = time.perf_counter() - t0
        done = [int(line.split()[1]) for line in proc.stdout.splitlines() if line.startswith("flushed")]
        if proc.returncode != 137 or not done:
            raise AssertionError(f"{point}: child exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
        rs_kernels.reset_launches()
        rewritten0 = stream_summary()["recovered"].get("parity_rewritten", 0)
        t0 = time.perf_counter()
        cp = PartitionParity(croot, "bench", "crash", 0)
        got = cp.recover()
        rec_s = time.perf_counter() - t0
        if len(got) < done[-1]:
            raise AssertionError(f"{point}: recovered {len(got)} records, the child flushed {done[-1]}")
        check_records(got, keys, values, ts0)
        rewritten = stream_summary()["recovered"].get("parity_rewritten", 0) - rewritten0
        cdir = os.path.join(croot, "bench", "crash", "0000")
        checked = verify_gens(cdir, ctx, backend)
        nxt = len(got)
        for i in range(nxt, nxt + 3):  # appends continue dense after the tail
            cp.append_record(i, ts0 + i, keys[i * MQ_KEY : (i + 1) * MQ_KEY],
                             values[i * MQ_VALUE : (i + 1) * MQ_VALUE])
        cp.flush()
        cp.close()
        again = PartitionParity(croot, "bench", "crash", 0).recover()
        if len(again) != nxt + 3:
            raise AssertionError(f"{point}: {len(again)} records after 3 more appends to {nxt}")
        check_records(again, keys, values, ts0)
        total_launches += rs_kernels.LAUNCHES["gf2_apply"]
        windows.append({
            "point": point, "child_s": child_s, "child_flushed_records": done[-1],
            "recovered_records": nxt, "recovery_s": rec_s, "parity_rewritten_first_pass": rewritten,
            "second_pass_stripes_clean": checked, "appended_after": 3,
        })
        shutil.rmtree(croot)
    shutil.rmtree(root)
    return {
        "records": n, "record_bytes": rec_bytes, "bytes": n * rec_bytes, "rate_per_s": MQ_RATE,
        "appends_per_s": n / append_s, "append_seconds": append_s, "close_seconds": t_end - t_close,
        "flushes": len(calls), "generations": len(gens),
        "flush_ms_p50": float(np.median([e - b for b, e in calls]) * 1e3),
        "flush_ms_max": float(max(e - b for b, e in calls) * 1e3),
        "flush_interval_ms_p50": float(np.median(np.diff(starts)) * 1e3) if len(calls) > 1 else None,
        "solo_flush": solo,
        "time_to_durable_parity_p50_ms": float(np.percentile(lags, 50) * 1e3),
        "time_to_durable_parity_p99_ms": float(np.percentile(lags, 99) * 1e3),
        "time_to_durable_parity_max_ms": float(lags.max() * 1e3),
        "launches": launches, "launches_table_body": launches - masked,
        "launches_masked_path": masked, "masked_share": masked / max(launches, 1),
        "recovery_seconds": recover_s, "recovery_launches": rec_launches, "recovery_stripes": stripes,
        "crash_windows": windows, "backend_stage_seconds": st,
        "encoder_stage_seconds": {
            k: sum(e.stage_seconds[k] for e in encoders.values()) for k in next(iter(encoders.values())).stage_seconds
        },
        "device_busy_share": st["kernel"] / (append_s + t_end - t_close),
    }, total_launches


# -- 9. the flight recorder, armed, over every path ---------------------------------

TRACE_READS = 20  # cold degraded reads of shard DEGRADED
TRACE_STREAM_BYTES = 32 << 20  # a phase 7a stream of this size
TRACE_MQ_FLUSHES = 4  # the phase 7b partition runs for at least this many flushes
TRACE_MQ_SECONDS = 2.0  # of 7b's traffic: 7b's flushes start 207-266 ms apart
TRACE_TOL_S = 0.05  # clock-read ordering slack of the span invariants
_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> dict:
    """Every sample of a Prometheus text exposition: {(name, sorted
    (label, value) pairs): value}. Raises on a line that does not lex."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            continue
        m = _SAMPLE.match(ln)
        if m is None:
            raise AssertionError(f"the registry rendered an unparseable line: {ln!r}")
        labels = tuple(sorted(
            (k, v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\"))
            for k, v in _LABEL.findall(m.group(2) or "")
        ))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def series(parsed: dict, name: str, label: str) -> dict:
    """{label value: sample value} of one single-label metric."""
    return {dict(lab)[label]: v for (n, lab), v in parsed.items() if n == name}


def walk(doc):
    yield doc
    for child in doc["children"]:
        yield from walk(child)


def check_tree(root: dict) -> None:
    """The span invariants of the JAX package's tests/test_trace.py, on
    every node: one trace id, every node inside its root's wall, every
    stage but queue_wait (summed over two threads) no longer than its
    node, every stage counted."""
    lo = root["start_ts"] - TRACE_TOL_S
    hi = root["start_ts"] + root["duration_s"] + TRACE_TOL_S
    for node in walk(root):
        if node["trace_id"] != root["trace_id"] or node["duration_s"] < 0.0 \
                or node["start_ts"] < lo or node["start_ts"] + node["duration_s"] > hi:
            raise AssertionError(f"span {node['op']} lies outside its root {root['op']}")
        for name, acc in node["stages"].items():
            if acc["count"] < 1 or (name != "queue_wait"
                                    and acc["seconds"] > node["duration_s"] + TRACE_TOL_S):
                raise AssertionError(f"stage {name} of {node['op']} exceeds its span: {acc}")


def device_stages(node: dict, launches: int, what: str, drain: str, card_of: dict) -> None:
    """The node's admission_wait, h2d_dispatch and device_drain each
    counted once per launch. A `TorchBackend` has no chip label (as a
    single-device JaxBackend has none), so the scheduled dispatch stages
    carry its device queue's label, "TorchBackend:<k>+<m>@<n>", and the
    drain carries what the JAX call site gives it: that label in the
    staged-apply driver (`drain="queue"`), "" in the encoder and the
    stream (`drain=""`). `card_of` maps each queue label of the phase to
    its backend's device: the label must name a backend on the card."""
    label = node["stages"].get("h2d_dispatch", {"chip": ""})["chip"]
    card0 = "cuda:0" if DEVICE == "cuda" else DEVICE
    want = {"admission_wait": label, "h2d_dispatch": label,
            "device_drain": label if drain == "queue" else ""}
    for s, chip in want.items():
        acc = node["stages"].get(s, {"count": 0, "chip": ""})
        if acc["count"] != launches or acc["chip"] != chip or not label.startswith("TorchBackend:") \
                or card_of.get(label) != card0:
            raise AssertionError(f"{what}: {s} counted {acc['count']} on {acc['chip']!r} "
                                 f"for {launches} launches on {chip!r}, a queue of the backend "
                                 f"on {card_of.get(label)!r}")


def trace_phase(work, base, ctx, records, dat_size, digests, prot, n_batches, mq_solo) -> tuple[dict, dict]:
    """Phase 9: the EC paths once more with the flight recorder armed
    (utils/trace.py), in `work`/trace (hard links to the volume's .dat
    and .idx), each output checked sha256-identical to its disarmed
    counterpart: encode (in turns with disarmed encodes: the tracer's
    cost), rebuild of LOST, TRACE_READS cold degraded reads of DEGRADED
    (then the .heat sidecar checked and read back by a fresh mount), a
    leaf repair of one rotten leaf, decode, a TRACE_STREAM_BYTES stream
    and phase 7b's partition for at least TRACE_MQ_FLUSHES flushes. Then
    every tree's invariants, one root per op (`sw_ec_traces_total`
    alike), device stages counted per launch on cuda:0, overlap
    efficiency in [0, 1], the registry's rendering and the leaf-repair
    counter, and the Chrome trace. Returns (result, launches by kernel)."""
    import collections

    from seaweedfs_tpu_torch.ec import (
        BitrotProtection, EcVolume, TorchBackend, VolumeInfo, ec_decode_volume, ec_encode_volume,
        device_queue, rebuild_ec_files, scrub_ec_volume,
    )
    from seaweedfs_tpu_torch.ec.decoder import find_dat_file_size
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH
    from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.utils import metrics, trace

    tdir = os.path.join(work, "trace")
    tbase = os.path.join(tdir, "1")
    shard = {i: tbase + ctx.to_ext(i) for i in range(ctx.total)}
    launches = dict.fromkeys(("gf2_apply", "gf2_apply_planes"), 0)
    expected = collections.Counter()  # root op -> roots this phase must record
    lists = lambda pr: (pr.shard_sizes, pr.shard_crcs, pr.leaf_size, pr.shard_leaf_crcs)  # noqa: E731

    def counted() -> dict:
        got = {k: rs_kernels.LAUNCHES[k] for k in launches}
        for k, v in got.items():
            launches[k] += v
        return got

    reb_batches = -(-prot.shard_sizes[0] // DEFAULT_BATCH)
    # every backend of the phase, alive until its device stages are
    # checked, so each queue label still names its backend
    cards: list = []

    def card(**kw):
        cards.append(TorchBackend(ctx, **kw))
        return cards[-1]

    before = parse_exposition(metrics.REGISTRY.render().decode())
    trace.configure(enabled=False, ring_size=1024, slow_op_s=0.0)
    trace.reset()
    try:
        # -- encode, disarmed and armed in turns ---------------------------
        walls: dict = {"disarmed": [], "armed": []}
        for armed in (False, True, True, False):
            trace.configure(enabled=armed)
            rs_kernels.reset_launches()
            t0 = time.perf_counter()
            ec_encode_volume(tbase, ctx, backend=card())
            walls["armed" if armed else "disarmed"].append(time.perf_counter() - t0)
            if counted()["gf2_apply"] != n_batches:
                raise AssertionError(f"encode launched {rs_kernels.LAUNCHES} for {n_batches} batches")
            if lists(BitrotProtection.load(tbase + ".ecsum")) != lists(prot):
                raise AssertionError("phase 9's encode gives other CRC lists than phase 4's")
            if armed:
                expected["ec.encode_volume"] += 1
                for i in range(ctx.total):
                    if sha256(shard[i]) != digests[i]:
                        raise AssertionError(f"armed encode: shard {i} differs from phase 4's")
        trace.configure(enabled=True)

        # -- rebuild -------------------------------------------------------
        for i in LOST:
            os.unlink(shard[i])
        rs_kernels.reset_launches()
        t0 = time.perf_counter()
        if rebuild_ec_files(tbase, backend=card()) != list(LOST):
            raise AssertionError("armed rebuild regenerated other shards")
        reb_s = time.perf_counter() - t0
        if counted()["gf2_apply"] != reb_batches or any(sha256(shard[i]) != digests[i] for i in LOST):
            raise AssertionError(f"armed rebuild: {rs_kernels.LAUNCHES}, or a shard differs")
        expected["ec.rebuild"] += 1

        # -- cold degraded reads, and the .heat sidecar ------------------------
        reads = degraded_records(records, dat_size)[:TRACE_READS]
        backend = card(impl="cuda_planes")
        src_fd = os.open(base + ".dat.orig", os.O_RDONLY)
        ev = EcVolume(tdir, 1, backend=backend)
        try:
            if (ev.bytes_read, ev.bytes_reconstructed) != (0, 0):
                raise AssertionError("a fresh mount started with heat")
            ev.unmount_shards([DEGRADED])
            rs_kernels.reset_launches()
            t0 = time.perf_counter()
            for rec in reads:
                if ev.read_needle(rec[0], cookie=rec[1]).data != os.pread(src_fd, rec[3], rec[2] + 20):
                    raise AssertionError(f"armed degraded read of needle {rec[0]:x} differs")
            reads_s = time.perf_counter() - t0
            heat = (ev.bytes_read, ev.bytes_reconstructed)
            loads = ev.interval_cache.loads
        finally:
            ev.close()
            os.close(src_fd)
        if counted()["gf2_apply_planes"] != loads or not heat[1]:
            raise AssertionError(f"armed reads: {rs_kernels.LAUNCHES} for {loads} cache misses")
        expected["ec.degraded_read"] += sum(
            1 for rec in reads for sid, _, _ in needle_intervals(rec, dat_size) if sid == DEGRADED)
        with open(tbase + ".heat") as f:
            blob = json.load(f)
        gen = VolumeInfo.load(tbase + ".vif").encode_ts_ns
        if blob != {"gen": gen, "read_bytes": heat[0], "reconstructed_bytes": heat[1]}:
            raise AssertionError(f".heat holds {blob}, the reads counted {heat} at generation {gen}")
        ev = EcVolume(tdir, 1, backend=backend)
        remount = (ev.bytes_read, ev.bytes_reconstructed)
        ev.close()
        if remount != heat:
            raise AssertionError(f"a fresh mount read {remount} back from .heat, not {heat}")

        # -- one rotten leaf of shard LEAF_DATA, repaired in place ----------------
        tprot = BitrotProtection.load(tbase + ".ecsum")
        leaf = len(tprot.shard_leaf_crcs[LEAF_DATA]) // 5
        flip(shard[LEAF_DATA], leaf * tprot.leaf_size + 500)
        repaired0 = series(before, "sw_ec_leaf_repairs_total", "outcome").get("repaired", 0.0)
        rs_kernels.reset_launches()
        t0 = time.perf_counter()
        r = scrub_ec_volume(tbase, ctx, backend=card(), repair=True)
        scrub_s = time.perf_counter() - t0
        if r.leaf_repaired != {LEAF_DATA: [leaf]} or r.quarantined or r.rebuilt or r.refused \
                or counted()["gf2_apply"] != 1 or sha256(shard[LEAF_DATA]) != digests[LEAF_DATA]:
            raise AssertionError(f"armed leaf repair: {r}, {rs_kernels.LAUNCHES}")
        expected["ec.leaf_repair"] += 1

        # -- decode, shard DEGRADED removed -------------------------------------
        os.unlink(shard[DEGRADED])
        rs_kernels.reset_launches()
        t0 = time.perf_counter()
        if not ec_decode_volume(tbase, ctx, backend=card(impl="cuda_planes")):
            raise AssertionError("armed decode found no live needle")
        dec_s = time.perf_counter() - t0
        if counted()["gf2_apply_planes"] != reb_batches or sha256(shard[DEGRADED]) != digests[DEGRADED]:
            raise AssertionError(f"armed decode: {rs_kernels.LAUNCHES}, or shard {DEGRADED} differs")
        live = find_dat_file_size(tbase, 3)
        if os.path.getsize(tbase + ".dat") != live or sha256(tbase + ".dat") != sha256(base + ".dat.orig", live):
            raise AssertionError("armed decode: the .dat differs from the original")
        expected["ec.decode"] += 1

        # -- a phase 7a stream, and its batch encode ------------------------------
        stream, _ = stream_phase(work, base + ".dat.orig", ctx, TRACE_STREAM_BYTES, cards)
        launches["gf2_apply"] += stream["launches"] + stream["batch_launches"]
        expected["ec.stream_encode"] += 1
        expected["ec.encode"] += 1  # write_ec_files alone is its own root

        # -- phase 7b's partition at its own traffic ----------------------------
        n = int(MQ_RATE * TRACE_MQ_SECONDS)
        keys, values = mq_source(n)
        ts0 = time.time_ns()
        mq_root = os.path.join(work, "mq-trace")
        pub = mq_publish(mq_root, "traced", n, keys, values, ts0)
        mq_launches = counted()["gf2_apply"]
        if len(pub["calls"]) < TRACE_MQ_FLUSHES:
            raise AssertionError(f"the traced partition flushed {len(pub['calls'])} times")
        gens = gens_of(os.path.join(mq_root, "bench", "traced", "0000"))
        expected["ec.stream_encode"] += len(gens)
        rs_kernels.reset_launches()
        recs = PartitionParity(mq_root, "bench", "traced", 0).recover()
        counted()
        if len(recs) != n:
            raise AssertionError(f"the traced partition replayed {len(recs)} of {n} records")
        check_records(recs, keys, values, ts0)
        del recs
        shutil.rmtree(mq_root)
    finally:
        trace.configure(enabled=False)
    docs = trace.traces()
    trace.reset()

    # -- the recorder's own checks ---------------------------------------------
    got = collections.Counter(d["op"] for d in docs)
    after = parse_exposition(metrics.REGISTRY.render().decode())
    counted_roots = {op: v - series(before, "sw_ec_traces_total", "op").get(op, 0.0)
                     for op, v in series(after, "sw_ec_traces_total", "op").items()}
    if got != expected or {op: v for op, v in counted_roots.items() if v} != dict(expected):
        raise AssertionError(f"roots {dict(got)}, sw_ec_traces_total moved {counted_roots}, "
                             f"expected {dict(expected)}")
    if series(after, "sw_ec_leaf_repairs_total", "outcome").get("repaired", 0.0) - repaired0 != 1:
        raise AssertionError("sw_ec_leaf_repairs_total{outcome=repaired} did not count the one range")
    by_op = collections.defaultdict(list)
    for d in docs:
        check_tree(d)
        by_op[d["op"]].append(d)
    card_of = {device_queue._queue_label(be): str(be.device) for be in cards}
    for d in by_op["ec.encode_volume"]:
        (child,) = d["children"]
        device_stages(child, n_batches, "encode", "", card_of)
    device_stages(by_op["ec.rebuild"][0], reb_batches, "rebuild", "queue", card_of)
    device_stages(by_op["ec.decode"][0]["children"][0], reb_batches, "decode's rebuild", "queue", card_of)
    device_stages(by_op["ec.encode"][0], stream["batch_launches"], "the stream's batch encode", "",
                  card_of)
    streams = sorted(by_op["ec.stream_encode"], key=lambda d: d["start_ts"])
    device_stages(streams[0], stream["launches"], "stream", "", card_of)
    mq_docs = streams[1:]
    mq_stages = collections.defaultdict(lambda: [0.0, 0])
    for d in mq_docs:
        for s, acc in d["stages"].items():
            mq_stages[s][0] += acc["seconds"]
            mq_stages[s][1] += acc["count"]
    for s in ("admission_wait", "h2d_dispatch", "device_drain"):
        chips = {d["stages"][s]["chip"] for d in mq_docs if s in d["stages"]}
        ok = all(c.startswith("TorchBackend:4+2@") for c in chips) if s != "device_drain" \
            else chips == {""}
        if mq_stages[s][1] != mq_launches or not ok or len(chips) != 1:
            raise AssertionError(f"partition: {s} counted {mq_stages[s][1]} on {chips} "
                                 f"for {mq_launches} launches of one backend")
    effs = {}
    for d in docs:
        for node in walk(d):
            e = trace.overlap_efficiency(node)
            if e is not None:
                if not 0.0 <= e <= 1.0:
                    raise AssertionError(f"overlap efficiency {e} of {node['op']}")
                effs.setdefault(node["op"], []).append(e)

    def summary(nodes: list) -> dict:
        stages: dict = {}
        for node in nodes:
            for s, acc in node["stages"].items():
                t = stages.setdefault(s, {"seconds": 0.0, "count": 0})
                t["seconds"] += acc["seconds"]
                t["count"] += acc["count"]
        e = [x for x in (trace.overlap_efficiency(nd) for nd in nodes) if x is not None]
        return {"spans": len(nodes), "wall_s": sum(nd["duration_s"] for nd in nodes), "stages": stages,
                "overlap_efficiency": float(np.mean(e)) if e else None}

    ops = {}
    for d in docs:
        for node in walk(d):
            key = d["op"] if node is d else f"{d['op']}/{node['op']}"
            ops.setdefault(key, []).append(node)
    # the stream's own span apart from the partition's generations
    ops["ec.stream_encode"] = streams[:1]
    ops["ec.stream_encode (7b partition)"] = mq_docs
    flushes = len(pub["calls"]) + 1  # and the close's
    flush_wall = sum(e - b for b, e in pub["calls"]) + pub["t_end"] - pub["t_close"]
    named = sum(mq_stages[s][0] for s in ("write_sink", "parity_update", "fsync_publish"))
    chrome = trace.chrome_trace(docs=docs)
    path = os.path.join(work, "phase9_trace.json")
    with open(path, "w") as f:
        json.dump(chrome, f)
    with open(path) as f:
        n_events = len(json.load(f)["traceEvents"])
    return {
        "ops": {k: summary(v) for k, v in sorted(ops.items())},
        "encode": {"armed_s": walls["armed"], "disarmed_s": walls["disarmed"],
                   "armed_over_disarmed": sum(walls["armed"]) / sum(walls["disarmed"])},
        "rebuild_s": reb_s, "reads": len(reads), "reads_s": reads_s, "read_cache_misses": loads,
        "heat": {"read_bytes": heat[0], "reconstructed_bytes": heat[1], "remount": list(remount)},
        "leaf_repair_scrub_s": scrub_s, "decode_s": dec_s,
        "stream": {k: stream[k] for k in ("bytes", "flushes", "launches", "stream_seconds",
                                          "time_to_durable_parity_p50_ms")},
        "partition": {
            "records": n, "flushes": flushes, "generations": len(gens), "launches": mq_launches,
            "flush_ms_mean": flush_wall / flushes * 1e3,
            "stage_ms_per_flush": {s: v[0] / flushes * 1e3 for s, v in sorted(mq_stages.items())},
            "unnamed_share_of_flush_wall": 1.0 - named / flush_wall,
            "phase_7b_solo_flush": mq_solo,
        },
        "overlap_efficiency": {op: [min(v), max(v)] for op, v in sorted(effs.items())},
        "roots": dict(got), "registry_samples": len(after),
        "chrome_trace": {"path": path, "events": n_events},
    }, launches


SCHED_RESET_S = 1.0  # 10c's breaker reset timeout: shorter than an encode, so probes fail mid-run
SCHED_THRESHOLD = 3  # 10c's breaker threshold: consecutive device failures before it opens
JAX_FOREGROUND_BAR = 0.85  # the JAX package's acceptance bar (ec/device_queue.py DEFAULT_SHARES)


def admitted(cls: str) -> tuple[float, float]:
    """`sw_ec_queue_admitted_total` and `..._cost_total` of one class,
    summed over every chip label, from the registry's text."""
    from seaweedfs_tpu_torch.utils import metrics

    parsed = parse_exposition(metrics.REGISTRY.render().decode())
    out = []
    for name in ("sw_ec_queue_admitted_total", "sw_ec_queue_admitted_cost_total"):
        out.append(sum(v for (n, lab), v in parsed.items() if n == name and dict(lab)["cls"] == cls))
    return out[0], out[1]


def gauge_of(be) -> float:
    """The breaker gauge's sample for one FallbackBackend."""
    from seaweedfs_tpu_torch.ec import backend as backend_mod

    label = be.chip_label or f"{type(be.primary).__name__}@{be._seq}"
    return dict((lab["chip"], v) for lab, v in backend_mod._breaker_samples())[label]


SCHED_TURN_READS = 30  # cold degraded reads per turn of 10b's scheduler on / off comparison


def losing_card():
    """`TorchBackend` subclass for 10c: a card that loses chosen batches
    of a staged stream as a reset card would, with an OSError (the class
    `FallbackBackend` fails over on). The `apply_staged` calls numbered
    in `at_dispatch` raise before they launch; the `to_host` calls
    numbered in `at_drain` raise after the batch ran. Made inside a
    function: the smoke imports the package only once it has a card."""
    from seaweedfs_tpu_torch.ec import TorchBackend

    class LosingCard(TorchBackend):
        def __init__(self, ctx, at_dispatch=(), at_drain=(), **kw):
            super().__init__(ctx, **kw)
            self.at_dispatch, self.at_drain = frozenset(at_dispatch), frozenset(at_drain)
            self.dispatched = self.drained = 0

        def apply_staged(self, coeffs, staged):
            self.dispatched += 1
            if self.dispatched in self.at_dispatch:
                raise OSError(f"the card was lost at dispatch {self.dispatched}")
            return super().apply_staged(coeffs, staged)

        def to_host(self, result):
            self.drained += 1
            if self.drained in self.at_drain:
                raise OSError(f"the card was lost at drain {self.drained}")
            return super().to_host(result)

    return LosingCard


def sched_phase(work, base, ctx, records, dat_size, digests, n_batches, enc_s) -> tuple[dict, dict]:
    """Phase 10: the device scheduler and the CPU failover, in
    `work`/sched (hard links to the volume's .dat and .idx, made right
    after phase 4). Returns (result, launches by kernel)."""
    import threading

    from seaweedfs_tpu_torch import faults
    from seaweedfs_tpu_torch.ec import (
        CpuBackend, EcVolume, FallbackBackend, QueueScope, TorchBackend, backend as backend_mod,
        ec_encode_volume, get_backend, rebuild_ec_files,
    )
    from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.utils import devices
    from seaweedfs_tpu_torch.utils.retry import CircuitBreaker

    src = os.path.join(work, "sched")
    launches = dict.fromkeys(("gf2_apply", "gf2_apply_planes"), 0)
    out: dict = {}
    LosingCard = losing_card()

    def volume_dir(name: str, shards_from: str | None = None) -> str:
        """A directory holding links to the .dat and .idx, or (for a
        rebuild) to a finished encode's sidecars and shards but LOST."""
        d = os.path.join(work, "sched-" + name)
        os.makedirs(d)
        if shards_from is None:
            for ext in (".dat", ".idx"):
                os.link(os.path.join(src, "1" + ext), os.path.join(d, "1" + ext))
        else:
            keep = [".ecx", ".ecj", ".vif", ".ecsum"] + [
                ctx.to_ext(i) for i in range(ctx.total) if i not in LOST]
            for ext in keep:
                if os.path.exists(shards_from + ext):
                    os.link(shards_from + ext, os.path.join(d, "1" + ext))
        return os.path.join(d, "1")

    def same_shards(b: str, what: str, ids=None) -> None:
        for i in (range(ctx.total) if ids is None else ids):
            if sha256(b + ctx.to_ext(i)) != digests[i]:
                raise AssertionError(f"{what}: shard {i} differs from phase 4's")

    def counted() -> int:
        for k in launches:
            launches[k] += rs_kernels.LAUNCHES[k]
        return rs_kernels.LAUNCHES["gf2_apply"]

    # -- 10a. the probe and auto --------------------------------------------------
    t0 = time.perf_counter()
    found = devices.probe_accelerators(refresh=True)
    probe_s = time.perf_counter() - t0
    auto = get_backend("auto", K, M)
    card0 = "cuda:0" if DEVICE == "cuda" else DEVICE
    if found < 1 or not isinstance(auto, FallbackBackend) or type(auto.primary) is not TorchBackend \
            or str(auto.primary.device) != card0 or any(backend_mod.AUTO_CPU.values()):
        raise AssertionError(f"auto resolved to {auto!r} with {found} cards probed, "
                             f"CPU resolutions {backend_mod.AUTO_CPU}")
    out["10a"] = {"probe_accelerators": found, "probe_s": probe_s, "auto": type(auto).__name__,
                  "primary": f"{type(auto.primary).__name__} on {auto.primary.device}",
                  "cpu_resolutions": dict(backend_mod.AUTO_CPU)}
    print("10a probe and auto: " + json.dumps(out["10a"]))

    # -- 10b. an unarmed encode through auto --------------------------------------
    b = volume_dir("b")
    fg0 = admitted("foreground")
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    ec_encode_volume(b, ctx, backend=auto)
    wall_b = time.perf_counter() - t0
    fg1 = admitted("foreground")
    n = counted()
    same_shards(b, "10b encode through auto")
    if (n, auto.fallback_batches, auto.breaker.state, gauge_of(auto), fg1[0] - fg0[0]) \
            != (n_batches, 0, "closed", 0.0, n_batches):
        raise AssertionError(f"10b: {n} launches, {auto.fallback_batches} batches on the CPU, "
                             f"breaker {auto.breaker.state}, gauge {gauge_of(auto)}, "
                             f"{fg1[0] - fg0[0]} foreground admissions for {n_batches} batches")
    out["10b"] = {"seconds": wall_b, "phase4_seconds": enc_s, "launches": n,
                  "foreground_admitted": fg1[0] - fg0[0], "foreground_cost": fg1[1] - fg0[1],
                  "fallback_batches": auto.fallback_batches, "breaker": auto.breaker.state,
                  "stage_seconds": dict(auto.stage_seconds)}
    print("10b encode through auto (14 shards sha256-identical, no batch on the CPU, one launch "
          "and one foreground admission per batch): " + json.dumps(out["10b"]))

    # -- 10b'. the scheduler's cost: the same encode and cold degraded reads
    # with the scope disabled and enabled, in turns, in one process ----------
    reads = degraded_records(records, dat_size)[:SCHED_TURN_READS]
    src_fd = os.open(base + ".dat.orig", os.O_RDONLY)
    off_scope = QueueScope(enabled=False)
    turns: dict = {"off": {"encode_s": [], "read_p50_ms": [], "read_p99_ms": []},
                   "on": {"encode_s": [], "read_p50_ms": [], "read_p99_ms": []}}
    try:
        for on in (False, True, True, False):
            scope = None if on else off_scope  # None: the default scope, enabled
            fg0 = admitted("foreground")
            rs_kernels.reset_launches()
            t0 = time.perf_counter()
            ec_encode_volume(b, ctx, backend=TorchBackend(ctx), scheduler=scope)
            wall = time.perf_counter() - t0
            if counted() != n_batches:
                raise AssertionError(f"10b': encode launched {rs_kernels.LAUNCHES}")
            same_shards(b, f"10b' encode with the scheduler {'on' if on else 'off'}")
            ev = EcVolume(os.path.dirname(b), 1, backend=TorchBackend(ctx, impl="cuda_planes"),
                          scheduler=scope)
            lat = []
            try:
                ev.unmount_shards([DEGRADED])
                rs_kernels.reset_launches()
                for rec in reads:
                    t0 = time.perf_counter()
                    got = ev.read_needle(rec[0], cookie=rec[1]).data
                    lat.append(time.perf_counter() - t0)
                    if got != os.pread(src_fd, rec[3], rec[2] + 20):
                        raise AssertionError(f"10b': degraded read of needle {rec[0]:x} differs")
                misses = ev.interval_cache.loads
            finally:
                ev.close()
            counted()
            moved = admitted("foreground")[0] - fg0[0]
            if rs_kernels.LAUNCHES["gf2_apply_planes"] != misses \
                    or moved != ((n_batches + misses) if on else 0):
                raise AssertionError(f"10b': {rs_kernels.LAUNCHES} for {misses} cache misses, "
                                     f"{moved} admissions with the scheduler {'on' if on else 'off'}")
            t = turns["on" if on else "off"]
            t["encode_s"].append(wall)
            t["read_p50_ms"].append(percentile_ms(lat, 50))
            t["read_p99_ms"].append(percentile_ms(lat, 99))
    finally:
        os.close(src_fd)
    out["10b_turns"] = {**turns, "reads_per_turn": len(reads),
                        "encode_on_over_off": sum(turns["on"]["encode_s"]) / sum(turns["off"]["encode_s"]),
                        "read_p50_on_over_off": sum(turns["on"]["read_p50_ms"])
                        / sum(turns["off"]["read_p50_ms"])}
    print("10b' the scheduler's cost, off and on in turns (outputs identical; admissions only when "
          "on): " + json.dumps(out["10b_turns"]))

    # -- 10c. failover on the card, armed by the smoke ----------------------------
    fc = FallbackBackend(TorchBackend(ctx), CpuBackend(ctx), breaker=CircuitBreaker(
        failure_threshold=SCHED_THRESHOLD, reset_timeout=SCHED_RESET_S))
    c = volume_dir("c")
    seen_open = []
    stop = threading.Event()

    def watch() -> None:  # the gauge, sampled while the armed encode runs
        while not stop.wait(0.005):
            seen_open.append(gauge_of(fc))

    watcher = threading.Thread(target=watch)
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    watcher.start()
    try:
        with faults.injected("ec.backend.device.to_host", faults.io_error()) as h:
            ec_encode_volume(c, ctx, backend=fc)
    finally:
        stop.set()
        watcher.join()
    wall_c1 = time.perf_counter() - t0
    state_after, gauge_after = fc.breaker.state, gauge_of(fc)
    n = counted()
    same_shards(c, "10c armed encode")
    to_card = h.hits  # batches that reached the card and failed in to_host
    served = n - to_card  # launched batches whose result came back from the card
    if served + fc.fallback_batches != n_batches or fc.fallback_batches != n_batches \
            or to_card < SCHED_THRESHOLD or max(seen_open, default=0.0) != 1.0 \
            or gauge_after != (1.0 if state_after == "open" else 0.0):
        raise AssertionError(f"10c armed: {fc.fallback_batches} on the CPU of {n_batches}, {n} launches "
                             f"for {to_card} batches on the card, gauge {max(seen_open, default=0.0)}"
                             f" while armed, {gauge_after} at the end ({state_after})")
    armed = {"seconds": wall_c1, "fallback_batches": fc.fallback_batches,
             "device_served": served, "batches_to_card_failed_in_to_host": to_card,
             "launches": n, "breaker_after": state_after, "gauge_max_while_armed": max(seen_open),
             "gauge_samples": len(seen_open)}
    while fc.breaker.state == "open":
        time.sleep(0.05)
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    ec_encode_volume(c, ctx, backend=fc)
    wall_c2 = time.perf_counter() - t0
    n = counted()
    same_shards(c, "10c encode after the reset timeout")
    # The first batch is the half-open probe; the batches the pipeline
    # dispatches while the probe is in flight find the breaker still
    # half-open with its one probe taken, and go to the CPU (the JAX
    # package's semantics); once the probe drains, the breaker is
    # closed and the rest run on the card.
    during_probe = fc.fallback_batches - n_batches
    if n + during_probe != n_batches or not 0 <= during_probe < n_batches \
            or fc.breaker.state != "closed" or gauge_of(fc) != 0.0:
        raise AssertionError(f"10c probe: {n} launches, {during_probe} on the CPU, "
                             f"breaker {fc.breaker.state}")
    probe = {"seconds": wall_c2, "launches": n, "batches_on_cpu_while_probing": during_probe,
             "fallback_batches": fc.fallback_batches, "breaker": fc.breaker.state}
    # The rebuild through the staged-apply driver (run_staged_apply: the
    # path of rebuild, decode's self-heal and wide reads) on a card that
    # loses batches mid-stream. Two in a row fail at dispatch and one
    # after a success fails at drain, so the breaker (threshold 3) never
    # opens and every other batch runs on the card.
    for i in LOST:
        os.unlink(c + ctx.to_ext(i))
    lossy = LosingCard(ctx, at_dispatch=(1, 2), at_drain=(2,))
    fr = FallbackBackend(lossy, CpuBackend(ctx), breaker=CircuitBreaker(
        failure_threshold=SCHED_THRESHOLD, reset_timeout=SCHED_RESET_S))
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    rebuilt = rebuild_ec_files(c, backend=fr)
    wall_c3 = time.perf_counter() - t0
    n = counted()
    same_shards(c, "10c rebuild on a card that loses batches", LOST)
    want_batches = -(-os.path.getsize(c + ctx.to_ext(0)) // (16 << 20))
    lost = len(lossy.at_dispatch) + len(lossy.at_drain)
    if rebuilt != list(LOST) or lossy.dispatched != want_batches or fr.fallback_batches != lost \
            or n != want_batches - len(lossy.at_dispatch) or fr.breaker.state != "closed" \
            or gauge_of(fr) != 0.0:
        raise AssertionError(f"10c rebuild: {rebuilt}, {n} launches and {lossy.dispatched} dispatches "
                             f"for {want_batches} batches, {fr.fallback_batches} on the CPU for {lost} "
                             f"lost, breaker {fr.breaker.state}")
    out["10c"] = {"armed_encode": armed, "probe_encode": probe,
                  "rebuild": {"seconds": wall_c3, "batches": want_batches,
                              "lost_at_dispatch": len(lossy.at_dispatch),
                              "lost_at_drain": len(lossy.at_drain),
                              "fallback_batches": fr.fallback_batches, "launches": n,
                              "breaker": fr.breaker.state},
                  "reset_timeout_s": SCHED_RESET_S, "threshold": SCHED_THRESHOLD}
    print("10c failover on the card (every output sha256-identical; CPU batches == what the smoke "
          "injected; launches == batches that reached the card): " + json.dumps(out["10c"]))

    # -- 10d. contention on one backend under one QueueScope ----------------------
    scope = QueueScope()
    d = volume_dir("d")
    r = volume_dir("r", shards_from=b)
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    ec_encode_volume(d, ctx, backend=auto, scheduler=scope)
    alone_s = time.perf_counter() - t0
    same_shards(d, "10d encode alone")
    errors: list = []
    reb_wall = []

    def rebuild() -> None:
        try:
            t = time.perf_counter()
            if rebuild_ec_files(r, backend=auto, priority="recovery", scheduler=scope) != list(LOST):
                raise AssertionError("10d rebuild regenerated other shards")
            reb_wall.append(time.perf_counter() - t)
        except BaseException as e:  # noqa: BLE001 - raised on the main thread
            errors.append(e)

    alone = {c: dict(v) for c, v in scope.stats_snapshot()[0]["classes"].items()}
    t = threading.Thread(target=rebuild)
    t0 = time.perf_counter()
    t.start()
    ec_encode_volume(d, ctx, backend=auto, scheduler=scope)
    contended_s = time.perf_counter() - t0
    t.join()
    if errors:
        raise errors[0]
    n = counted()
    same_shards(d, "10d encode beside the rebuild")
    same_shards(r, "10d rebuild beside the encode", LOST)
    (q,) = scope.stats_snapshot()
    classes = q["classes"]
    reb_n = -(-os.path.getsize(b + ctx.to_ext(0)) // (16 << 20))
    if classes["foreground"]["admitted"] != 2 * n_batches or classes["recovery"]["admitted"] != reb_n \
            or n != 2 * n_batches + reb_n or auto.fallback_batches != 0 or q["load"] != 0:
        raise AssertionError(f"10d: {classes}, {n} launches, {auto.fallback_batches} on the CPU")
    ratio = alone_s / contended_s
    out["10d"] = {
        "foreground_alone_s": alone_s, "foreground_beside_rebuild_s": contended_s,
        "rebuild_s": reb_wall[0], "foreground_rate_ratio": ratio,
        "jax_bar_foreground_at_least": JAX_FOREGROUND_BAR, "bar_met": ratio >= JAX_FOREGROUND_BAR,
        "classes": {cls: {"admitted": st["admitted"] - alone[cls]["admitted"],
                          "admitted_cost": st["admitted_cost"] - alone[cls]["admitted_cost"],
                          "wait_s_total": st["wait_s_total"] - alone[cls]["wait_s_total"],
                          "wait_s_max": st["wait_s_max"]}
                    for cls, st in classes.items() if cls != "scrub"},
        "window": q["window"], "queue": q["chip"],
    }
    print("10d foreground encode beside a recovery rebuild on one auto backend (both outputs "
          "sha256-identical; per class for the contended run; the bar is an observation): "
          + json.dumps(out["10d"]))

    # -- 10e. streams -----------------------------------------------------------------
    fg0 = admitted("foreground")
    stream, stream_launches = stream_phase(work, base + ".dat.orig", ctx, TRACE_STREAM_BYTES)
    fg1 = admitted("foreground")
    launches["gf2_apply"] += stream_launches
    if fg1[0] - fg0[0] != stream_launches:
        raise AssertionError(f"10e stream: {fg1[0] - fg0[0]} foreground admissions for "
                             f"{stream_launches} launches")
    os.environ["SEAWEED_EC_STREAM_BACKEND"] = "auto"
    try:
        n_rec = int(MQ_RATE * TRACE_MQ_SECONDS)
        keys, values = mq_source(n_rec)
        ts0 = time.time_ns()
        mq_root = os.path.join(work, "mq-sched")
        fg0 = admitted("foreground")
        pub = mq_publish(mq_root, "auto", n_rec, keys, values, ts0, backend_name="auto")
        fg1 = admitted("foreground")
        mq_launches = counted()
        mq_be = pub["backend"]
        rs_kernels.reset_launches()
        recs = PartitionParity(mq_root, "bench", "auto", 0).recover()
        counted()
    finally:
        os.environ.pop("SEAWEED_EC_STREAM_BACKEND", None)
    if len(pub["calls"]) < TRACE_MQ_FLUSHES or len(recs) != n_rec or not isinstance(mq_be, FallbackBackend) \
            or mq_be.fallback_batches != 0 or fg1[0] - fg0[0] != mq_launches:
        raise AssertionError(f"10e partition: {len(pub['calls'])} flushes, {len(recs)} of {n_rec} "
                             f"records, {type(mq_be).__name__} with {getattr(mq_be, 'fallback_batches', None)}"
                             f" on the CPU, {fg1[0] - fg0[0]} admissions for {mq_launches} launches")
    check_records(recs, keys, values, ts0)
    del recs
    shutil.rmtree(mq_root)
    out["10e"] = {
        "stream": {k: stream[k] for k in ("bytes", "flushes", "launches", "batch_launches",
                                          "stream_seconds", "time_to_durable_parity_p50_ms")},
        "stream_foreground_admitted": stream_launches,
        "partition": {"records": n_rec, "flushes": len(pub["calls"]) + 1, "launches": mq_launches,
                      "foreground_admitted": fg1[0] - fg0[0], "backend": type(mq_be).__name__,
                      "fallback_batches": mq_be.fallback_batches},
    }
    print("10e stream through place_stream and an auto partition (sha256-identical, admissions "
          "== launches, records replayed byte-exact, no batch on the CPU): " + json.dumps(out["10e"]))

    # -- no fallback and no CPU resolution outside 10c ---------------------------
    stray = [be for be in list(backend_mod._FALLBACKS) if be not in (fc, fr) and be.fallback_batches]
    if stray or any(backend_mod.AUTO_CPU.values()):
        raise AssertionError(f"batches on the CPU outside 10c: {[be.fallback_batches for be in stray]}, "
                             f"CPU resolutions {backend_mod.AUTO_CPU}")
    for name in ("b", "c", "d", "r"):
        shutil.rmtree(os.path.join(work, "sched-" + name))
    return out, launches


PEER_LOCAL = (0, 1, 2, 4)  # the local holder's shards: fewer than k
PEER_ROT = 4  # its shard with two rotten leaves, leaf-repaired from peers
# one holder per shard, as on a balanced cluster; shards LOST are held by no one
PEER_SHARDS = {"peer-a": (5, 8, 12), "peer-b": (6, 9, 13), "peer-c": (7, 10)}
ROT_PEER = "peer-rot"  # an extra holder of shard 5, first in its list, serving one flipped byte
ROT_SHARD = 5

# The peers of phases 11 and 12 in one child (a fresh interpreter that
# touches no CUDA, so the sendfile egress and the rebuilding interpreter
# share no GIL): a ShardNetPlane per holder, each with its own resolve and
# generation fence, and, given a fifth argument, "peer-blob": a plane
# with a `resolve_blob` confined to that directory (a volume server's
# stream-blob root), counting the ops it serves. It prints its ports,
# then answers "status" and "stop <name>..." lines on stdin with one JSON
# line each (with "blob": the blob ops, the unlinked paths and this
# process's `sw_net_bytes_received_total`), and "exit".
PEER_CHILD = r"""
import json, os, sys
from seaweedfs_tpu_torch.ec import native_io, net_plane
from seaweedfs_tpu_torch.utils import metrics as M

src, rot, gen, spec = sys.argv[1], sys.argv[2], int(sys.argv[3]), json.loads(sys.argv[4])
blob_root = os.path.realpath(sys.argv[5]) if len(sys.argv) > 5 else None
blob = {"ops": {}, "unlinked": []}
planes = {}
for name, sids in spec.items():
    root = rot if name == "peer-rot" else src
    fds = {}

    def resolve(vid, sid, g, sids=frozenset(sids), root=root, fds=fds):
        if g != gen:
            raise net_plane.NetPlaneError("stale generation")
        if vid != 1 or sid not in sids:
            raise net_plane.NetPlaneError("shard not local")
        if sid not in fds:
            fds[sid] = os.open(os.path.join(root, "1.ec%02d" % sid), os.O_RDONLY)
        return fds[sid], os.fstat(fds[sid]).st_size

    planes[name] = net_plane.ShardNetPlane("127.0.0.1", 0, resolve, server_label=name)
    planes[name].start()


def resolve_blob(path, op, md):
    full = os.path.realpath(os.path.join(blob_root, path))
    if not full.startswith(blob_root + os.sep):
        raise net_plane.NetPlaneError("blob path escapes stream root")
    blob["ops"][op] = blob["ops"].get(op, 0) + 1
    if op == "unlink":
        blob["unlinked"].append(path)
        try:
            os.unlink(full)
        except FileNotFoundError:
            pass
        return None
    os.makedirs(os.path.dirname(full), exist_ok=True)
    return os.open(full, os.O_CREAT | os.O_RDWR, 0o644)


def no_shards(vid, sid, g):
    raise net_plane.NetPlaneError("shard not local")


if blob_root:
    planes["peer-blob"] = net_plane.ShardNetPlane("127.0.0.1", 0, no_shards, server_label="peer-blob",
                                                  resolve_blob=resolve_blob)
    planes["peer-blob"].start()
print(json.dumps({"ports": {n: p.port for n, p in planes.items()},
                  "egress_native": net_plane.egress_native()}), flush=True)
for line in sys.stdin:
    cmd = line.split()
    if cmd[0] == "stop":
        for n in cmd[1:]:
            planes.pop(n).stop()
    elif cmd[0] == "exit":
        break
    status = {n: p.status() for n, p in planes.items()}
    if blob_root:
        status["blob"] = dict(blob, received={"%s,%s" % k: v for k, v in
                                              M.net_bytes_received_total.snapshot().items()})
    print(json.dumps(status), flush=True)
for p in planes.values():
    p.stop()
"""


class PeerChild:
    """PEER_CHILD in a fresh interpreter, its stderr in `log_path`: the
    JSON line it prints when its planes are up (`hello`), `ask` for a
    command's answer, `close` to end it."""

    def __init__(self, args: list[str], log_path: str):
        repo = os.path.dirname(os.path.abspath(__file__))
        self.log_path = log_path
        with open(log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", PEER_CHILD, *args],
                cwd=repo, env=dict(os.environ, PYTHONPATH=repo), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=log, text=True,
            )

    def _line(self, what: str) -> dict:
        got = self.proc.stdout.readline()
        if not got:
            with open(self.log_path) as f:
                raise AssertionError(f"the peer child {what}: {f.read()[-3000:]}")
        return json.loads(got)

    def hello(self) -> dict:
        return self._line("did not start")

    def ask(self, line: str) -> dict:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()
        return self._line("died")

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("exit\n")
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def peer_copies(work: str, base: str, ctx, digests: dict) -> None:
    """Phase 11's inputs, made right after phase 5 while every shard is
    as encoded (checked here): copies, not links, of the shards some
    holder serves or the local holder keeps (later phases patch,
    truncate and replace shards in place), the small files, and the
    rotten holder's copy of shard ROT_SHARD."""
    src = os.path.join(work, "peer", "src")
    os.makedirs(src)
    held = sorted(set(PEER_LOCAL).union(*PEER_SHARDS.values()))
    for i in held:
        if sha256(base + ctx.to_ext(i)) != digests[i]:
            raise AssertionError(f"phase 11's copy of shard {i} is not as encoded")
        shutil.copyfile(base + ctx.to_ext(i), os.path.join(src, "1" + ctx.to_ext(i)))
    for ext in (".ecx", ".ecj", ".vif", ".ecsum"):
        if os.path.exists(base + ext):
            shutil.copyfile(base + ext, os.path.join(src, "1" + ext))
    os.makedirs(os.path.join(work, "peer", "rot"))
    shutil.copyfile(base + ctx.to_ext(ROT_SHARD), os.path.join(work, "peer", "rot", "1" + ctx.to_ext(ROT_SHARD)))


class Timed:
    """A transport wrapped to count its calls, bytes and seconds."""

    def __init__(self, fn, nbytes):
        self.fn, self.nbytes = fn, nbytes
        self.calls = self.bytes = 0
        self.seconds = 0.0
        self.sizes: list[int] = []

    def __call__(self, *args):
        t0 = time.perf_counter()
        try:
            return self.fn(*args)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.bytes += self.nbytes(args)
            self.sizes.append(self.nbytes(args))

    def summary(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes, "seconds": self.seconds,
                "gb_per_s": self.bytes / self.seconds / 1e9 if self.seconds else None}


def net_snapshot() -> dict:
    """The `sw_net_*` counters, keyed "name{plane=..,direction=..}"."""
    from seaweedfs_tpu_torch.utils import metrics as M

    return {f"{name}{{plane={plane},direction={direction}}}": v
            for name, fam in (("sent", M.net_bytes_sent_total), ("received", M.net_bytes_received_total),
                              ("copied", M.net_bytes_copied_total))
            for (plane, direction), v in fam.snapshot().items()}


def net_delta(before: dict) -> dict:
    """What the `sw_net_*` counters moved by since `before` (process-wide
    counters: compared by delta)."""
    return {k: int(v - before.get(k, 0)) for k, v in net_snapshot().items() if v != before.get(k, 0)}


def peer_phase(work, ctx, digests, reb_batches) -> tuple[dict, int]:
    """Phase 11: peer-fetch rebuild of shards LOST from a local holder of
    shards PEER_LOCAL (fewer than k, shard PEER_ROT with two rotten
    leaves) and three peers in a child process serving the rest over the
    shard net plane. 11a native plane, 11b Python plane, 11c two peers
    stopped: a clean refusal. Returns (result, gf2_apply launches)."""
    from seaweedfs_tpu_torch.ec import BitrotProtection, ECError, TorchBackend, native_io, net_plane
    from seaweedfs_tpu_torch.ec import backend as port_backend
    from seaweedfs_tpu_torch.ec import peer_rebuild as pr
    from seaweedfs_tpu_torch.ec.repair_journal import leaf_ranges
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.utils import native

    if not native_io.enabled():
        raise AssertionError("phase 11 needs the native plane (SEAWEED_EC_NATIVE is 0)")
    root = os.path.join(work, "peer")
    src = os.path.join(root, "src")
    src_base = os.path.join(src, "1")
    prot = BitrotProtection.load(src_base + ".ecsum")
    lsize = prot.leaf_size
    size = prot.shard_sizes[0]
    n_leaves = len(prot.shard_leaf_crcs[PEER_ROT])
    rot_leaves = [n_leaves // 4, 3 * n_leaves // 4]  # not adjacent: two ranges
    n_ranges = len(leaf_ranges(rot_leaves, lsize, prot.shard_sizes[PEER_ROT]))
    rot_at = (n_leaves // 2) * lsize + 333  # outside shard PEER_ROT's rotten leaves
    flip(os.path.join(root, "rot", "1" + ctx.to_ext(ROT_SHARD)), rot_at)
    holders = {sid: [name] for name, sids in PEER_SHARDS.items() for sid in sids}
    holders[ROT_SHARD] = [ROT_PEER] + holders[ROT_SHARD]
    spec = {**{n: list(s) for n, s in PEER_SHARDS.items()}, ROT_PEER: [ROT_SHARD]}

    child = PeerChild([src, os.path.join(root, "rot"), str(prot.generation), json.dumps(spec)],
                      os.path.join(root, "peers.log"))
    client = net_plane.NetPlaneClient(timeout=60.0)

    result: dict = {"holders": {str(k): v for k, v in sorted(holders.items())},
                    "rot_leaves": rot_leaves, "rotten_byte": rot_at,
                    "recv_overlap_active_4MiB": native.recv_overlap_active(4 << 20)}
    launches = 0
    try:
        hello = child.hello()
        if not hello["egress_native"]:
            raise AssertionError("the peers would egress through Python")
        addr = {n: ("127.0.0.1", p) for n, p in hello["ports"].items()}
        try:
            client.read_bytes(addr["peer-a"], 1, 5, prot.generation + 1, 0, 16)
            raise AssertionError("a stale generation was served")
        except net_plane.NetPlaneError as e:
            if "stale generation" not in str(e):
                raise

        def transports():
            def fetch(peer, sid, off, n):
                try:
                    return client.read_bytes(addr[peer], 1, sid, prot.generation, off, n)
                except (net_plane.NetPlaneUnavailable, net_plane.NetPlaneError) as e:
                    raise pr.PeerFetchTransient(str(e)) from e

            return (Timed(fetch, lambda a: a[3]),
                    Timed(net_plane.make_fetch_into(client, 1, prot.generation, addr_of=addr.__getitem__),
                          lambda a: a[3]))

        def local(tag: str) -> str:
            from_src = same_inputs(src_base, os.path.join(root, tag), [i for i in PEER_LOCAL if i != PEER_ROT])
            shutil.copyfile(src_base + ctx.to_ext(PEER_ROT), from_src + ctx.to_ext(PEER_ROT))
            for li in rot_leaves:
                flip(from_src + ctx.to_ext(PEER_ROT), li * lsize + 1000)
            return from_src

        def run(tag: str, native_plane: bool) -> dict:
            base = local(tag)
            fetch, fetch_into = transports()
            backend = TorchBackend(ctx)
            rebuild_wall = []
            inner = pr.rebuild_ec_files

            def timed_rebuild(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return inner(*a, **kw)
                finally:
                    rebuild_wall.append(time.perf_counter() - t0)

            cpu_before = dict(port_backend.AUTO_CPU)
            net_before = net_snapshot()
            rs_kernels.reset_launches()
            pr.rebuild_ec_files = timed_rebuild
            t0 = time.perf_counter()
            try:
                rep = pr.rebuild_from_peers(base, holders, fetch, ctx=ctx, targets=list(LOST),
                                            backend=backend,
                                            fetch_into=fetch_into if native_plane else None)
            finally:
                pr.rebuild_ec_files = inner
            wall = time.perf_counter() - t0
            n_launch = rs_kernels.LAUNCHES["gf2_apply"]
            plane = "native" if native_plane else "python"
            if rep.leaf_repaired != {PEER_ROT: rot_leaves} or rep.rebuilt != list(LOST):
                raise AssertionError(f"11{tag}: {rep}")
            for sid in (*LOST, PEER_ROT):
                if sha256(base + ctx.to_ext(sid)) != digests[sid]:
                    raise AssertionError(f"11{tag}: shard {sid} differs from its encode-time bytes")
            k = ctx.data_shards
            local_good = len(PEER_LOCAL) - 1
            if rep.repair_wire_bytes != (k - local_good) * lsize * n_ranges:
                raise AssertionError(f"11{tag}: repair_wire_bytes {rep.repair_wire_bytes}")
            want_fetched = {sid: holders[sid][-1] for sid in range(5, 11)}
            if rep.excluded_peers != [ROT_PEER] or rep.fetched != want_fetched:
                raise AssertionError(f"11{tag}: excluded {rep.excluded_peers}, fetched {rep.fetched}")
            # `fetch` carried the leaf ranges and ONE re-read of the rotten
            # holder's bad granule (the granule, not the chunk)
            n_fetch = (k - local_good) * n_ranges + 1
            if native_plane and fetch.sizes != [lsize] * n_fetch:
                raise AssertionError(f"11{tag}: fetch asked for {fetch.sizes}, expected {n_fetch} "
                                     f"ranges of {lsize}")
            if set(rep.fetched_plane.values()) != {plane}:
                raise AssertionError(f"11{tag}: planes {rep.fetched_plane}")
            if os.path.exists(pr.staging_dir(base)):
                raise AssertionError(f"11{tag}: staging left behind")
            if n_launch != reb_batches + n_ranges or rs_kernels.LAUNCHES["gf2_apply_planes"]:
                raise AssertionError(f"11{tag}: {rs_kernels.LAUNCHES} launches for {reb_batches} "
                                     f"batches and {n_ranges} leaf ranges")
            if dict(port_backend.AUTO_CPU) != cpu_before:
                raise AssertionError(f"11{tag}: a CPU resolution {port_backend.AUTO_CPU}")
            if client._no_plane:
                raise AssertionError(f"11{tag}: no-plane memo for live peers {client._no_plane}")
            # the wire: whole streams on `plane`, the rotten holder's up to
            # and including its bad chunk, one granule re-read and the
            # leaf ranges through `fetch` (the Python plane)
            delta = net_delta(net_before)
            chunk = pr.NATIVE_FETCH_CHUNK if native_plane else pr.FETCH_CHUNK
            streamed = len(want_fetched) * size + min(size, (rot_at // chunk + 1) * chunk)
            want = {"native": streamed if native_plane else 0,
                    "python": rep.repair_wire_bytes + lsize + (0 if native_plane else streamed)}
            got = {p: delta.get(f"received{{plane={p},direction=read}}", 0) for p in ("native", "python")}
            if got != want:
                raise AssertionError(f"11{tag}: sw_net_bytes_received_total moved {got}, expected {want}")
            return {
                "wall_s": wall, "rebuild_wall_s": sum(rebuild_wall),
                "fetched_bytes": streamed, "fetched_gb_per_s_over_loopback":
                    streamed / (fetch_into if native_plane else fetch).seconds / 1e9,
                "fetch_into": fetch_into.summary(), "fetch": fetch.summary(),
                "launches": n_launch, "leaf_ranges": n_ranges, "rebuild_batches": reb_batches,
                "repair_wire_bytes": rep.repair_wire_bytes, "excluded": rep.excluded_peers,
                "fetched": {str(s): p for s, p in rep.fetched.items()}, "plane": plane,
                "backend_stage_seconds": dict(backend.stage_seconds), "sw_net_delta": delta,
                "outputs": {str(s): sha256(base + ctx.to_ext(s)) for s in (*LOST, PEER_ROT)},
            }

        t0 = time.perf_counter()
        a = run("a", True)
        launches += a["launches"]
        b = run("b", False)
        launches += b["launches"]
        if a["outputs"] != b["outputs"]:
            raise AssertionError("11b's outputs differ from 11a's")
        result["11a_native"], result["11b_python"] = a, b
        result["peers_status"] = child.ask("status")

        # -- 11c. two of the three peers stopped: fewer than k reachable ------
        child.ask("stop peer-a peer-b")
        base = local("c")
        before = {name: sha256(os.path.join(root, "c", name)) for name in sorted(os.listdir(os.path.join(root, "c")))}
        fetch, fetch_into = transports()
        rs_kernels.reset_launches()
        t1 = time.perf_counter()
        try:
            pr.rebuild_from_peers(base, holders, fetch, ctx=ctx, targets=list(LOST),
                                  backend=TorchBackend(ctx), fetch_into=fetch_into)
            raise AssertionError("11c: the rebuild did not refuse")
        except ECError as e:
            refusal = str(e)
        after = {name: sha256(os.path.join(root, "c", name)) for name in sorted(os.listdir(os.path.join(root, "c")))}
        if after != before or os.path.exists(pr.staging_dir(base)):
            raise AssertionError(f"11c: the local directory changed: {sorted(before)} -> {sorted(after)}")
        launches += rs_kernels.LAUNCHES["gf2_apply"]
        result["11c_refusal"] = {"wall_s": time.perf_counter() - t1, "message": refusal,
                                 "launches": rs_kernels.LAUNCHES["gf2_apply"],
                                 "memoized_unreachable": sorted(f"{h}:{p}" for h, p in client._no_plane)}
        result["phase_s"] = time.perf_counter() - t0
    finally:
        client.close()
        child.close()
    return result, launches


# -- 12. a durable-parity partition with remote stream shards --------------------------

REMOTE_ROOTS_ENV = "SEAWEED_EC_STREAM_REMOTE_ROOTS"
# generation 0 is pruned, live, by the first flush that finds this
# generation open: at phase 7b's traffic the partition rotates once or
# twice (flush timing decides), so generation 1 is the one every run opens
PRUNE_WHEN_OPEN = 1


def remote_stream_phase(work: str, mq_local: dict) -> tuple[dict, int]:
    """Phase 12: phase 7b's partition and traffic with two remote roots,
    a mounted path (`hostA`, a local directory standing in for the
    mount) and a net plane (`peer`, the blob plane of PEER_CHILD); the
    flusher prunes generation 0, live, once generation PRUNE_WHEN_OPEN is
    open (the phase fails if the traffic ends before it opens).
    Checked: placements on both roots in every generation, remote data
    shards sha256-identical at close (a parity shard on the peer only of
    its local length: both packages push each extent once, so its rows of
    a stripe open at a flush stay stale), the prune's remote unlinks, a byte-exact
    recovery of every unpruned record, `delete()` leaving both roots
    empty, one `gf2_apply` launch per parity delta, every pushed byte on
    the native plane. Returns (result, gf2_apply launches)."""
    import logging

    from seaweedfs_tpu_torch.ec import backend as port_backend
    from seaweedfs_tpu_torch.ec import load_stream_journal, native_io, net_plane
    from seaweedfs_tpu_torch.ec.stream_encode import EcStreamEncoder
    from seaweedfs_tpu_torch.mq import stream_parity as sp
    from seaweedfs_tpu_torch.ops import rs_kernels

    if not native_io.enabled():
        raise AssertionError("phase 12 needs the native plane (SEAWEED_EC_NATIVE is 0)")
    root = os.path.join(work, "remote-stream")
    host_a, blobs, local = (os.path.join(root, d) for d in ("hostA", "peer-blobs", "local"))
    os.makedirs(host_a)
    os.makedirs(blobs)
    child = PeerChild([root, root, "0", "{}", blobs], os.path.join(root, "peer.log"))
    rec_bytes = mq_record_bytes()
    n = MQ_BYTES // rec_bytes
    keys, values = mq_source(n)
    ts0 = time.time_ns()
    part = os.path.join(local, "bench", "remote", "0000")

    class Warnings(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.lines: list[str] = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    warned = Warnings()
    deltas = [0]
    pushes: list[float] = []
    placement: dict[int, dict] = {}
    pruned: dict = {}
    live: list = []  # the partition, as the flusher hook sees it
    enc_apply, push = EcStreamEncoder._dispatch_apply, sp.PartitionParity._push_net_shards

    def counted_apply(self, coeffs, data):
        deltas[0] += 1
        return enc_apply(self, coeffs, data)

    def timed_push(self):
        t = time.perf_counter()
        try:
            return push(self)
        finally:
            pushes.append(time.perf_counter() - t)

    def place(pp) -> None:
        """Each generation's placement, read once its files exist."""
        with pp._lock:
            plans = {g: dict(p) for g, p in pp._net_shards.items()}
        for g in gens_of(pp.dir):
            if g in placement:
                continue
            gbase = os.path.join(pp.dir, f"gen-{g:08d}")
            links = {sid: os.readlink(gbase + pp.ctx.to_ext(sid)) for sid in range(pp.ctx.total)
                     if os.path.islink(gbase + pp.ctx.to_ext(sid))}
            net = {sid: rpath for sid in range(pp.ctx.total)
                   for path, (_addr, rpath) in plans.get(g, {}).items() if path == gbase + pp.ctx.to_ext(sid)}
            if not links or not net:
                raise AssertionError(f"12: generation {g} placed on hostA {sorted(links)}, "
                                     f"on the peer {sorted(net)}: both roots must hold shards")
            placement[g] = {"hostA": links, "peer": net,
                            "local": sorted(set(range(pp.ctx.total)) - set(links) - set(net))}

    def prune_gen0(pp, when: str) -> None:
        keep = load_stream_journal(os.path.join(pp.dir, "gen-00000001")).meta
        pruned.update(removed=pp.prune(keep), keep_from=keep, when=when)

    def after_flush(pp) -> None:
        live[:] = [pp]
        place(pp)
        opened = os.path.join(pp.dir, f"gen-{PRUNE_WHEN_OPEN:08d}")
        if not pruned and load_stream_journal(opened) is not None:
            prune_gen0(pp, f"flush, generation {PRUNE_WHEN_OPEN} open")

    logger = logging.getLogger(sp.__name__)
    prev_env = os.environ.get(REMOTE_ROOTS_ENV)
    result: dict = {}
    try:
        port = child.hello()["ports"]["peer-blob"]
        gport = port - net_plane.NET_PLANE_PORT_OFFSET
        if gport < 1 or net_plane.derive_port(gport) != port:
            raise AssertionError(f"12: no gRPC port derives the blob plane's port {port}")
        os.environ[REMOTE_ROOTS_ENV] = f"hostA={host_a},peer=net:127.0.0.1:{gport}/sub"
        logger.addHandler(warned)
        net_before = net_snapshot()
        cpu_before = dict(port_backend.AUTO_CPU)
        EcStreamEncoder._dispatch_apply = counted_apply
        sp.PartitionParity._push_net_shards = timed_push
        try:
            pub = mq_publish(local, "remote", n, keys, values, ts0, after_flush=after_flush)
        finally:
            EcStreamEncoder._dispatch_apply = enc_apply
            sp.PartitionParity._push_net_shards = push
        launches = rs_kernels.LAUNCHES["gf2_apply"]
        masked = rs_kernels.MASKED["gf2_apply"]
        if launches != deltas[0]:
            raise AssertionError(f"12: {launches} gf2_apply launches for {deltas[0]} parity deltas")
        ctx, calls, t_append = pub["ctx"], pub["calls"], pub["t_append"]
        place(live[0])
        if not pruned:
            raise AssertionError(f"12: generation {PRUNE_WHEN_OPEN} never opened under traffic")
        gens = gens_of(part)
        if pruned["removed"] != 1 or gens[0] != 1:
            raise AssertionError(f"12: the prune ({pruned}) left generations {gens}")
        status = child.ask("status")
        # every unpruned net-planned data shard's remote copy is its local
        # file; a parity shard's has its length (stale rows: ROADMAP Queue 3)
        stale_parity = []
        for g in gens:
            gbase = os.path.join(part, f"gen-{g:08d}")
            for sid, rpath in placement[g]["peer"].items():
                # an empty shard (a row the generation never reached) pushes nothing
                rp, lp = os.path.join(blobs, rpath), gbase + ctx.to_ext(sid)
                remote = sha256(rp) if os.path.exists(rp) else hashlib.sha256(b"").hexdigest()
                if sha256(lp) == remote:
                    continue
                if sid < ctx.data_shards or os.path.getsize(rp) != os.path.getsize(lp):
                    raise AssertionError(f"12: the peer's {rpath} differs from its local shard")
                stale_parity.append(rpath)
            for sid, target in placement[g]["hostA"].items():
                if not (os.path.realpath(gbase + ctx.to_ext(sid)).startswith(os.path.realpath(host_a))
                        and os.path.isfile(target) and not os.path.islink(target)):
                    raise AssertionError(f"12: generation {g} shard {sid}'s link target {target}")
        # the prune: generation 0's remote blobs unlinked, its link targets gone
        gen0 = placement[0]
        unlinked = set(status["blob"]["unlinked"])
        if not set(gen0["peer"].values()) <= unlinked or any(
                os.path.exists(os.path.join(blobs, r)) for r in gen0["peer"].values()):
            raise AssertionError(f"12: generation 0's blobs {gen0['peer']} not unlinked ({sorted(unlinked)})")
        if any(os.path.lexists(t) for t in gen0["hostA"].values()):
            raise AssertionError("12: the prune left generation 0's link targets on hostA")
        # every pushed byte rode the native plane into the child
        delta = net_delta(net_before)
        pushed = delta.get("sent{plane=native,direction=write}", 0)
        child_got = status["blob"]["received"]
        if (pushed <= 0 or child_got.get("native,write", 0) != pushed
                or child_got.get("python,write", 0) or delta.get("sent{plane=python,direction=write}", 0)):
            raise AssertionError(f"12: pushed {delta}, the child received {child_got}")
        if dict(port_backend.AUTO_CPU) != cpu_before:
            raise AssertionError(f"12: a CPU resolution {port_backend.AUTO_CPU}")
        if warned.lines:
            raise AssertionError(f"12: the partition warned: {warned.lines[:5]}")

        # a fresh partition over the same local dir: every unpruned record
        rs_kernels.reset_launches()
        t0 = time.perf_counter()
        recs = sp.PartitionParity(local, "bench", "remote", 0).recover()
        recover_s = time.perf_counter() - t0
        rec_launches = rs_kernels.LAUNCHES["gf2_apply"]
        first = pruned["keep_from"]
        if len(recs) != n - first:
            raise AssertionError(f"12: recovered {len(recs)} records, {n - first} unpruned")
        check_records(recs, keys, values, ts0, first)
        del recs
        # delete: no byte left on either root
        rs_kernels.reset_launches()
        sp.PartitionParity(local, "bench", "remote", 0).delete()
        rec_launches += rs_kernels.LAUNCHES["gf2_apply"]
        left = [os.path.join(d, f) for r in (host_a, blobs) for d, _s, fs in os.walk(r) for f in fs]
        if left:
            raise AssertionError(f"12: delete() left {left[:5]}")
        if warned.lines:
            raise AssertionError(f"12: the partition warned: {warned.lines[:5]}")
        final = child.ask("status")

        starts = np.array([c[0] for c in calls])
        ends = np.array([c[1] for c in calls] + [pub["t_end"]])
        lags = ends[np.searchsorted(starts, t_append, side="left")] - t_append
        result = {
            "records": n, "rate_per_s": MQ_RATE, "appends_per_s": n / pub["append_s"],
            "time_to_durable_parity_p50_ms": float(np.percentile(lags, 50) * 1e3),
            "time_to_durable_parity_p99_ms": float(np.percentile(lags, 99) * 1e3),
            "phase_7b_local_only": {k: mq_local[k] for k in (
                "appends_per_s", "time_to_durable_parity_p50_ms", "time_to_durable_parity_p99_ms")},
            "flushes": len(calls), "generations": len(gens) + 1, "pruned": pruned,
            "stale_parity_on_peer": stale_parity,
            "pushed_bytes": pushed, "pushes": len(pushes), "push_seconds": sum(pushes),
            "push_ms_per_flush_p50": float(np.median(pushes) * 1e3),
            "push_ms_per_flush_max": float(max(pushes) * 1e3),
            "placement": {str(g): {"hostA": sorted(p["hostA"]), "peer": sorted(p["peer"]),
                                   "local": p["local"]} for g, p in sorted(placement.items())},
            "blob_ops": final["blob"]["ops"], "blob_plane": final["peer-blob"],
            "launches": launches, "launches_masked_path": masked, "parity_deltas": deltas[0],
            "recovery_seconds": recover_s, "recovery_launches": rec_launches,
        }
    finally:
        logger.removeHandler(warned)
        if prev_env is None:
            os.environ.pop(REMOTE_ROOTS_ENV, None)
        else:
            os.environ[REMOTE_ROOTS_ENV] = prev_env
        sp._net_client().close()
        child.close()
    shutil.rmtree(root)
    return result, launches + rec_launches


# -- 13. the Store at the smoke's volume size -----------------------------------------

STORE_VID = 7
STORE_ROT_SHARD = 7  # a mounted shard with one rotten leaf, repaired by ScrubDaemon
SCRUB_BYTES_PER_S = float(8 << 30)  # the daemon's read budget: above what 9p reads


def store_phase(work: str, ctx, vol_rng_state: dict) -> tuple[dict, dict]:
    """Phase 13: phase 3's needles (the same seeded sizes and bodies)
    written through `Store.write_needle` into a volume the Store
    allocated, read back, 5 deleted, the volume remounted (the .idx
    replayed), sealed and encoded on the card; its EC volume mounted with
    shard DEGRADED unmounted, every live needle over that shard read
    through `Store.read_needle` (reconstructed by `gf2_apply_planes`);
    one rotten leaf of shard STORE_ROT_SHARD repaired by a `ScrubDaemon`
    pass through `gf2_apply`. Phase 11's copies are removed first, and
    this phase's directory at its end. Returns (result, launches by
    kernel)."""
    from seaweedfs_tpu_torch.ec import (
        BitrotProtection, ScrubDaemon, TorchBackend, ec_encode_volume, native_io,
    )
    from seaweedfs_tpu_torch.ec import backend as port_backend
    from seaweedfs_tpu_torch.ec import scrub as scrub_mod
    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.ec_volume import EcNotFoundError
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.ec.repair_journal import leaf_ranges
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.volume import NotFoundError

    if not native_io.enabled():
        raise AssertionError("phase 13 needs the native plane (SEAWEED_EC_NATIVE is 0)")
    shutil.rmtree(os.path.join(work, "peer"), ignore_errors=True)  # phase 11's copies
    root = os.path.join(work, "store")
    os.makedirs(root)
    rng = np.random.default_rng()
    rng.bit_generator.state = vol_rng_state  # phase 3's needles
    cpu_before = dict(port_backend.AUTO_CPU)
    launches = {"gf2_apply": 0, "gf2_apply_planes": 0}
    result: dict = {}
    store = Store([root], ec_backend="cuda")
    try:
        # -- write, read back, delete, remount ------------------------------
        v = store.allocate_volume(STORE_VID)
        want: dict[int, tuple[int, bytes, int]] = {}  # id -> (cookie, sha256, body length)
        to_bytes, built = Needle.to_bytes, [0.0]  # the write's record build, timed apart

        def timed_to_bytes(self, *a, **kw):
            t = time.perf_counter()
            try:
                return to_bytes(self, *a, **kw)
            finally:
                built[0] += time.perf_counter() - t

        Needle.to_bytes = timed_to_bytes
        t0 = time.perf_counter()
        try:
            for nid, cookie, body in needle_stream(rng):
                n = Needle(cookie=cookie, needle_id=nid, data=body)
                if v.size + n.disk_size(3) > VOLUME_BYTES:
                    break
                store.write_needle(STORE_VID, n)
                want[nid] = (cookie, hashlib.sha256(body).digest(), len(body))
            write_s = time.perf_counter() - t0
        finally:
            Needle.to_bytes = to_bytes
        written = v.size
        t0 = time.perf_counter()
        for nid, (cookie, digest, _) in want.items():
            if hashlib.sha256(store.read_needle(STORE_VID, nid, cookie).data).digest() != digest:
                raise AssertionError(f"13: needle {nid:x} read back differs")
        read_s = time.perf_counter() - t0
        ids = list(want)
        first = len(ids) // 3
        deleted = ids[first :: (len(ids) - first) // N_DELETED][:N_DELETED]
        if any(store.delete_needle(STORE_VID, nid) <= 0 for nid in deleted):
            raise AssertionError(f"13: deleting {deleted} failed")
        records = [(nid, want[nid][0], v.needle_map.get(nid).offset * 8, want[nid][2])
                   for nid in ids if nid not in deleted]
        store.unmount_volume(STORE_VID)
        t0 = time.perf_counter()
        v = store.mount_volume(STORE_VID)
        remount_s = time.perf_counter() - t0
        st = store.status()["volumes"]
        if len(st) != 1 or (st[0]["id"], st[0]["file_count"], st[0]["deleted_count"], st[0]["read_only"],
                            st[0]["size"]) != (STORE_VID, len(ids), N_DELETED, False, v.size) \
                or v.size <= written:
            raise AssertionError(f"13: status after the remount {st}")

        # -- seal, encode on the card ----------------------------------------
        v.set_read_only(True)
        base = v.dat_path[:-4]
        dat_size = os.path.getsize(base + ".dat")
        n_batches = len(list(batch_plan(dat_size, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)))
        rs_kernels.reset_launches()
        t0 = time.perf_counter()
        ec_encode_volume(base, ctx, backend=TorchBackend(ctx))
        enc_s = time.perf_counter() - t0
        if rs_kernels.LAUNCHES["gf2_apply"] != n_batches:
            raise AssertionError(f"13: encode launched {rs_kernels.LAUNCHES} for {n_batches} batches")
        launches["gf2_apply"] += n_batches
        prot = BitrotProtection.load(base + ".ecsum")
        for i in range(ctx.total):
            if prot.verify_shard_file(base + ctx.to_ext(i), i):
                raise AssertionError(f"13: shard {i} fails .ecsum")
        shard_digest = {i: sha256(base + ctx.to_ext(i)) for i in range(ctx.total)}

        # -- the EC volume, shard DEGRADED unmounted: degraded reads ---------
        store.unmount_volume(STORE_VID)
        ev = store.mount_ec_volume(STORE_VID)
        be = ev.backend
        if not (isinstance(be, TorchBackend) and be.device.type == DEVICE and be.impl == "cuda_planes"):
            raise AssertionError(f"13: the Store's EC volume runs on {be}")
        store.unmount_ec_shards(STORE_VID, [DEGRADED])
        degraded = degraded_records(records, dat_size)
        cache = ev.interval_cache
        rs_kernels.reset_launches()
        loads0, hits0 = cache.loads, cache.hits
        lat = []
        for nid, cookie, _, _ in degraded:
            t0 = time.perf_counter()
            got = store.read_needle(STORE_VID, nid, cookie).data
            lat.append(time.perf_counter() - t0)
            if hashlib.sha256(got).digest() != want[nid][1]:
                raise AssertionError(f"13: degraded read of needle {nid:x} differs")
        planes = rs_kernels.LAUNCHES["gf2_apply_planes"]
        if planes != cache.loads - loads0 or planes < 1 or rs_kernels.LAUNCHES["gf2_apply"]:
            raise AssertionError(f"13: reads launched {rs_kernels.LAUNCHES}, "
                                 f"{cache.loads - loads0} reconstructions")
        launches["gf2_apply_planes"] += planes
        for nid in deleted:
            try:
                store.read_needle(STORE_VID, nid)
                raise AssertionError(f"13: deleted needle {nid:x} was read")
            except (NotFoundError, EcNotFoundError):
                pass

        # -- ScrubDaemon: one rotten leaf repaired in place ------------------
        leaf = len(prot.shard_leaf_crcs[STORE_ROT_SHARD]) // 3
        flip(base + ctx.to_ext(STORE_ROT_SHARD), leaf * prot.leaf_size + 4321)
        legit = ev.legitimate_shards()
        if legit != [i for i in range(ctx.total) if i != DEGRADED]:  # served + quarantined
            raise AssertionError(f"13: legitimate shards {legit}")
        stages: dict = {}
        scrub_once = scrub_mod.scrub_ec_volume

        def staged(*a, **kw):
            return scrub_once(*a, stages=stages, **kw)

        daemon = ScrubDaemon(store, interval=3600.0, bytes_per_sec=SCRUB_BYTES_PER_S, repair=True)
        rs_kernels.reset_launches()
        scrub_mod.scrub_ec_volume = staged
        t0 = time.perf_counter()
        try:
            report = daemon.scrub_once()[STORE_VID]
        finally:
            scrub_mod.scrub_ec_volume = scrub_once
        scrub_s = time.perf_counter() - t0
        n_ranges = len(leaf_ranges([leaf], prot.leaf_size, prot.shard_sizes[STORE_ROT_SHARD]))
        if (report.leaf_repaired != {STORE_ROT_SHARD: [leaf]} or report.quarantined or report.rebuilt
                or report.refused or rs_kernels.LAUNCHES["gf2_apply"] != n_ranges
                or rs_kernels.LAUNCHES["gf2_apply_planes"]):
            raise AssertionError(f"13: scrub {report}, launches {rs_kernels.LAUNCHES}")
        if sha256(base + ctx.to_ext(STORE_ROT_SHARD)) != shard_digest[STORE_ROT_SHARD]:
            raise AssertionError("13: the repaired shard differs from its encode-time bytes")
        if daemon.breakers[STORE_VID].state != "closed" or ev.legitimate_shards() != legit:
            raise AssertionError("13: the daemon's breaker opened or the shard set changed")
        launches["gf2_apply"] += n_ranges
        if dict(port_backend.AUTO_CPU) != cpu_before:
            raise AssertionError(f"13: a CPU resolution {port_backend.AUTO_CPU}")
        shard_bytes = sum(prot.shard_sizes)
        result = {
            "needles": len(ids), "deleted": N_DELETED, "volume_bytes": written,
            "write_seconds": write_s, "write_mb_per_s": written / write_s / 1e6,
            "write_record_build_seconds": built[0],
            "read_back_seconds": read_s, "read_back_mb_per_s": written / read_s / 1e6,
            "remount_seconds": remount_s, "status": st[0],
            "encode_seconds": enc_s, "encode_gb_per_s": dat_size / enc_s / 1e9, "encode_batches": n_batches,
            "degraded_reads": len(degraded), "degraded_p50_ms": percentile_ms(lat, 50),
            "degraded_p99_ms": percentile_ms(lat, 99), "reconstructions": planes,
            "cache_hits": cache.hits - hits0,
            "scrub_pass_seconds": scrub_s, "scrub_gb_per_s": shard_bytes / scrub_s / 1e9,
            "leaf_ranges": n_ranges,
            "repair_ms_per_range": sum(sec for k, sec in stages.items() if "." not in k) / n_ranges * 1e3,
            "repair_stage_seconds": stages, "legitimate_shards": legit,
            "launches": launches,
        }
    finally:
        store.close()
    shutil.rmtree(root)
    return result, launches


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
        vol_rng_state = rng.bit_generator.state  # phase 13 writes the same needles
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
        for d in ("trace", "sched"):  # phases 9 and 10's inputs: the same .dat and .idx
            os.makedirs(os.path.join(work, d))
            for ext in (".dat", ".idx"):
                os.link(base + ext, os.path.join(work, d, "1" + ext))
        py_plane = python_plane_encode(work, base, ctx, digests, prot)
        print("encode, native plane against Python plane (SEAWEED_EC_NATIVE=0) on the same .dat: "
              "14 shards sha256-identical, block and leaf CRC lists equal: " + json.dumps({
                  "native": {"seconds": enc_s, "stage_seconds": enc_stages},
                  "python": py_plane,
              }))
        cpu_enc = cpu_encode(work, base, ctx, digests, prot, n_batches)
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
        t0 = time.perf_counter()
        peer_copies(work, base, ctx, digests)  # phase 11's inputs, every shard as encoded
        print(f"phase 11's inputs copied: {time.perf_counter() - t0:.3f} s")
        if reb_launches < 1:
            raise AssertionError("rebuild never launched the kernel")
        reb_stages = dict(backend.stage_seconds)
        cpu_reb = cpu_rebuild(work, base, ctx, digests)
        src_bytes = K * shard_size
        print(f"rebuild: shards {list(LOST)} from {src_bytes} source bytes in {reb_s:.3f} s = "
              f"{src_bytes / reb_s / 1e9:.3f} GB/s; {reb_launches} launches; sha256 identical; "
              f"stage seconds {json.dumps(dict(backend.stage_seconds))}; "
              f"native plane {json.dumps(reb_plane)}")

        # -- 6. degraded needle reads ----------------------------------------------
        shutil.copy(base + ctx.to_ext(ROTTEN), base + ctx.to_ext(ROTTEN) + ".orig")
        read, read_launches, deleted = read_phase(work, base, ctx, records, dat_size, rng)
        print(f"degraded reads (shard {DEGRADED} unmounted, all bit-exact): {json.dumps(read)}")
        os.replace(base + ctx.to_ext(ROTTEN) + ".orig", base + ctx.to_ext(ROTTEN))
        cpu_read = cpu_reads(work, base, ctx, records, dat_size)

        # -- 6b. scrub, leaf repair, crash windows, quarantine -------------------------
        scrub, scrub_launches = scrub_phase(work, base, ctx, records, dat_size, digests)
        print(f"scrub and leaf repair (every check exact): {json.dumps(scrub)}")

        # -- 7. ec.decode ---------------------------------------------------------------
        cpu_dec_base = same_inputs(base, os.path.join(work, "cpu-decode"),
                                   [i for i in range(ctx.total) if i != DEGRADED])
        decode, dec_launches = decode_phase(base, ctx, digests[DEGRADED], deleted)
        print(f"decode ({N_DELETED} deleted, shard {DEGRADED} regenerated; .dat, .idx and "
              f"shard identical): {json.dumps(decode)}")
        cpu_dec = cpu_decode(cpu_dec_base, base, ctx)

        # -- 8. the native CPU backend against the card, same host, same bytes ---------
        print("native CPU backend against the card on the same host and bytes (every output "
              "identical; no launch during a CpuBackend run; CPU stage tables are host wall "
              "time, the card's h2d/kernel/d2h CUDA events): " + json.dumps({
                  "host": host_info(),
                  "encode": versus(enc_s, enc_stages, cpu_enc),
                  "rebuild": versus(reb_s, reb_stages, cpu_reb),
                  "degraded_reads": {
                      **versus(read["cold_seconds"], {**read["read_stage_seconds"],
                                                      **read["backend_stage_seconds"]},
                               {"seconds": cpu_read["cold_seconds"],
                                "stage_seconds": {**cpu_read["read_stage_seconds"],
                                                  **cpu_read["backend_stage_seconds"]}}),
                      "reads": cpu_read["degraded_reads"],
                      "card_p50_ms": read["cold_p50_ms"], "card_p99_ms": read["cold_p99_ms"],
                      "cpu_p50_ms": cpu_read["cold_p50_ms"], "cpu_p99_ms": cpu_read["cold_p99_ms"],
                  },
                  "decode": versus(decode["seconds"], decode["stage_seconds"], cpu_dec),
              }))
        print(f"card: {card_line()}")

        # -- 7a, 7b. streaming EC and the MQ durable-parity partition -----------------
        t0 = time.perf_counter()
        stream, stream_launches = stream_phase(work, base + ".dat.orig", ctx)
        print("stream encode (14 shards sha256-identical to the batch encode, CRC lists equal, "
              f"launches == chunks + tail stripes): {json.dumps(stream)}")
        mq, mq_launches = mq_phase(work)
        print("MQ durable-parity partition (every record recovered byte-exact, no parity "
              "rewritten, recovery launches == stripes; each crash window recovered dense "
              f"past the child's last flush): {json.dumps(mq)}")
        print(f"phase 7 (7a and 7b): {time.perf_counter() - t0:.3f} s")

        # -- 9. the flight recorder, armed ---------------------------------------------
        t0 = time.perf_counter()
        traced, trace_launches = trace_phase(work, base, ctx, records, dat_size, digests, prot,
                                             n_batches, mq["solo_flush"])
        print("flight recorder armed (every output sha256-identical to its disarmed counterpart, "
              "one root per op, span invariants hold, device stages == launches, labeled as the "
              "JAX call sites label them, "
              f"overlap efficiency in [0, 1], registry renders, .heat read back): {json.dumps(traced)}")
        print(f"phase 9: {time.perf_counter() - t0:.3f} s")

        # -- 10. the device scheduler and the CPU failover -------------------------------
        t0 = time.perf_counter()
        _, sched_launches = sched_phase(work, base, ctx, records, dat_size, digests, n_batches, enc_s)
        print(f"phase 10: {time.perf_counter() - t0:.3f} s")

        # -- 11. peer-fetch rebuild over the shard net plane -------------------------------
        t0 = time.perf_counter()
        peer, peer_launches = peer_phase(work, ctx, digests, reb_batches)
        print("peer-fetch rebuild (11a native plane, 11b Python plane: shards 3 and 11 rebuilt "
              "and shard 4's two rotten leaves repaired from peers, sha256-identical, the rotten "
              "holder excluded, launches == rebuild batches + leaf ranges; 11c two peers stopped: "
              f"refused, local files unchanged): {json.dumps(peer)}")
        print(f"phase 11: {time.perf_counter() - t0:.3f} s")

        # -- 12. remote stream shards ---------------------------------------------------
        t0 = time.perf_counter()
        remote, remote_launches = remote_stream_phase(work, mq)
        print("remote stream shards (phase 7b's partition and traffic with a mounted root and a "
              "net-plane root: shards of every generation on both, remote copies sha256-identical "
              "at close, generation 0 pruned from both roots, every unpruned record recovered "
              "byte-exact, delete leaves both roots empty, launches == parity deltas, every pushed "
              f"byte on the native plane): {json.dumps(remote)}")
        print(f"phase 12: {time.perf_counter() - t0:.3f} s")

        # -- 13. the Store ------------------------------------------------------------
        t0 = time.perf_counter()
        stored, store_launches = store_phase(work, ctx, vol_rng_state)
        print("Store (phase 3's needles written through Store.write_needle, read back bit-exact, "
              "5 deleted, remounted, encoded on the card, every shard verified; degraded reads with "
              f"shard {DEGRADED} unmounted bit-exact through gf2_apply_planes; a ScrubDaemon pass "
              f"leaf-repaired shard {STORE_ROT_SHARD} through gf2_apply): {json.dumps(stored)}")
        print(f"phase 13: {time.perf_counter() - t0:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_row = rows["encode 10x1MiB m=4"]
    read_row = prows["degraded read 10x1MiB m=1"]
    kernels = []
    for name, replaces, by_phase, row, all_rows in (
        ("gf2_apply", "seaweedfs_tpu/ops/rs_pallas.py:55",
         {"4 encode": enc_launches, "5 rebuild": reb_launches, "6b scrub": scrub_launches,
          "7a stream": stream_launches, "7b partition": mq_launches,
          "9 flight recorder": trace_launches["gf2_apply"], "10 scheduler": sched_launches["gf2_apply"],
          "11 peer rebuild": peer_launches, "12 remote stream": remote_launches,
          "13 store": store_launches["gf2_apply"]},
         main_row, rows),
        ("gf2_apply_planes", "seaweedfs_tpu/ops/rs_pallas.py:257",
         {"6 reads": read_launches, "7 decode": dec_launches,
          "9 flight recorder": trace_launches["gf2_apply_planes"],
          "10 scheduler": sched_launches["gf2_apply_planes"],
          "13 store": store_launches["gf2_apply_planes"]},
         read_row, prows),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/csrc/gf2_apply.cu",
            "replaces": replaces,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": max(r["max_abs_err"] for r in all_rows.values()),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "cpu_ms": row["cpu_ms"],
            "shapes": {label: {k: r[k] for k in ("ms", "cpu_ms", "bound_ms", "plain_ms", "library_ms")}
                       for label, r in all_rows.items()},
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    # one card driven, whatever else the host shows
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
