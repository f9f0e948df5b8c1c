#!/usr/bin/env python3
"""Phase 4's encode and phase 6's cold degraded reads of chip_smoke.py
under two trees of this repo, in alternating processes on one card.

    python3 chip_sched_ab.py TREE_A TREE_B [--pairs 4] [--reads 60]

Each TREE is the root of a checkout (for example `git archive` of a
commit unpacked into a directory), holding its own `seaweedfs_tpu_torch`.
The script writes chip_smoke.py's seeded 1 GiB volume once, in a fresh
directory under this tree's seaweedfs_tpu_torch/build/, builds each
tree's libraries, then runs one child process per turn in the order
A B B A, repeated `--pairs` / 2 times (an odd count ends on A B), so
that neither tree always goes first. A child runs from its tree's root
and imports only that tree's package; it launches the kernel once to
warm the card, encodes the volume (hard links to its .dat and .idx)
through `ec_encode_volume` with a `TorchBackend` as phase 4 does, then
reads `--reads` needles that lie on shard 3 cold, through a fresh
`EcVolume` with shard 3 unmounted and `impl="cuda_planes"` as phase 6
does, each checked against the .dat. It fails on a launch count other
than the batch count, or on a needle that differs.

Prints the card's name and power limit, one JSON line per turn (the
tree, the encode wall and stage seconds, the read p50 and p99), and as
the last line one JSON object with each tree's lists of those numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

CHILD = r"""
import json, os, sys, time
import numpy as np
from seaweedfs_tpu_torch.ec import ECContext, EcVolume, TorchBackend, ec_encode_volume
from seaweedfs_tpu_torch.ops import rs_kernels

src, work, reads_path, n_batches = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
ctx = ECContext(10, 4)
TorchBackend(ctx).encode(np.zeros((10, 1 << 16), dtype=np.uint8))  # warm the card
os.makedirs(work)
base = os.path.join(work, "1")
for ext in (".dat", ".idx"):
    os.link(os.path.join(src, "1" + ext), base + ext)
be = TorchBackend(ctx)
rs_kernels.reset_launches()
t0 = time.perf_counter()
ec_encode_volume(base, ctx, backend=be)
enc_s = time.perf_counter() - t0
if rs_kernels.LAUNCHES["gf2_apply"] != n_batches:
    raise AssertionError(f"encode launched {rs_kernels.LAUNCHES} for {n_batches} batches")
stages = dict(be.stage_seconds)
with open(reads_path) as f:
    reads = json.load(f)
fd = os.open(base + ".dat", os.O_RDONLY)
ev = EcVolume(work, 1, backend=TorchBackend(ctx, impl="cuda_planes"))
lat = []
try:
    ev.unmount_shards([3])
    for nid, cookie, off, size in reads:
        t0 = time.perf_counter()
        got = ev.read_needle(nid, cookie=cookie).data
        lat.append(time.perf_counter() - t0)
        if got != os.pread(fd, size, off + 20):
            raise AssertionError(f"degraded read of needle {nid:x} differs")
finally:
    ev.close()
    os.close(fd)
ms = np.asarray(lat) * 1e3
print(json.dumps({"encode_s": enc_s, "stage_seconds": stages,
                  "read_p50_ms": float(np.percentile(ms, 50)),
                  "read_p99_ms": float(np.percentile(ms, 99)), "reads": len(lat)}))
"""


def order(pairs: int) -> list[int]:
    """0 1 1 0 0 1 1 0 ...: `pairs` turns of each tree."""
    return [(0, 1, 1, 0)[i % 4] for i in range(2 * pairs)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs=2)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--reads", type=int, default=60)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_sched_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.ops import _build

    trees = [os.path.abspath(t) for t in args.trees]
    print(chip_smoke.card_line())
    builds = [subprocess.Popen([sys.executable, "-c",
                                "from seaweedfs_tpu_torch.ops import _build; _build.build_all()"],
                               cwd=t) for t in trees]
    if any(p.wait() for p in builds):
        raise AssertionError("a tree's libraries did not build")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ab-", dir=str(_build.BUILD_DIR))
    try:
        src = os.path.join(work, "vol")
        os.makedirs(src)
        records = chip_smoke.write_volume(os.path.join(src, "1"),
                                          np.random.default_rng(chip_smoke.SEED))
        dat_size = os.path.getsize(os.path.join(src, "1.dat"))
        n_batches = len(list(batch_plan(dat_size, chip_smoke.K, DEFAULT_BATCH,
                                        LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)))
        reads = [list(r) for r in chip_smoke.degraded_records(records, dat_size)[:args.reads]]
        reads_path = os.path.join(work, "reads.json")
        with open(reads_path, "w") as f:
            json.dump(reads, f)
        summary = {t: {"encode_s": [], "pin_s": [], "disk_read_s": [], "read_p50_ms": [],
                       "read_p99_ms": []} for t in trees}
        for turn, which in enumerate(order(args.pairs)):
            tree = trees[which]
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, src, os.path.join(work, f"turn{turn}"), reads_path,
                 str(n_batches)],
                cwd=tree, capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                raise AssertionError(f"turn {turn} in {tree} failed:\n{proc.stdout}\n{proc.stderr}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            shutil.rmtree(os.path.join(work, f"turn{turn}"))
            s = summary[tree]
            s["encode_s"].append(got["encode_s"])
            s["pin_s"].append(got["stage_seconds"].get("pin", 0.0))
            s["disk_read_s"].append(got["stage_seconds"].get("disk_read", 0.0))
            s["read_p50_ms"].append(got["read_p50_ms"])
            s["read_p99_ms"].append(got["read_p99_ms"])
            print(json.dumps({"turn": turn, "tree": tree, "process_s": time.perf_counter() - t0,
                              **got}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(chip_smoke.card_line())
    print(json.dumps({"volume_bytes": dat_size, "batches": n_batches, "reads": len(reads),
                      "order": [trees[w] for w in order(args.pairs)], "trees": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
