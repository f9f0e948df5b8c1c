#!/usr/bin/env python3
"""The kernel phases of chip_smoke.py alone, for iterating on the GF(2) kernels.

    python3 chip_kernels.py

Runs chip_smoke.py's phases 1, 2 and 2b on one card, in seconds: builds
csrc/, prints ptxas's registers and spills per kernel, holds both entry
points against their plain versions and the numpy oracle (tolerance 0)
at the main paths' shapes, the tile-edge widths and on misaligned data,
and times them beside a device copy of the same bytes, with `gf2_apply`'s
table body timed beside the planes body on the same coefficients and a
16-byte add timed the same way: the least any launch reads under the
method. Then it times each of the three bodies (table, planes, masked
byte path) at m = 1, 2 and 4 at (10, 1 MiB) and (10, 16 MiB). The last
line is the timed rows as JSON. Exits 2 without a card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

import chip_smoke


def bodies(rng, flush) -> dict:
    """Each body at m = 1, 2, 4 and (10, 1 MiB), (10, 16 MiB): gf2_apply's
    table body, the planes body (pack_width 1) and the masked byte path
    (gf2_apply on data 1 byte off alignment), exact and timed."""
    out = {}
    for m in (1, 2, 4):
        coeffs = rng.integers(0, 256, (m, chip_smoke.K), dtype=np.uint8)
        for n, size in ((1 << 20, "1MiB"), (16 << 20, "16MiB")):
            for body, kind, misaligned in (("table", "gf2_apply", False),
                                           ("planes", "gf2_apply_planes", False),
                                           ("masked", "gf2_apply", True)):
                row = chip_smoke.check_kernel(kind, coeffs, n, rng, flush, misaligned=misaligned)
                label = f"{body} 10x{size} m={m}"
                out[label] = {k: row[k] for k in ("ms", "bound_ms", "copy_ms", "max_abs_err")}
                print(f"body {label}: " + json.dumps(out[label]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    chip_smoke.build()
    rng = np.random.default_rng(chip_smoke.SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows, prows = chip_smoke.kernel_phases(rng, flush)
    body_rows = bodies(rng, flush)
    tiny = torch.zeros(16, dtype=torch.uint8, device="cuda")
    floor_ms = chip_smoke.median_ms(lambda: tiny.add_(1), 21, flush)
    print(chip_smoke.card_line())
    print(json.dumps({"gf2_apply": rows, "gf2_apply_planes": prows, "bodies": body_rows,
                      "floor_ms": floor_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
