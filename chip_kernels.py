#!/usr/bin/env python3
"""The kernel phases of chip_smoke.py alone, for iterating on the GF(2) kernels.

    python3 chip_kernels.py

Runs chip_smoke.py's phases 1, 2 and 2b on one card, in seconds: builds
csrc/, prints ptxas's registers and spills per kernel, holds both entry
points against their plain versions and the numpy oracle (tolerance 0)
at the main paths' shapes and the planes body's edge widths, and times
them, with the old streaming loop (`gf2_apply` at m = 1 on the same
coefficients) timed beside the planes body in the same run, and a
16-byte add timed the same way: the least any launch reads under the
method. The last line is the timed rows as JSON. Exits 2 without a
card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

import chip_smoke


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    chip_smoke.build()
    rng = np.random.default_rng(chip_smoke.SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows, prows = chip_smoke.kernel_phases(rng, flush)
    tiny = torch.zeros(16, dtype=torch.uint8, device="cuda")
    floor_ms = chip_smoke.median_ms(lambda: tiny.add_(1), 21, flush)
    print(chip_smoke.card_line())
    print(json.dumps({"gf2_apply": rows, "gf2_apply_planes": prows, "floor_ms": floor_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
