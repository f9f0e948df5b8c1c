"""Watchdogged accelerator probing.

Port of seaweedfs_tpu/utils/devices.py. A wedged driver or a card that
hangs at initialisation can block the first CUDA call of a process for
good. Every "is there a card?" decision that the port takes without the
caller naming a device (`get_backend("auto", ...)`) therefore goes
through this subprocess probe, which bounds the damage to a timeout and
caches the verdict for the life of the process. The probe never
initialises the device in the calling process.

``SEAWEED_DEVICE_PROBE_TIMEOUT`` bounds the probe (seconds, default 30).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading

_lock = threading.Lock()
_cached: int | None = None


def probe_accelerators(timeout: float | None = None, refresh: bool = False) -> int:
    """Number of CUDA devices reachable right now (0 on a hang or an
    error). Cached after the first call."""
    global _cached
    with _lock:
        if _cached is not None and not refresh:
            return _cached
        if timeout is None:
            try:
                timeout = float(os.environ.get("SEAWEED_DEVICE_PROBE_TIMEOUT", "30"))
            except ValueError:
                timeout = 30.0
        code = "import torch;print(torch.cuda.device_count())"
        count = 0
        try:
            out = subprocess.run(
                [sys.executable, "-c", code],
                capture_output=True,
                text=True,
                timeout=timeout,
            )
            for line in reversed(out.stdout.splitlines()):
                try:
                    count = int(line.strip())
                    break
                except ValueError:
                    continue
        except (subprocess.TimeoutExpired, OSError):
            count = 0
        _cached = count
        return count


def accelerator_available(timeout: float | None = None) -> bool:
    return probe_accelerators(timeout) > 0
