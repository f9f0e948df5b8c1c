"""`python -m seaweedfs_tpu_torch.worker -master host:9333[,h2:p2,...]
-backend cuda|cpu|auto -maxConcurrent N -capabilities k1,k2`: register
with the master group's fleet control plane and execute maintenance
tasks (reference `weed worker`) until SIGTERM or SIGINT.

Port of seaweedfs_tpu/worker/__main__.py. `-backend` defaults to cuda
(the JAX default is auto) and refuses tpu: one error line and exit code
2, before any connect.
"""

from __future__ import annotations

import argparse
import signal
import sys

from .worker import Worker


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch.worker")
    p.add_argument("-master", default="localhost:9333")
    p.add_argument("-backend", default="cuda", help="EC backend: cpu|cuda|auto")
    p.add_argument("-maxConcurrent", type=int, default=2)
    p.add_argument("-capabilities", default="ec_encode,vacuum")
    a = p.parse_args(argv)
    try:
        w = Worker(
            master=a.master,
            capabilities=tuple(a.capabilities.split(",")),
            backend=a.backend,
            max_concurrent=a.maxConcurrent,
        )
    except ValueError as e:
        p.error(str(e))
    signal.signal(signal.SIGTERM, lambda *x: w.stop())
    signal.signal(signal.SIGINT, lambda *x: w.stop())
    print(f"worker {w.worker_id} -> {a.master} (backend={a.backend})", flush=True)
    w.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
