"""`python -m seaweedfs_tpu_torch.server volume`: a port volume server by name.

Port of seaweedfs_tpu/server/__main__.py, its `volume` mode only; argparse
refuses the other modes (master, filer, server, ...). The flags are the
JAX launcher's, less its TLS flags. A flag left unset is filled from
`volume.toml` (utils/config.py), then from the default; `-jwt.key` falls
back to `security.toml`'s `jwt.signing.key`. Where the two launchers
differ, on purpose:

- `-ec.backend` takes cuda, cpu or auto and defaults to cuda, where the
  JAX default is auto; tpu is refused.
- The port serves no TLS: a `security.toml` that sets `https.default.cert`
  stops the launcher with a message, where the JAX launcher would serve
  HTTPS. Serving plain HTTP where the operator asked for TLS is not an
  option.

`build(argv)` parses, builds and starts the servers and returns them;
`main(argv)` also waits for SIGINT or SIGTERM, stops them and returns 0.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ..utils.config import CONFIG_DIRS, load_config
from ..utils.glog import logger

log = logger("launcher")

EC_BACKENDS = ("cuda", "cpu", "auto")


def resolve(argv=None, config_dirs=CONFIG_DIRS) -> argparse.Namespace:
    """The parsed flags with the unset ones filled from `security.toml`
    and `volume.toml` (searched in `config_dirs`), then the defaults.
    SystemExit for a backend the port does not run and for a TLS
    config."""
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch.server")
    sub = p.add_subparsers(dest="mode", required=True)
    v = sub.add_parser("volume")
    v.add_argument("-ip", default="localhost")
    v.add_argument("-port", type=int, default=8080)
    v.add_argument("-dir", action="append", required=True)
    v.add_argument("-master", default="localhost:9333")
    v.add_argument("-max", type=int, default=None)
    v.add_argument("-ec.backend", dest="ec_backend", default=None,
                   help="cuda (the default), cpu or auto")
    v.add_argument("-index", default=None, choices=["memory", "sqlite"],
                   help="needle map kind (sqlite = durable, O(delta) restart)")
    v.add_argument("-dataCenter", default="")
    v.add_argument("-rack", default="")
    v.add_argument("-jwt.key", dest="jwt_key", default="")
    v.add_argument("-ec.trace", dest="ec_trace", action="store_true",
                   help="arm the EC flight recorder (per-stage spans, "
                   "/debug/traces ring, sw_ec_stage_seconds histograms)")
    v.add_argument("-ec.traceRing", dest="ec_trace_ring", type=int, default=0,
                   help="completed traces kept in the /debug/traces ring (0 = default 256)")
    v.add_argument("-ec.slowOpSeconds", dest="ec_slow_op_s", type=float, default=0.0,
                   help="log the full span tree of any EC op slower than this "
                   "(arms the flight recorder; 0 = off)")
    a = p.parse_args(argv)
    sec = load_config("security", config_dirs)
    if sec:
        if not a.jwt_key:
            a.jwt_key = sec.get_str("jwt.signing.key")
        if sec.get_str("https.default.cert"):
            raise SystemExit(
                f"{sec.path} sets https.default.cert, but the port serves no TLS: "
                "refusing to serve plain HTTP where TLS was asked for")
    vcfg = load_config("volume", config_dirs)
    if a.index is None:
        a.index = vcfg.get_str("volume.index", "memory") or "memory"
    if a.ec_backend is None:
        a.ec_backend = vcfg.get_str("volume.ec_backend", "cuda") or "cuda"
    if a.max is None:
        a.max = int(vcfg.get("volume.store.max_volumes", 8))
    if a.ec_backend == "tpu":
        p.error("-ec.backend tpu: the port runs its EC on cuda, cpu or auto")
    if a.ec_backend not in EC_BACKENDS:
        p.error(f"-ec.backend {a.ec_backend}: choose from {', '.join(EC_BACKENDS)}")
    return a


def build(argv=None, config_dirs=CONFIG_DIRS) -> list:
    """Build and start the servers the flags name (one volume server)."""
    from .volume_server import VolumeServer

    a = resolve(argv, config_dirs)
    vs = VolumeServer(
        directories=a.dir,
        master=a.master,
        ip=a.ip,
        port=a.port,
        max_volume_count=a.max,
        ec_backend=a.ec_backend,
        data_center=a.dataCenter,
        rack=a.rack,
        jwt_key=a.jwt_key,
        needle_map_kind=a.index,
        ec_trace=a.ec_trace,
        ec_trace_ring=a.ec_trace_ring,
        ec_slow_op_s=a.ec_slow_op_s,
    )
    vs.start()
    log.info("volume server on %s:%s (grpc %s, ec backend %s)", a.ip, a.port, vs.grpc_port,
             a.ec_backend)
    return [vs]


def main(argv=None) -> int:
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    servers = build(argv)
    while not stop.wait(1.0):
        pass
    for srv in servers:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
