"""`python -m seaweedfs_tpu_torch.server master|volume|filer|server|mq.broker|mq.agent|telemetry|scaffold`:
port servers by name.

Port of seaweedfs_tpu/server/__main__.py, its `master`, `volume`, `filer`
and `server` modes (`server`: a master and a volume server in one
process, reference `weed server`, with a filer too under `-filer`, its
metadata in `<dir>/filerdb`, and the S3 gateway over that filer under
`-s3`, which implies `-filer`: `-s3Port`, identities from `-s3Config` or
`s3.toml`'s `s3.config`, an admin key pair from `-s3AccessKey` and
`-s3SecretKey`), `mq.broker` (mq/broker.py: segments in `-filer`,
durable-parity streams in `-parityDir`, a group under `-peers`, the Kafka
wire protocol on `-kafkaPort` (mq/kafka/), `/status`, `/metrics` and
`/debug/kernels` on `-statusPort`), `mq.agent` (mq/agent.py,
in front of `-broker`), `telemetry` (the phone-home collector,
utils/telemetry_server.py) and `scaffold` (a config template,
utils/scaffold.py, printed or written to `-output`/<name>.toml). The flags
are the JAX launcher's. A flag left unset is filled from `volume.toml`,
`master.toml`, `filer.toml` (`sqlite.dbFile`: the filer's directory) or
`notification.toml` (`notification.webhook.endpoint`,
`notification.mq.broker`) (utils/config.py),
then from the default; `-jwt.key` falls back to `security.toml`'s
`jwt.signing.key`, and `-tls.cert`, `-tls.key` and `-tls.ca` each fall
back to its `https.default.*` key, field by field. A certificate turns
the node's HTTP listeners into TLS listeners with hot reload
(utils/tls.py), `-tls.ca` requires client certificates, and every
internal hop of the process speaks https (`utils/urls.py`
`enable_https`); gRPC stays plaintext, as in the JAX package. A filer
(`-store sqlite|sstable|memory`, its gRPC on `-grpcPort` or port+10000,
`-peers` for the lock ring and the MetaAggregator, `-notify.webhook` for
a webhook sink, `-notify.mq` for a broker's `default/filer-events`) serves
server/filer_server.py. Where the two launchers
differ, on purpose:

- `-ec.backend` takes cuda, cpu or auto and defaults to cuda, where the
  JAX default is auto; tpu is refused.
- Under `-tls.ca` the process presents its own certificate on its https
  hops, since its servers require one; the JAX launcher points `requests`
  at the CA alone.
- What needs a module the port does not have yet stops it with a
  message, where the JAX launcher would start it: `server`'s `-webdav`,
  `-sftp` and `-admin`, and `mq.broker`'s `-pgPort` (ROADMAP item 19).

The master's maintenance scanners (`-ec.autoFullness`, or
`master.maintenance.ec_auto_fullness`; `-ec.scrubInterval`;
`-ec.rebalanceInterval`) submit tasks for the worker fleet (`python -m
seaweedfs_tpu_torch.worker`).

`build(argv)` parses, builds and starts the servers and returns them;
`main(argv)` also waits for SIGINT or SIGTERM, stops them and returns 0.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from ..utils.config import CONFIG_DIRS, load_config
from ..utils.glog import logger

log = logger("launcher")

EC_BACKENDS = ("cuda", "cpu", "auto")


def _add_tls_flags(sp) -> None:
    """Reference security.toml https.* keys as flags: a cert/key pair
    turns the node's HTTP listener(s) into TLS listeners with hot
    cert-reload (utils/tls.py)."""
    sp.add_argument("-tls.cert", dest="tls_cert", default="")
    sp.add_argument("-tls.key", dest="tls_key", default="")
    sp.add_argument("-tls.ca", dest="tls_ca", default="",
                    help="when set, require and verify client certificates (mTLS)")


def _tls_from(a):
    if not getattr(a, "tls_cert", ""):
        return None
    from ..utils.tls import TlsConfig

    return TlsConfig(cert_file=a.tls_cert, key_file=a.tls_key, ca_file=a.tls_ca or None,
                     client_auth=bool(a.tls_ca))


def _add_ec_trace_flags(sp) -> None:
    sp.add_argument("-ec.trace", dest="ec_trace", action="store_true",
                    help="arm the EC flight recorder (per-stage spans, "
                    "/debug/traces ring, sw_ec_stage_seconds histograms)")
    sp.add_argument("-ec.traceRing", dest="ec_trace_ring", type=int, default=0,
                    help="completed traces kept in the /debug/traces ring (0 = default 256)")
    sp.add_argument("-ec.slowOpSeconds", dest="ec_slow_op_s", type=float, default=0.0,
                    help="log the full span tree of any EC op slower than this "
                    "(arms the flight recorder; 0 = off)")


def _add_scanner_flags(sp, rebalance: bool) -> None:
    sp.add_argument("-ec.autoFullness", dest="ec_auto", type=float, default=None,
                    help="auto-submit ec_encode for volumes at this fraction of the size limit "
                    "(0=off)")
    if rebalance:
        sp.add_argument("-ec.scrubInterval", dest="ec_scrub_interval", type=float, default=0.0,
                        help="fleet scrub period in seconds: every EC volume verified "
                        "once per period via ec_scrub worker tasks (0=off)")
        sp.add_argument("-ec.rebalanceInterval", dest="ec_rebalance_interval", type=float,
                        default=0.0,
                        help="data-gravity period in seconds: rank hot EC volumes vs "
                        "holder chip-deficit and dispatch bounded ec_migrate worker "
                        "tasks toward chip-rich low-load nodes (0=off; "
                        "SEAWEED_EC_REBALANCE_* knobs bound each sweep)")
    else:
        sp.add_argument("-ec.scrubInterval", dest="ec_scrub_interval", type=float, default=0.0,
                        help="fleet scrub period in seconds (0=off)")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch.server")
    sub = p.add_subparsers(dest="mode", required=True)

    m = sub.add_parser("master")
    m.add_argument("-ip", default="localhost")
    m.add_argument("-port", type=int, default=9333)
    m.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    m.add_argument("-jwt.key", dest="jwt_key", default="")
    _add_scanner_flags(m, rebalance=True)
    m.add_argument("-peers", default="",
                   help="comma-separated HA master group incl. this node (host:port,...)")
    m.add_argument("-mdir", default="",
                   help="meta dir for the durable raft log (required for HA restarts)")
    m.add_argument("-telemetry.url", dest="telemetry_url", default="",
                   help="opt-in phone-home endpoint (leader posts count aggregates)")
    _add_tls_flags(m)

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
    _add_ec_trace_flags(v)
    _add_tls_flags(v)

    f = sub.add_parser("filer")
    f.add_argument("-ip", default="localhost")
    f.add_argument("-port", type=int, default=8888)
    f.add_argument("-master", default="localhost:9333")
    f.add_argument("-dir", default=None)
    f.add_argument("-collection", default="")
    f.add_argument("-replication", default="")
    f.add_argument("-jwt.key", dest="jwt_key", default="")
    f.add_argument("-notify.webhook", dest="notify_webhook", default="")
    f.add_argument("-notify.mq", dest="notify_mq", default="")
    f.add_argument("-store", default="sqlite", choices=["sqlite", "sstable", "memory"],
                   help="metadata backend (sstable = embedded WAL+SSTable engine)")
    f.add_argument("-grpcPort", type=int, default=0, help="gRPC metadata API port (0 = port+10000)")
    f.add_argument("-peers", default="", help="comma-separated peer filer gRPC addrs for multi-filer")
    _add_tls_flags(f)

    s = sub.add_parser("server")
    s.add_argument("-ip", default="localhost")
    s.add_argument("-masterPort", type=int, default=9333)
    s.add_argument("-port", type=int, default=8080)
    s.add_argument("-filerPort", type=int, default=8888)
    s.add_argument("-filer", action="store_true", help="also run a filer")
    s.add_argument("-s3", action="store_true", help="also run the S3 gateway")
    s.add_argument("-s3Port", type=int, default=8333)
    s.add_argument("-s3AccessKey", default="")
    s.add_argument(
        "-s3Config",
        default="",
        help="identities/roles JSON (reference -s3.config identities.json)",
    )
    s.add_argument("-s3SecretKey", default="")
    s.add_argument("-dir", action="append", required=True)
    s.add_argument("-max", type=int, default=None)
    s.add_argument("-ec.backend", dest="ec_backend", default=None,
                   help="cuda (the default), cpu or auto")
    s.add_argument("-jwt.key", dest="jwt_key", default="")
    s.add_argument("-notify.webhook", dest="notify_webhook", default="")
    s.add_argument("-notify.mq", dest="notify_mq", default="")
    _add_scanner_flags(s, rebalance=False)
    _add_ec_trace_flags(s)
    # the JAX launcher's gateways, refused until their modules are ported
    for flag in ("-webdav", "-sftp", "-admin"):
        s.add_argument(flag, action="store_true", help="not served by the port yet")
    _add_tls_flags(s)

    b = sub.add_parser("mq.broker")
    b.add_argument("-ip", default="localhost")
    b.add_argument("-port", type=int, default=17777)
    b.add_argument("-filer", default="", help="filer host:port for durable segments")
    b.add_argument("-segmentRecords", type=int, default=4096)
    b.add_argument("-kafkaPort", type=int, default=-1,
                   help="also speak the Kafka wire protocol on this port (-1 = off)")
    b.add_argument("-pgPort", type=int, default=-1,
                   help="serve PostgreSQL clients a SQL view over topics (-1 = off; not "
                   "served by the port yet)")
    b.add_argument("-pgUser", default="", help="user:password for PG auth (empty = trust)")
    b.add_argument("-peers", default="",
                   help="comma-separated broker group (grpc host:port,...) for "
                   "partition balancing + follower replication")
    b.add_argument("-statusPort", type=int, default=-1,
                   help="HTTP operator plane: /status JSON (parity lag, broker loads), "
                   "/metrics prometheus text and /debug/kernels (-1 = off)")
    b.add_argument("-parityDir", default="",
                   help="local dir for streaming-EC durable-parity log streams: "
                   "topics get parity trailing the append head by a bounded lag "
                   "(SEAWEED_EC_STREAM_* knobs) instead of waiting for segment "
                   "seal, and the unsealed tail is crash-recoverable")
    # the broker dials the filer: it needs the https switch from
    # security.toml even though it has no HTTP listener of its own
    _add_tls_flags(b)

    ag = sub.add_parser("mq.agent", help="MQ agent: session facade for thin publish/subscribe "
                        "clients (reference weed mq.agent)")
    ag.add_argument("-ip", default="localhost")
    ag.add_argument("-port", type=int, default=16777)
    ag.add_argument("-broker", default="localhost:17777")

    ts = sub.add_parser("telemetry", help="telemetry collector server (reference telemetry/server)")
    ts.add_argument("-ip", default="localhost")
    ts.add_argument("-port", type=int, default=9999)
    ts.add_argument("-file", default="", help="JSONL persistence path")

    sc = sub.add_parser("scaffold", help="emit a commented config template (weed scaffold)")
    sc.add_argument("-config", dest="config", default="security")
    sc.add_argument("-output", default="",
                    help="directory to write <name>.toml into (default: stdout)")
    return p


def resolve(argv=None, config_dirs=CONFIG_DIRS) -> argparse.Namespace:
    """The parsed flags with the unset ones filled from `security.toml`,
    `volume.toml`, `master.toml`, `filer.toml`, `notification.toml` and
    `s3.toml` (searched in `config_dirs`), then the
    defaults. SystemExit for a backend the port does not run and what
    needs a module the port does not have yet (the broker's `-pgPort`
    among them)."""
    p = _parser()
    a = p.parse_args(argv)
    if a.mode == "scaffold":
        return a
    sec = load_config("security", config_dirs)
    if sec:
        if hasattr(a, "jwt_key") and not a.jwt_key:
            a.jwt_key = sec.get_str("jwt.signing.key")
        # per-field merge: an explicit -tls.ca survives a security.toml
        # that sets only cert and key (flags win field by field)
        for attr, key in (("tls_cert", "https.default.cert"), ("tls_key", "https.default.key"),
                          ("tls_ca", "https.default.ca")):
            if hasattr(a, attr) and not getattr(a, attr):
                setattr(a, attr, sec.get_str(key))
    if a.mode in ("volume", "server"):
        vcfg = load_config("volume", config_dirs)
        if getattr(a, "index", None) is None:
            a.index = vcfg.get_str("volume.index", "memory") or "memory"
        if a.ec_backend is None:
            a.ec_backend = vcfg.get_str("volume.ec_backend", "cuda") or "cuda"
        if a.max is None:
            a.max = int(vcfg.get("volume.store.max_volumes", 8))
        if a.ec_backend == "tpu":
            p.error("-ec.backend tpu: the port runs its EC on cuda, cpu or auto")
        if a.ec_backend not in EC_BACKENDS:
            p.error(f"-ec.backend {a.ec_backend}: choose from {', '.join(EC_BACKENDS)}")
    if a.mode in ("master", "server"):
        mcfg = load_config("master", config_dirs)
        if a.ec_auto is None:
            a.ec_auto = float(mcfg.get("master.maintenance.ec_auto_fullness", 0.0))
        a.garbage_threshold = float(mcfg.get("master.vacuum.garbage_threshold", 0.3))
        a.vacuum_interval = float(mcfg.get("master.vacuum.interval_seconds", 60))
    if a.mode in ("filer", "server"):
        fcfg = load_config("filer", config_dirs)
        if a.mode == "filer" and a.dir is None:
            db = fcfg.get_str("sqlite.dbFile") if fcfg.get("sqlite.enabled") else ""
            a.dir = (os.path.dirname(db) or ".") if db else "./filerdb"
        ncfg = load_config("notification", config_dirs)
        if ncfg:
            if not a.notify_webhook and ncfg.get("notification.webhook.enabled"):
                a.notify_webhook = ncfg.get_str("notification.webhook.endpoint")
            if not a.notify_mq and ncfg.get("notification.mq.enabled"):
                a.notify_mq = ncfg.get_str("notification.mq.broker")
    if a.mode == "mq.broker":
        from ..mq.broker import refuse_later_ports

        try:
            refuse_later_ports(a.pgPort)
        except ValueError as e:
            p.error(str(e))
    if a.mode == "server":
        for flag in ("webdav", "sftp", "admin"):
            if getattr(a, flag):
                p.error(f"-{flag}: the port has no {flag} module yet")
        if a.s3 and not a.s3Config:
            scfg = load_config("s3", config_dirs)
            if scfg:
                a.s3Config = scfg.get_str("s3.config")
    return a


def scaffold(a: argparse.Namespace) -> int:
    """`scaffold`: the template on stdout, or written to
    `-output`/<name>.toml (its path printed)."""
    from ..utils.scaffold import scaffold as template

    text = template(a.config)
    if a.output:
        path = os.path.join(a.output, f"{a.config}.toml")
        with open(path, "w") as fh:
            fh.write(text)
        print(path)
    else:
        print(text, end="")
    return 0


def build(argv=None, config_dirs=CONFIG_DIRS) -> list:
    """Build and start the servers the flags name: a master, a volume
    server, a filer, both of the first (`server`, with a filer under
    `-filer` and the S3 gateway over it under `-s3`), an MQ broker, an
    MQ agent, or the telemetry collector."""
    return start(resolve(argv, config_dirs))


def start(a: argparse.Namespace) -> list:
    """Start the servers of resolved flags `a`; returns them."""
    tls = _tls_from(a)
    if tls is not None:
        # internal hops (client to volume, replication, the shell's reads)
        # speak https too, trusting the cluster CA (or the certificate
        # itself for a single self-signed one); under mTLS they present
        # this node's certificate
        from ..utils.urls import enable_https

        mtls = tls.client_auth
        enable_https(tls.ca_file or tls.cert_file, cert_file=tls.cert_file if mtls else "",
                     key_file=tls.key_file if mtls else "")
    servers = []
    if a.mode == "telemetry":
        from ..utils.telemetry_server import TelemetryServer

        tsrv = TelemetryServer(ip=a.ip, port=a.port, persist_path=a.file or None)
        tsrv.start()
        log.info("telemetry collector on %s:%s", a.ip, tsrv.port)
        return [tsrv]
    if a.mode == "mq.agent":
        from ..mq.agent import MqAgentServer

        agent = MqAgentServer(a.broker, ip=a.ip, port=a.port)
        agent.start()
        log.info("mq agent on %s:%s -> broker %s", a.ip, agent.port, a.broker)
        return [agent]
    if a.mode == "mq.broker":
        from ..mq.broker import MqBrokerServer

        # -pgPort (and so -pgUser) was refused in resolve
        bs = MqBrokerServer(
            ip=a.ip, grpc_port=a.port, filer=a.filer, segment_records=a.segmentRecords,
            kafka_port=a.kafkaPort,
            peers=[p.strip() for p in a.peers.split(",") if p.strip()],
            parity_dir=a.parityDir, status_port=a.statusPort)
        bs.start()
        log.info("mq broker on %s:%s (filer=%s%s%s)", a.ip, a.port, a.filer or "memory-only",
                 f", kafka on :{bs.kafka.port}" if bs.kafka else "",
                 f", status on :{bs.status_port}" if bs._status_httpd is not None else "")
        return [bs]
    if a.mode in ("master", "server"):
        from .master import MasterServer

        port = a.port if a.mode == "master" else a.masterPort
        limit = a.volumeSizeLimitMB * 1024 * 1024 if a.mode == "master" else 30 * 1024**3
        ms = MasterServer(
            ip=a.ip, port=port, volume_size_limit=limit, jwt_key=a.jwt_key,
            peers=getattr(a, "peers", "") or None, meta_dir=getattr(a, "mdir", "") or None,
            telemetry_url=getattr(a, "telemetry_url", ""), tls=tls,
            garbage_threshold=a.garbage_threshold,
            vacuum_interval=a.vacuum_interval, ec_auto_fullness=a.ec_auto,
            ec_scrub_interval=a.ec_scrub_interval,
            ec_rebalance_interval=getattr(a, "ec_rebalance_interval", 0.0))
        ms.start()
        servers.append(ms)
        log.info("master listening on %s:%s (grpc %s)", a.ip, port, ms.grpc_port)
    if a.mode in ("volume", "server"):
        from .volume_server import VolumeServer

        vs = VolumeServer(
            directories=a.dir,
            master=a.master if a.mode == "volume" else f"{a.ip}:{a.masterPort}",
            ip=a.ip,
            port=a.port,
            max_volume_count=a.max,
            ec_backend=a.ec_backend,
            data_center=getattr(a, "dataCenter", ""),
            rack=getattr(a, "rack", ""),
            jwt_key=a.jwt_key,
            needle_map_kind=a.index,
            ec_trace=a.ec_trace,
            ec_trace_ring=a.ec_trace_ring,
            ec_slow_op_s=a.ec_slow_op_s,
            tls=tls,
        )
        vs.start()
        servers.append(vs)
        log.info("volume server on %s:%s (grpc %s, ec backend %s)", a.ip, a.port, vs.grpc_port,
                 a.ec_backend)
    if a.mode == "filer" or (a.mode == "server" and (a.filer or a.s3)):
        fs = start_filer(a, tls)
        servers.append(fs)
        if a.mode == "server" and a.s3:
            servers.append(start_s3(a, fs.filer, tls))
    return servers


def start_filer(a: argparse.Namespace, tls):
    """The filer of `filer` mode or of `server -filer`: its store in
    `-dir` (`<dir>/filerdb` under `server`), its meta log beside it."""
    from ..filer.filer import Filer
    from ..filer.meta_log import MetaLog
    from .filer_server import FilerServer

    if a.mode == "filer":
        master, fport, dbdir = a.master, a.port, a.dir
        store_kind, fgrpc = a.store, a.grpcPort or a.port + 10000
        peers = [p.strip() for p in a.peers.split(",") if p.strip()]
    else:
        master, fport = f"{a.ip}:{a.masterPort}", a.filerPort
        dbdir = os.path.join(a.dir[0], "filerdb")
        store_kind, fgrpc, peers = "sqlite", fport + 10000, []
    if store_kind == "sstable":
        from ..filer.sstable_store import SSTableStore

        store = SSTableStore(os.path.join(dbdir, "filer.sst"))
    elif store_kind == "memory":
        from ..filer.filer_store import MemoryStore

        store = MemoryStore()
    else:
        from ..filer.filer_store import SqliteStore

        store = SqliteStore(os.path.join(dbdir, "filer.db"))
    filer = Filer(store, master=master, collection=getattr(a, "collection", ""),
                  replication=getattr(a, "replication", ""), jwt_key=a.jwt_key)
    if a.notify_webhook:
        from ..filer.notification import WebhookNotifier

        filer.subscribe(WebhookNotifier(a.notify_webhook))
        log.info("filer events -> webhook %s", a.notify_webhook)
    if a.notify_mq:
        from ..filer.notification import MqNotifier

        filer.subscribe(MqNotifier(a.notify_mq))
        log.info("filer events -> mq %s", a.notify_mq)
    fs = FilerServer(filer, ip=a.ip, port=fport, meta_log=MetaLog(os.path.join(dbdir, "metalog")),
                     grpc_port=fgrpc, peers=peers, tls=tls)
    fs.start()
    log.info("filer on %s:%s (grpc %s%s)", a.ip, fport, fs.grpc_port,
             f", peers={peers}" if peers else "")
    return fs


def start_s3(a: argparse.Namespace, filer, tls):
    """The S3 gateway of `server -s3` over the process's filer."""
    from ..s3 import Identity, IdentityStore, S3Server

    sts = oidc = ldap = None
    if a.s3Config:
        from ..s3.config import load_s3_config

        idents, sts, oidc, ldap = load_s3_config(a.s3Config)
    else:
        idents = IdentityStore()
    if a.s3AccessKey:
        idents.add(Identity("admin", a.s3AccessKey, a.s3SecretKey))
    s3srv = S3Server(
        filer, ip=a.ip, port=a.s3Port, identities=idents, sts=sts, tls=tls,
        oidc=oidc, ldap=ldap,
    )
    s3srv.start()
    log.info("s3 gateway on %s:%s", a.ip, a.s3Port)
    return s3srv


def main(argv=None) -> int:
    a = resolve(argv)
    if a.mode == "scaffold":
        return scaffold(a)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    servers = start(a)
    while not stop.wait(1.0):
        pass
    # the volume server first: it leaves the master it heartbeats to
    for srv in reversed(servers):
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
