"""PyTorch port: the launcher (`python -m seaweedfs_tpu_torch.server
master|volume|server`, server/__main__.py) and its trimmed config loader
(utils/config.py), on the CPU:

- a launched port server on the JAX master heartbeats, serves POST and
  GET, and exits with 0 on SIGTERM, leaving the master;
- a launched port master elects itself, writes its raft log to `-mdir`,
  answers Assign (growing a volume on a port server) and exits with 0 on
  SIGTERM; `server` mode runs a master and a volume server in one process
  that assign, take a POST, look it up and serve it;
- `-ec.backend tpu` stops the launcher with a message and a nonzero
  exit; so do the modes the port does not have (mq.broker), the flags of
  `server` whose modules are not ported (`-webdav`, `-sftp`, `-admin`),
  and `-notify.mq`
  of `filer` and `server` (ROADMAP item 14a), from the flag or from
  `notification.toml`;
- `filer` and `server -filer` children serve a file over HTTP and
  LookupDirectoryEntry over gRPC, post their events to a
  `-notify.webhook` sink and exit 0 on SIGTERM; `filer.toml`'s
  `sqlite.dbFile` and `notification.toml` fill the flags left unset;
- `server -filer -s3` and `server -s3` children (identities from
  `-s3Config` or from `s3.toml`) answer signed S3 PUTs and GETs, refuse an
  unsigned one, and exit 0 on SIGTERM; `s3.toml` fills `-s3Config` only
  where the flag is unset;
- a `security.toml` asking for TLS, and the `-tls.*` flags of master,
  volume, server and filer, serve HTTPS (mutual TLS under `-tls.ca`), the file
  merged field by field under the flags;
- the `telemetry` mode runs the collector by name, and `scaffold` prints
  a template;
- the maintenance scanners' flags (`-ec.autoFullness`,
  `-ec.scrubInterval`, `-ec.rebalanceInterval`) reach the master's live
  maintenance config;
- `volume.toml` and `master.toml` fill the flags left unset, explicit
  flags win, and the backend defaults to cuda;
- the config loader reads the same keys as the JAX one.
"""

import hashlib
import http.client
import http.server
import json
import os
import signal
import ssl
import subprocess
import sys
import threading
import urllib.request

import grpc
import pytest
from conftest import allocate_port, wait_for
from test_torch_volume_server import _ports

from seaweedfs_tpu.pb import cluster_pb2 as jpb
from seaweedfs_tpu.pb import rpc as jrpc
from seaweedfs_tpu.server.master import MasterServer
from seaweedfs_tpu.utils import config as jax_config
from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.pb import worker_pb2 as wk
from seaweedfs_tpu_torch.server import __main__ as launcher
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.utils import config, urls
from seaweedfs_tpu_torch.utils.tls import generate_self_signed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(tmp_path, *args, **kw):
    """The launcher in a child interpreter, run from `tmp_path` (so that
    only a config file the test writes there is found) with HOME there."""
    env = dict(os.environ, PYTHONPATH=REPO, HOME=str(tmp_path))
    return subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch.server", *args],
                            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kw)


def test_launched_server_heartbeats_serves_and_stops_on_sigterm(tmp_path):
    mport = allocate_port()
    master = MasterServer(ip="127.0.0.1", port=mport)
    master.start()
    port = _ports()
    proc = launch(tmp_path, "volume", "-dir", str(tmp_path / "v"), "-master", f"127.0.0.1:{mport}",
                  "-ip", "127.0.0.1", "-port", str(port), "-ec.backend", "cpu")
    node = f"127.0.0.1:{port}"
    try:
        wait_for(lambda: node in master.topo.nodes or proc.poll() is not None, timeout=90,
                 msg="the launched server did not heartbeat")
        assert proc.poll() is None, proc.communicate(timeout=10)
        with grpc.insecure_channel(f"127.0.0.1:{port + 10000}") as ch:
            r = jrpc.volume_stub(ch).AllocateVolume(jpb.AllocateVolumeRequest(volume_id=3), timeout=30)
            assert r == jpb.AllocateVolumeResponse()
        wait_for(lambda: 3 in master.topo.nodes[node].volumes, msg="the new volume reached the master")
        fid = FileId(3, 0x1234, 0x5678)
        import http.client

        def req(method, body=None):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            try:
                c.request(method, f"/{fid}", body=body)
                r = c.getresponse()
                return r.status, r.read()
            finally:
                c.close()

        assert req("POST", b"launched" * 1000)[0] == 201
        assert req("GET") == (200, b"launched" * 1000)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        wait_for(lambda: node not in master.topo.nodes, msg="the stopped server left the master")
        assert "volume server on 127.0.0.1" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
        master.stop()


@pytest.mark.parametrize("case", ["tpu", "tls"])
def test_launcher_refuses_tpu_and_tls(tmp_path, case):
    """`-ec.backend tpu` is refused; a security.toml that asks for TLS is
    now served: the launched volume server answers over https and a
    plaintext client fails."""
    port = _ports()
    args = ["volume", "-dir", str(tmp_path / "v"), "-master", "127.0.0.1:1", "-ip", "127.0.0.1",
            "-port", str(port)]
    if case == "tpu":
        proc = launch(tmp_path, *args, "-ec.backend", "tpu")
        out, err = proc.communicate(timeout=120)
        want = "-ec.backend tpu: the port runs its EC on cuda, cpu or auto"
        assert proc.returncode != 0 and want in err, err
        assert not (tmp_path / "v").exists()  # nothing was built
        return
    certs = generate_self_signed(str(tmp_path / "tls"))
    (tmp_path / "security.toml").write_text(
        f'[https.default]\ncert = "{certs.cert_file}"\nkey = "{certs.key_file}"\n')
    proc = launch(tmp_path, *args, "-ec.backend", "cpu")
    try:
        def status():
            assert proc.poll() is None, proc.communicate(timeout=10)
            try:
                with urllib.request.urlopen(f"https://127.0.0.1:{port}/status", timeout=5,
                                            context=certs.client_context()) as r:
                    return json.loads(r.read())
            except OSError:
                return None

        wait_for(status, timeout=90, msg="the launched server did not answer over https")
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=5)
        stop_child(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_other_modes_are_refused():
    for mode in ("mq.broker",):
        with pytest.raises(SystemExit) as e:
            launcher.resolve([mode, "-dir", "/nonexistent"], config_dirs=())
        assert e.value.code == 2


def test_telemetry_mode_collects_by_name(tmp_path):
    port = allocate_port()
    store = tmp_path / "reports.jsonl"
    proc = launch(tmp_path, "telemetry", "-ip", "127.0.0.1", "-port", str(port), "-file",
                  str(store))
    try:
        def post():
            assert proc.poll() is None, proc.communicate(timeout=10)
            req = urllib.request.Request(f"http://127.0.0.1:{port}/api/collect", method="POST",
                                         data=json.dumps({"cluster_id": "c1",
                                                          "server_count": 3}).encode())
            try:
                with urllib.request.urlopen(req, timeout=5) as r:
                    return r.status == 200
            except OSError:
                return False

        wait_for(post, timeout=90, msg="the telemetry child did not answer")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/stats", timeout=5) as r:
            stats = json.loads(r.read())
        assert stats["clusters"] == 1 and stats["total_server_count"] == 3
        assert "telemetry collector on 127.0.0.1" in stop_child(proc)
        assert json.loads(store.read_text())["cluster_id"] == "c1"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_scaffold_mode_prints_a_template_by_name(tmp_path):
    from seaweedfs_tpu.utils.scaffold import scaffold as jax_template

    proc = launch(tmp_path, "scaffold", "-config", "volume")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0 and out == jax_template("volume"), err


@pytest.mark.parametrize("args, want", [
    (["server", "-webdav"], "-webdav: the port has no webdav module yet"),
    (["server", "-sftp"], "-sftp: the port has no sftp module yet"),
    (["server", "-admin"], "-admin: the port has no admin module yet"),
    (["server", "-notify.mq", "b:1"], "-notify.mq b:1: the port has no MQ broker yet: it comes "
     "with ROADMAP.md item 14a"),
    (["filer", "-notify.mq", "b:1"], "-notify.mq b:1: the port has no MQ broker yet: it comes "
     "with ROADMAP.md item 14a"),
    (["server", "-ec.backend", "tpu"], "-ec.backend tpu: the port runs its EC on cuda, cpu or auto"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_unserved_flags_of_master_and_server_are_refused(capsys, args, want):
    argv = args[:1] + (["-dir", "/nonexistent"] if args[0] == "server" else []) + args[1:]
    with pytest.raises(SystemExit) as e:
        launcher.resolve(argv, config_dirs=())
    assert e.value.code == 2 and want in capsys.readouterr().err


@pytest.mark.parametrize("args, field, want", [
    (["server", "-ec.autoFullness", "0.8"], "ec_auto_fullness", 0.8),
    (["server", "-ec.scrubInterval", "60"], "ec_scrub_interval_seconds", 60.0),
    (["master", "-ec.autoFullness", "0.8"], "ec_auto_fullness", 0.8),
    (["master", "-ec.scrubInterval", "60"], "ec_scrub_interval_seconds", 60.0),
    (["master", "-ec.rebalanceInterval", "5"], "ec_rebalance_interval_seconds", 5.0),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_scanner_flags_reach_the_masters_maintenance_config(tmp_path, args, field, want):
    """The master `build` starts serves the flag's value over
    GetMaintenanceConfig, as the JAX launcher's master would; the other
    scanners stay off."""
    mport = _ports()
    if args[0] == "master":
        argv = ["master", "-ip", "127.0.0.1", "-port", str(mport)]
    else:
        argv = ["server", "-ip", "127.0.0.1", "-masterPort", str(mport), "-port", str(_ports()),
                "-dir", str(tmp_path / "v"), "-ec.backend", "cpu"]
    servers = launcher.build(argv + args[1:], config_dirs=())
    try:
        cfg = grpc_call(mport, rpc.WORKER_SERVICE, "GetMaintenanceConfig",
                        wk.GetMaintenanceConfigRequest())
    finally:
        for srv in reversed(servers):
            srv.stop()
    knobs = ("ec_auto_fullness", "ec_scrub_interval_seconds", "ec_rebalance_interval_seconds")
    assert {k: getattr(cfg, k) for k in knobs} == {k: want if k == field else 0.0 for k in knobs}
    assert (cfg.ec_quiet_seconds, cfg.vacuum_interval_seconds, cfg.garbage_threshold) == (
        60.0, 60.0, pytest.approx(0.3))


def test_master_toml_fills_unset_flags_and_flags_win(tmp_path, capsys):
    d = tmp_path / "conf"
    d.mkdir()
    a = launcher.resolve(["master"], config_dirs=[str(d)])
    assert (a.port, a.ec_auto, a.garbage_threshold, a.vacuum_interval, a.peers, a.mdir) == (
        9333, 0.0, 0.3, 60.0, "", "")
    (d / "master.toml").write_text("[master.vacuum]\ngarbage_threshold = 0.5\n"
                                   "interval_seconds = 15\n[master.maintenance]\n"
                                   "ec_auto_fullness = 0.9\n")
    for mode in (["master"], ["server", "-dir", "/data"]):
        a = launcher.resolve(mode, config_dirs=[str(d)])  # the file's auto-EC scanner
        assert (a.ec_auto, a.garbage_threshold, a.vacuum_interval) == (0.9, 0.5, 15.0)
        a = launcher.resolve(mode + ["-ec.autoFullness", "0"], config_dirs=[str(d)])
        assert (a.ec_auto, a.garbage_threshold, a.vacuum_interval) == (0.0, 0.5, 15.0)
    # security.toml's https.default.* fill the -tls.* flags left unset,
    # field by field
    (d / "security.toml").write_text('[https.default]\ncert = "/c.pem"\nkey = "/k.pem"\n')
    a = launcher.resolve(["master", "-ec.autoFullness", "0"], config_dirs=[str(d)])
    assert (a.tls_cert, a.tls_key, a.tls_ca) == ("/c.pem", "/k.pem", "")
    a = launcher.resolve(["master", "-tls.ca", "/ca.pem", "-tls.cert", "/x.pem"],
                         config_dirs=[str(d)])
    assert (a.tls_cert, a.tls_key, a.tls_ca) == ("/x.pem", "/k.pem", "/ca.pem")
    assert launcher._tls_from(a).client_auth


@pytest.mark.parametrize("mode", ["master", "volume", "server", "filer"])
def test_tls_flags_of_master_volume_and_server_are_served(tmp_path, mode):
    """-tls.cert/-tls.key/-tls.ca: the servers `build` starts answer over
    https only to a client with a certificate the CA signed, and the
    process's own hops present the node's certificate."""
    certs = generate_self_signed(str(tmp_path / "tls"))
    flags = ["-tls.cert", certs.cert_file, "-tls.key", certs.key_file, "-tls.ca", certs.ca_file]
    mport, port = _ports(), _ports()
    if mode == "master":
        argv, ports = ["master", "-ip", "127.0.0.1", "-port", str(mport)], [mport]
    elif mode == "volume":
        argv, ports = ["volume", "-ip", "127.0.0.1", "-port", str(port), "-master",
                       "127.0.0.1:1", "-dir", str(tmp_path / "v"), "-ec.backend", "cpu"], [port]
    elif mode == "filer":
        argv, ports = ["filer", "-ip", "127.0.0.1", "-port", str(port), "-master", "127.0.0.1:1",
                       "-dir", str(tmp_path / "f"), "-store", "memory"], [port]
    else:
        argv = ["server", "-ip", "127.0.0.1", "-masterPort", str(mport), "-port", str(port),
                "-dir", str(tmp_path / "v"), "-ec.backend", "cpu"]
        ports = [mport, port]
    servers = launcher.build(argv + flags, config_dirs=())
    try:
        for p in ports:
            path = "/dir/status" if p == mport else "/debug/slo" if mode == "filer" else "/status"
            with urllib.request.urlopen(f"https://127.0.0.1:{p}{path}", timeout=10,
                                        context=certs.client_context()) as r:
                assert r.status == 200
            with urls.urlopen(f"https://127.0.0.1:{p}{path}", timeout=10) as r:
                assert r.status == 200
            bare = ssl.create_default_context(cafile=certs.ca_file)
            with pytest.raises(OSError):
                urllib.request.urlopen(f"https://127.0.0.1:{p}{path}", timeout=10, context=bare)
    finally:
        for srv in reversed(servers):
            srv.stop()
        urls.disable_https()


def grpc_call(port: int, service: str, method: str, req, timeout=10):
    with grpc.insecure_channel(f"127.0.0.1:{port + 10000}") as ch:
        return getattr(rpc.Stub(ch, service), method)(req, timeout=timeout)


def stop_child(proc) -> str:
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 0
    return proc.stderr.read()


def test_launched_master_elects_answers_assign_and_stops_on_sigterm(tmp_path):
    mport = allocate_port()
    mdir = tmp_path / "mdir"
    mdir.mkdir()
    proc = launch(tmp_path, "master", "-ip", "127.0.0.1", "-port", str(mport), "-mdir", str(mdir),
                  "-volumeSizeLimitMB", "64")
    vs = None
    try:
        def leads():
            assert proc.poll() is None, proc.communicate(timeout=10)
            try:
                return grpc_call(mport, rpc.RAFT_SERVICE, "RaftStatus",
                                 pb.RaftStatusRequest()).role == "leader"
            except grpc.RpcError:
                return False

        wait_for(leads, timeout=90, msg="the launched master did not elect itself")
        r = grpc_call(mport, rpc.MASTER_SERVICE, "Assign", pb.AssignRequest())
        assert r.error == "no writable volumes and growth failed"
        vs = VolumeServer([str(tmp_path / "v")], master=f"127.0.0.1:{mport}", ip="127.0.0.1",
                          port=_ports(), ec_backend="cpu")
        vs.start()
        wait_for(lambda: grpc_call(mport, rpc.MASTER_SERVICE, "Statistics",
                                   pb.StatisticsRequest()).node_count == 1,
                 timeout=60, msg="the volume server did not register")
        r = grpc_call(mport, rpc.MASTER_SERVICE, "Assign", pb.AssignRequest(collection="c"))
        assert not r.error and r.fid.startswith("1,") and r.location.url == f"127.0.0.1:{vs.port}"
        assert vs.store.find_volume(1) is not None  # grown through AllocateVolume
        vs.stop()
        vs = None
        err = stop_child(proc)
        assert "master listening on 127.0.0.1" in err
        recs = [json.loads(line) for line in (mdir / "raft.jsonl").read_text().splitlines()]
        assert {"entry"} <= {r["t"] for r in recs}
        assert any(r.get("kind") == "alloc_volume_id" for r in recs)
    finally:
        if vs is not None:
            vs.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_launched_server_mode_assigns_writes_and_reads(tmp_path):
    mport, port = allocate_port(), _ports()
    proc = launch(tmp_path, "server", "-ip", "127.0.0.1", "-masterPort", str(mport), "-port",
                  str(port), "-dir", str(tmp_path / "d"), "-ec.backend", "cpu")

    def req(p, method, path, body=None):
        c = http.client.HTTPConnection("127.0.0.1", p, timeout=30)
        try:
            c.request(method, path, body=body)
            r = c.getresponse()
            return r.status, r.read()
        finally:
            c.close()

    try:
        def assigned():
            assert proc.poll() is None, proc.communicate(timeout=10)
            try:
                code, body = req(mport, "GET", "/dir/assign?collection=s")
            except OSError:
                return None
            return json.loads(body) if code == 200 else None

        holder = {}
        wait_for(lambda: holder.setdefault("a", assigned()) is not None or holder.pop("a"),
                 timeout=90, msg="the launched server did not assign")
        a = holder["a"]
        assert a["url"] == f"127.0.0.1:{port}"
        assert req(port, "POST", f"/{a['fid']}", b"one process" * 100)[0] == 201
        vid = a["fid"].split(",")[0]
        code, body = req(mport, "GET", f"/dir/lookup?volumeId={vid}")
        assert code == 200 and json.loads(body)["locations"][0]["url"] == a["url"]
        assert req(port, "GET", f"/{a['fid']}") == (200, b"one process" * 100)
        err = stop_child(proc)
        assert "master listening on" in err and "volume server on" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_volume_toml_fills_unset_flags_and_flags_win(tmp_path):
    d = tmp_path / "conf"
    d.mkdir()
    base = ["volume", "-dir", "/data"]
    a = launcher.resolve(base, config_dirs=[str(d)])
    assert (a.ec_backend, a.index, a.max, a.master, a.jwt_key) == ("cuda", "memory", 8,
                                                                   "localhost:9333", "")
    (d / "volume.toml").write_text('[volume]\nindex = "sqlite"\nec_backend = "cpu"\n'
                                   "[volume.store]\nmax_volumes = 3\n")
    (d / "security.toml").write_text('[jwt.signing]\nkey = "from-toml"\n')
    a = launcher.resolve(base, config_dirs=[str(d)])
    assert (a.ec_backend, a.index, a.max, a.jwt_key) == ("cpu", "sqlite", 3, "from-toml")
    a = launcher.resolve(base + ["-ec.backend", "cuda", "-index", "memory", "-max", "8",
                                 "-jwt.key", "flag"], config_dirs=[str(d)])
    assert (a.ec_backend, a.index, a.max, a.jwt_key) == ("cuda", "memory", 8, "flag")
    (d / "volume.toml").write_text('[volume]\nec_backend = "tpu"\n')
    with pytest.raises(SystemExit):
        launcher.resolve(base, config_dirs=[str(d)])


def test_config_loader_reads_as_jax(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "volume.toml").write_text(
        '# comment\n[volume]\nindex = "sqlite"\nflag = true\n[volume.store]\nmax_volumes = 12\n'
        'ratio = 0.5\nlist = [1, 2]\n')
    (tmp_path / "b" / "broken.toml").write_text("[volume\nindex = \n")
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    for name in ("volume", "broken", "absent"):
        assert config.find_config_file(name, dirs) == jax_config.find_config_file(name, dirs)
        got, want = config.load_config(name, dirs), jax_config.load_config(name, dirs)
        assert got.data == want.data and bool(got) == bool(want) and got.path == want.path
        for key in ("volume.index", "volume.flag", "volume.store.max_volumes", "volume.store.ratio",
                    "volume.store.list", "volume.missing", "volume.index.deeper"):
            assert got.get(key) == want.get(key) and got.get_str(key, "d") == want.get_str(key, "d")
    assert config.CONFIG_DIRS == jax_config.CONFIG_DIRS


# ------------------------------------------------------------- the filer


class _Hook(http.server.BaseHTTPRequestHandler):
    """A webhook sink: keeps each POSTed JSON event."""

    events: list = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        _Hook.events.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


@pytest.mark.parametrize("mode", ["filer", "server -filer"])
def test_launched_filer_serves_files_grpc_and_webhook_by_name(tmp_path, mode):
    """`filer` (over a port master and volume server in this process) and
    `server -filer` children: a file PUT and read back over HTTP, gRPC
    LookupDirectoryEntry on port + 10000, the events POSTed to the
    `-notify.webhook` sink, exit 0 on SIGTERM."""
    from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
    from seaweedfs_tpu_torch.server.master import MasterServer as PortMaster

    hook = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Hook)
    threading.Thread(target=hook.serve_forever, daemon=True).start()
    _Hook.events = []
    sink = f"http://127.0.0.1:{hook.server_address[1]}/events"
    fport, mport = _ports(), _ports()
    inproc = []
    if mode == "filer":
        ms = PortMaster(ip="127.0.0.1", port=mport, vacuum_interval=3600)
        ms.start()
        vs = VolumeServer([str(tmp_path / "v")], master=f"127.0.0.1:{mport}", ip="127.0.0.1",
                          port=_ports(), ec_backend="cpu")
        vs.start()
        inproc = [vs, ms]
        wait_for(lambda: ms.topo.nodes, timeout=30, msg="the volume server registered")
        args = ["filer", "-ip", "127.0.0.1", "-port", str(fport), "-master", f"127.0.0.1:{mport}",
                "-dir", str(tmp_path / "fdb"), "-store", "sstable", "-collection", "lf",
                "-notify.webhook", sink]
    else:
        args = ["server", "-ip", "127.0.0.1", "-masterPort", str(mport), "-port", str(_ports()),
                "-filerPort", str(fport), "-dir", str(tmp_path / "d"), "-ec.backend", "cpu",
                "-filer", "-notify.webhook", sink]
    proc = launch(tmp_path, *args)
    body = os.urandom(300_000)

    def req(method, path, data=None):
        c = http.client.HTTPConnection("127.0.0.1", fport, timeout=30)
        try:
            c.request(method, path, body=data)
            r = c.getresponse()
            return r.status, r.read()
        finally:
            c.close()

    try:
        def put():
            assert proc.poll() is None, proc.communicate(timeout=10)
            try:
                return req("PUT", "/launched/a.bin", body)[0] == 201
            except OSError:
                return False

        wait_for(put, timeout=90, msg="the launched filer did not take a PUT")
        assert req("GET", "/launched/a.bin") == (200, body)
        code, listing = req("GET", "/launched")
        assert code == 200 and [e["FullPath"] for e in json.loads(listing)["Entries"]] == [
            "/launched/a.bin"]
        with grpc.insecure_channel(f"127.0.0.1:{fport + 10000}") as ch:
            r = rpc.filer_stub(ch).LookupDirectoryEntry(
                fpb.LookupEntryRequest(directory="/launched", name="a.bin"), timeout=30)
        assert not r.error and r.entry.attributes.file_size == len(body)
        wait_for(lambda: len(_Hook.events) >= 2, timeout=30, msg="the webhook got the events")
        assert [(e["directory"], (e["newEntry"] or {}).get("name")) for e in _Hook.events[:2]] == [
            ("/", "launched"), ("/launched", "a.bin")]
        err = stop_child(proc)
        assert "filer on 127.0.0.1" in err and "filer events -> webhook" in err
        if mode == "filer":
            assert (tmp_path / "fdb" / "filer.sst").is_dir()
        else:
            assert (tmp_path / "d" / "filerdb" / "filer.db").is_file()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
        for srv in inproc:
            srv.stop()
        hook.shutdown()
        hook.server_close()


def test_launched_filer_refuses_notify_mq_naming_its_item(tmp_path):
    (tmp_path / "notification.toml").write_text(
        '[notification.mq]\nenabled = true\nbroker = "127.0.0.1:17777"\n')
    for extra in ([], ["-notify.mq", "b:1"]):
        proc = launch(tmp_path, "filer", "-master", "127.0.0.1:1", "-dir", str(tmp_path / "f"),
                      *extra)
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 2 and "ROADMAP.md item 14a" in err, err
    assert not (tmp_path / "f").exists()  # nothing was built


def test_filer_and_notification_toml_fill_unset_flags(tmp_path):
    d = tmp_path / "conf"
    d.mkdir()
    a = launcher.resolve(["filer"], config_dirs=[str(d)])
    assert (a.dir, a.notify_webhook, a.store, a.grpcPort, a.peers) == (
        "./filerdb", "", "sqlite", 0, "")
    (d / "filer.toml").write_text('[sqlite]\nenabled = true\ndbFile = "/data/meta/filer.db"\n')
    (d / "notification.toml").write_text(
        '[notification.webhook]\nenabled = true\nendpoint = "http://hook/x"\n')
    a = launcher.resolve(["filer"], config_dirs=[str(d)])
    assert (a.dir, a.notify_webhook) == ("/data/meta", "http://hook/x")
    a = launcher.resolve(["filer", "-dir", "/mine", "-notify.webhook", "http://mine/y"],
                         config_dirs=[str(d)])
    assert (a.dir, a.notify_webhook) == ("/mine", "http://mine/y")
    a = launcher.resolve(["server", "-dir", "/data", "-filer"], config_dirs=[str(d)])
    assert (a.filer, a.filerPort, a.notify_webhook) == (True, 8888, "http://hook/x")


S3_IDENTITIES = {"identities": [{"name": "admin", "accessKey": "AKLAUNCH",
                                 "secretKey": "launched/secret", "actions": ["Admin"]}]}


@pytest.mark.parametrize("how", ["-filer -s3 -s3Config", "-s3 with s3.toml"])
def test_launched_server_serves_s3_by_name(tmp_path, how):
    """`server -s3` children: the gateway over the process's filer (`-s3`
    alone implies `-filer`) takes a signed bucket and object PUT, serves
    the object back, refuses an anonymous PUT and exits 0 on SIGTERM."""
    from seaweedfs_tpu_torch.s3.auth import sign_v4

    conf = tmp_path / "identities.json"
    conf.write_text(json.dumps(S3_IDENTITIES))
    s3port = _ports()
    args = ["server", "-ip", "127.0.0.1", "-masterPort", str(_ports()), "-port", str(_ports()),
            "-filerPort", str(_ports()), "-dir", str(tmp_path / "d"), "-ec.backend", "cpu",
            "-s3", "-s3Port", str(s3port)]
    if how.startswith("-filer"):
        args += ["-filer", "-s3Config", str(conf)]
    else:
        (tmp_path / "s3.toml").write_text(f'[s3]\nconfig = "{conf}"\n')
    proc = launch(tmp_path, *args)
    body = os.urandom(300_000)

    def req(method, path, data=b"", signed=True):
        headers = {"host": f"127.0.0.1:{s3port}"}
        if signed:
            headers = sign_v4(method, path, "", access_key="AKLAUNCH",
                              secret_key="launched/secret", headers=headers,
                              payload_hash=hashlib.sha256(data).hexdigest())
        c = http.client.HTTPConnection("127.0.0.1", s3port, timeout=30)
        try:
            c.request(method, path, body=data, headers=headers)
            r = c.getresponse()
            return r.status, r.read()
        finally:
            c.close()

    try:
        def bucket():
            assert proc.poll() is None, proc.communicate(timeout=10)
            try:
                return req("PUT", "/launched")[0] == 200
            except OSError:
                return False

        wait_for(bucket, timeout=90, msg="the launched gateway did not take a bucket")
        assert req("PUT", "/launched/a.bin", body)[0] == 200
        assert req("GET", "/launched/a.bin") == (200, body)
        status, doc = req("PUT", "/launched/b.bin", b"x", signed=False)
        assert status == 403 and b"<Code>AccessDenied</Code>" in doc
        err = stop_child(proc)
        assert f"s3 gateway on 127.0.0.1:{s3port}" in err and "filer on 127.0.0.1" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_s3_toml_fills_s3_config_where_the_flag_is_unset(tmp_path):
    d = tmp_path / "conf"
    d.mkdir()
    a = launcher.resolve(["server", "-dir", "/data", "-s3"], config_dirs=[str(d)])
    assert (a.s3, a.s3Port, a.s3Config, a.s3AccessKey, a.filer) == (True, 8333, "", "", False)
    (d / "s3.toml").write_text('[s3]\nconfig = "/etc/seaweed/identities.json"\n')
    a = launcher.resolve(["server", "-dir", "/data", "-s3"], config_dirs=[str(d)])
    assert a.s3Config == "/etc/seaweed/identities.json"
    a = launcher.resolve(["server", "-dir", "/data", "-s3", "-s3Config", "/mine.json"],
                         config_dirs=[str(d)])
    assert a.s3Config == "/mine.json"
    # without -s3 the file is not read
    assert launcher.resolve(["server", "-dir", "/data"], config_dirs=[str(d)]).s3Config == ""
