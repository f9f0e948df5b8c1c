"""PyTorch port: the launcher's volume mode
(`python -m seaweedfs_tpu_torch.server volume`, server/__main__.py) and
its trimmed config loader (utils/config.py), on the CPU:

- a launched port server on the JAX master heartbeats, serves POST and
  GET, and exits with 0 on SIGTERM, leaving the master;
- `-ec.backend tpu` and a `security.toml` asking for TLS each stop the
  launcher with a message and a nonzero exit;
- `volume.toml` fills the flags left unset, explicit flags win, and the
  backend defaults to cuda;
- the config loader reads the same keys as the JAX one.
"""

import os
import signal
import subprocess
import sys

import grpc
import pytest
from conftest import allocate_port, wait_for
from test_torch_volume_server import _ports

from seaweedfs_tpu.pb import cluster_pb2 as jpb
from seaweedfs_tpu.pb import rpc as jrpc
from seaweedfs_tpu.server.master import MasterServer
from seaweedfs_tpu.utils import config as jax_config
from seaweedfs_tpu_torch.server import __main__ as launcher
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.utils import config

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
    args = ["volume", "-dir", str(tmp_path / "v"), "-master", "127.0.0.1:1", "-port", str(_ports())]
    if case == "tpu":
        args += ["-ec.backend", "tpu"]
        want = "-ec.backend tpu: the port runs its EC on cuda, cpu or auto"
    else:
        (tmp_path / "security.toml").write_text(
            '[https.default]\ncert = "/etc/ssl/node.crt"\nkey = "/etc/ssl/node.key"\n')
        want = "sets https.default.cert, but the port serves no TLS"
    proc = launch(tmp_path, *args)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and want in err, err
    assert not (tmp_path / "v").exists()  # nothing was built


def test_other_modes_are_refused():
    for mode in ("master", "filer", "server"):
        with pytest.raises(SystemExit) as e:
            launcher.resolve([mode, "-dir", "/nonexistent"], config_dirs=())
        assert e.value.code == 2


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
