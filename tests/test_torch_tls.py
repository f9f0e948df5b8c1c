"""PyTorch port: TLS listeners with certificate hot reload (utils/tls.py),
the client side of TLS (utils/urls.py) and the launcher's TLS flags, on
the CPU:

- the five cases of tests/test_tls.py against port servers: an https
  master round trip (a plaintext client fails), a cert rotated under a
  live master, a stalled client that does not block the listener, the
  client's upload and read over https into a port master and volume
  server, and mutual TLS refusing a client without a certificate;
- one certificate minted by each package's `generate_self_signed`, taken
  by the other package's servers;
- a port `Operations` over https into a JAX master and volume server, and
  a JAX `Operations` over https into a port master and volume server,
  with the same bytes back;
- `enable_https` trusts the cluster CA and, under mutual TLS, presents
  the node's certificate.
"""

import json
import os
import ssl
import urllib.request

import pytest
from conftest import allocate_port as free_port
from conftest import wait_for

from seaweedfs_tpu.client.operations import Operations as JaxOperations
from seaweedfs_tpu.server.master import MasterServer as JaxMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer
from seaweedfs_tpu.utils import tls as jax_tls
from seaweedfs_tpu.utils import urls as jax_urls
from seaweedfs_tpu_torch.client.operations import Operations
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils import urls
from seaweedfs_tpu_torch.utils.tls import TlsConfig, generate_self_signed


def _get(url: str, ctx: ssl.SSLContext) -> bytes:
    with urllib.request.urlopen(url, context=ctx, timeout=10) as r:
        return r.read()


@pytest.fixture
def certs(tmp_path):
    return generate_self_signed(str(tmp_path / "tls"))


@pytest.fixture
def https(monkeypatch):
    """Both packages' internal hops on plaintext again after the test; the
    port's and the JAX client's HTTP data path (no net plane, which is
    plaintext TCP in both packages)."""
    monkeypatch.setenv("SEAWEED_CHUNK_NET_PLANE", "0")
    monkeypatch.setenv("SEAWEED_CHUNK_NET_PLANE_WRITE", "0")
    monkeypatch.setenv("REQUESTS_CA_BUNDLE", "")
    monkeypatch.setattr(jax_urls, "_scheme", "http")
    yield
    urls.disable_https()


def test_https_master_round_trip(certs):
    port = free_port()
    ms = MasterServer(ip="127.0.0.1", port=port, tls=certs)
    ms.start()
    try:
        body = _get(f"https://127.0.0.1:{port}/dir/status", certs.client_context())
        assert b"topology" in body.lower() or b"{" in body
        # plaintext client against the TLS port must fail
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/dir/status", timeout=5)
    finally:
        ms.stop()


def test_cert_hot_reload(tmp_path, certs):
    port = free_port()
    ms = MasterServer(ip="127.0.0.1", port=port, tls=certs)
    ms.start()
    try:
        ctx = certs.client_context()
        _get(f"https://127.0.0.1:{port}/dir/status", ctx)
        old = ssl.get_server_certificate(("127.0.0.1", port))
        # rotate the leaf (same CA, same paths): no server restart
        generate_self_signed(str(tmp_path / "tls"))
        _get(f"https://127.0.0.1:{port}/dir/status", ctx)
        assert ssl.get_server_certificate(("127.0.0.1", port)) != old
    finally:
        ms.stop()


def test_stalled_client_does_not_block_listener(certs):
    """A client that connects and never handshakes does not stall other
    connections (the handshake runs per connection, off the accept loop)."""
    import socket

    port = free_port()
    ms = MasterServer(ip="127.0.0.1", port=port, tls=certs)
    ms.start()
    stalled = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        assert _get(f"https://127.0.0.1:{port}/dir/status", certs.client_context())
    finally:
        stalled.close()
        ms.stop()


def _cluster(pkg: str, tmp_path, tls):
    master_cls, volume_cls = ((JaxMasterServer, JaxVolumeServer) if pkg == "jax"
                              else (MasterServer, VolumeServer))
    mport, vport = free_port(), free_port()
    ms = master_cls(ip="127.0.0.1", port=mport, tls=tls)
    ms.start()
    kw = {"ec_backend": "cpu"}
    vs = volume_cls(directories=[str(tmp_path / f"v-{pkg}")], master=f"127.0.0.1:{mport}",
                    ip="127.0.0.1", port=vport, tls=tls, **kw)
    vs.start()
    wait_for(lambda: ms.topo.nodes, timeout=30)
    return ms, vs


def test_cluster_internal_hops_over_https(tmp_path, certs, https):
    """enable_https() sends the client's uploads and reads over https
    (the service_url seam of every internal hop)."""
    urls.enable_https(certs.ca_file)
    ms, vs = _cluster("port", tmp_path, certs)
    try:
        assert urls.service_url(f"127.0.0.1:{vs.port}").startswith("https://")
        ops = Operations(master=f"127.0.0.1:{ms.port}")
        fid = ops.upload(b"tls payload", name="t.txt")
        assert ops.read(fid, fast=False) == b"tls payload"
        assert ops.read(fid) == b"tls payload"
        ops.close()
        # a plaintext client against the https volume port fails
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{vs.port}/{fid}", timeout=5)
    finally:
        vs.stop()
        ms.stop()


def test_mutual_tls_requires_client_cert(tmp_path):
    d = str(tmp_path / "mtls")
    server_cfg = generate_self_signed(d, name="server")
    client_cfg = generate_self_signed(d, name="client")
    server_cfg.client_auth = True
    port = free_port()
    ms = MasterServer(ip="127.0.0.1", port=port, tls=server_cfg)
    ms.start()
    try:
        bare = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        bare.load_verify_locations(server_cfg.ca_file)
        with pytest.raises(Exception):
            _get(f"https://127.0.0.1:{port}/dir/status", bare)
        assert _get(f"https://127.0.0.1:{port}/dir/status", client_cfg.client_context())
        # the process-wide client context presents the node's certificate
        urls.enable_https(server_cfg.ca_file, cert_file=client_cfg.cert_file,
                          key_file=client_cfg.key_file)
        with urls.urlopen(f"https://127.0.0.1:{port}/dir/status", timeout=10) as r:
            assert r.status == 200
        urls.enable_https(server_cfg.ca_file)
        with pytest.raises(Exception):
            urls.urlopen(f"https://127.0.0.1:{port}/dir/status", timeout=10)
    finally:
        urls.disable_https()
        ms.stop()


@pytest.mark.parametrize("minted_by", ["port", "jax"])
def test_one_certificate_serves_both_packages(tmp_path, minted_by):
    """A CA and leaf minted by either package's generate_self_signed are
    served by both packages' masters and trusted by both client contexts."""
    gen = generate_self_signed if minted_by == "port" else jax_tls.generate_self_signed
    c = gen(str(tmp_path / "tls"))
    port_cfg = TlsConfig(cert_file=c.cert_file, key_file=c.key_file, ca_file=c.ca_file)
    jax_cfg = jax_tls.TlsConfig(cert_file=c.cert_file, key_file=c.key_file, ca_file=c.ca_file)
    masters = [JaxMasterServer(ip="127.0.0.1", port=free_port(), tls=jax_cfg),
               MasterServer(ip="127.0.0.1", port=free_port(), tls=port_cfg)]
    for ms in masters:
        ms.start()
    try:
        bodies = [[_get(f"https://127.0.0.1:{ms.port}/dir/status", cfg.client_context())
                   for cfg in (port_cfg, jax_cfg)] for ms in masters]
        assert all(json.loads(b)["IsLeader"] for pair in bodies for b in pair)
    finally:
        for ms in masters:
            ms.stop()


def test_port_client_over_https_into_jax_servers(tmp_path, certs, https):
    urls.enable_https(certs.ca_file)
    jcfg = jax_tls.TlsConfig(cert_file=certs.cert_file, key_file=certs.key_file,
                             ca_file=certs.ca_file)
    ms, vs = _cluster("jax", tmp_path, jcfg)
    try:
        ops = Operations(master=f"127.0.0.1:{ms.port}")
        payload = os.urandom(70_000)
        fid = ops.upload(payload, name="p.bin")
        assert ops.read(fid, fast=False) == payload
        ops.close()
        n = vs.store.read_needle(*_ids(fid))
        assert n.data == payload and n.name == b"p.bin"
    finally:
        vs.stop()
        ms.stop()


def test_jax_client_over_https_into_port_servers(tmp_path, certs, https):
    jax_urls.enable_https(certs.ca_file)
    ms, vs = _cluster("port", tmp_path, certs)
    try:
        ops = JaxOperations(master=f"127.0.0.1:{ms.port}")
        payload = os.urandom(70_000)
        fid = ops.upload(payload, name="j.bin")
        assert ops.read(fid, fast=False) == payload
        ops.close()
        n = vs.store.read_needle(*_ids(fid))
        assert n.data == payload and n.name == b"j.bin"
    finally:
        vs.stop()
        ms.stop()


def _ids(fid: str):
    from seaweedfs_tpu_torch.storage.file_id import FileId

    f = FileId.parse(fid)
    return f.volume_id, f.needle_id, f.cookie
