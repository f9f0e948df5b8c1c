"""PyTorch port: the bulk-read fast path (csrc/fastread.cpp,
utils/fastread.py, the volume server's ?locate=true and the client's
`_try_fast_read`), held against the JAX package on the CPU:

- the three cases of tests/test_fastread.py against the port: the raw
  sidecar's round trip and root confinement, a port server's ?locate and
  the client's fast read (counted in `operations.FAST_READS`), and the
  sidecar not slower than HTTP on a 16 MB needle;
- the port's and the JAX server's ?locate=true over the same volume
  files: the same offset, size and CRC, and each package's
  `read_fid_fast` reading the other's sidecar to the same bytes;
- a location whose socket cannot be bound serves HTTP only: ?locate names
  no socket and the client reads over HTTP;
- the library is built into seaweedfs_tpu_torch/build/ from csrc/.
"""

import http.client
import json
import os
import shutil
import time

import numpy as np
import pytest
from conftest import allocate_port
from test_torch_volume_server import _ports

from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer
from seaweedfs_tpu.utils import fastread as jax_fastread
from seaweedfs_tpu_torch.client import operations
from seaweedfs_tpu_torch.client.operations import Operations
from seaweedfs_tpu_torch.ops import _build
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils.fastread import (
    FastReadClient,
    FastReadError,
    read_fid_fast,
    start_server,
    stop_server,
)


def get(port: int, path: str) -> tuple[int, bytes]:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def test_raw_server_round_trip_and_confinement(tmp_path):
    root = tmp_path / "served"
    root.mkdir()
    blob = np.random.default_rng(21).bytes(300_000)
    (root / "vol.dat").write_bytes(blob)
    secret = tmp_path / "secret.txt"
    secret.write_bytes(b"never serve this")
    sock = str(root / ".fr.sock")
    start_server(sock, str(root))
    try:
        c = FastReadClient(sock)
        assert c.read(str(root / "vol.dat"), 0, len(blob)) == blob
        assert c.read(str(root / "vol.dat"), 1000, 50) == blob[1000:1050]
        for off in (0, 7, 299_000):  # several requests on one connection
            assert c.read(str(root / "vol.dat"), off, 100) == blob[off : off + 100]
        with pytest.raises(FastReadError, match="EOF"):
            c.read(str(root / "vol.dat"), len(blob) - 10, 100)
        # root confinement: an absolute path outside, and a traversal
        c2 = FastReadClient(sock)
        with pytest.raises(FastReadError, match="outside"):
            c2.read(str(secret), 0, 10)
        c3 = FastReadClient(sock)
        with pytest.raises(FastReadError, match="outside|open"):
            c3.read(str(root / ".." / "secret.txt"), 0, 10)
        c.close(), c2.close(), c3.close()
    finally:
        stop_server(sock)
    assert any(p.name.startswith("libfastread-") for p in _build.BUILD_DIR.iterdir())


@pytest.fixture
def cluster(tmp_path):
    mport = allocate_port()
    ms = MasterServer(ip="127.0.0.1", port=mport)
    ms.start()
    vs = VolumeServer(directories=[str(tmp_path / "v")], master=f"127.0.0.1:{mport}",
                      ip="127.0.0.1", port=_ports(), ec_backend="cpu")
    vs.start()
    ops = Operations(master=f"127.0.0.1:{mport}")
    deadline = time.time() + 30
    while not ms.topo.nodes and time.time() < deadline:
        time.sleep(0.05)
    yield ms, vs, ops
    ops.close()
    vs.stop()
    ms.stop()


def test_volume_server_locate_and_fast_read(cluster, monkeypatch):
    _, vs, ops = cluster
    assert vs.fastread_sockets, "the sidecar should be running"
    payload = np.random.default_rng(22).bytes(200_000)
    fid = ops.upload(payload, name="big.bin")
    code, body = get(vs.port, f"/{fid}?locate=true")
    loc = json.loads(body)
    assert code == 200 and loc["size"] == len(payload)
    assert loc["socket"] and os.path.exists(loc["socket"])
    with open(loc["path"], "rb") as f:  # the raw bytes at (path, offset, size)
        f.seek(loc["offset"])
        assert f.read(loc["size"]) == payload
    assert read_fid_fast(loc) == payload
    # the client's read order: the net plane first, so turn it off to reach
    # the sidecar; then HTTP
    monkeypatch.setenv("SEAWEED_CHUNK_NET_PLANE", "0")
    before = operations.FAST_READS["sidecar"]
    assert ops.read(fid) == payload
    assert operations.FAST_READS["sidecar"] == before + 1
    assert ops.read(fid, fast=False) == payload
    assert operations.FAST_READS["sidecar"] == before + 1
    # a wrong cookie is refused at locate time; a stale CRC fails the read
    f = FileId.parse(fid)
    assert get(vs.port, f"/{FileId(f.volume_id, f.needle_id, f.cookie ^ 1)}?locate=true")[0] == 404
    with pytest.raises(FastReadError, match="checksum"):
        read_fid_fast(dict(loc, crc32c=loc["crc32c"] ^ 1))


def test_fast_read_beats_http(cluster):
    """Sanity perf check on a 16 MB blob: the sendfile path should not be
    slower than HTTP."""
    _, vs, ops = cluster
    payload = np.random.default_rng(23).bytes(16 << 20)
    fid = ops.upload(payload, name="bulk.bin")
    loc = json.loads(get(vs.port, f"/{fid}?locate=true")[1])
    assert read_fid_fast(loc) == payload  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        assert len(read_fid_fast(loc)) == len(payload)
    fast_t = (time.perf_counter() - t0) / 3
    assert get(vs.port, f"/{fid}")[1] == payload  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        assert len(get(vs.port, f"/{fid}")[1]) == len(payload)
    http_t = (time.perf_counter() - t0) / 3
    print(f"fastread {len(payload) / fast_t / 1e6:.0f} MB/s vs http {len(payload) / http_t / 1e6:.0f} MB/s")
    assert fast_t < http_t * 1.5, (fast_t, http_t)


def _volume_files(d, vid: int = 4) -> list[tuple[int, int, bytes]]:
    rng = np.random.default_rng(24)
    v = Volume(str(d), vid)
    items = []
    for nid in range(1, 25):
        body = rng.bytes(int(rng.integers(1, 90_000)))
        cookie = int(rng.integers(0, 1 << 32))
        v.write_needle(Needle(cookie=cookie, needle_id=nid, data=body))
        items.append((nid, cookie, body))
    v.delete_needle(5)
    v.close()
    return items


def test_locate_answers_and_sidecars_match_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    items = _volume_files(src)
    for pkg in ("jax", "port"):
        shutil.copytree(src, tmp_path / pkg)
    jax_vs = JaxVolumeServer([str(tmp_path / "jax")], master="localhost:1", ip="127.0.0.1",
                             port=_ports(), ec_backend="cpu")
    port_vs = VolumeServer([str(tmp_path / "port")], ip="127.0.0.1", port=_ports(),
                           ec_backend="cpu")
    for vs in (jax_vs, port_vs):
        vs.start()
    try:
        for nid, cookie, body in items:
            path = f"/{FileId(4, nid, cookie)}?locate=true"
            (jcode, jbody), (pcode, pbody) = get(jax_vs.port, path), get(port_vs.port, path)
            assert jcode == pcode
            if nid == 5:
                assert pcode == 404 and json.loads(jbody) == json.loads(pbody)
                continue
            jloc, ploc = json.loads(jbody), json.loads(pbody)
            assert {k: jloc[k] for k in ("offset", "size", "crc32c")} == {
                k: ploc[k] for k in ("offset", "size", "crc32c")}
            assert ploc["path"] == str(tmp_path / "port" / "4.dat")
            assert ploc["socket"] == str(tmp_path / "port" / ".fastread.sock")
            # each package's client on the other's sidecar
            assert read_fid_fast(jloc) == jax_fastread.read_fid_fast(ploc) == body
    finally:
        for vs in (jax_vs, port_vs):
            vs.stop()


def test_unbindable_socket_leaves_the_location_on_http(tmp_path, monkeypatch):
    """A data directory whose socket path is past the AF_UNIX limit: the
    server logs it and serves that location over HTTP only."""
    deep = tmp_path / ("d" * 100)
    vs = VolumeServer([str(deep)], ip="127.0.0.1", port=_ports(), ec_backend="cpu")
    vs.start()
    try:
        assert vs.fastread_sockets == {}
        vs.store.allocate_volume(3)
        body = b"over http" * 100
        vs.store.write_needle(3, Needle(cookie=9, needle_id=1, data=body))
        code, answer = get(vs.port, f"/{FileId(3, 1, 9)}?locate=true")
        assert code == 200 and json.loads(answer)["socket"] == ""
        assert get(vs.port, f"/{FileId(3, 1, 9)}") == (200, body)
    finally:
        vs.stop()
