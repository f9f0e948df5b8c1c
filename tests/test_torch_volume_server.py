"""PyTorch port: the volume server's data plane (server/volume_server.py,
utils/http_pool.py, the request-tracing mixin of utils/request_id.py,
storage/file_id.py), held against the JAX package's VolumeServer on the
CPU.

- A port server and a JAX server (both ec_backend="cpu") take the same
  seeded needles over HTTP (raw and multipart POSTs) and answer the same
  requests: GET, HEAD, Range (206), past the end (416), bad fids, DELETE,
  JWT 401s and the tenant-shed 503, with the same status, the same
  ETag / Content-Range / Content-Type / Accept-Ranges / Content-Length /
  Retry-After and the same bodies. Their `.dat` records are equal with
  the append time normalised (server threads stamp the real clock) and
  their `.idx` files byte-equal.
- A degraded GET of an EC volume with a shard unmounted: bit-exact, and
  the same answers from both servers (the JAX one reads through its
  CpuBackend).
- /status key sets, /metrics families, the /debug/slo, /debug/gateway and
  /debug/traces keys; a saturated worker pool's 503 and its JSON body;
  the threaded front end (http_workers=0) answering alike.
- The needle-read opcode on both servers from both packages' clients,
  and the refusal of a missing needle or a wrong cookie (status 2 from
  both servers).
- Each fan-out refusal of a server without a master: a write or delete on
  a replicated volume, a plane write to one, a delete on an EC volume.
- The multipart parser's fast path against the JAX parser on crafted and
  fuzzed bodies.
- A subprocess that imports the server module leaves grpc,
  google.protobuf, jax and seaweedfs_tpu out of sys.modules, and one that
  also serves a request leaves jax and seaweedfs_tpu out.
"""

import http.client
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
from conftest import allocate_port

from seaweedfs_tpu.ec.backend import CpuBackend as JaxCpuBackend
from seaweedfs_tpu.ec.context import ECContext as JaxECContext
from seaweedfs_tpu.ec.encoder import ec_encode_volume as jax_ec_encode_volume
from seaweedfs_tpu.ec import device_queue as jax_device_queue
import seaweedfs_tpu.server.topology  # noqa: F401 (see test_status_metrics_and_debug_surfaces_match_jax)
from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer
from seaweedfs_tpu.server.volume_server import _parse_upload as jax_parse_upload
from seaweedfs_tpu.utils import metrics as JM
from seaweedfs_tpu_torch.ec import CpuBackend, ECContext, ec_encode_volume, net_plane
from seaweedfs_tpu_torch.ec import device_queue
from seaweedfs_tpu_torch.server import volume_server as vs_mod
from seaweedfs_tpu_torch.server.volume_server import FAN_OUT_REFUSED, VolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.types import actual_offset
from seaweedfs_tpu_torch.utils import metrics as M
from seaweedfs_tpu_torch.utils.security import sign_jwt

VID, DEL_VID, EC_VID = 5, 6, 7
COMPARED = ("etag", "content-range", "content-type", "accept-ranges", "content-length",
            "retry-after")


def _ports() -> int:
    """An HTTP port whose gRPC shadow (+10000) and net-plane port are free."""
    while True:
        p = allocate_port()
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", net_plane.derive_port(p + 10000)))
        except OSError:
            continue
        return p


def start(pkg: str, directory, **kw):
    port = _ports()
    if pkg == "jax":
        vs = JaxVolumeServer([str(directory)], master="localhost:1", ip="127.0.0.1", port=port,
                             ec_backend="cpu", **kw)
        # no master: its replica lookups find no other holder, after a
        # connect attempt each; answer that at once
        vs.replicate_write = lambda request: ""
        vs.replicate_delete = lambda request: None
    else:
        vs = VolumeServer([str(directory)], ip="127.0.0.1", port=port, ec_backend="cpu", **kw)
    vs.start()
    return vs


def request(vs, method: str, path: str, body: bytes | None = None, headers=None):
    """(status, {compared header: value}, body) of one request on a fresh
    connection."""
    c = http.client.HTTPConnection("127.0.0.1", vs.port, timeout=30)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        data = r.read()
        hdrs = {k.lower(): v for k, v in r.getheaders()}
        return r.status, {k: hdrs[k] for k in COMPARED if k in hdrs}, data
    finally:
        c.close()


def multipart(payload: bytes, name: str, mime: str, boundary: str = "b0undary7") -> tuple[bytes, dict]:
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"{name}\"\r\n"
            f"Content-Type: {mime}\r\n\r\n").encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def upload(i: int, payload: bytes) -> tuple[bytes, dict]:
    """The i-th upload's request body and headers: raw octet-stream, raw
    with a type, multipart with a file name, in turns."""
    if i % 3 == 0:
        return payload, {"Content-Type": "application/octet-stream"}
    if i % 3 == 1:
        return payload, {"Content-Type": "text/plain"}
    return multipart(payload, f"f{i}.bin", "application/x-test")


def canon(raw: bytes) -> bytes:
    n = Needle.from_bytes(bytes(raw))
    n.append_at_ns = 1
    return n.to_bytes()


def record(vs, vid: int, nid: int) -> bytes:
    vol = vs.store.find_volume(vid)
    nv = vol.needle_map.get(nid)
    return vol._pread_record(actual_offset(nv.offset), nv.size)


def dat_records(vs, vid: int) -> list[bytes]:
    """Every record of the volume's .dat, in order, append time normalised."""
    vol = vs.store.find_volume(vid)
    vol.flush()
    raw = open(vol.dat_path, "rb").read()
    out, off = [], 8  # past the superblock
    while off < len(raw):
        _c, _n, size = Needle.parse_header(raw[off : off + 16])
        end = off + vol._record_disk_len(size)
        out.append(canon(raw[off:end]))
        off = end
    return out


def needles(seed: int, n: int, hi: int):
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(1, 1 << 20), n, replace=False)
    return [(int(nid), int(rng.integers(0, 1 << 32)), rng.bytes(int(rng.integers(0, hi))))
            for nid in ids]


def post_all(servers, vid, items):
    answers = []
    for i, (nid, cookie, payload) in enumerate(items):
        body, hdrs = upload(i, payload)
        answers.append([request(vs, "POST", f"/{FileId(vid, nid, cookie)}", body, hdrs)
                        for vs in servers])
    return answers


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX and a port server with the same needles in volume VID."""
    root = tmp_path_factory.mktemp("vs")
    servers = [start("jax", root / "jax"), start("port", root / "port")]
    for vs in servers:
        vs.store.allocate_volume(VID)
    items = needles(11, 15, 70_000) + [(7, 0x1234, b"")]
    posted = post_all(servers, VID, items)
    yield servers, items, posted
    for vs in servers:
        vs.stop()


def test_posts_and_records_match_jax(pair):
    servers, items, posted = pair
    for (nid, _c, payload), (jax_ans, port_ans) in zip(items, posted):
        assert jax_ans == port_ans
        assert port_ans[0] == 201 and json.loads(port_ans[2])["size"] >= len(payload)
        assert canon(record(servers[0], VID, nid)) == canon(record(servers[1], VID, nid))
    assert dat_records(servers[0], VID) == dat_records(servers[1], VID)
    idx = [open(vs.store.find_volume(VID).dat_path[:-4] + ".idx", "rb").read() for vs in servers]
    assert idx[0] == idx[1] and len(idx[1]) == 16 * len(items)


RANGES = [
    ("GET", None), ("HEAD", None), ("GET", "bytes=0-99"), ("GET", "bytes=-100"),
    ("GET", "bytes=100-"), ("GET", "bytes=10-5"), ("GET", "bytes=999999999-"),
    ("GET", "bytes=abc"), ("GET", "bytes=0-0,5-9"), ("HEAD", "bytes=0-9"),
]


@pytest.mark.parametrize("method,rng", RANGES, ids=[f"{m}-{r}" for m, r in RANGES])
def test_reads_match_jax(pair, method, rng):
    """GET, HEAD and each Range case on every needle: the same status,
    headers and body from both servers; a whole GET gives the payload."""
    servers, items, _ = pair
    hdrs = {"Range": rng} if rng else {}
    for nid, cookie, payload in items:
        path = f"/{FileId(VID, nid, cookie)}"
        jax_ans, port_ans = (request(vs, method, path, headers=hdrs) for vs in servers)
        assert jax_ans == port_ans, (nid, rng)
        if rng is None or method == "HEAD":
            assert port_ans[0] == 200
            assert port_ans[2] == (payload if method == "GET" else b"")
            assert port_ans[1]["content-length"] == str(len(payload))


def test_error_answers_match_jax(pair):
    servers, items, _ = pair
    nid, cookie, payload = items[0]
    paths = [
        "/5,zz", "/nonsense", f"/{FileId(99, nid, cookie)}",
        f"/{FileId(VID, nid, cookie ^ 1)}", f"/{FileId(VID, 999_999_999, 1)}",
        f"/{VID}/{str(FileId(VID, nid, cookie)).split(',')[1]}",
    ]
    got = []
    for path in paths:
        jax_ans, port_ans = (request(vs, "GET", path) for vs in servers)
        assert jax_ans == port_ans, path
        got.append(port_ans[0])
    assert got == [400, 400, 404, 404, 404, 200]


def test_request_id_echo_matches_jax(pair):
    servers, items, _ = pair
    nid, cookie, _ = items[1]
    for vs in servers:
        c = http.client.HTTPConnection("127.0.0.1", vs.port, timeout=10)
        c.request("GET", f"/{FileId(VID, nid, cookie)}", headers={"X-Request-ID": "rid-test-7"})
        r = c.getresponse()
        r.read()
        assert r.getheader("X-Request-ID") == "rid-test-7"
        c.close()


def test_send_body_native_and_wfile_give_the_same_bytes(pair, monkeypatch):
    """A GET body leaves through the host library's sendv, or through
    wfile with SEAWEED_EC_NATIVE=0: the same answer either way, each
    counted on its plane."""
    servers, items, _ = pair
    nid, cookie, payload = max(items, key=lambda it: len(it[2]))
    assert len(payload) >= 8 << 10  # past the native sender's floor
    path = f"/{FileId(VID, nid, cookie)}"
    answers = []
    for plane in ("native", "python"):
        if plane == "python":
            monkeypatch.setenv("SEAWEED_EC_NATIVE", "0")
        before = M.net_bytes_sent_total.snapshot().get((plane, "read"), 0)
        answers.append(request(servers[1], "GET", path))
        deadline = time.monotonic() + 5  # counted after the last byte is sent
        while M.net_bytes_sent_total.snapshot().get((plane, "read"), 0) - before < len(payload):
            assert time.monotonic() < deadline, plane
            time.sleep(0.005)
    assert answers[0] == answers[1] and answers[0][2] == payload


def test_deletes_match_jax(pair):
    servers, _items, _ = pair
    for vs in servers:
        vs.store.allocate_volume(DEL_VID)
    items = needles(12, 4, 30_000)
    post_all(servers, DEL_VID, items)
    nid, cookie, _ = items[0]
    fid = f"/{FileId(DEL_VID, nid, cookie)}"
    seq = [("DELETE", fid), ("DELETE", fid), ("GET", fid), ("DELETE", "/99,0100000001"),
           ("DELETE", "/6,zz"), ("DELETE", f"{fid}?type=replicate")]
    answers = [[request(vs, m, p) for vs in servers] for m, p in seq]
    for jax_ans, port_ans in answers:
        assert jax_ans == port_ans
    assert [a[1][0] for a in answers] == [202, 202, 404, 404, 400, 202]
    assert json.loads(answers[0][1][2])["size"] > 0 and json.loads(answers[1][1][2]) == {"size": 0}
    idx = [open(vs.store.find_volume(DEL_VID).dat_path[:-4] + ".idx", "rb").read() for vs in servers]
    assert idx[0] == idx[1]
    recs = [dat_records(vs, DEL_VID) for vs in servers]
    assert recs[0] == recs[1] and len(recs[1]) == len(items) + 1  # the tombstone


def test_jwt_rejections_match_jax(tmp_path):
    servers = [start("jax", tmp_path / "jax", jwt_key="k3y"),
               start("port", tmp_path / "port", jwt_key="k3y")]
    try:
        for vs in servers:
            vs.store.allocate_volume(VID)
        fid = str(FileId(VID, 0x99, 0x1234))
        good = {"Authorization": f"Bearer {sign_jwt('k3y', fid, ttl_seconds=60)}"}
        wrong = {"Authorization": f"Bearer {sign_jwt('k3y', '5,77', ttl_seconds=60)}"}
        seq = [("POST", {}), ("POST", wrong), ("POST", good), ("GET", {}), ("DELETE", {}),
               ("DELETE", good)]
        answers = [[request(vs, m, f"/{fid}", b"payload" if m == "POST" else None, h)
                    for vs in servers] for m, h in seq]
        for jax_ans, port_ans in answers:
            assert jax_ans == port_ans
        assert [a[1][0] for a in answers] == [401, 401, 201, 200, 401, 202]
        assert json.loads(answers[0][1][2]) == {"error": "unauthorized: malformed token"}
    finally:
        for vs in servers:
            vs.stop()


def test_tenant_shed_503_matches_jax(pair, monkeypatch):
    servers, items, _ = pair
    monkeypatch.setattr(jax_device_queue, "shed_advice", lambda tenant: 2.7)
    monkeypatch.setattr(device_queue, "shed_advice", lambda tenant: 2.7)
    nid, cookie, _ = items[2]
    jax_ans, port_ans = (request(vs, "GET", f"/{FileId(VID, nid, cookie)}") for vs in servers)
    assert jax_ans == port_ans
    assert port_ans[0] == 503 and port_ans[1]["retry-after"] == "2"
    assert json.loads(port_ans[2]) == {"error": "tenant over fair device share"}


def test_degraded_ec_reads_match_jax(pair):
    """Needles of a sealed, encoded volume read with data shard 0 unmounted:
    each reconstructed (the CPU backends) and bit-exact, the same answers
    from both servers, Range included."""
    servers, _items, _ = pair
    items = needles(13, 30, 90_000)
    for vs in servers:
        vs.store.allocate_volume(EC_VID)
    post_all(servers, EC_VID, items)
    for vs, encode, ctx, cpu in ((servers[0], jax_ec_encode_volume, JaxECContext(10, 4), JaxCpuBackend),
                                 (servers[1], ec_encode_volume, ECContext(10, 4), CpuBackend)):
        vol = vs.store.find_volume(EC_VID)
        vol.set_read_only(True)
        encode(vol.dat_path[:-4], ctx, backend=cpu(ctx))
        vs.store.unmount_volume(EC_VID)
        # no master: the JAX server's remote shard reader would try one per
        # read before it reconstructs; the port has no remote reader yet
        vs.store.ec_remote_reader_factory = None
        vs.store.mount_ec_volume(EC_VID)
        vs.store.unmount_ec_shards(EC_VID, [0])
    for nid, cookie, payload in items:
        path = f"/{FileId(EC_VID, nid, cookie)}"
        for hdrs in ({}, {"Range": "bytes=7-4000"}):
            jax_ans, port_ans = (request(vs, "GET", path, headers=hdrs) for vs in servers)
            assert jax_ans == port_ans
        assert request(servers[1], "GET", path)[2] == payload
    ev = servers[1].store.find_ec_volume(EC_VID)
    assert isinstance(ev.backend, CpuBackend) and ev.bytes_reconstructed > 0


def _families(text: str) -> set[str]:
    return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE ")}


def test_status_metrics_and_debug_surfaces_match_jax(pair):
    servers, items, _ = pair
    nid, cookie, _ = items[3]
    for vs in servers:
        request(vs, "GET", f"/{FileId(VID, nid, cookie)}")
    sts = [json.loads(request(vs, "GET", "/status")[2]) for vs in servers]
    assert set(sts[0]) == set(sts[1]) == {"volumes", "ec_volumes", "ec_device_queue",
                                          "ec_net_plane", "ec_streams", "ec_residency"}
    for key in ("ec_device_queue", "ec_net_plane", "ec_streams", "ec_residency"):
        assert set(sts[0][key]) == set(sts[1][key]), key
    assert set(sts[0]["volumes"][0]) == set(sts[1]["volumes"][0])
    assert [v["id"] for v in sts[0]["volumes"]] == [v["id"] for v in sts[1]["volumes"]]

    # the registries are process-wide: a family a module registers at import
    # shows on every server of its package in the process. The port's master
    # topology registers the JAX topology's two fleet gauges, so the JAX one
    # is imported at the top of this file to hold the same families.
    texts = [request(vs, "GET", "/metrics")[2].decode() for vs in servers]
    theirs, ours = _families(texts[0]), _families(texts[1])
    assert ours <= theirs
    assert {"sw_volumes", "sw_volume_bytes", "sw_request_seconds", "sw_request_total",
            "sw_gateway_inflight", "sw_gateway_rejected_total", "sw_net_bytes_sent_total"} <= ours
    assert 'sw_request_seconds_count{server="volume",op="read"}' in texts[1]
    addr = servers[1].store.public_url
    assert f'sw_volumes{{kind="normal",addr="{addr}"}}' in texts[1]

    slo = [json.loads(request(vs, "GET", "/debug/slo")[2]) for vs in servers]
    assert "volume.read" in slo[1] and set(slo[0]["volume.read"]) == set(slo[1]["volume.read"])
    gw = [json.loads(request(vs, "GET", "/debug/gateway")[2]) for vs in servers]
    assert set(gw[0]) == set(gw[1]) and set(gw[0]["front_end"]) == set(gw[1]["front_end"])
    assert gw[1]["front_end"]["kind"] == "pooled" and gw[1]["front_end"]["server"] == "volume"
    tr = [json.loads(request(vs, "GET", "/debug/traces")[2]) for vs in servers]
    assert set(tr[0]) == set(tr[1])


def _saturated_answer(vs) -> bytes:
    """Hold the one connection a 1-worker, 0-queue pool admits (parked
    after a request), then read what a second connection gets."""
    held = socket.create_connection(("127.0.0.1", vs.port), timeout=10)
    try:
        held.sendall(b"GET /status HTTP/1.1\r\nHost: x\r\n\r\n")
        head = b""
        while b"\r\n\r\n" not in head:
            head += held.recv(65536)
        second = socket.create_connection(("127.0.0.1", vs.port), timeout=10)
        try:
            out = b""
            while chunk := second.recv(65536):
                out += chunk
            return out
        finally:
            second.close()
    finally:
        held.close()


def test_pool_saturation_503_matches_jax(tmp_path):
    servers = [start("jax", tmp_path / "jax", http_workers=1, http_queue=0),
               start("port", tmp_path / "port", http_workers=1, http_queue=0)]
    try:
        before = (JM.gateway_rejected_total.snapshot().get(("volume",), 0),
                  M.gateway_rejected_total.snapshot().get(("volume",), 0))
        answers = [_saturated_answer(vs) for vs in servers]
        assert answers[0] == answers[1]
        assert answers[1].startswith(b"HTTP/1.1 503 Service Unavailable\r\nRetry-After: 1\r\n")
        assert answers[1].endswith(b'{"error": "volume server saturated: worker pool and '
                                   b'accept queue are full"}')
        assert M.gateway_rejected_total.snapshot()[("volume",)] == before[1] + 1
        assert JM.gateway_rejected_total.snapshot()[("volume",)] == before[0] + 1
    finally:
        for vs in servers:
            vs.stop()


@pytest.mark.parametrize("client_side", ["jax", "port"])
def test_plane_needle_reads_on_volume_servers(pair, client_side):
    """Either package's client reads the needles of either server over the
    needle-read opcode. A missing needle and a wrong cookie get the same
    status from both servers: 2, the volume refusal. The JAX resolver's
    `except VolumeError` catches NotFoundError and CookieMismatch, its
    subclasses, though its comment reserves status 2 for EC, TTL'd and
    tiered volumes; the port answers as it does."""
    from seaweedfs_tpu.ec import net_plane as jax_np

    servers, items, _ = pair
    mod = {"jax": jax_np, "port": net_plane}[client_side]
    c = mod.NetPlaneClient(timeout=10)
    try:
        for vs in servers:
            addr = ("127.0.0.1", vs.net_plane.port)
            for nid, cookie, payload in items[:6]:
                assert c.read_needle(addr, VID, nid, cookie) == payload
            flags = []
            for nid, cookie in ((999_999, 1), (items[0][0], items[0][1] ^ 1)):
                with pytest.raises(mod.NetPlaneError, match="not found|cookie mismatch") as e:
                    c.read_needle(addr, VID, nid, cookie)
                flags.append(getattr(e.value, "volume_refusal", False))
            with pytest.raises(mod.NetPlaneError, match="volume not here") as e:
                c.read_needle(addr, 99, 1, 1)
            flags.append(e.value.volume_refusal)
            assert flags == [True, True, True]
    finally:
        c.close()


def test_threaded_front_end_answers_alike(tmp_path):
    """http_workers=0 takes the stdlib threaded server in both packages:
    the same answers, and /debug/gateway names the front end."""
    servers = [start("jax", tmp_path / "jax", http_workers=0),
               start("port", tmp_path / "port", http_workers=0)]
    try:
        for vs in servers:
            vs.store.allocate_volume(VID)
        items = needles(15, 3, 50_000)
        posted = post_all(servers, VID, items)
        assert all(a == b and a[0] == 201 for a, b in posted)
        for nid, cookie, payload in items:
            answers = [request(vs, "GET", f"/{FileId(VID, nid, cookie)}") for vs in servers]
            assert answers[0] == answers[1] and answers[1][2] == payload
        fronts = [json.loads(request(vs, "GET", "/debug/gateway")[2])["front_end"] for vs in servers]
        assert fronts[0] == fronts[1] == {"kind": "threading", "server": "", "workers": 0}
    finally:
        for vs in servers:
            vs.stop()


# ------------------------------------------------------------ fan-out refusals


@pytest.fixture
def port_server(tmp_path):
    vs = start("port", tmp_path / "port")
    vs.store.allocate_volume(8, replica_placement="001")
    vs.store.allocate_volume(9)
    yield vs
    vs.stop()


def test_replicated_write_refused_not_acknowledged(port_server):
    fid = f"/{FileId(8, 0x42, 0x77)}"
    status, _h, body = request(port_server, "POST", fid, b"x" * 5000)
    err = json.loads(body)["error"]
    assert status == 500 and FAN_OUT_REFUSED in err and "asks for 2 copies" in err
    # the local append stands, as the JAX server's does when a replica leg fails
    assert request(port_server, "GET", fid)[2] == b"x" * 5000
    # a replication leg is not fanned out further: acknowledged
    assert request(port_server, "POST", fid + "?type=replicate", b"y" * 10)[0] == 201


def test_replicated_delete_refused(port_server):
    fid = f"/{FileId(8, 0x43, 0x77)}"
    assert request(port_server, "POST", fid + "?type=replicate", b"z" * 100)[0] == 201
    status, _h, body = request(port_server, "DELETE", fid)
    assert status == 500 and FAN_OUT_REFUSED in json.loads(body)["error"]
    assert request(port_server, "DELETE", fid + "?type=replicate")[0] == 202


def test_plane_write_to_replicated_volume_refused(port_server):
    client = net_plane.NetPlaneClient(timeout=10)
    addr = ("127.0.0.1", port_server.net_plane.port)
    try:
        with pytest.raises(net_plane.NetPlaneError, match=FAN_OUT_REFUSED) as e:
            client.write_needle(addr, 8, 0x44, 0x77, b"w" * 3000)
        assert not getattr(e.value, "volume_refusal", False)
        assert client.write_needle(addr, 8, 0x44, 0x77, b"w" * 3000, replicate=False)[0] > 3000
        # a volume whose placement asks for one copy takes plane writes
        assert client.write_needle(addr, 9, 0x45, 0x77, b"v" * 3000)[0] > 3000
    finally:
        client.close()


def test_ec_delete_refused(port_server):
    items = needles(14, 8, 20_000)
    for nid, cookie, payload in items:
        assert request(port_server, "POST", f"/{FileId(9, nid, cookie)}", payload)[0] == 201
    store = port_server.store
    vol = store.find_volume(9)
    vol.set_read_only(True)
    ec_encode_volume(vol.dat_path[:-4], ECContext(10, 4), backend=CpuBackend(ECContext(10, 4)))
    store.unmount_volume(9)
    store.mount_ec_volume(9)
    nid, cookie, _ = items[0]
    status, _h, body = request(port_server, "DELETE", f"/{FileId(9, nid, cookie)}")
    err = json.loads(body)["error"]
    # the JAX server's answer where the holder lookup fails
    assert status == 500 and err.startswith("ec tombstone fan-out: holder lookup failed: ")
    assert request(port_server, "GET", f"/{FileId(9, nid, cookie)}")[0] == 404


# ------------------------------------------------------------ multipart parser


def _mp(payload, hdr=b'Content-Disposition: form-data; name="file"; filename="a.bin"\r\n'
                      b"Content-Type: application/x-test\r\n", boundary=b"XyZ123"):
    return b"--" + boundary + b"\r\n" + hdr + b"\r\n" + payload + b"\r\n--" + boundary + b"--\r\n"


H = {"Content-Type": "multipart/form-data; boundary=XyZ123"}
CRAFTED = {
    "payload_edges": [(H, _mp(p)) for p in (
        b"", b"x", b"\r\n", b"\r", b"\n", b"abc\r", b"abc\n", b"abc\r\r", b"a\r--XyZ123",
        b"a\n--XyZ123x", b"--XyZ123", b"\r\n--XyZ123 \t")],
    "part_headers": [
        (H, _mp(b"q", hdr=b'Content-Disposition: form-data; name="f"\r\n')),
        (H, _mp(b"aGVsbG8=", hdr=b"Content-Transfer-Encoding: base64\r\n"
                                 b'Content-Disposition: form-data; filename="b"\r\n')),
        (H, _mp(b"x", hdr=b"Content-Type: multipart/mixed; boundary=inner\r\n")),
        (H, _mp(b"x", hdr=b" folded: v\r\n")),
        (H, _mp(b"x", hdr=b"Content-Disposition: form-data; filename*=utf-8''%C3%A9.bin\r\n")),
        (H, b"--XyZ123\r\n\r\nno headers\r\n--XyZ123--\r\n"),
    ],
    "framing": [
        (H, b"preamble\r\n" + _mp(b"pp")),
        (H, _mp(b"zz").replace(b"\r\n", b"\n")),
        (H, b"--XyZ123\r\nContent-Type: text/plain\r\n\r\nno close"),
        (H, b"--XyZ123--\r\n"),
        (H, b"--XyZ123\r\n--XyZ123\r\nContent-Type: a/b\r\n\r\nx\r\n--XyZ123--"),
        ({"Content-Type": 'multipart/form-data; boundary="q q"'},
         b"--q q\r\nContent-Type: a/b\r\n\r\nhi\r\n--q q--"),
        ({"Content-Type": "multipart/form-data"}, _mp(b"no boundary")),
        ({"Content-Type": "text/plain"}, b"raw"),
        ({"Content-Type": "application/octet-stream"}, b"raw"),
        ({}, b"raw"),
    ],
}


def _fuzzed(seed: int, n: int):
    rng = np.random.default_rng(seed)
    marks = [b"\r\n--XyZ123\r\n", b"\r--XyZ123", b"\n--XyZ123--", b"--XyZ123", b"\r\r\n",
             b"\r\n--XyZ123 x"]
    for _ in range(n):
        pl = bytearray(rng.bytes(int(rng.integers(0, 3000))))
        for _ in range(int(rng.integers(0, 4))):
            at = int(rng.integers(0, len(pl) + 1))
            pl[at:at] = marks[int(rng.integers(0, len(marks)))]
        yield H, _mp(bytes(pl))


@pytest.mark.parametrize("group", [*CRAFTED, "fuzzed"])
def test_parse_upload_matches_jax(group):
    cases = CRAFTED[group] if group in CRAFTED else list(_fuzzed(5, 200))
    for headers, body in cases:
        assert vs_mod._parse_upload(headers, body) == jax_parse_upload(headers, body), body[:60]


def test_parse_upload_takes_fast_path_for_client_uploads():
    payload = np.random.default_rng(6).bytes(1 << 20)
    body, hdrs = multipart(payload, "big.bin", "application/x-test")
    assert vs_mod._first_part("b0undary7", body) == ("big.bin", "application/x-test", payload)
    assert vs_mod._parse_upload(hdrs, body) == jax_parse_upload(hdrs, body)


# ------------------------------------------------------------------ guards

_GUARD = r"""
import http.client, json, socket, sys, tempfile
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.ec.net_plane import free_grpc_port
def bad(tops, protobuf=False):
    return [m for m in sys.modules
            if m.split(".")[0] in tops or (protobuf and m.startswith("google.protobuf"))]
imported = bad(("grpc", "jax", "jaxlib", "seaweedfs_tpu"), protobuf=True)
def free():
    s = socket.socket(); s.bind(("127.0.0.1", 0)); p = s.getsockname()[1]; s.close()
    return p
port = free()
vs = VolumeServer([tempfile.mkdtemp()], ip="127.0.0.1", port=port, grpc_port=free_grpc_port(),
                  ec_backend="cpu")
vs.start()
vs.store.allocate_volume(3)
c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
c.request("POST", "/3,01637037d6", body=b"guarded")
r = c.getresponse()
assert r.status == 201 and r.read()
c.request("GET", "/3,01637037d6")
assert c.getresponse().read() == b"guarded"
c.close()
vs.stop()
print(json.dumps([imported, bad(("jax", "jaxlib", "seaweedfs_tpu"))]))
"""


def test_server_imports_no_grpc_protobuf_or_jax():
    """The server module imports none of them; a server (which builds its
    gRPC half, server/volume_grpc.py) that serves a request brings in no
    JAX."""
    out = subprocess.run([sys.executable, "-c", _GUARD], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], []]
