"""PyTorch port: the servers' cross-cutting parts, held against the JAX
package on the CPU:

- `utils/images.resized` gives the JAX one's bytes and sizes in every
  mode, for seeded PNG, JPEG and GIF images, and serves the original
  where decoding fails;
- a thumbnail GET (?width, ?height, ?mode) from a port and a JAX volume
  server gives the same status, bytes, ETag and type, over a plain volume
  and over an EC volume with a data shard gone (the port's read runs the
  planes kernel's plain torch version here);
- /debug/pprof (the stacks and a short profile) answers on both packages'
  masters and volume servers, and the loopback gate of /debug/pprof and
  /debug/traces sends the JAX 403 to a non-loopback client;
- the telemetry collector (`utils/telemetry_server.py`): `summary`,
  `prometheus`, persist-and-reload and its HTTP answers agree with the
  JAX one for the same reports.
"""

import http.client
import io
import json
import time
import types
from urllib.parse import urlparse

import numpy as np
import pytest
from conftest import allocate_port
from PIL import Image
from test_torch_volume_server import request, start

from seaweedfs_tpu.ec.backend import CpuBackend as JaxCpuBackend
from seaweedfs_tpu.ec.context import ECContext as JaxECContext
from seaweedfs_tpu.ec.encoder import ec_encode_volume as jax_ec_encode_volume
from seaweedfs_tpu.server.master import MasterServer as JaxMasterServer
from seaweedfs_tpu.utils import images as jax_images
from seaweedfs_tpu.utils import pprof as jax_pprof
from seaweedfs_tpu.utils import telemetry_server as jax_ts
from seaweedfs_tpu_torch.ec import ECContext, TorchBackend, ec_encode_volume
from seaweedfs_tpu_torch.ec import ec_volume as port_ec_volume
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.utils import images, pprof
from seaweedfs_tpu_torch.utils import telemetry_server as port_ts


def seeded_image(fmt: str, seed: int, size=(96, 80)) -> bytes:
    rng = np.random.default_rng(seed)
    w, h = size
    # smooth gradients plus noise: JPEG and GIF encoders get real work
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([(xx * 255 // w), (yy * 255 // h), ((xx + yy) * 127 // (w + h))], -1)
    rgb = np.clip(rgb + rng.integers(-30, 30, rgb.shape), 0, 255).astype(np.uint8)
    img = Image.fromarray(rgb, "RGB")
    if fmt == "GIF":
        img = img.convert("P")
    out = io.BytesIO()
    img.save(out, fmt)
    return out.getvalue()


RESIZES = [(64, 0, ""), (0, 40, ""), (64, 64, "fill"), (200, 200, "fit"), (200, 200, ""),
           (50, 50, "bogus")]


@pytest.mark.parametrize("fmt", ["PNG", "JPEG", "GIF"])
@pytest.mark.parametrize("w, h, mode", RESIZES)
def test_resized_matches_jax(fmt, w, h, mode):
    data = seeded_image(fmt, seed=len(fmt) * 7 + w + h)
    assert images.detect_format(data) == jax_images.detect_format(data) == fmt
    got = images.resized(data, w, h, mode)
    assert got == jax_images.resized(data, w, h, mode)
    if (w, h, mode) == (64, 0, ""):
        assert got[1:] == (64, 53) and got[0] != data


def test_resized_serves_the_original_where_decoding_fails():
    broken = seeded_image("PNG", 3)[:60]
    for data in (b"not an image", broken):
        assert images.resized(data, 32, 32) == jax_images.resized(data, 32, 32)
        assert images.resized(data, 32, 32)[0] is data


THUMBS = ["?width=64", "?width=64&height=64&mode=fill", "?height=30&mode=fit",
          "?width=64&mode=evil%0d%0aX-Injected:%201", "?width=abc", "?width=4000"]


def _post_images(servers, vid, items) -> None:
    for vs in servers:
        vs.store.allocate_volume(vid)
    for nid, cookie, body, mime in items:
        for vs in servers:
            code, _, _ = request(vs, "POST", f"/{FileId(vid, nid, cookie)}", body,
                                 {"Content-Type": mime})
            assert code == 201


def _image_items(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fmt = ("PNG", "JPEG", "GIF")[i % 3]
        body = seeded_image(fmt, seed + i, size=(int(rng.integers(120, 400)),
                                                 int(rng.integers(120, 400))))
        out.append((i + 1, int(rng.integers(0, 1 << 32)), body, f"image/{fmt.lower()}"))
    return out


def _thumbnail_answers(servers, vid, items):
    for nid, cookie, body, _ in items:
        for q in THUMBS:
            jax_ans, port_ans = (request(vs, "GET", f"/{FileId(vid, nid, cookie)}{q}")
                                 for vs in servers)
            assert jax_ans == port_ans, q
            code, hdrs, got = port_ans
            assert code == 200
            if q == "?width=64":
                want = images.resized(body, 64, 0, "")[0]
                assert got == want and got != body
                assert hdrs["etag"].endswith('-64x0"')
                assert hdrs["content-type"] == ("image/png" if body[:4] in (b"\x89PNG", b"GIF8")
                                                else "image/jpeg")
            if "evil" in q:
                assert "X-Injected" not in hdrs["etag"] and hdrs["etag"].endswith('-64x0"')


@pytest.fixture
def image_servers(tmp_path):
    servers = [start("jax", tmp_path / "jax"), start("port", tmp_path / "port")]
    yield servers
    for vs in servers:
        vs.stop()


def test_thumbnail_gets_match_jax(image_servers):
    items = _image_items(31, 6)
    _post_images(image_servers, 3, items)
    _thumbnail_answers(image_servers, 3, items)
    # no dimension asked: the original, its own ETag and type
    nid, cookie, body, mime = items[0]
    answers = [request(vs, "GET", f"/{FileId(3, nid, cookie)}") for vs in image_servers]
    assert answers[0] == answers[1] and answers[1][2] == body
    assert answers[1][1]["content-type"] == mime


def test_thumbnail_over_a_degraded_ec_read_matches_jax(image_servers, monkeypatch):
    """Thumbnails of needles in an EC volume whose data shard 0 is gone:
    each read reconstructs (the JAX server through its CpuBackend, the
    port's through the plain torch version of gf2_apply_planes)."""
    items = _image_items(41, 12)
    _post_images(image_servers, 4, items)
    built = []

    def plain_planes(name, k, m, impl="cuda"):
        built.append(TorchBackend(ECContext(k, m), device="cpu", impl="cuda_planes"))
        return built[-1]

    monkeypatch.setattr(port_ec_volume, "get_backend", plain_planes)
    for vs, encode, ctx, backend in (
            (image_servers[0], jax_ec_encode_volume, JaxECContext(10, 4), JaxCpuBackend),
            (image_servers[1], ec_encode_volume, ECContext(10, 4), None)):
        vol = vs.store.find_volume(4)
        vol.set_read_only(True)
        encode(vol.dat_path[:-4], ctx,
               backend=backend(ctx) if backend else TorchBackend(ctx, device="cpu"))
        vs.store.unmount_volume(4)
        vs.store.ec_remote_reader_factory = None
        vs.store.mount_ec_volume(4)
        vs.store.unmount_ec_shards(4, [0])
    _thumbnail_answers(image_servers, 4, items)
    ev = image_servers[1].store.find_ec_volume(4)
    assert ev.backend is built[-1] and ev.bytes_reconstructed > 0


# --------------------------------------------------------------- pprof


def _get(port: int, path: str) -> tuple[int, bytes]:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


@pytest.mark.parametrize("kind", ["master", "volume"])
def test_debug_pprof_answers_on_both_packages(tmp_path, kind):
    if kind == "master":
        servers = [JaxMasterServer(ip="127.0.0.1", port=allocate_port()),
                   MasterServer(ip="127.0.0.1", port=allocate_port())]
        for s in servers:
            s.start()
    else:
        servers = [start("jax", tmp_path / "jax"), start("port", tmp_path / "port")]
    try:
        for s in servers:
            code, stacks = _get(s.port, "/debug/pprof")
            assert code == 200 and b"thread MainThread" in stacks
            code, gor = _get(s.port, "/debug/pprof/goroutine")
            assert code == 200 and b"(id " in gor
            t0 = time.perf_counter()
            code, prof = _get(s.port, "/debug/pprof/profile?seconds=0.3")
            assert code == 200 and time.perf_counter() - t0 >= 0.3
            assert all(ln.rsplit(" ", 1)[1].isdigit() for ln in prof.decode().splitlines())
    finally:
        for s in servers:
            s.stop()


class _FakeHandler:
    """A BaseHTTPRequestHandler's reply surface, recorded."""

    def __init__(self, peer: str):
        self.client_address = (peer, 40000)
        self.sent: list = []
        self.wfile = io.BytesIO()

    def send_response(self, code):
        self.sent.append(("status", code))

    def send_header(self, k, v):
        self.sent.append((k, v))

    def end_headers(self):
        self.sent.append(("end", None))


@pytest.mark.parametrize("peer", ["10.1.2.3", "192.168.0.7", "127.0.0.1"])
@pytest.mark.parametrize("path", ["/debug/pprof", "/debug/pprof/goroutine"])
def test_loopback_gate_matches_jax(peer, path):
    replies = []
    for mod in (jax_pprof, pprof):
        h = _FakeHandler(peer)
        assert mod.handle_debug_endpoint(h, urlparse(path)) is True
        # a local caller gets this process's stacks: the status and type
        # agree; a remote one gets the same 403 text from both
        remote = peer != "127.0.0.1"
        replies.append((h.sent[0], h.sent[1], h.sent[2] if remote else None,
                        h.wfile.getvalue() if remote else b""))
        assert mod.require_loopback(_FakeHandler(peer), "trace") == (peer == "127.0.0.1")
    assert replies[0] == replies[1]
    if peer != "127.0.0.1":
        assert replies[1][0] == ("status", 403)
        assert replies[1][3] == b"pprof endpoints are loopback-only\n"
    assert pprof.handle_debug_endpoint(_FakeHandler(peer), urlparse("/status")) is False


def test_volume_server_debug_gates_refuse_a_remote_peer(tmp_path, monkeypatch):
    """The volume server's /debug/traces and /debug/pprof go through the
    shared gate: a peer that is not loopback gets 403 from both packages."""
    servers = [start("jax", tmp_path / "jax"), start("port", tmp_path / "port")]
    real = jax_pprof.require_loopback

    def as_remote(mod_real):
        def gate(handler, what="debug"):
            handler.client_address = ("10.9.8.7", handler.client_address[1])
            return mod_real(handler, what)
        return gate

    import seaweedfs_tpu_torch.server.volume_server as port_vs

    monkeypatch.setattr(jax_pprof, "require_loopback", as_remote(real))
    monkeypatch.setattr(pprof, "require_loopback", as_remote(pprof.require_loopback))
    monkeypatch.setattr(port_vs, "require_loopback", pprof.require_loopback)
    try:
        for path in ("/debug/traces", "/debug/pprof"):
            answers = [request(vs, "GET", path) for vs in servers]
            assert answers[0] == answers[1] and answers[1][0] == 403, path
    finally:
        for vs in servers:
            vs.stop()


# ----------------------------------------------------------- telemetry

REPORTS = [
    {"cluster_id": "c-1", "version": "v1", "os": "Linux/x86_64", "volume_count": 3,
     "ec_volume_count": 1, "server_count": 4, "used_size": 1 << 30, "file_count": 77},
    {"cluster_id": "c-2", "version": "v2", "os": "Linux/aarch64", "volume_count": "7",
     "server_count": None, "used_size": 5},
    {"cluster_id": 'c"3\n', "version": "v1", "os": "Darwin/arm64", "file_count": "x"},
    {"cluster_id": "c-1", "version": "v1", "os": "Linux/x86_64", "volume_count": 4,
     "server_count": 4},
    {"version": "v0"},
]


def test_telemetry_server_matches_jax(tmp_path, monkeypatch):
    # one clock for both modules' received_at stamps (their own `time`
    # name, not the process's time module)
    clock = types.SimpleNamespace(time=lambda: 1_700_000_000.5)
    for mod in (jax_ts, port_ts):
        monkeypatch.setattr(mod, "time", clock)
    paths = {"jax": str(tmp_path / "jax.jsonl"), "port": str(tmp_path / "port.jsonl")}
    srvs = {"jax": jax_ts.TelemetryServer(ip="127.0.0.1", port=0, persist_path=paths["jax"]),
            "port": port_ts.TelemetryServer(ip="127.0.0.1", port=0, persist_path=paths["port"])}
    for s in srvs.values():
        s.start()
        for r in REPORTS:
            s.ingest(r)
    assert srvs["port"].summary() == srvs["jax"].summary()
    assert srvs["port"].prometheus() == srvs["jax"].prometheus()
    assert srvs["port"].summary()["clusters"] == 4
    assert open(paths["port"]).read() == open(paths["jax"]).read()
    for s in srvs.values():
        s.stop()
    # reload compacts the JSONL to the latest report per cluster
    again = {k: mod.TelemetryServer(ip="127.0.0.1", port=0, persist_path=paths[k])
             for k, mod in (("jax", jax_ts), ("port", port_ts))}
    for s in again.values():
        s.start()
    # a report without a cluster_id is kept live as "unknown" but not
    # replayed: both packages reload the three named clusters
    assert again["port"].summary() == again["jax"].summary()
    assert again["port"].summary()["clusters"] == 3
    assert open(paths["port"]).read() == open(paths["jax"]).read()
    assert len(open(paths["port"]).read().splitlines()) == 3
    for s in again.values():
        s.stop()


def test_telemetry_http_answers_match_jax():
    srvs = [jax_ts.TelemetryServer(ip="127.0.0.1", port=0),
            port_ts.TelemetryServer(ip="127.0.0.1", port=0)]
    for s in srvs:
        s.start()
    try:
        def call(s, method, path, body=None):
            c = http.client.HTTPConnection("127.0.0.1", s.port, timeout=10)
            c.request(method, path, body=body)
            r = c.getresponse()
            out = r.status, r.getheader("Content-Type"), r.read()
            c.close()
            return out

        for method, path, body in (
                ("POST", "/api/collect", json.dumps(REPORTS[0]).encode()),
                ("POST", "/api/collect/", json.dumps(REPORTS[1]).encode()),
                ("POST", "/api/collect", b"[1, 2]"), ("POST", "/api/collect", b"{bad"),
                ("POST", "/elsewhere", b"{}"), ("GET", "/healthz", None),
                ("GET", "/api/stats", None), ("GET", "/metrics", None), ("GET", "/nope", None)):
            answers = [call(s, method, path, body) for s in srvs]
            assert answers[0] == answers[1], (method, path)
    finally:
        for s in srvs:
            s.stop()
