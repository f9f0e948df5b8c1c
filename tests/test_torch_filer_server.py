"""PyTorch port: the filer server (seaweedfs_tpu_torch/server/filer_server.py)
with TUS (filer/tus.py), the webhook notifier (filer/notification.py) and
the filer client (client/filer_client.py), held against the JAX package on
the CPU:

- twin filer servers (a JAX `FilerServer` over a JAX master and volume
  server, a port `FilerServer` over a port master and volume server) take
  one seeded sequence of HTTP requests covering every route: listings
  with `limit` and `lastFileName`, `?chunks=true`, full reads and ranges
  (the suffix form, 416, a malformed range that answers 200), ETag, HEAD,
  multipart and chunked-TE PUTs, mkdir by trailing slash and `?mkdir`,
  `mv.from`, `?ttl=` (a bad one answers 400), DELETE with `recursive` and
  409, TUS (OPTIONS, creation, HEAD, three PATCHes with an offset
  mismatch between, termination), `/~meta/tail`, /debug/slo and
  /debug/gateway. Statuses, the named headers and bodies must be equal
  with `Mtime` and `tsNs` masked and chunk fids compared through the bytes
  they read; GET bodies sha256-equal;
- `/~meta/tail`: the wait clamped where the long-poll slots are gone, and
  `droppedBeforeTsNs` after rotation, at the same event in both;
- the saturated pooled front end answers 503 with the same head and body;
- a TLS filer serves https and refuses a plaintext client;
- both packages' `WebhookNotifier`s against one local sink: equal JSON
  payloads in the same order, the same retries of a 5xx and the same drops
  at queue overflow; `make_notifier("kafka")` names item 14b-2, and
  `make_notifier("mq")` (item 14a, tests/test_torch_mq.py) is built;
- `list_dir` and `walk` of both clients against one filer server, paged
  past 1024 entries, strict errors alike.
"""

import hashlib
import http.client
import http.server
import json
import re
import socket
import threading
import time
import types

import numpy as np
import pytest
from conftest import wait_for
from test_torch_filer import norm_record
from test_torch_volume_server import _ports

import seaweedfs_tpu.client.filer_client as j_client
import seaweedfs_tpu.filer.meta_log as j_meta_log
import seaweedfs_tpu.filer.notification as j_notification
import seaweedfs_tpu.filer.tus as j_tus
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.filer import MemoryStore as JaxMemoryStore
from seaweedfs_tpu.filer import SqliteStore as JaxSqliteStore
from seaweedfs_tpu.filer.meta_log import MetaLog as JaxMetaLog
from seaweedfs_tpu.server.filer_server import FilerServer as JaxFilerServer
from seaweedfs_tpu.server.master import MasterServer as JaxMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer
import seaweedfs_tpu_torch.client.filer_client as p_client
import seaweedfs_tpu_torch.filer.meta_log as p_meta_log
import seaweedfs_tpu_torch.filer.notification as p_notification
import seaweedfs_tpu_torch.filer.tus as p_tus
from seaweedfs_tpu_torch.filer import Filer, MemoryStore, SqliteStore
from seaweedfs_tpu_torch.filer.meta_log import MetaLog
from seaweedfs_tpu_torch.server import filer_server as p_filer_server
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils import urls
from seaweedfs_tpu_torch.utils.tls import generate_self_signed

PKGS = {
    "jax": types.SimpleNamespace(master=JaxMasterServer, volume=JaxVolumeServer, filer=JaxFiler,
                                 sqlite=JaxSqliteStore, memory=JaxMemoryStore, meta_log=JaxMetaLog,
                                 server=JaxFilerServer, tus=j_tus, ml_mod=j_meta_log,
                                 notification=j_notification, client=j_client),
    "port": types.SimpleNamespace(master=MasterServer, volume=VolumeServer, filer=Filer,
                                  sqlite=SqliteStore, memory=MemoryStore, meta_log=MetaLog,
                                  server=FilerServer, tus=p_tus, ml_mod=p_meta_log,
                                  notification=p_notification, client=p_client),
}
HEADERS = ("Content-Type", "Content-Length", "X-Filer-Listing", "X-Filer-Chunks", "Content-Range",
           "Accept-Ranges", "ETag", "Tus-Resumable", "Tus-Version", "Tus-Extension", "Tus-Max-Size",
           "Upload-Offset", "Upload-Length", "Location", "Cache-Control", "Retry-After")
CHUNK = 16 * 1024


def http_call(port: int, method: str, path: str, body=None, headers=None):
    """(status, the named headers present, body) of one request."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        data = r.read()
        return r.status, {k: r.getheader(k) for k in HEADERS if r.getheader(k) is not None}, data
    finally:
        c.close()


class Side:
    """One twin: a master, a volume server and a filer server of one
    package, the filer's chunks 16 KiB, its meta log rotating at
    `segment_bytes`, every event it causes kept in `caused`."""

    def __init__(self, name: str, root, monkeypatch):
        pkg = PKGS[name]
        self.name = name
        self.pkg = pkg
        self.mport = _ports()
        self.master = pkg.master(ip="127.0.0.1", port=self.mport, vacuum_interval=3600)
        self.master.start()
        self.vs = pkg.volume([str(root / "v")], master=f"127.0.0.1:{self.mport}", ip="127.0.0.1",
                             port=_ports(), ec_backend="cpu")
        self.vs.start()
        wait_for(lambda: self.master.topo.nodes, timeout=30, msg=f"the {name} server registered")
        self.filer = pkg.filer(pkg.sqlite(str(root / "filer.db")), master=f"127.0.0.1:{self.mport}",
                               chunk_size=CHUNK)
        self.caused = []
        self.filer.subscribe(self.caused.append)
        self.log = pkg.meta_log(str(root / "meta"))
        self.port = _ports()
        self.server = pkg.server(self.filer, ip="127.0.0.1", port=self.port, meta_log=self.log,
                                 http_workers=4)
        self.server.start()
        # the TUS upload ids, from a counter of each package's own
        ids = iter(range(1, 1 << 20))
        monkeypatch.setattr(pkg.tus, "uuid", types.SimpleNamespace(
            uuid4=lambda: types.SimpleNamespace(hex=f"{next(ids):032x}")))

    def call(self, method: str, path: str, body=None, headers=None):
        return http_call(self.port, method, path, body, headers)

    def index_of(self, ts: int):
        """An event's place in what this filer caused, for a tsNs."""
        if ts == 0:
            return 0
        return [e.ts_ns for e in self.caused].index(ts) + 1

    def stop(self):
        self.server.stop()
        self.vs.stop()
        self.master.stop()


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    root = tmp_path_factory.mktemp("filer-server")
    mp = pytest.MonkeyPatch()
    # a meta log that rotates: droppedBeforeTsNs moves in the scenario
    for pkg in PKGS.values():
        mp.setattr(pkg.ml_mod, "SEGMENT_BYTES", 6_000)
        mp.setattr(pkg.ml_mod, "KEEP_SEGMENTS", 2)
    sides = {}
    try:
        for name in PKGS:
            (root / name).mkdir()
            sides[name] = Side(name, root / name, mp)
        yield sides
    finally:
        for s in sides.values():
            s.stop()
        mp.undo()


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def norm(side: Side, status: int, headers: dict, body: bytes):
    """(status, headers, body) with what differs between two clusters and
    two clocks masked: Mtime and tsNs, chunk fids through their bytes."""
    ctype = headers.get("Content-Type", "")
    if ctype == "application/json" and body:
        doc = json.loads(body)
        if headers.get("X-Filer-Listing"):
            for e in doc["Entries"]:
                e["Mtime"] = "<mtime>"
        elif headers.get("X-Filer-Chunks"):
            doc["chunks"] = [sha(side.filer.ops.read(fid)) for fid in doc["chunks"]]
        elif "events" in doc:
            doc = {"events": [norm_record(r) for r in doc["events"]],
                   "lastTsNs": side.index_of(doc["lastTsNs"]),
                   "droppedBeforeTsNs": side.index_of(doc["droppedBeforeTsNs"]),
                   "nowNs": doc["nowNs"] > 0}
        return status, headers, doc
    return status, headers, sha(body)


def multipart(name: str, mime: str, data: bytes) -> tuple[bytes, dict]:
    b = "sw-filer-test-boundary"
    body = (f'--{b}\r\nContent-Disposition: form-data; name="file"; filename="{name}"\r\n'
            f"Content-Type: {mime}\r\n\r\n").encode() + data + f"\r\n--{b}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={b}"}


def scenario(side: Side) -> list:
    rng = np.random.default_rng(25)
    out = []

    def call(method, path, body=None, headers=None):
        r = side.call(method, path, body, headers)
        out.append((method, re.sub(r"sinceNs=\d{6,}", "sinceNs=<ts>", path), norm(side, *r)))
        return r

    big = rng.bytes(5 * CHUNK + 1234)
    small = rng.bytes(300)
    # writes: raw, multipart, chunked transfer encoding, mkdir both ways
    call("PUT", "/docs/small.txt", small, {"Content-Type": "text/plain"})
    body, hdrs = multipart("big.bin", "application/x-test", big)
    call("PUT", "/docs/big.bin", body, hdrs)
    mid = rng.bytes(3 * CHUNK + 7)
    call("PUT", "/docs/streamed.bin", (mid[i:i + 5000] for i in range(0, len(mid), 5000)),
         {"Content-Type": "application/octet-stream"})
    call("POST", "/docs/sub/")
    call("POST", "/other?mkdir=true")
    call("PUT", "/docs/sub/deep/x.bin", rng.bytes(700))
    for i in range(6):
        call("POST", f"/many/f{i:02d}", rng.bytes(int(rng.integers(1, 2000))))
    # ttl: units, a bare number and a bad spec
    call("PUT", "/ttl/minutes?ttl=3m", b"three minutes")
    call("PUT", "/ttl/bare?ttl=45", b"forty-five seconds")
    call("PUT", "/ttl/bad?ttl=xm", b"never written")
    # listings: limit and lastFileName; the root; a HEAD of one
    call("GET", "/docs")
    call("GET", "/many?limit=2")
    call("GET", "/many?limit=2&lastFileName=f01")
    call("GET", "/many?limit=x")
    call("GET", "/")
    call("HEAD", "/many")
    # chunk manifests, reads, ranges, HEAD
    call("GET", "/docs/big.bin?chunks=true")
    call("GET", "/docs/small.txt?chunks=true")
    for path in ("/docs/big.bin", "/docs/small.txt", "/docs/streamed.bin", "/ttl/minutes"):
        call("GET", path)
        call("HEAD", path)
    for rng_hdr in ("bytes=0-9", f"bytes={CHUNK - 5}-{2 * CHUNK + 5}", "bytes=-100",
                    "bytes=-999999999", f"bytes={len(big) - 10}-", f"bytes={len(big)}-",
                    "bytes=20-10", "bytes=abc", "bytes=5-x", "items=0-5", "bytes=0-1,5-6"):
        call("GET", "/docs/big.bin", headers={"Range": rng_hdr})
    call("GET", "/docs/none.bin")
    call("HEAD", "/docs/none.bin")
    # mv.from: a file, a directory, a missing source, onto a directory's child
    call("POST", "/moved/small.txt?mv.from=/docs/small.txt")
    call("POST", "/moved/subdir?mv.from=/docs/sub")
    call("POST", "/moved/none?mv.from=/docs/none.bin")
    call("GET", "/moved/subdir/deep/x.bin")
    call("PUT", "/moved/small.txt/under", b"not under a file")
    # DELETE: a non-empty directory, then recursive, then a file
    call("DELETE", "/moved")
    call("DELETE", "/moved/subdir?recursive=true")
    call("DELETE", "/many/f00")
    call("DELETE", "/many/none")
    call("GET", "/moved")
    # TUS: options, creation, HEAD, three PATCHes with a mismatch between
    call("OPTIONS", "/.tus/")
    tus = rng.bytes(3 * CHUNK + 99)
    st, h, _ = call("POST", "/up/tus.bin", b"", {"Tus-Resumable": "1.0.0",
                                                 "Upload-Length": str(len(tus))})
    loc = h["Location"]
    t = {"Tus-Resumable": "1.0.0"}
    call("HEAD", loc, headers=t)
    cuts = [0, CHUNK + 10, 2 * CHUNK + 77, len(tus)]
    call("PATCH", loc, tus[:cuts[1]], {**t, "Upload-Offset": "0"})
    call("PATCH", loc, tus[cuts[1]:cuts[2]], {**t, "Upload-Offset": "0"})  # a mismatch
    call("HEAD", loc, headers=t)
    call("PATCH", loc, tus[cuts[1]:cuts[2]], {**t, "Upload-Offset": str(cuts[1])})
    call("PATCH", loc, tus + b"x", {**t, "Upload-Offset": str(cuts[2])})  # past the length
    call("PATCH", loc, tus[cuts[2]:], {**t, "Upload-Offset": "nope"})
    call("PATCH", loc, tus[cuts[2]:], {**t, "Upload-Offset": str(cuts[2])})
    call("HEAD", loc, headers=t)  # completed: the session is gone
    call("GET", "/up/tus.bin")
    call("GET", "/up/tus.bin?chunks=true")
    st, h, _ = call("POST", "/up/dropped.bin", b"", {"Tus-Resumable": "1.0.0",
                                                     "Upload-Length": "100"})
    call("PATCH", h["Location"], b"y" * 40, {**t, "Upload-Offset": "0"})
    call("DELETE", h["Location"], headers=t)
    call("DELETE", h["Location"], headers=t)
    call("POST", "/up", b"", {"Tus-Resumable": "1.0.0", "Upload-Length": "5"})  # a directory
    call("POST", "/up/neg.bin", b"", {"Tus-Resumable": "1.0.0", "Upload-Length": "x"})
    call("PATCH", "/docs/big.bin", b"z", {"Upload-Offset": "0"})
    call("HEAD", "/.tus/..", headers=t)
    call("GET", "/.tus")
    # the meta tail: all, from an event on, a limit, bad parameters
    call("GET", "/~meta/tail?sinceNs=0&limit=100000")
    fifth = side.caused[4].ts_ns
    call("GET", f"/~meta/tail?sinceNs={fifth}&limit=3")
    call("GET", f"/~meta/tail?sinceNs={side.caused[-1].ts_ns}&waitSeconds=0")
    call("GET", "/~meta/tail?sinceNs=x")
    # the meta log's rotation: droppedBeforeTsNs at the same event in both
    for i in range(40):
        side.call("PUT", f"/churn/c{i:02d}", rng.bytes(64))
    call("GET", f"/~meta/tail?sinceNs={side.caused[-3].ts_ns}")
    return out


def test_filer_server_routes_match_jax(twins):
    got = {name: scenario(side) for name, side in twins.items()}
    assert len(got["port"]) == len(got["jax"])
    for p, j in zip(got["port"], got["jax"]):
        assert p == j, p[:2]
    # the sequence reached every branch it names
    statuses = {r[2][0] for r in got["port"]}
    assert {200, 201, 204, 206, 400, 404, 405, 409, 413, 416} <= statuses
    tail = [r for r in got["port"] if r[1].startswith("/~meta/tail") and r[2][0] == 200]
    assert tail[-1][2][2]["droppedBeforeTsNs"] > 0
    for side in twins.values():
        assert side.filer.read_file("/up/tus.bin") == side.filer.read_file("/up/tus.bin")


def test_meta_tail_wait_is_clamped_when_the_slots_are_gone(twins):
    """http_workers=4 leaves one long-poll slot: a second waiter gets an
    early empty batch, in both packages."""
    outs = {}
    for name, side in twins.items():
        since = side.log.last_ts_ns
        held = threading.Thread(target=side.call,
                                args=("GET", f"/~meta/tail?sinceNs={since}&waitSeconds=3"))
        held.start()
        wait_for(lambda: side.server._tail_slots._value == 0, timeout=10,
                 msg="the first long-poll took the slot")
        t0 = time.monotonic()
        status, headers, body = side.call("GET", f"/~meta/tail?sinceNs={since}&waitSeconds=20")
        waited = time.monotonic() - t0
        held.join()
        doc = json.loads(body)
        outs[name] = (status, doc["events"], doc["lastTsNs"] == since, waited < 2.5)
        # a slot free again: the wait is served in full up to an event
        t0 = time.monotonic()
        status2, _, _ = side.call("GET", f"/~meta/tail?sinceNs={since}&waitSeconds=0.6")
        outs[name] += (status2, time.monotonic() - t0 >= 0.55)
    assert outs["port"] == outs["jax"] == (200, [], True, True, 200, True)


def test_saturated_front_end_answers_503_alike(tmp_path):
    """One worker and no queue: an idle connection holds the pool, the
    next connect gets the 503 head and JSON body at once."""
    raws = {}
    for name, pkg in PKGS.items():
        f = pkg.filer(pkg.memory(), master="127.0.0.1:1")
        port = _ports()
        fs = pkg.server(f, ip="127.0.0.1", port=port, http_workers=1, http_queue=0)
        fs.start()
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            c.request("GET", "/~meta/tail")  # no meta log: 404
            r = c.getresponse()
            first = (r.status, r.read())
            c.close()
            wait_for(lambda: not fs._http._conns, timeout=30, msg="the pool let the first go")
            hold = socket.create_connection(("127.0.0.1", port))
            wait_for(lambda: len(fs._http._conns) == 1, timeout=30, msg="the pool holds one")
            with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
                data = b""
                while chunk := s.recv(65536):
                    data += chunk
            hold.close()
            raws[name] = (first, data)
        finally:
            fs.stop()
    assert raws["port"] == raws["jax"]
    assert raws["port"][1].startswith(b"HTTP/1.1 503 ") and b"Retry-After: 1" in raws["port"][1]
    assert raws["port"][1].endswith(b'{"error": "filer saturated: worker pool and accept queue '
                                    b'are full"}')


def test_debug_endpoints_answer_alike(twins):
    """/debug/slo and /debug/gateway read each package's process-wide
    registry, which other tests in the process feed too: their shape is
    compared, and the filer's read class in each."""
    docs = {}
    for name, side in twins.items():
        side.call("GET", "/docs")
        slo = side.call("GET", "/debug/slo")
        gw = side.call("GET", "/debug/gateway")
        slo_doc, gw_doc = json.loads(slo[2]), json.loads(gw[2])
        docs[name] = (slo[0], slo[1]["Content-Type"], sorted(slo_doc["filer.read"]), gw[0],
                      gw[1]["Content-Type"], sorted(gw_doc), gw_doc["front_end"]["kind"])
    assert docs["port"] == docs["jax"]
    assert docs["port"][0] == docs["port"][3] == 200 and docs["port"][-1] == "pooled"


def test_tls_filer_serves_https_only(tmp_path, twins):
    certs = generate_self_signed(str(tmp_path / "tls"))
    f = Filer(MemoryStore(), master=f"127.0.0.1:{twins['port'].mport}")
    port = _ports()
    fs = FilerServer(f, ip="127.0.0.1", port=port, tls=certs)
    fs.start()
    try:
        urls.enable_https(certs.ca_file)
        conn = urls.connection(f"https://127.0.0.1:{port}/", 10)
        conn.request("PUT", "/tls/a.txt", body=b"over https")
        assert conn.getresponse().status == 201
        conn.close()
        with urls.urlopen(f"https://127.0.0.1:{port}/tls/a.txt", timeout=10) as r:
            assert r.read() == b"over https"
        assert urls.service_url(f"127.0.0.1:{port}").startswith("https://")
        assert [e["FullPath"] for e in p_client.list_dir(f"127.0.0.1:{port}", "/tls")] == [
            "/tls/a.txt"]
        with pytest.raises(OSError):
            plain = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            plain.request("GET", "/tls/a.txt")
            plain.getresponse()
    finally:
        urls.disable_https()
        fs.stop()


def test_peer_filer_servers_converge_alike(tmp_path):
    """Two filer servers given each other as peers: each follows the
    other through its MetaAggregator, so a write to A lists on B, in both
    packages alike."""
    listings = {}
    for name, pkg in PKGS.items():
        gports = [_ports(), _ports()]
        addrs = [f"127.0.0.1:{g}" for g in gports]
        servers = []
        for i in range(2):
            f = pkg.filer(pkg.memory(), master="127.0.0.1:1")
            fs = pkg.server(f, ip="127.0.0.1", port=_ports(), grpc_port=gports[i],
                            meta_log=pkg.meta_log(str(tmp_path / name / f"meta{i}")),
                            peers=[addrs[1 - i]])
            fs.start()
            servers.append(fs)
        try:
            a, b = (types.SimpleNamespace(call=lambda *r, p=fs.port: http_call(p, *r))
                    for fs in servers)
            assert a.call("POST", "/peer/dir/")[0] == 201
            assert a.call("PUT", "/peer/dir/note.txt", b"from a")[0] == 201
            assert b.call("PUT", "/peer/back.txt", b"from b")[0] == 201

            def listed(side, path):
                status, headers, body = side.call("GET", path)
                if status != 200:
                    return None
                return norm(side, status, headers, body)

            want = [listed(a, "/peer/dir"), listed(b, "/peer")]
            wait_for(lambda: listed(b, "/peer/dir") == want[0] and listed(a, "/peer") == want[1],
                     timeout=30, msg="the peers converge")
            listings[name] = want + [b.call("GET", "/peer/dir/note.txt")[2],
                                     a.call("GET", "/peer/back.txt")[2]]
        finally:
            for fs in servers:
                fs.stop()
    assert listings["port"] == listings["jax"]
    assert listings["port"][2:] == [b"from a", b"from b"]


# ------------------------------------------------------------- notifier


class Sink(http.server.BaseHTTPRequestHandler):
    """One local webhook: records each POST's body; answers the codes in
    `codes` in turn (200 once they run out)."""

    protocol_version = "HTTP/1.1"
    bodies: list = []
    codes: list = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).bodies.append((self.headers["Content-Type"], body))
        code = type(self).codes.pop(0) if type(self).codes else 200
        self.send_response(code)
        self.send_header("Content-Length", "0")
        self.end_headers()


@pytest.fixture
def sink():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    Sink.bodies, Sink.codes = [], []
    yield srv
    srv.shutdown()
    srv.server_close()


def seeded_events(n: int) -> list:
    from seaweedfs_tpu_torch.pb import filer_pb2 as fpb

    rng = np.random.default_rng(26)
    out = []
    for i in range(n):
        ev = fpb.FullEventNotification(directory=f"/d{i % 3}", ts_ns=1_000 + i)
        ev.event.new_entry.name = f"n{i}"
        ev.event.new_entry.content = rng.bytes(int(rng.integers(0, 40)))
        if i % 4 == 1:
            ev.event.old_entry.name = f"o{i}"
            ev.event.delete_chunks = True
        out.append(ev)
    return out


@pytest.mark.parametrize("case", ["delivered", "retried", "rejected", "overflow"])
def test_webhook_notifiers_deliver_alike(sink, case):
    url = f"http://127.0.0.1:{sink.server_address[1]}/hook?x=1"
    events = seeded_events(12)
    got = {}
    for name, pkg in PKGS.items():
        Sink.bodies = []
        Sink.codes = {"delivered": [], "retried": [503, 500], "rejected": [404],
                      "overflow": []}[case]
        if case == "overflow":
            n = pkg.notification.WebhookNotifier(url, max_queue=3)
            n._stop.set()  # the delivery thread parked: the queue fills
            n._thread.join(timeout=5)
            for ev in events:
                n(ev)
            got[name] = (n.dropped, n._q.qsize(), n.delivered)
            n.close()
            continue
        n = pkg.notification.WebhookNotifier(url)
        n.policy = pkg.notification.RetryPolicy(max_attempts=3, base_delay=0.01, max_delay=0.05)
        try:
            for ev in events[:4]:
                n(ev)
            wait_for(lambda: n.delivered + n.dropped == 4, timeout=30, msg="the events handled")
            got[name] = (list(Sink.bodies), n.delivered, n.dropped)
        finally:
            n.close()
    assert got["port"] == got["jax"]
    if case == "delivered":
        ctype, body = got["port"][0][0]
        assert ctype == "application/json"
        assert json.loads(body) == p_notification.event_to_json(events[0])
    if case == "retried":
        assert len(got["port"][0]) == 6 and got["port"][1:] == (4, 0)
    if case == "rejected":
        assert got["port"][1:] == (3, 1)
    if case == "overflow":
        assert got["port"] == (9, 3, 0)


@pytest.mark.parametrize("kind, item", [("mq", "14a"), ("kafka", "14b-2")])
def test_mq_and_kafka_notifiers_name_their_items(kind, item):
    """Kafka's notifier still names its item; MQ's came with item 14a and
    is built, as the JAX one is, where its broker is not up (the topic's
    configure fails quietly; its events run in tests/test_torch_mq.py)."""
    if kind == "mq":
        for pkg in (p_notification, j_notification):
            n = pkg.make_notifier(kind, "127.0.0.1:1")
            assert type(n).__name__ == "MqNotifier" and (n.topic, n.namespace) == (
                "filer-events", "default")
            n.close()
    else:
        with pytest.raises(RuntimeError, match=f"ROADMAP.md item {item}"):
            p_notification.make_notifier(kind, "127.0.0.1:1")
        with pytest.raises(RuntimeError, match=f"ROADMAP.md item {item}"):
            p_notification.KafkaNotifier("127.0.0.1:1")
    with pytest.raises(ValueError):
        p_notification.make_notifier("carrier-pigeon", "x")
    assert p_notification.DELIVERY_POLICY == p_notification.RetryPolicy(
        **{k: getattr(j_notification.DELIVERY_POLICY, k) for k in (
            "max_attempts", "base_delay", "max_delay", "multiplier", "jitter", "deadline")})


# --------------------------------------------------------------- client


def test_filer_clients_list_and_walk_alike(twins):
    side = twins["port"]
    for i in range(1030):
        side.filer.create_entry(_dir_entry(f"/paged/d{i:04d}"))
    side.filer.write_file("/paged/d0001/leaf.txt", b"leaf")
    addr = f"127.0.0.1:{side.port}"
    got = {}
    for name, pkg in PKGS.items():
        c = pkg.client
        out = [len(list(c.list_dir(addr, "/paged"))),
               [e["FullPath"] for e in c.list_dir(addr, "/paged/d0001")],
               list(c.list_dir(addr, "/nowhere")),
               list(c.list_dir(addr, "/paged/d0001/leaf.txt")),
               sorted(e["FullPath"] for e in c.walk(addr, "/docs")),
               len(list(c.walk(addr, "/paged", strict=True))),
               c.filer_url(addr, "a b/é"), c.filer_url(addr, "/x")]
        for path in ("/nowhere", "/paged/d0001/leaf.txt"):
            with pytest.raises(c.FilerListingError) as e:
                list(c.walk(addr, path, strict=True))
            out.append(str(e.value))
        got[name] = out
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1030
    assert issubclass(p_client.FilerListingError, OSError)


def _dir_entry(path: str):
    from seaweedfs_tpu_torch.filer.entry import new_entry

    return new_entry(path, is_directory=True, mode=0o755)
