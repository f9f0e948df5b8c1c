"""PyTorch port: the shard net plane (ec/net_plane.py) and its natives
(csrc/sn_net.h, `sn_send_file`, `sn_sendv`, `sn_recv_into` in
csrc/seaweed_native.cpp), held against the JAX package on the CPU.

- The wrappers: the port's `send_file`, `sendv` and `recv_into` give the
  JAX wrappers' bytes, counts and granule CRCs over socketpairs, with
  the overlapped core forced off, forced on and left to the host.
- Wire interop both ways: the port's client against a JAX
  `ShardNetPlane`, the JAX client against the port's. The same bytes
  and granule CRCs for the ranges (0, whole), (BLOCK, 2 * BLOCK) and
  (17, 301), the same stale-generation refusal, and the same answers
  to needle-read and write frames from a server with no resolvers.
- Peer-fetch rebuild over the wire (RS 4+2, shards of 3 x 4096 + 57
  bytes): native against Python plane with v1 and v2 sidecars,
  bit-identical; a rotten peer caught by the copy-in CRCs, re-read at
  one granule and excluded; a peer dying mid-stream admits nothing; an
  armed registry and SEAWEED_EC_NATIVE=0 route to the Python plane; a
  peer without the plane falls back and is memoized, the memo expires
  and `reset` drops it.
"""

import contextlib
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
from test_torch_peer_rebuild import BLOCK, CTX, JCTX, SHARD_SIZE, synth

from seaweedfs_tpu.ec import net_plane as jax_np
from seaweedfs_tpu.ec.backend import CpuBackend as JaxCpuBackend
from seaweedfs_tpu.ec.peer_rebuild import rebuild_from_peers as jax_rebuild_from_peers
from seaweedfs_tpu.utils import native as jax_native
from seaweedfs_tpu.utils.retry import RetryPolicy as JaxRetryPolicy
from seaweedfs_tpu_torch import faults
from seaweedfs_tpu_torch.ec import ECError, TorchBackend
from seaweedfs_tpu_torch.ec import net_plane
from seaweedfs_tpu_torch.ec.peer_rebuild import (
    PeerFetchTransient,
    rebuild_from_peers,
    staging_dir,
)
from seaweedfs_tpu_torch.utils import metrics as M
from seaweedfs_tpu_torch.utils import native
from seaweedfs_tpu_torch.utils.crc import crc32c
from seaweedfs_tpu_torch.utils.retry import RetryPolicy

FAST = RetryPolicy(max_attempts=3, base_delay=0.0, max_delay=0.0, jitter=0.0)
JFAST = JaxRetryPolicy(max_attempts=3, base_delay=0.0, max_delay=0.0, jitter=0.0)
GEN = 3  # the sidecar generation synth() writes
RANGES = [(0, SHARD_SIZE), (BLOCK, 2 * BLOCK), (17, 301)]


@pytest.fixture(autouse=True)
def _clear_registry():
    faults.clear()
    yield
    faults.clear()


def _overlap_env(mode):
    if mode == "auto":
        os.environ.pop("SEAWEED_EC_NET_OVERLAP", None)
    else:
        os.environ["SEAWEED_EC_NET_OVERLAP"] = mode


@pytest.fixture
def overlap(request):
    prev = os.environ.get("SEAWEED_EC_NET_OVERLAP")
    _overlap_env(request.param)
    yield request.param
    _overlap_env("auto" if prev is None else prev)


# ------------------------------------------------------------ primitives


def _recv(lib, sock, n, granule):
    dst = np.zeros(n, np.uint8)
    cs, fs = np.zeros(1, np.uint32), np.zeros(1, np.uint64)
    oc, cnt = np.zeros(n // max(granule, 1) + 2, np.uint32), np.zeros(1, np.int32)
    got = lib.recv_into(sock.fileno(), dst, n, timeout_ms=10000, granule=granule,
                        crc_state=cs, filled_state=fs, out_crcs=oc, out_counts=cnt)
    return got, dst.tobytes(), oc[: int(cnt[0])].tolist(), int(cs[0]), int(fs[0])


@pytest.mark.parametrize("overlap", ["0", "1", "auto"], indirect=True)
@pytest.mark.parametrize("granule", [1024, 65536])
def test_sendv_recv_into_match_jax_wrappers(overlap, granule):
    """Scatter-gather egress and direct-landing ingress of 512 KiB (past
    the overlap floor): both packages' wrappers land the same bytes with
    the same granule CRCs, each a CRC32C of its granule."""
    payload = np.random.default_rng(9).integers(0, 256, 512 * 1024 + 77, dtype=np.uint8)
    parts = [b"x" * 3000, payload, memoryview(b"tail" * 25)]
    ref = b"".join(bytes(p) for p in parts)
    got = {}
    for name, lib in (("port", native), ("jax", jax_native)):
        a, b = socket.socketpair()
        try:
            sent = []
            t = threading.Thread(target=lambda: sent.append(lib.sendv(a.fileno(), parts, 10000)))
            t.start()
            got[name] = _recv(lib, b, len(ref), granule)
            t.join()
            assert sent == [len(ref)]
        finally:
            a.close()
            b.close()
    assert got["port"] == got["jax"]
    n, data, crcs, tail_crc, filled = got["port"]
    assert n == len(ref) and data == ref
    assert crcs == [crc32c(ref[i * granule : (i + 1) * granule]) for i in range(len(crcs))]
    assert filled == len(ref) % granule and tail_crc == crc32c(ref[len(crcs) * granule :])
    assert native.recv_overlap_active(len(ref)) == jax_native.recv_overlap_active(len(ref))


def test_send_file_offset_and_eof_short_as_jax(tmp_path):
    p = tmp_path / "f"
    payload = bytes(range(256)) * 8
    p.write_bytes(payload)
    fd = os.open(p, os.O_RDONLY)
    try:
        for lib in (native, jax_native):
            a, b = socket.socketpair()
            try:
                assert lib.send_file(a.fileno(), fd, 100, 500, 5000) == 500
                assert b.recv(500, socket.MSG_WAITALL) == payload[100:600]
                # past EOF: a SHORT send, not an error
                assert lib.send_file(a.fileno(), fd, len(payload) - 10, 100, 5000) == 10
                assert b.recv(10, socket.MSG_WAITALL) == payload[-10:]
            finally:
                a.close()
                b.close()
    finally:
        os.close(fd)


@pytest.mark.parametrize("granule", [0, 4])
def test_recv_into_short_on_peer_close_as_jax(granule):
    got = []
    for lib in (native, jax_native):
        a, b = socket.socketpair()
        a.sendall(b"abcdefghij")
        a.close()
        try:
            got.append(_recv(lib, b, 20, granule))
        finally:
            b.close()
    assert got[0] == got[1]
    assert got[0][0] == 10 and got[0][1][:10] == b"abcdefghij"


def test_recv_overlap_env_gate_as_jax():
    """SEAWEED_EC_NET_OVERLAP forces the core gate on or off; the 256 KiB
    floor always applies; both libraries read the same answers."""
    prev = os.environ.get("SEAWEED_EC_NET_OVERLAP")
    try:
        for mode, big in (("1", True), ("0", False), ("", None), ("auto", None)):
            _overlap_env(mode)
            for lib in (native, jax_native):
                assert lib.recv_overlap_active(4096) is False
                want = ((os.cpu_count() or 1) >= 4) if big is None else big
                assert lib.recv_overlap_active(1 << 20) is want, (mode, lib)
    finally:
        _overlap_env("auto" if prev is None else prev)


# -------------------------------------------------------------- harness


class FilePlane:
    """A ShardNetPlane (of either package) serving shard files out of a
    directory, with the generation fence: the stand-in for a peer."""

    def __init__(self, module, directory, generation=GEN, plane_cls=None):
        self.directory = str(directory)
        self.generation = generation
        self._fds: dict[int, int] = {}
        self.module = module
        cls = plane_cls or module.ShardNetPlane
        self.server = cls("127.0.0.1", 0, self._resolve, server_label="test-peer")
        self.server.start()
        self.addr = ("127.0.0.1", self.server.port)

    def _resolve(self, vid, sid, gen):
        if gen and gen != self.generation:
            raise self.module.NetPlaneError("stale generation")
        fd = self._fds.get(sid)
        if fd is None:
            p = os.path.join(self.directory, f"{vid}" + CTX.to_ext(sid))
            if not os.path.exists(p):
                raise self.module.NetPlaneError("shard not local")
            fd = os.open(p, os.O_RDONLY)
            self._fds[sid] = fd
        return fd, os.fstat(fd).st_size

    def close(self):
        self.server.stop()
        for fd in self._fds.values():
            os.close(fd)


@pytest.fixture
def planes():
    made = []

    def make(module, directory, **kw):
        if isinstance(module, str):
            module = {"port": net_plane, "jax": jax_np}[module]
        fp = FilePlane(module, directory, **kw)
        made.append(fp)
        return fp

    clients = []

    def client(module=net_plane, **kw):
        c = module.NetPlaneClient(timeout=5.0, connect_timeout=1.0, **kw)
        clients.append(c)
        return c

    yield make, client
    for c in clients:
        c.close()
    for fp in made:
        fp.close()


def wire_transports(client, addr_by_peer, module=net_plane, transient=PeerFetchTransient):
    """(fetch, fetch_into) over the SAME wire: `fetch` is the Python-plane
    bytes transport (granule re-reads use it too), `fetch_into` the
    native landing transport."""
    log = []

    def fetch(peer, sid, off, size):
        log.append((peer, sid, off, size))
        try:
            return client.read_bytes(addr_by_peer[peer], 1, sid, GEN, off, size)
        except (module.NetPlaneUnavailable, module.NetPlaneError) as e:
            raise transient(str(e)) from e

    fetch_into = module.make_fetch_into(client, 1, GEN, addr_of=lambda peer: addr_by_peer[peer])
    fetch.log = log
    return fetch, fetch_into


def _peer_dir(tmp_path, blobs, name="peer", flip=None):
    d = tmp_path / name
    d.mkdir()
    for i in range(CTX.total):
        blob = bytearray(blobs[i])
        if flip is not None and flip[0] == i:
            blob[flip[1]] ^= 0xFF
        (d / ("1" + CTX.to_ext(i))).write_bytes(bytes(blob))
    return d


# ---------------------------------------------------------- wire interop


@pytest.mark.parametrize("off,size", RANGES)
@pytest.mark.parametrize("server,client_side", [("jax", "port"), ("port", "jax")])
def test_wire_interop_range_bytes_and_crcs(tmp_path, planes, server, client_side, off, size):
    """One package's client against the other's server: read_into lands
    the range with the granule CRCs rolled in the copy-in, read_bytes
    gives the same bytes, and both equal the same package pair's own
    answers."""
    make, client = planes
    _, blobs = synth(tmp_path / "v", local=())
    pdir = _peer_dir(tmp_path, blobs)
    mod = {"port": net_plane, "jax": jax_np}
    ref = blobs[2][off : off + size]
    got = []
    for srv in (server, client_side):  # across the packages, then within one
        fp = make(srv, pdir)
        c = client(mod[client_side])
        dst = np.zeros(size, np.uint8)
        crcs = c.read_into(fp.addr, 1, 2, GEN, off, size, dst, granule=BLOCK)
        got.append((dst.tobytes(), [int(x) for x in crcs], c.read_bytes(fp.addr, 1, 2, GEN, off, size)))
    assert got[0] == got[1]
    data, crcs, raw = got[0]
    assert data == raw == ref
    assert crcs == [crc32c(ref[lo : lo + BLOCK]) for lo in range(0, size, BLOCK)]


@pytest.mark.parametrize("server,client_side", [("jax", "port"), ("port", "jax")])
def test_wire_interop_stale_generation_refusal(tmp_path, planes, server, client_side):
    make, client = planes
    _, blobs = synth(tmp_path / "v", local=())
    fp = make(server, _peer_dir(tmp_path, blobs))
    mod = {"port": net_plane, "jax": jax_np}[client_side]
    c = client(mod)
    with pytest.raises(mod.NetPlaneError, match="stale generation") as e1:
        c.read_bytes(fp.addr, 1, 2, 999, 0, 16)
    with pytest.raises(mod.NetPlaneError, match="stale generation") as e2:
        c.read_into(fp.addr, 1, 2, 999, 0, 16, np.zeros(16, np.uint8), granule=BLOCK)
    assert str(e1.value) == str(e2.value) == f"{fp.addr}: stale generation"
    # the refusal left the connection in sync: the next read is served
    assert c.read_bytes(fp.addr, 1, 2, GEN, 0, 16) == blobs[2][:16]


def _frame(magic, size=0, meta=b""):
    return net_plane._REQ.pack(magic, 1, 7, 9, 0, size, len(meta)) + meta


FRAMES = {
    "needle_read": (_frame(b"SWNR"), b""),
    "needle_write": (_frame(b"SWNW", 5, b"x-sw-w-kind\tneedle"), b"hello"),
    "blob_write": (_frame(b"SWNW", 70000, b"x-sw-w-kind\tblob"), bytes(70000)),
    "unknown_write_kind": (_frame(b"SWNW", 3, b"x-sw-w-kind\tnope"), b"abc"),
    "oversized_needle_write": (_frame(b"SWNW", (64 << 20) + 1, b"x-sw-w-kind\tneedle"), b""),
    "bad_magic": (_frame(b"XXXX"), b""),
}


def _read_n(s, n) -> bytes:
    """Up to n bytes, fewer only where the peer closes or goes quiet."""
    out = b""
    while len(out) < n:
        try:
            got = s.recv(n - len(out))
        except (ConnectionResetError, TimeoutError):
            break
        if not got:
            break
        out += got
    return out


def _exchange(addr, frame, payload) -> tuple[bytes, bytes | str]:
    """Send one raw frame (and its payload), read what comes back, then
    check the connection: the answer to a shard read after it, or
    "closed"."""
    s = socket.create_connection(addr, timeout=2.0)
    try:
        s.sendall(frame + payload)
        answer = _read_n(s, net_plane._RESP.size)
        if not answer:
            return answer, "closed"
        _status, n = net_plane._RESP.unpack(answer)
        answer += _read_n(s, n)
        s.sendall(net_plane._REQ.pack(b"SWNP", 1, 2, GEN, 0, 8, 0))
        return answer, _read_n(s, net_plane._RESP.size + 8)
    finally:
        s.close()


@pytest.mark.parametrize("frame", list(FRAMES))
def test_frames_without_resolvers_answered_as_jax(tmp_path, planes, frame):
    """A server with no needle, write or blob resolver answers the
    needle-read and write opcodes exactly as the JAX package's does: a
    status-1 refusal (after draining a write's payload) that keeps the
    connection in frame sync, or a dropped connection for a desynced
    frame."""
    make, _ = planes
    _, blobs = synth(tmp_path / "v", local=())
    pdir = _peer_dir(tmp_path, blobs)
    answers = [_exchange(make(side, pdir).addr, *FRAMES[frame]) for side in ("jax", "port")]
    assert answers[0] == answers[1]
    answer, after = answers[1]
    if frame in ("unknown_write_kind", "oversized_needle_write", "bad_magic"):
        assert answer == b"" and after == "closed"
    else:
        status, n = net_plane._RESP.unpack(answer[: net_plane._RESP.size])
        assert status == 1 and answer[net_plane._RESP.size :].endswith(b"not served here")
        assert after == net_plane._RESP.pack(0, 8) + blobs[2][:8]


def test_status_keys_match_jax(tmp_path, planes):
    make, client = planes
    _, blobs = synth(tmp_path / "v", local=())
    pdir = _peer_dir(tmp_path, blobs)
    st = []
    for side, mod in (("jax", jax_np), ("port", net_plane)):
        fp = make(side, pdir)
        client(mod).read_bytes(fp.addr, 1, 2, GEN, 0, 100)
        deadline = time.monotonic() + 5
        while fp.server.status()["sendfile_bytes"] < 100 and time.monotonic() < deadline:
            time.sleep(0.005)  # egress counters land after the last byte
        s = fp.server.status()
        s.pop("port")
        st.append(s)
    assert st[0] == st[1]
    assert st[1]["requests"] == 1 and st[1]["sendfile_bytes"] == 100


# ------------------------------------------- peer rebuild over the wire


@pytest.mark.parametrize("leaf", [0, BLOCK])
def test_peer_rebuild_native_vs_python_bit_identical(tmp_path, planes, monkeypatch, leaf):
    """A shard rebuilt from native-plane fetches (sendfile egress,
    recv-into pooled buffers, copy-in CRCs) equals one rebuilt from
    Python-plane fetches over the same wire, and the JAX package's over
    its own plane, and the original. v1 and v2 sidecars, ragged tails,
    multi-chunk streams."""
    from seaweedfs_tpu.ec import peer_rebuild as jax_pr
    from seaweedfs_tpu_torch.ec import peer_rebuild as port_pr

    monkeypatch.setattr(port_pr, "FETCH_CHUNK", 8192)  # several chunks a shard
    monkeypatch.setattr(jax_pr, "FETCH_CHUNK", 8192)
    make, client = planes
    results = {}
    for tag in ("native", "python", "jax"):
        sub = tmp_path / tag
        base, blobs = synth(sub / "local", local=(0,), leaf=leaf, seed=11)
        pdir = _peer_dir(sub, blobs)
        holders = {1: ["p"], 2: ["p"], 3: ["p"], 4: ["p"]}
        if tag == "jax":
            fp = make("jax", pdir)
            from seaweedfs_tpu.ec.peer_rebuild import PeerFetchTransient as JT

            fetch, fetch_into = wire_transports(client(jax_np), {"p": fp.addr}, jax_np, JT)
            rep = jax_rebuild_from_peers(base, holders, fetch, ctx=JCTX, targets=[5],
                                         backend=JaxCpuBackend(JCTX), policy=JFAST,
                                         fetch_into=fetch_into)
            plane = "native"
        else:
            fp = make("port", pdir)
            fetch, fetch_into = wire_transports(client(), {"p": fp.addr})
            rep = rebuild_from_peers(base, holders, fetch, ctx=CTX, targets=[5],
                                     backend=TorchBackend(CTX, device="cpu"), policy=FAST,
                                     fetch_into=fetch_into if tag == "native" else None)
            plane = tag
        assert rep.rebuilt == [5]
        assert set(rep.fetched_plane.values()) == {plane}
        results[tag] = (open(base + CTX.to_ext(5), "rb").read(), rep.fetched)
    assert results["native"] == results["python"] == results["jax"]
    assert results["native"][0] == blobs[5]


def test_copy_in_crc_excludes_rotten_peer_rereading_one_granule(tmp_path, planes):
    """A peer serving rot is caught by the copy-in CRCs, re-read once at
    the granule's width (not the chunk's) through `fetch`, then
    excluded, and the plan re-routes to a clean holder."""
    make, client = planes
    base, blobs = synth(tmp_path / "local", local=(0,))
    bad = make("port", _peer_dir(tmp_path, blobs, "rot", flip=(2, BLOCK + 17)))
    good = make("port", _peer_dir(tmp_path, blobs))
    fetch, fetch_into = wire_transports(client(), {"bad": bad.addr, "good": good.addr})
    rep = rebuild_from_peers(base, {1: ["good"], 2: ["bad", "good"], 3: ["good"], 4: ["good"]},
                             fetch, ctx=CTX, targets=[5], backend=TorchBackend(CTX, device="cpu"),
                             policy=FAST, fetch_into=fetch_into)
    assert rep.rebuilt == [5] and rep.excluded_peers == ["bad"]
    assert rep.fetched == {1: "good", 2: "good", 3: "good"}
    assert set(rep.fetched_plane.values()) == {"native"}
    assert fetch.log == [("bad", 2, BLOCK, BLOCK)], "one re-read, of the bad granule only"
    assert open(base + CTX.to_ext(5), "rb").read() == blobs[5]


class TruncatingPlane(net_plane.ShardNetPlane):
    """Advertises the full length, ships half the bytes, then drops the
    connection: a peer dying mid-sendfile."""

    def _serve_one(self, conn, vid, sid, gen, off, size):
        fd, fsize = self.resolve(vid, sid, gen)
        n = max(0, min(size, fsize - off))
        conn.sendall(net_plane._RESP.pack(0, n))
        conn.sendall(os.pread(fd, n // 2, off))
        return False


def test_mid_stream_death_admits_nothing(tmp_path, planes):
    """Every native landing comes up short, the holder is abandoned after
    its retries, and below k the rebuild refuses: staging wiped, no
    canonical shard file appears."""
    make, client = planes
    base, blobs = synth(tmp_path / "local", local=(0, 1))
    fp = make(net_plane, _peer_dir(tmp_path, blobs), plane_cls=TruncatingPlane)

    def fetch(peer, sid, off, size):  # dead to the Python plane too
        raise PeerFetchTransient("peer down")

    fetch_into = net_plane.make_fetch_into(client(), 1, GEN, addr_of=lambda peer: fp.addr)
    with pytest.raises(ECError, match="refusing"):
        rebuild_from_peers(base, {2: ["p"], 3: ["p"]}, fetch, ctx=CTX, targets=[5],
                           backend=TorchBackend(CTX, device="cpu"), policy=FAST,
                           fetch_into=fetch_into)
    assert sorted(os.listdir(tmp_path / "local")) == ["1.ec00", "1.ec01", "1.ecsum"]
    assert not os.path.exists(staging_dir(base))


@pytest.mark.parametrize("route", ["armed_registry", "native_disabled"])
def test_python_plane_routes_on_both_ends(tmp_path, planes, monkeypatch, route):
    """An armed fault registry (latency only) or SEAWEED_EC_NATIVE=0
    sends every stream over the Python plane even with fetch_into wired:
    the client fetches with `fetch`, the server egresses with pread and
    sendall (no sendfile byte), and the result is bit-identical."""
    make, client = planes
    base, blobs = synth(tmp_path / "local", local=(0,))
    fp = make("port", _peer_dir(tmp_path, blobs))
    fetch, fetch_into = wire_transports(client(), {"p": fp.addr})
    if route == "native_disabled":
        monkeypatch.setenv("SEAWEED_EC_NATIVE", "0")
    received = M.net_bytes_received_total.snapshot()
    armed = route == "armed_registry"
    with faults.injected("ec.peer_fetch.read", faults.latency(0.001), when=faults.every(3)) \
            if armed else contextlib.nullcontext():
        rep = rebuild_from_peers(base, {1: ["p"], 2: ["p"], 3: ["p"]}, fetch, ctx=CTX,
                                 targets=[5], backend=TorchBackend(CTX, device="cpu"),
                                 policy=FAST, fetch_into=fetch_into)
    assert rep.rebuilt == [5] and set(rep.fetched_plane.values()) == {"python"}
    assert open(base + CTX.to_ext(5), "rb").read() == blobs[5]
    st = fp.server.status()
    assert st["sendfile_bytes"] == 0 and st["python_bytes"] == 3 * SHARD_SIZE
    after = M.net_bytes_received_total.snapshot()
    assert after.get(("native", "read"), 0) == received.get(("native", "read"), 0)
    assert after[("python", "read")] - received.get(("python", "read"), 0) == 3 * SHARD_SIZE


def test_peer_without_plane_falls_back_and_is_memoized(tmp_path, planes):
    """A peer whose plane port refuses is a capability miss: the streams
    ride the Python fetch, the rebuild succeeds, and the refused address
    is memoized."""
    make, client = planes
    base, blobs = synth(tmp_path / "local", local=(0,))
    fp = make("port", _peer_dir(tmp_path, blobs))
    c = client()
    dead = ("127.0.0.1", 1)  # port 1: connect refused
    fetch, _ = wire_transports(c, {"p": fp.addr})
    fetch_into = net_plane.make_fetch_into(c, 1, GEN, addr_of=lambda peer: dead)
    rep = rebuild_from_peers(base, {1: ["p"], 2: ["p"], 3: ["p"]}, fetch, ctx=CTX, targets=[5],
                             backend=TorchBackend(CTX, device="cpu"), policy=FAST,
                             fetch_into=fetch_into)
    assert rep.rebuilt == [5] and set(rep.fetched_plane.values()) == {"python"}
    assert open(base + CTX.to_ext(5), "rb").read() == blobs[5]
    assert list(c._no_plane) == [dead]


def _free_port() -> int:
    hold = socket.socket()
    hold.bind(("127.0.0.1", 0))
    port = hold.getsockname()[1]
    hold.close()  # nothing listens here now
    return port


@pytest.mark.parametrize("how", ["ttl", "reset"])
def test_no_plane_memo_expires_or_resets(tmp_path, planes, how):
    """The no-plane memo is not forever: a sidecar that comes up later
    is re-probed once the TTL has passed, or at once after `reset`."""
    make, client = planes
    _, blobs = synth(tmp_path / "v", local=())
    pdir = _peer_dir(tmp_path, blobs)
    port = _free_port()
    c = client(unavailable_ttl=0.3 if how == "ttl" else 3600.0)
    addr = ("127.0.0.1", port)
    with pytest.raises(net_plane.NetPlaneUnavailable):
        c.read_bytes(addr, 1, 2, GEN, 0, 64)
    fp = FilePlane(net_plane, pdir)
    fp.server.stop()
    srv = net_plane.ShardNetPlane("127.0.0.1", port, fp._resolve)
    srv.start()
    try:
        with pytest.raises(net_plane.NetPlaneUnavailable):  # memoized: no connect
            c.read_bytes(addr, 1, 2, GEN, 0, 64)
        assert srv.requests == 0
        if how == "ttl":
            time.sleep(0.35)
        else:
            c.reset(addr)
        assert c.read_bytes(addr, 1, 2, GEN, 0, 64) == blobs[2][:64]
    finally:
        srv.stop()


def test_derive_port_and_net_addr_match_jax():
    for p in (8080, 18080, 55535, 55536, 65535):
        assert net_plane.derive_port(p) == jax_np.derive_port(p)
        assert net_plane.net_addr(f"10.0.0.7:{p}") == jax_np.net_addr(f"10.0.0.7:{p}")
    assert net_plane._REQ.size == jax_np._REQ.size == 38
    assert struct.calcsize("<BQ") == net_plane._RESP.size
