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
- The needle opcodes across the packages, each way: needle reads on both
  landing planes, a CRC mismatch, refusals (status 1 and 2) with the
  connection kept, an armed registry, concurrent readers on the pool,
  idle pooled connections discarded, the JAX chunk reader
  negative-caching a port plane's volume refusals only; needle writes on
  both planes, a volume refusal, no resolver, a stored-CRC mismatch and
  foreign chaos; the same `status()` after the same traffic; the same
  fid written over the plane by either client and over HTTP landing the
  same record on either package's volume server.
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

from seaweedfs_tpu import faults as jax_faults
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


# --------------------------------------------------------- needle opcodes
# The needle-read and needle-write opcodes across the two packages: a JAX
# client against a port server and a port client against a JAX server.

MODS = {"port": net_plane, "jax": jax_np}
FAULTS = {"port": faults, "jax": jax_faults}
PAIRS = [("jax", "port"), ("port", "jax")]  # (server, client)
PAIR_IDS = ["jax_server-port_client", "port_server-jax_client"]


def _settle(fn, timeout=5.0):
    """Egress counters land after the last payload byte is on the wire:
    poll briefly rather than race the serving thread."""
    deadline = time.monotonic() + timeout
    while not fn() and time.monotonic() < deadline:
        time.sleep(0.005)
    return fn()


def _needle_server(mod, tmp_path, payload=b"", crc=None, resolve=None, resolve_write=None,
                   with_needles=True):
    """A plane of package `mod` serving needle (7, 0xABC, 0x55) from a file,
    or the given resolvers."""
    p = tmp_path / f"needle-{id(mod)}-{time.monotonic_ns()}.dat"
    p.write_bytes(b"HDR!" + payload + b"TRAILER")
    want = crc32c(payload) if crc is None else crc

    def resolve_needle(vid, nid, cookie):
        assert (vid, nid, cookie) == (7, 0xABC, 0x55)
        return os.open(p, os.O_RDONLY), 4, len(payload), want, True

    def refuse_shards(vid, sid, gen):
        raise mod.NetPlaneError("no shards here")

    srv = mod.ShardNetPlane("127.0.0.1", 0, refuse_shards, server_label="needle-test",
                            resolve_needle=(resolve or resolve_needle) if with_needles else None,
                            resolve_write=resolve_write)
    srv.start()
    return srv


@pytest.fixture
def needle_env():
    made = []

    def server(side, *a, **kw):
        srv = _needle_server(MODS[side], *a, **kw)
        made.append(srv)
        return srv

    def client(side, **kw):
        c = MODS[side].NetPlaneClient(timeout=5.0, connect_timeout=1.0, **kw)
        made.append(c)
        return c

    yield server, client
    for x in made:
        (x.close if hasattr(x, "close") else x.stop)()


@pytest.mark.parametrize("plane", ["native", "python"])
@pytest.mark.parametrize("server,client_side", PAIRS, ids=PAIR_IDS)
def test_needle_read_roundtrip_across_packages(tmp_path, needle_env, monkeypatch, plane, server,
                                               client_side):
    """A whole needle over the needle-read opcode, byte-exact on both
    landing planes; the server counts its egress on the right plane and
    the second read reuses the pooled connection."""
    if plane == "python":
        monkeypatch.setenv("SEAWEED_EC_NATIVE", "0")
    make, client = needle_env
    payload = np.random.default_rng(3).integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    srv = make(server, tmp_path, payload)
    c = client(client_side)
    addr = ("127.0.0.1", srv.port)
    assert c.read_needle(addr, 7, 0xABC, 0x55) == payload
    assert srv.needle_requests == 1
    if plane == "native":
        assert _settle(lambda: srv.sendfile_bytes == len(payload)) and srv.python_bytes == 0
    else:
        assert _settle(lambda: srv.python_bytes == len(payload)) and srv.sendfile_bytes == 0
    assert c.read_needle(addr, 7, 0xABC, 0x55) == payload
    assert len(c._npool[addr]) == 1 and srv.needle_requests == 2


@pytest.mark.parametrize("server,client_side", PAIRS, ids=PAIR_IDS)
def test_needle_read_crc_mismatch_refused_across_packages(tmp_path, needle_env, server, client_side):
    make, client = needle_env
    payload = b"q" * 70_000
    srv = make(server, tmp_path, payload, crc=crc32c(payload) ^ 0xDEAD)
    c = client(client_side)
    with pytest.raises(MODS[client_side].NetPlaneError, match="needle CRC mismatch"):
        c.read_needle(("127.0.0.1", srv.port), 7, 0xABC, 0x55)


@pytest.mark.parametrize("status", [1, 2])
@pytest.mark.parametrize("server,client_side", PAIRS, ids=PAIR_IDS)
def test_needle_read_refusals_across_packages(tmp_path, needle_env, server, client_side, status):
    """A resolver's refusal reaches the other package's client with its
    message, flagged as a volume refusal for status 2 only, and the
    connection stays in sync: the shard opcode answers next."""
    make, client = needle_env
    smod = MODS[server]
    exc = smod.NetPlaneVolumeRefusal if status == 2 else smod.NetPlaneError

    def refuse(vid, nid, cookie):
        raise exc("volume not here (or EC)")

    srv = make(server, tmp_path, resolve=refuse)
    c = client(client_side)
    addr = ("127.0.0.1", srv.port)
    with pytest.raises(MODS[client_side].NetPlaneError, match="not here") as e:
        c.read_needle(addr, 7, 0xABC, 0x55)
    assert getattr(e.value, "volume_refusal", False) is (status == 2)
    with pytest.raises(MODS[client_side].NetPlaneError, match="no shards"):
        c.read_bytes(addr, 1, 0, 0, 0, 10)
    assert srv.needle_requests == 0


@pytest.mark.parametrize("server,client_side", PAIRS, ids=PAIR_IDS)
def test_needle_read_refused_while_faults_armed_across_packages(tmp_path, needle_env, server,
                                                                client_side):
    make, client = needle_env
    payload = b"z" * 10_000
    srv = make(server, tmp_path, payload)
    c = client(client_side)
    addr = ("127.0.0.1", srv.port)
    reg = FAULTS[server]
    with reg.injected("unrelated.point", reg.latency(0.0), when=reg.always()):
        with pytest.raises(MODS[client_side].NetPlaneError, match="registry armed"):
            c.read_needle(addr, 7, 0xABC, 0x55)
    assert c.read_needle(addr, 7, 0xABC, 0x55) == payload


@pytest.mark.parametrize("server,client_side", PAIRS, ids=PAIR_IDS)
def test_needle_reads_fan_out_concurrently_across_packages(tmp_path, needle_env, server,
                                                           client_side):
    """12 readers at once each check a connection out: every payload
    exact, the pool bounded."""
    make, client = needle_env
    payload = np.random.default_rng(5).integers(0, 256, 120_000, dtype=np.uint8).tobytes()
    srv = make(server, tmp_path, payload)
    c = client(client_side)
    addr = ("127.0.0.1", srv.port)
    errs = []

    def rd():
        try:
            assert c.read_needle(addr, 7, 0xABC, 0x55) == payload
        except Exception as e:  # noqa: BLE001 — fails the assert below
            errs.append(e)

    threads = [threading.Thread(target=rd) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and srv.needle_requests == 12
    assert 1 <= sum(len(v) for v in c._npool.values()) <= c._npool_max


@pytest.mark.parametrize("server", ["jax", "port"])
def test_needle_pool_discards_idle_connections(tmp_path, needle_env, server):
    """A pooled connection parked past the idle TTL is discarded at
    checkout: the next read dials fresh instead of failing on it."""
    make, client = needle_env
    payload = b"idle" * 2000
    srv = make(server, tmp_path, payload)
    c = client("port")
    c._npool_idle_s = 0.05
    addr = ("127.0.0.1", srv.port)
    assert c.read_needle(addr, 7, 0xABC, 0x55) == payload
    for s, _t in c._npool[addr]:
        s.close()  # the server reaping the parked connection
    time.sleep(0.1)
    assert c.read_needle(addr, 7, 0xABC, 0x55) == payload


@pytest.mark.parametrize("level", ["volume", "needle"])
def test_jax_operations_negative_caches_port_volume_refusals_only(tmp_path, needle_env, level):
    """The JAX client's chunk reader against a port plane: a volume refusal
    (status 2) is negative-cached per volume, so later reads skip the
    plane; a needle-level refusal (status 1) is not."""
    from seaweedfs_tpu.client.operations import Operations
    from seaweedfs_tpu.storage.file_id import FileId as JaxFileId

    make, _ = needle_env
    exc = net_plane.NetPlaneVolumeRefusal if level == "volume" else net_plane.NetPlaneError

    def refuse(vid, nid, cookie):
        raise exc("volume not here (or EC)" if level == "volume" else f"needle {nid:x} not found")

    srv = make("port", tmp_path, resolve=refuse)
    assert srv.port > 11023  # derive_port(grpc) must not wrap
    ops = Operations(master="localhost:1")
    try:
        loc = type("Loc", (), {"url": "127.0.0.1:80", "grpc_port": srv.port - 10000})()
        assert ops._try_plane_read(loc, JaxFileId(9, 0xABC, 0x55)) is None
        first = srv.requests
        assert ops._try_plane_read(loc, JaxFileId(9, 0xDEF, 0x55)) is None
        if level == "volume":
            assert 9 in ops._plane_refused and srv.requests == first
        else:
            assert 9 not in ops._plane_refused and srv.requests == first + 1
    finally:
        ops.close()


def _land_writes():
    stored = {}

    def resolve_write(vid, nid, cookie, data, md):
        stored[(vid, nid)] = (cookie, data, dict(md))
        return len(data), crc32c(data)

    return stored, resolve_write


@pytest.mark.parametrize("plane", ["native", "python"])
@pytest.mark.parametrize("server,client_side", PAIRS, ids=PAIR_IDS)
def test_needle_write_roundtrip_across_packages(tmp_path, needle_env, monkeypatch, plane, server,
                                                client_side):
    """One needle over the write opcode on both landing planes: the
    resolver sees the payload and its meta, the ACK certifies the stored
    CRC, the server counts the ingress on the right plane. A ragged size
    takes the fused CRC's tail."""
    if plane == "python":
        monkeypatch.setenv("SEAWEED_EC_NATIVE", "0")
    make, client = needle_env
    stored, resolve_write = _land_writes()
    payload = np.random.default_rng(7).integers(0, 256, 300_001, dtype=np.uint8).tobytes()
    srv = make(server, tmp_path, resolve_write=resolve_write)
    c = client(client_side)
    addr = ("127.0.0.1", srv.port)
    size, crc = c.write_needle(addr, 7, 0xABC, 0x55, payload, name=b"f.bin",
                               mime=b"application/x-test", fsync=True, replicate=False)
    assert size == len(payload) and crc == crc32c(payload)
    cookie, data, md = stored[(7, 0xABC)]
    assert cookie == 0x55 and data == payload
    assert (md["x-sw-w-fsync"], md["x-sw-w-replicate"]) == ("1", "0")
    assert net_plane._unb64(md["x-sw-w-name"]) == b"f.bin"
    assert net_plane._unb64(md["x-sw-w-mime"]) == b"application/x-test"
    native_bytes, python_bytes = (len(payload), 0) if plane == "native" else (0, len(payload))
    assert (srv.write_requests, srv.write_native_bytes, srv.write_python_bytes) == (
        1, native_bytes, python_bytes)
    c.write_needle(addr, 7, 0xDEF, 0x66, b"x")
    assert srv.write_requests == 2 and len(c._npool[addr]) == 1


@pytest.mark.parametrize("server,client_side", PAIRS, ids=PAIR_IDS)
def test_needle_write_volume_refusal_across_packages(tmp_path, needle_env, server, client_side):
    """A volume-level write refusal (status 2) is flagged as one, and the
    pooled connection survives it: the server drained the payload."""
    make, client = needle_env

    def refuse(vid, nid, cookie, data, md):
        raise MODS[server].NetPlaneVolumeRefusal("volume not here")

    srv = make(server, tmp_path, resolve_write=refuse)
    c = client(client_side)
    addr = ("127.0.0.1", srv.port)
    with pytest.raises(MODS[client_side].NetPlaneError, match="not here") as e:
        c.write_needle(addr, 1, 2, 3, b"zz" * 5000)
    assert getattr(e.value, "volume_refusal", False)
    with pytest.raises(MODS[client_side].NetPlaneError, match="not here"):
        c.write_needle(addr, 1, 9, 3, b"y")
    assert srv.write_requests == 2, "the refusal killed the connection"


@pytest.mark.parametrize("server,client_side", PAIRS, ids=PAIR_IDS)
def test_needle_write_without_resolver_refused_across_packages(tmp_path, needle_env, server,
                                                               client_side):
    make, client = needle_env
    srv = make(server, tmp_path)
    c = client(client_side)
    with pytest.raises(MODS[client_side].NetPlaneError, match="needle writes not served here"):
        c.write_needle(("127.0.0.1", srv.port), 1, 2, 3, b"data")
    assert srv.write_requests == 0


@pytest.mark.parametrize("server,client_side", PAIRS, ids=PAIR_IDS)
def test_needle_write_stored_crc_mismatch_raises_across_packages(tmp_path, needle_env, server,
                                                                 client_side):
    make, client = needle_env

    def liar(vid, nid, cookie, data, md):
        return len(data), crc32c(data) ^ 0xBAD

    srv = make(server, tmp_path, resolve_write=liar)
    c = client(client_side)
    with pytest.raises(MODS[client_side].NetPlaneError, match="stored CRC mismatch"):
        c.write_needle(("127.0.0.1", srv.port), 1, 2, 3, b"abc")


@pytest.mark.parametrize("server,client_side", PAIRS, ids=PAIR_IDS)
def test_needle_write_refused_under_foreign_chaos_across_packages(tmp_path, needle_env, server,
                                                                  client_side):
    """An armed point outside the write path refuses write frames (drained,
    in protocol); a point on the write path leaves them served."""
    make, client = needle_env
    stored, resolve_write = _land_writes()
    srv = make(server, tmp_path, resolve_write=resolve_write)
    c = client(client_side)
    addr = ("127.0.0.1", srv.port)
    reg = FAULTS[server]
    with reg.injected("unrelated.point", reg.latency(0.0), when=reg.always()):
        with pytest.raises(MODS[client_side].NetPlaneError, match="registry armed"):
            c.write_needle(addr, 1, 2, 3, b"k" * 100)
    with reg.injected("ec.net.write.before_pwrite", reg.latency(0.0), when=reg.always()):
        c.write_needle(addr, 1, 2, 3, b"served")
    assert stored[(1, 2)][1] == b"served"


@pytest.mark.parametrize("server,client_side", PAIRS, ids=PAIR_IDS)
def test_needle_status_matches_jax_after_reads_and_writes(tmp_path, needle_env, server, client_side):
    make, client = needle_env
    _stored, resolve_write = _land_writes()
    st = []
    for side in (server, client_side):
        srv = make(side, tmp_path, b"s" * 5000, resolve_write=resolve_write)
        c = client(client_side)
        addr = ("127.0.0.1", srv.port)
        c.read_needle(addr, 7, 0xABC, 0x55)
        c.write_needle(addr, 1, 2, 3, b"w" * 9000)
        assert _settle(lambda: srv.status()["sendfile_bytes"] == 5000)
        s = srv.status()
        s.pop("port")
        st.append(s)
    assert st[0] == st[1]
    assert (st[1]["needle_requests"], st[1]["write_requests"], st[1]["write_native_bytes"]) == (
        1, 1, 9000)


# --------------------------------- the plane against HTTP on a volume server


@pytest.mark.parametrize("server", ["jax", "port"])
def test_write_bit_identity_plane_vs_http_on_volume_servers(tmp_path, server):
    """The same fid written over the write opcode (by either package's
    client) and by an HTTP multipart POST lands the same record (append
    time normalised) on either package's volume server; the needle-read
    opcode gives the payload back to both clients."""
    from test_torch_volume_server import canon, multipart, record, request, start

    vs = start(server, tmp_path / server)
    clients = [net_plane.NetPlaneClient(timeout=10), jax_np.NetPlaneClient(timeout=10)]
    try:
        vs.store.allocate_volume(4)
        addr = ("127.0.0.1", vs.net_plane.port)
        payload = np.random.default_rng(11).integers(0, 256, 123_457, dtype=np.uint8).tobytes()
        nid, cookie = 0x1F2E, 0x5A5A5A5A
        raws = []
        for c in clients:
            assert c.write_needle(addr, 4, nid, cookie, payload, name=b"same.bin",
                                  mime=b"application/x-test")[0] > len(payload)
            raws.append(record(vs, 4, nid))
        body, hdrs = multipart(payload, "same.bin", "application/x-test")
        assert request(vs, "POST", f"/4,{nid:x}{cookie:08x}", body, hdrs)[0] == 201
        raws.append(record(vs, 4, nid))
        assert len({canon(r) for r in raws}) == 1 and len({len(r) for r in raws}) == 1
        assert vs.net_plane.write_requests == 2
        for c in clients:
            assert c.read_needle(addr, 4, nid, cookie) == payload
    finally:
        for c in clients:
            c.close()
        vs.stop()
