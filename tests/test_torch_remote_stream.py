"""PyTorch port: remote stream shards, held against the JAX package on the
CPU.

- `sn_recv_file` / `recv_file`: the port's wrapper against the JAX one
  over socketpairs (bytes at an offset, the CRC32C, a short landing
  when the peer closes).
- `utils/security.py`: `sign_jwt` gives the JAX package's tokens under a
  fixed clock, and each package's `verify_jwt` takes the other's tokens
  and refuses what the other refuses.
- `ec/placement.py`: `plan_shard_placement` on seeded random `NodeView`s
  gives the JAX plan, views mutated the same way.
- The blob-write opcode on the wire, both ways (the port's client
  against a JAX `ShardNetPlane` with `resolve_blob`, and the reverse):
  the same file bytes and ACKs, the CRC-mismatch refusal, the status-2
  refusal, the drain-then-refuse answer of a server without a resolver,
  unlink, and the armed-registry gate (`write_plane_admissible`).
- `mq/stream_parity.py`'s remote roots, as the JAX package's
  `test_remote_roots_place_stream_shards_and_recover` and
  `test_net_remote_roots_push_shards_over_write_plane` run them,
  through both packages: the same placements, remote bytes, recovered
  records and unlink ops.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest
from conftest import allocate_port

from seaweedfs_tpu.ec import net_plane as jax_np
from seaweedfs_tpu.ec import placement as jax_pl
from seaweedfs_tpu.mq import stream_parity as jax_sp
from seaweedfs_tpu.utils import native as jax_native
from seaweedfs_tpu.utils import security as jax_sec
from seaweedfs_tpu_torch import faults
from seaweedfs_tpu_torch.ec import net_plane
from seaweedfs_tpu_torch.ec import placement
from seaweedfs_tpu_torch.mq import stream_parity as port_sp
from seaweedfs_tpu_torch.utils import metrics as M
from seaweedfs_tpu_torch.utils import native
from seaweedfs_tpu_torch.utils import security
from seaweedfs_tpu_torch.utils.crc import crc32c

PLANES = {"port": net_plane, "jax": jax_np}
PARITY = {"port": port_sp, "jax": jax_sp}
SIDES = [("port", "jax"), ("jax", "port")]


@pytest.fixture(autouse=True)
def _small_stripes(monkeypatch):
    monkeypatch.setenv("SEAWEED_EC_STREAM_BLOCK_KB", "16")
    monkeypatch.setenv("SEAWEED_EC_STREAM_SMALL_KB", "4")
    monkeypatch.setenv("SEAWEED_EC_STREAM_MAX_LAG_MS", "40")
    monkeypatch.setenv("SEAWEED_EC_STREAM_BACKEND", "cpu")
    monkeypatch.delenv("SEAWEED_EC_STREAM_REMOTE_ROOTS", raising=False)
    monkeypatch.delenv("SEAWEED_JWT_KEY", raising=False)
    faults.clear()
    yield
    faults.clear()


def _msg(i: int) -> tuple[bytes, bytes]:
    return (b"k%06d" % i, b"value-%06d-" % i + b"x" * (900 + i % 191))


MSGS = [(i, 10 + i, *_msg(i)) for i in range(40)]


def _tree(root) -> dict[str, bytes]:
    out = {}
    for dirpath, _d, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


# ------------------------------------------------------------- recv_file


def _land(lib, payload: bytes, path, offset: int, length: int, close_early: bool):
    a, b = socket.socketpair()
    fd = os.open(str(path), os.O_CREAT | os.O_RDWR, 0o644)
    try:
        def send():
            a.sendall(payload)
            if close_early:
                a.close()

        t = threading.Thread(target=send)
        t.start()
        got = lib.recv_file(b.fileno(), fd, offset, length, timeout_ms=10000)
        t.join()
    finally:
        os.close(fd)
        b.close()
        if not close_early:
            a.close()
    return got, path.read_bytes()


@pytest.mark.parametrize("size,offset", [(0, 0), (1, 0), (4096, 7), (256 * 1024 + 3, 0),
                                         (1 << 20, 65536)])
def test_recv_file_matches_jax_wrapper(tmp_path, size, offset):
    """Bytes land at the offset (a hole before it), with the CRC32C of
    what landed, from both packages' wrappers."""
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    got = {name: _land(lib, payload, tmp_path / name, offset, size, False)
           for name, lib in (("port", native), ("jax", jax_native))}
    assert got["port"] == got["jax"]
    (n, crc), data = got["port"]
    assert n == size and crc == crc32c(payload)
    assert data == (bytes(offset) + payload if size else b"")


def test_recv_file_short_when_the_peer_closes_as_jax(tmp_path):
    payload = b"z" * 70000
    got = {name: _land(lib, payload, tmp_path / name, 100, 100000, True)
           for name, lib in (("port", native), ("jax", jax_native))}
    assert got["port"] == got["jax"]
    (n, crc), data = got["port"]
    assert n == len(payload) and crc == crc32c(payload) and data == bytes(100) + payload


# -------------------------------------------------------------------- jwt


@pytest.fixture
def fixed_clock(monkeypatch):
    now = [1_700_000_000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


@pytest.mark.parametrize("key,fid,ttl", [("secret", "blob", 60), ("k", "3,01637037d6", 10),
                                         ("ключ", "7", 1)])
def test_sign_jwt_matches_jax_under_a_fixed_clock(fixed_clock, key, fid, ttl):
    token = security.sign_jwt(key, fid, ttl_seconds=ttl)
    assert token == jax_sec.sign_jwt(key, fid, ttl_seconds=ttl)
    assert security._b64(b"\xff\x00ab") == jax_sec._b64(b"\xff\x00ab")
    assert security._unb64(security._b64(b"xyz")) == b"xyz"


def _tamper(tok: str) -> str:
    h, p, s = tok.split(".")
    return ".".join((h, p, ("A" if s[0] != "A" else "B") + s[1:]))


CASES = {
    "good": lambda sign: (sign("key", "3,ab"), "3,ab", 0),
    "volume_scope": lambda sign: (sign("key", "3"), "3,ab", 0),
    "wrong_fid": lambda sign: (sign("key", "4,ab"), "3,ab", 0),
    "expired": lambda sign: (sign("key", "3,ab"), "3,ab", 11),
    "bad_signature": lambda sign: (_tamper(sign("key", "3,ab")), "3,ab", 0),
    "wrong_key": lambda sign: (sign("other", "3,ab"), "3,ab", 0),
    "malformed": lambda sign: ("a.b", "3,ab", 0),
    "malformed_payload": lambda sign: ("e30." + "!!" + ".x", "3,ab", 0),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("signer,verifier", SIDES)
def test_verify_jwt_takes_and_refuses_what_jax_does(fixed_clock, case, signer, verifier):
    sign = {"port": security.sign_jwt, "jax": jax_sec.sign_jwt}[signer]
    token, fid, later = CASES[case](sign)
    fixed_clock[0] += later
    outcome = {}
    for name, mod in (("port", security), ("jax", jax_sec)):
        try:
            mod.verify_jwt("key", token, fid)
            outcome[name] = "ok"
        except mod.JwtError as e:
            outcome[name] = str(e)
    assert outcome["port"] == outcome["jax"]
    assert (outcome[verifier] == "ok") == (case in ("good", "volume_scope"))


# -------------------------------------------------------------- placement


def _views(mod, seed: int):
    rng = np.random.default_rng(seed)
    views = []
    for i in range(int(rng.integers(2, 8))):
        shards = {int(v): {int(s) for s in rng.choice(14, int(rng.integers(0, 5)), replace=False)}
                  for v in rng.choice(5, int(rng.integers(0, 3)), replace=False)}
        views.append(mod.NodeView(
            id=f"n{i}", rack=f"r{int(rng.integers(0, 3))}",
            free_slots=int(rng.integers(0, 6)),
            free_bytes=int(rng.choice([-1, 0, 1 << 20, 1 << 30, int(rng.integers(0, 1 << 24))])),
            ec_load=float(rng.choice([-1.0, 0.0, float(rng.integers(0, 1 << 26))])),
            ec_breakers_open=int(rng.integers(0, 2)),
            ec_stage_ewma_s=float(rng.choice([-1.0, 0.5, 0.01])),
            ec_chips=int(rng.integers(0, 5)),
            shards=shards,
        ))
    return views


@pytest.mark.parametrize("seed", range(10))
def test_plan_shard_placement_matches_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    vid = int(rng.integers(0, 5))
    sids = [int(s) for s in rng.choice(14, int(rng.integers(1, 14)), replace=False)]
    shard_bytes = int(rng.choice([0, 1 << 16, 1 << 22]))
    pv, jv = _views(placement, seed), _views(jax_pl, seed)
    assert [v.gravity_score() for v in pv] == [v.gravity_score() for v in jv]
    assert [placement.gravity_key(v) for v in pv] == [jax_pl.gravity_key(v) for v in jv]
    plan = placement.plan_shard_placement(pv, vid, sids, shard_bytes=shard_bytes)
    assert plan == jax_pl.plan_shard_placement(jv, vid, sids, shard_bytes=shard_bytes)
    assert [(v.free_slots, v.free_bytes, v.shards) for v in pv] == [
        (v.free_slots, v.free_bytes, v.shards) for v in jv
    ]


@pytest.mark.parametrize("value", [None, "12.5", "junk"])
def test_telemetry_stale_after_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("SEAWEED_EC_TELEMETRY_STALE_S", raising=False)
    else:
        monkeypatch.setenv("SEAWEED_EC_TELEMETRY_STALE_S", value)
    assert placement.telemetry_stale_after() == jax_pl.telemetry_stale_after()


# ------------------------------------------------------- blob-write plane


class BlobPlane:
    """A ShardNetPlane of either package with a `resolve_blob` rooted in a
    directory (the volume server's, confined to its root), recording the
    (op, path) pairs it served; `refuse` makes the resolver refuse the
    whole root (status 2)."""

    def __init__(self, side: str, root, with_resolver: bool = True, port: int = 0):
        self.mod = PLANES[side]
        self.root = str(root)
        self.served: list[tuple[str, str]] = []
        self.refuse = False
        self.server = self.mod.ShardNetPlane(
            "127.0.0.1", port, self._no_shards,
            resolve_blob=self._resolve_blob if with_resolver else None,
        )
        self.server.start()
        self.addr = ("127.0.0.1", self.server.port)

    def _no_shards(self, vid, sid, gen):
        raise self.mod.NetPlaneError("no shards here")

    def _resolve_blob(self, path, op, md):
        if self.refuse:
            raise self.mod.NetPlaneVolumeRefusal("blob root full")
        self.served.append((op, path))
        root = os.path.realpath(self.root)
        full = os.path.realpath(os.path.join(root, path))
        if full != root and not full.startswith(root + os.sep):
            raise self.mod.NetPlaneError("blob path escapes stream root")
        if op == "unlink":
            try:
                os.unlink(full)
            except FileNotFoundError:
                pass
            return None
        os.makedirs(os.path.dirname(full), exist_ok=True)
        return os.open(full, os.O_CREAT | os.O_RDWR, 0o644)

    def stop(self):
        self.server.stop()


@pytest.fixture
def blob_planes():
    made, clients = [], []

    def make(side, root, **kw):
        p = BlobPlane(side, root, **kw)
        made.append(p)
        return p

    def client(side):
        c = PLANES[side].NetPlaneClient(timeout=5.0, connect_timeout=1.0)
        clients.append(c)
        return c

    yield make, client
    for c in clients:
        c.close()
    for p in made:
        p.stop()


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the exception is the result here
        return (type(e).__name__, str(e).split(": ", 1)[-1], getattr(e, "volume_refusal", None))


@pytest.mark.parametrize("server,client_side", SIDES)
def test_wire_interop_write_and_unlink_blob(tmp_path, blob_planes, server, client_side):
    """Extents written at offsets (out of order, with an overwrite) land
    the same file on either server from either client; unlink removes
    it; the connection stays usable after each."""
    make, client = blob_planes
    rng = np.random.default_rng(5)
    ext = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (70000, 1, 300001)]
    srv = make(server, tmp_path / "root")
    c = client(client_side)
    acks = [c.write_blob(srv.addr, "sub/ns/t/0000/gen-00000000.ec01", off, data)
            for off, data in ((70001, ext[2]), (0, ext[0]), (70000, ext[1]), (5, b"over"))]
    blob = (tmp_path / "root" / "sub/ns/t/0000/gen-00000000.ec01").read_bytes()
    want = bytearray(ext[0] + ext[1] + ext[2])
    want[5:9] = b"over"
    assert blob == bytes(want)
    assert acks == [len(ext[2]), len(ext[0]), 1, 4]
    c.unlink_blob(srv.addr, "sub/ns/t/0000/gen-00000000.ec01")
    c.unlink_blob(srv.addr, "sub/ns/t/0000/never-written")
    assert not (tmp_path / "root" / "sub/ns/t/0000/gen-00000000.ec01").exists()
    assert srv.served == [("write", "sub/ns/t/0000/gen-00000000.ec01")] * 4 + [
        ("unlink", "sub/ns/t/0000/gen-00000000.ec01"), ("unlink", "sub/ns/t/0000/never-written")]
    st = srv.server.status()
    assert st["write_requests"] == 6 and st["write_python_bytes"] == 0
    assert st["write_native_bytes"] == sum(len(e) for e in ext) + 4


def _bad_crc_write(mod, c, addr, data):
    extra = {"x-sw-w-kind": "blob", "x-sw-w-path": mod._b64("b/x"),
             "x-sw-w-crc": str(crc32c(data) ^ 1), "x-sw-w-fsync": "1"}
    return c._write_request(addr, 0, 0, 0, 0, data, extra)


@pytest.mark.parametrize("client_side", ["port", "jax"])
def test_refusals_match_jax_servers(tmp_path, blob_planes, client_side):
    """The CRC-mismatch refusal, the status-2 refusal of a full root and
    the drain-then-refuse of a server without a resolver read the same
    from a JAX server as from the port's, and each leaves the connection
    in frame sync (a write after it is served)."""
    make, client = blob_planes
    mod = PLANES[client_side]
    answers = {}
    for srv_side in ("port", "jax"):
        srv = make(srv_side, tmp_path / srv_side)
        bare = make(srv_side, tmp_path / f"{srv_side}-bare", with_resolver=False)
        c = client(client_side)
        got = [_outcome(lambda: _bad_crc_write(mod, c, srv.addr, b"payload" * 100))]
        srv.refuse = True
        got.append(_outcome(lambda: c.write_blob(srv.addr, "b/y", 0, b"abc")))
        srv.refuse = False
        got.append(_outcome(lambda: c.write_blob(bare.addr, "b/z", 0, b"q" * 70000)))
        got.append(_outcome(lambda: c.unlink_blob(bare.addr, "b/z")))
        got.append(_outcome(lambda: c.write_blob(srv.addr, "b/after", 0, b"fine")))
        got.append(_outcome(lambda: c.write_blob(bare.addr, "b/z", 0, b"")))
        answers[srv_side] = got
    assert answers["port"] == answers["jax"]
    crc, full, bare_w, bare_u, after, bare_empty = answers["port"]
    assert crc == ("NetPlaneError", "blob payload CRC mismatch", False)
    assert full == ("NetPlaneError", "blob root full", True)
    assert bare_w == bare_u == bare_empty == ("NetPlaneError", "blob writes not served here", False)
    assert after == ("ok", 4)


@pytest.mark.parametrize("point,served", [("ec.net.write.before_pwrite", True),
                                          ("server.ec_shard_read", False)])
def test_armed_registry_gates_the_write_plane_as_jax(tmp_path, blob_planes, point, served):
    """Armed points inside the write path's own namespaces keep the write
    plane serving; any other armed point refuses writes."""
    from seaweedfs_tpu import faults as jax_faults

    make, client = blob_planes
    answers = {}
    for side, fmod in (("port", faults), ("jax", jax_faults)):
        srv = make(side, tmp_path / side)
        fmod.inject(point, fmod.latency(0.0))
        try:
            assert PLANES[side].write_plane_admissible() is served
            answers[side] = _outcome(lambda: client(side).write_blob(srv.addr, "a/b", 0, b"x" * 9))
        finally:
            fmod.clear()
    assert answers["port"] == answers["jax"]
    assert answers["port"] == (("ok", 9) if served else (
        "NetPlaneError", "fault registry armed: use the fallback transport", False))


def test_encode_meta_and_b64_match_jax():
    extra = {"x-sw-w-kind": "blob", "x-sw-w-path": net_plane._b64("a/b c"), "x-sw-w-jwt": "",
             "x-sw-w-fsync": "1", "x-none": None}
    assert net_plane._encode_meta(extra) == jax_np._encode_meta(extra)
    assert net_plane._encode_meta() == jax_np._encode_meta() == b""
    for raw in (b"", b"\xff\xfe", "päth/ü".encode()):
        assert net_plane._b64(raw) == jax_np._b64(raw)
        assert net_plane._unb64(net_plane._b64(raw)) == raw
    assert net_plane._unb64("!!!") == jax_np._unb64("!!!")


@pytest.mark.parametrize("native_on", [True, False])
def test_land_payload_matches_jax(native_on):
    """The pooled landing of a write payload: the same bytes and CRC on
    the native and the Python plane, as the JAX server lands them."""
    payload = np.random.default_rng(3).integers(0, 256, 300000, dtype=np.uint8).tobytes()
    got = {}
    for side in ("port", "jax"):
        mod = PLANES[side]
        srv = mod.ShardNetPlane("127.0.0.1", 0, lambda *a: None)
        srv.start()
        try:
            a, b = socket.socketpair()
            b.settimeout(5.0)
            row = np.zeros(1 << 19, np.uint8)
            t = threading.Thread(target=a.sendall, args=(payload,))
            t.start()
            if side == "port":
                crc = srv._land_payload(b, row, len(payload), native_on)
            else:
                crc = srv._land_payload(b, row, len(payload), jax_native if native_on else None)
            t.join()
            a.close()
            b.close()
            got[side] = (crc, row[: len(payload)].tobytes())
        finally:
            srv.stop()
    assert got["port"] == got["jax"]
    assert got["port"] == (crc32c(payload), payload)


# --------------------------------------------------- stream parity remote


def _fixed_free(mod, monkeypatch):
    """statvfs headroom as a function of the path's last component, so
    both packages plan against the same numbers (the real call reads a
    filesystem that the other package's run is writing to)."""
    monkeypatch.setattr(mod, "_statvfs_free", lambda path: 1 << 40)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_remote_roots_place_stream_shards_and_recover(tmp_path, monkeypatch, pkg):
    """The JAX package's test, through each package: shards spread over
    two mounted roots as symlinks, recovery reads through them, delete
    leaves no remote byte, and unset keeps every shard local."""
    sp = PARITY[pkg]
    r1, r2 = tmp_path / "hostA", tmp_path / "hostB"
    monkeypatch.setenv("SEAWEED_EC_STREAM_REMOTE_ROOTS", f"hostA={r1},hostB={r2}")
    pp = sp.PartitionParity(str(tmp_path / "local"), "ns", "t", 0)
    for off, ts, k, v in MSGS:
        pp.append_record(off, ts, k, v)
    pp.flush()
    pp.close()
    links = [n for n in os.listdir(pp.dir)
             if n.startswith(sp.GEN_PREFIX) and os.path.islink(os.path.join(pp.dir, n))]
    assert links
    assert _tree(r1) or _tree(r2)
    pp2 = sp.PartitionParity(str(tmp_path / "local"), "ns", "t", 0)
    assert pp2.recover() == MSGS
    pp2.delete()
    assert not _tree(r1) and not _tree(r2)
    monkeypatch.delenv("SEAWEED_EC_STREAM_REMOTE_ROOTS")
    pp3 = sp.PartitionParity(str(tmp_path / "plain"), "ns", "t", 0)
    for off, ts, k, v in MSGS:
        pp3.append_record(off, ts, k, v)
    pp3.flush()
    pp3.close()
    assert not any(os.path.islink(os.path.join(pp3.dir, n)) for n in os.listdir(pp3.dir))


def _mounted_run(sp, base, monkeypatch):
    r1, r2 = base / "hostA", base / "hostB"
    monkeypatch.setenv("SEAWEED_EC_STREAM_REMOTE_ROOTS", f"hostA={r1},hostB={r2}")
    pp = sp.PartitionParity(str(base / "local"), "ns", "t", 0, rotate_bytes=24 * 1024)
    for n, (off, ts, k, v) in enumerate(MSGS, 1):
        pp.append_record(off, ts, k, v)
        if n % 7 == 0:
            pp.flush()
    pp.close()
    links = {n: os.path.relpath(os.readlink(os.path.join(pp.dir, n)), str(base))
             for n in sorted(os.listdir(pp.dir)) if os.path.islink(os.path.join(pp.dir, n))}
    shards = {n: b for n, b in _tree(pp.dir).items() if ".ec" in n}
    remote = {"hostA": _tree(r1), "hostB": _tree(r2)}
    recovered = sp.PartitionParity(str(base / "local"), "ns", "t", 0).recover()
    pruned = sp.PartitionParity(str(base / "local"), "ns", "t", 0)
    removed = pruned.prune(MSGS[-1][0])
    after_prune = {"hostA": sorted(_tree(r1)), "hostB": sorted(_tree(r2))}
    pruned.delete()
    return links, shards, remote, recovered, removed, after_prune, _tree(r1), _tree(r2)


def test_mounted_roots_place_and_recover_as_jax(tmp_path, monkeypatch):
    """Across rotations (24 KiB generations), flushed every 7 records:
    the same symlinks with the same targets, the same shard and remote
    bytes, the same records recovered, the same generations pruned with
    their link targets, and nothing left after delete."""
    _fixed_free(port_sp, monkeypatch)
    _fixed_free(jax_sp, monkeypatch)
    port = _mounted_run(port_sp, tmp_path / "p", monkeypatch)
    jax = _mounted_run(jax_sp, tmp_path / "j", monkeypatch)
    assert port == jax
    links, shards, remote, recovered, removed, after_prune, r1, r2 = port
    assert links and remote["hostA"] and remote["hostB"]
    assert recovered == MSGS and removed >= 1
    for name, rel in links.items():
        host, *_ = rel.split(os.sep)
        assert remote[host][os.path.relpath(rel, host)] == shards[name]
    assert not r1 and not r2


def _net_run(sp, side_server, base, monkeypatch, flush_every):
    gport = allocate_port()
    srv = BlobPlane(side_server, base / "peer_blobs", port=PLANES["port"].derive_port(gport))
    monkeypatch.setenv("SEAWEED_EC_STREAM_REMOTE_ROOTS", f"peer=net:127.0.0.1:{gport}/sub")
    try:
        pp = sp.PartitionParity(str(base / "local"), "ns", "t", 0, rotate_bytes=24 * 1024)
        for n, (off, ts, k, v) in enumerate(MSGS, 1):
            pp.append_record(off, ts, k, v)
            if flush_every and n % flush_every == 0:
                pp.flush()
        pp.flush()
        plans = {os.path.relpath(path, pp.dir): (addr[1] == srv.server.port, rpath)
                 for plan in pp._net_shards.values() for path, (addr, rpath) in plan.items()}
        assert all(not os.path.islink(os.path.join(pp.dir, p)) for p in plans)
        pp.close()
        out = {"plans": plans}
        # the .stream journal carries a random stream uuid: compare shards
        out["local"] = {n: b for n, b in _tree(pp.dir).items() if ".ec" in n}
        out["remote"] = _tree(base / "peer_blobs")
        out["stale"] = sorted(r for p, (_o, r) in plans.items()
                              if out["remote"].get(r, b"") != out["local"][p])
        out["written"] = sorted({p for op, p in srv.served if op == "write"})
        out["recovered"] = sp.PartitionParity(str(base / "local"), "ns", "t", 0).recover()
        pruner = sp.PartitionParity(str(base / "local"), "ns", "t", 0)
        out["removed"] = pruner.prune(MSGS[-1][0])
        out["after_prune"] = sorted(_tree(base / "peer_blobs"))
        pruner.delete()
        out["unlinked"] = sorted({p for op, p in srv.served if op == "unlink"})
        out["left"] = _tree(base / "peer_blobs")
        return out
    finally:
        srv.stop()


@pytest.mark.parametrize("flush_every", [0, 7])
@pytest.mark.parametrize("server", ["port", "jax"])
def test_net_remote_roots_push_shards_as_jax(tmp_path, monkeypatch, server, flush_every):
    """Net roots, each partition against the same kind of server, flushed
    once (the JAX package's test) or every 7 records: the same planned
    shards and remote paths, the same remote bytes, the same blobs
    written, the same records recovered locally, the same unlinks at
    prune and delete, leaving the blob root empty. Every planned data
    shard's remote copy equals its local file at close. Both packages push
    each extent once, so flushed every 7 records a parity shard's remote
    rows of a stripe open at a flush stay stale (ROADMAP Queue 3): the
    same stale parity in both."""
    _fixed_free(port_sp, monkeypatch)
    _fixed_free(jax_sp, monkeypatch)
    received = M.net_bytes_received_total.snapshot()
    port = _net_run(port_sp, server, tmp_path / "p", monkeypatch, flush_every)
    jax = _net_run(jax_sp, server, tmp_path / "j", monkeypatch, flush_every)
    parity = tuple(port_sp.parity_context().to_ext(s) for s in (4, 5))
    assert all(p.endswith(parity) for p in port["stale"])
    assert bool(port["stale"]) == bool(flush_every)
    assert port == jax
    plans, local = port["plans"], port["local"]
    assert plans and all(ours for ours, _ in plans.values())
    assert {p.endswith(parity) for p in plans} == {True, False}
    for path, (_ours, rpath) in plans.items():
        assert rpath.startswith("sub/ns/t/0000/")
    assert port["written"] == sorted(rpath for p, (_o, rpath) in plans.items() if local[p])
    assert port["recovered"] == MSGS
    if flush_every:  # rotations at flush boundaries: prune drops gen 0's blobs
        assert port["removed"] >= 1 and set(port["after_prune"]) < set(port["written"])
    else:
        assert port["removed"] == 0 and port["after_prune"] == port["written"]
    assert set(port["unlinked"]) >= {rpath for _o, rpath in plans.values()}
    assert not port["left"]
    # a port server lands the pushed bytes on the native plane
    moved = M.net_bytes_received_total.snapshot()
    pushed = moved.get(("native", "write"), 0) - received.get(("native", "write"), 0)
    assert (pushed > 0) == (server == "port")
    assert moved.get(("python", "write"), 0) == received.get(("python", "write"), 0)


def test_net_push_remote_copy_equals_local_at_close(tmp_path, monkeypatch):
    """Flushed every 3 records across 24 KiB generations, each net-planned
    data shard's remote copy is the local file, byte for byte, once the
    partition is closed, and each parity shard's remote copy has its
    local file's length (every extent pushed once; its rows of a stripe
    open at a flush are stale, ROADMAP Queue 3); an empty shard pushes
    nothing."""
    gport = allocate_port()
    srv = BlobPlane("port", tmp_path / "blobs", port=net_plane.derive_port(gport))
    monkeypatch.setenv("SEAWEED_EC_STREAM_REMOTE_ROOTS", f"peer=net:127.0.0.1:{gport}")
    parity = tuple(port_sp.parity_context().to_ext(s) for s in (4, 5))
    try:
        pp = port_sp.PartitionParity(str(tmp_path / "local"), "ns", "t", 0,
                                     rotate_bytes=24 * 1024)
        for n, (off, ts, k, v) in enumerate(MSGS, 1):
            pp.append_record(off, ts, k, v)
            if n % 3 == 0:
                pp.flush()
        plans = {path: rpath for plan in pp._net_shards.values()
                 for path, (_a, rpath) in plan.items()}
        pp.close()
        remote = _tree(tmp_path / "blobs")
        assert len(plans) >= 4
        assert {p.endswith(parity) for p in plans} == {True, False}
        for path, rpath in plans.items():
            with open(path, "rb") as f:
                local = f.read()
            if path.endswith(parity):
                assert len(remote.get(rpath, b"")) == len(local), rpath
            else:
                assert remote.get(rpath, b"") == local, rpath
    finally:
        srv.stop()
