"""PyTorch port: the volume server's gRPC service and cluster half
(server/volume_grpc.py, client/master_client.py, pb/, ec/fleet.py,
ec/placement.py `node_view_for`, `NetPlaneClient.fetch_shard_to_file`),
held against the JAX package's VolumeServer on the CPU, in mixed
clusters on the JAX `MasterServer` (port servers on ec_backend="cpu"
beside JAX servers):

- VolumeEcShardsGenerate: shards, .ecx, .vif and .ecsum sha256-identical
  (the encoders' clock pinned: the generation is a time stamp), and the
  master's topology fed by port heartbeats equal to the one fed by JAX
  heartbeats; VolumeServerStatus, ScrubEcVolume and CopyFile alike;
- VolumeEcShardsCopy over the shard net plane and over CopyFile, each way
  between the packages, identical; a rotten source refused with DATA_LOSS;
- VolumeEcShardRead: the same bytes, FAILED_PRECONDITION for a stale
  generation, NOT_FOUND for a shard that is not local;
- peer-fetch rebuild (`from_peers`) at a subset holder of either package
  fed by a peer of the other: the same rebuilt, fetched, distributed and
  repaired lists, shard files identical to the encoded ones; a degraded
  GET through the remote shard reader bit-exact; EC deletes reaching
  every holder; VolumeEcShardsToVolume giving the original .dat;
- replicated writes (HTTP POST, the plane leg and the gRPC leg) landing
  byte-equal records on the other package's replica, and deletes;
- where the master lookup fails, the JAX server acknowledges a replicated
  write with one copy and the port refuses it; where the master answers
  and names no other holder, both acknowledge it with one copy;
- the port's `MasterServer` (which replaced the smoke's stand-in master)
  answering lookups, topology and the KeepConnected snapshot as the JAX
  `MasterServer` does for the same heartbeats (tests/test_torch_master.py
  holds the rest of the master);
- the port's volume service has every RPC of the JAX one
  (tests/test_torch_volume_admin.py holds the admin RPCs of plain volumes
  against the JAX server).
"""

import hashlib
import http.client
import os
import shutil
import threading
import types
import uuid

import grpc
import numpy as np
import pytest
from conftest import allocate_port, wait_for
from test_torch_volume_server import _ports

import seaweedfs_tpu.ec.encoder as jax_encoder
from seaweedfs_tpu.pb import cluster_pb2 as jpb
from seaweedfs_tpu.pb import rpc as jrpc
from seaweedfs_tpu.server.master import MasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer
import seaweedfs_tpu_torch.ec.encoder as port_encoder
from seaweedfs_tpu_torch.ec.placement import node_view_for
from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server.volume_server import FAN_OUT_REFUSED, VolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import actual_offset

TOTAL = 14
MOVED = list(range(4, TOTAL))  # the subset holder keeps shards 0-3, fewer than k
PKGS = ("port", "jax")


def server(pkg: str, directory, master: str):
    cls = VolumeServer if pkg == "port" else JaxVolumeServer
    vs = cls([str(directory)], master=master, ip="127.0.0.1", port=_ports(), ec_backend="cpu")
    vs.start()
    return vs


class Cluster:
    """A JAX MasterServer and volume servers of the named packages."""

    def __init__(self, root, pkgs):
        self.mport = allocate_port()
        self.master = MasterServer(ip="127.0.0.1", port=self.mport)
        self.master.start()
        self.vols = [server(pkg, root / f"{pkg}{i}", f"127.0.0.1:{self.mport}")
                     for i, pkg in enumerate(pkgs)]
        wait_for(lambda: len(self.master.topo.nodes) >= len(pkgs),
                 msg="volume servers did not register")
        self._channels = []

    def stub(self, vs):
        ch = grpc.insecure_channel(f"127.0.0.1:{vs.grpc_port}")
        self._channels.append(ch)
        return jrpc.volume_stub(ch)  # the JAX stub knows every RPC

    def locs(self, vid):
        return {sid: [loc.url for loc in locs]
                for sid, locs in self.master.topo.lookup_ec(vid).items()}

    def stop(self):
        for ch in self._channels:
            ch.close()
        for vs in self.vols:
            vs.stop()
        self.master.stop()


def needles(seed: int, n: int, hi: int):
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(1, 1 << 20), n, replace=False)
    return [(int(nid), int(rng.integers(1, 1 << 32)), rng.bytes(int(rng.integers(1, hi))))
            for nid in ids]


def volume_files(d, vid: int, items) -> str:
    """A sealed volume's .dat and .idx written through the port's Store;
    returns its base path."""
    store = Store([str(d)], ec_backend="cpu")
    vol = store.allocate_volume(vid)
    for nid, cookie, body in items:
        store.write_needle(vid, Needle(cookie=cookie, needle_id=nid, data=body))
    base = vol.dat_path[:-4]
    store.close()
    return base


def place(base: str, vs, vid: int) -> None:
    """Copy a volume's files into a server's directory."""
    d = vs.store.locations[0].directory
    for ext in (".dat", ".idx"):
        shutil.copy(base + ext, os.path.join(d, f"{vid}{ext}"))


def sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def ec_base(vs, vid: int) -> str:
    return os.path.join(vs.store.locations[0].directory, str(vid))


def pinned_clock(monkeypatch, ns: int) -> None:
    """Both encoders stamp the generation with time.time_ns(), in those
    modules only (the servers' threads read the real clock), and the
    sidecar with a uuid4."""
    for mod in (jax_encoder, port_encoder):
        fake = types.SimpleNamespace(**{k: getattr(mod.time, k) for k in dir(mod.time)
                                        if not k.startswith("__")})
        fake.time_ns = lambda: ns
        monkeypatch.setattr(mod, "time", fake)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=ns))


def hreq(vs, method: str, path: str, body: bytes | None = None):
    c = http.client.HTTPConnection("127.0.0.1", vs.port, timeout=60)
    try:
        c.request(method, path, body=body)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def canon(raw: bytes) -> bytes:
    n = Needle.from_bytes(bytes(raw))
    n.append_at_ns = 1
    return n.to_bytes()


def record(vs, vid: int, nid: int) -> bytes:
    vol = vs.store.find_volume(vid)
    nv = vol.needle_map.get(nid)
    return canon(vol._pread_record(actual_offset(nv.offset), nv.size))


# ------------------------------------------------------- generate and friends

GEN_VID = 11
GEN_NS = 1_760_000_000_123_456_789


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """A JAX master, two port and two JAX servers; the first of each
    package generates the same volume's shards and mounts them."""
    root = tmp_path_factory.mktemp("mixed")
    c = Cluster(root, ["port", "jax", "port", "jax"])
    items = needles(21, 40, 60_000)
    base = volume_files(root / "src", GEN_VID, items)
    mp = pytest.MonkeyPatch()
    try:
        pinned_clock(mp, GEN_NS)
        gens = []
        for vs in c.vols[:2]:
            place(base, vs, GEN_VID)
            st = c.stub(vs)
            assert not st.VolumeMount(jpb.AllocateVolumeRequest(volume_id=GEN_VID), timeout=30).error
            gens.append(st.VolumeEcShardsGenerate(
                jpb.EcShardsGenerateRequest(volume_id=GEN_VID, backend="cpu"), timeout=120).generation)
            st.VolumeEcShardsMount(jpb.EcShardsMountRequest(volume_id=GEN_VID), timeout=30)
    finally:
        mp.undo()
    yield c, items, gens
    c.stop()


def test_generate_gives_identical_files(mixed):
    c, _items, gens = mixed
    assert gens == [GEN_NS, GEN_NS]
    port, jax = c.vols[0], c.vols[1]
    exts = [f".ec{i:02d}" for i in range(TOTAL)] + [".ecx", ".vif", ".ecsum"]
    for ext in exts:
        assert sha(ec_base(port, GEN_VID) + ext) == sha(ec_base(jax, GEN_VID) + ext), ext


def test_topology_from_port_heartbeats_equals_jax(mixed):
    c, _items, _gens = mixed
    port, jax = c.vols[0], c.vols[1]

    def node(vs):
        return c.master.topo.nodes[f"127.0.0.1:{vs.port}"]

    wait_for(lambda: all(GEN_VID in node(vs).ec_shards and GEN_VID in node(vs).volumes
                         for vs in (port, jax)), msg="heartbeats did not bring the shards")
    a, b = node(port), node(jax)
    assert dict(a.volumes) == dict(b.volumes) and dict(a.ec_shards) == dict(b.ec_shards)
    assert (a.max_volume_count, a.rack, a.data_center) == (b.max_volume_count, b.rack, b.data_center)
    assert a.grpc_port == port.grpc_port and a.public_url == f"127.0.0.1:{port.port}"
    assert set(a.ec_telemetry) == set(b.ec_telemetry)
    hbs = [vs.cluster._full_heartbeat() if vs is port else vs._full_heartbeat() for vs in (port, jax)]
    for hb in hbs:
        hb.ClearField("ec_telemetry_json")
        hb.ClearField("port")
        hb.ClearField("public_url")
        hb.ClearField("grpc_port")
    assert hbs[0] == hbs[1]
    # the master's lookups name both
    assert sorted(c.locs(GEN_VID)[0]) == sorted(f"127.0.0.1:{vs.port}" for vs in (port, jax))


def test_status_scrub_and_copyfile_match_jax(mixed):
    c, _items, _gens = mixed
    answers = []
    for vs in c.vols[:2]:
        st = c.stub(vs)
        status = st.VolumeServerStatus(jpb.VolumeServerStatusRequest(), timeout=30)
        scrub = st.ScrubEcVolume(jpb.ScrubRequest(volume_id=GEN_VID), timeout=60)
        files = {ext: b"".join(ch.data for ch in st.CopyFile(
            jpb.CopyFileRequest(volume_id=GEN_VID, ext=ext, start_offset=7, stop_offset=70_007),
            timeout=30)) for ext in (".ec03", ".ecx", ".dat")}
        with pytest.raises(grpc.RpcError) as e:
            list(st.CopyFile(jpb.CopyFileRequest(volume_id=GEN_VID, ext=".nope"), timeout=30))
        answers.append((status, scrub, files, e.value.code()))
    assert answers[0] == answers[1]
    assert answers[0][1].checked == TOTAL and not answers[0][1].bad_shards
    assert answers[0][3] == grpc.StatusCode.NOT_FOUND


def test_ec_shard_read_matches_jax(mixed):
    c, _items, gens = mixed
    for sid, off, size in ((0, 0, 100), (5, 12_345, 300_000), (13, 1 << 20, 1000)):
        got = [b"".join(ch.data for ch in c.stub(vs).VolumeEcShardRead(
            jpb.EcShardReadRequest(volume_id=GEN_VID, shard_id=sid, offset=off, size=size,
                                   generation=gens[0]), timeout=30)) for vs in c.vols[:2]]
        assert got[0] == got[1] and len(got[0]) == min(size, max(0, os.path.getsize(
            ec_base(c.vols[0], GEN_VID) + f".ec{sid:02d}") - off))
    for req, code in ((dict(shard_id=1, generation=gens[0] + 1), grpc.StatusCode.FAILED_PRECONDITION),
                      (dict(shard_id=1, generation=0, volume_id=99), grpc.StatusCode.NOT_FOUND)):
        codes = []
        for vs in c.vols[:2]:
            with pytest.raises(grpc.RpcError) as e:
                list(c.stub(vs).VolumeEcShardRead(
                    jpb.EcShardReadRequest(**{"volume_id": GEN_VID, "offset": 0, "size": 10, **req}),
                    timeout=30))
            codes.append((e.value.code(), e.value.details()))
        assert codes[0] == codes[1] and codes[0][0] == code


@pytest.mark.parametrize("path", ["native", "copyfile"])
def test_shard_copies_match_across_packages(mixed, monkeypatch, path):
    """Port -> JAX and JAX -> port, over the shard net plane and over
    CopyFile (SEAWEED_EC_NATIVE=0): every copied file identical to the
    source's."""
    c, _items, _gens = mixed
    if path == "copyfile":
        monkeypatch.setenv("SEAWEED_EC_NATIVE", "0")
    for src, dst in ((c.vols[0], c.vols[3]), (c.vols[1], c.vols[2])):
        c.stub(dst).VolumeEcShardsCopy(jpb.EcShardsCopyRequest(
            volume_id=GEN_VID, shard_ids=[2, 9, 13], source_url=f"127.0.0.1:{src.grpc_port}",
            copy_ecx=True, copy_ecj=True, copy_vif=True, copy_ecsum=True), timeout=60)
        for ext in (".ec02", ".ec09", ".ec13", ".ecx", ".vif", ".ecsum"):
            assert sha(ec_base(dst, GEN_VID) + ext) == sha(ec_base(src, GEN_VID) + ext), ext
        c.stub(dst).VolumeEcShardsDelete(jpb.EcShardsDeleteRequest(
            volume_id=GEN_VID, shard_ids=[2, 9, 13]), timeout=30)
        assert not any(os.path.exists(ec_base(dst, GEN_VID) + ext)
                       for ext in (".ec02", ".ecx", ".ecsum"))


def test_native_copy_rides_the_net_plane(mixed):
    """A port destination lands shards over the source's net plane: its
    `sw_net_bytes_received_total{plane="native"}` moves by the shard's
    size, and the source's plane served it."""
    from seaweedfs_tpu_torch.utils import metrics as M

    c, _items, _gens = mixed
    src, dst = c.vols[1], c.vols[2]  # a JAX source, a port destination
    size = os.path.getsize(ec_base(src, GEN_VID) + ".ec06")
    before = M.net_bytes_received_total.snapshot().get(("native", "read"), 0)
    requests0 = src.net_plane.requests
    c.stub(dst).VolumeEcShardsCopy(jpb.EcShardsCopyRequest(
        volume_id=GEN_VID, shard_ids=[6], source_url=f"127.0.0.1:{src.grpc_port}",
        copy_ecx=True, copy_vif=True, copy_ecsum=True), timeout=60)
    assert M.net_bytes_received_total.snapshot().get(("native", "read"), 0) - before == size
    assert src.net_plane.requests == requests0 + 1
    assert sha(ec_base(dst, GEN_VID) + ".ec06") == sha(ec_base(src, GEN_VID) + ".ec06")
    c.stub(dst).VolumeEcShardsDelete(jpb.EcShardsDeleteRequest(volume_id=GEN_VID, shard_ids=[6]),
                                     timeout=30)


def test_rotten_source_copy_refused_with_data_loss(mixed):
    c, _items, _gens = mixed
    codes = []
    for src, dst in ((c.vols[0], c.vols[3]), (c.vols[1], c.vols[2])):
        path = ec_base(src, GEN_VID) + ".ec04"
        with open(path, "r+b") as f:
            f.seek(1000)
            b = f.read(1)
            f.seek(1000)
            f.write(bytes([b[0] ^ 0x5A]))
        try:
            with pytest.raises(grpc.RpcError) as e:
                c.stub(dst).VolumeEcShardsCopy(jpb.EcShardsCopyRequest(
                    volume_id=GEN_VID, shard_ids=[4], source_url=f"127.0.0.1:{src.grpc_port}",
                    copy_ecx=True, copy_vif=True, copy_ecsum=True), timeout=60)
            codes.append(e.value.code())
            assert not os.path.exists(ec_base(dst, GEN_VID) + ".ec04")
        finally:
            with open(path, "r+b") as f:
                f.seek(1000)
                f.write(b)
            c.stub(dst).VolumeEcShardsDelete(jpb.EcShardsDeleteRequest(
                volume_id=GEN_VID, shard_ids=[4]), timeout=30)
    assert codes == [grpc.StatusCode.DATA_LOSS] * 2


def test_unported_rpc_answers_unimplemented(mixed):
    """No RPC of the JAX servicer is left unported: the port's
    VOLUME_SERVICE has every row of the JAX one, with the same request
    type, response type and streaming kind, and a port server answers each
    (none UNIMPLEMENTED). Only a method neither package has is answered
    UNIMPLEMENTED."""
    port_rows = rpc.SERVICES[rpc.VOLUME_SERVICE]
    jax_rows = jrpc.SERVICES[jrpc.VOLUME_SERVICE]
    assert set(port_rows) == set(jax_rows) and len(port_rows) == 31
    for name, (kind, req_t, resp_t) in jax_rows.items():
        assert port_rows[name][0] == kind, name
        # one cluster.proto per process: both packages hold the same classes
        assert port_rows[name][1] is req_t and port_rows[name][2] is resp_t, name
    c, _items, _gens = mixed
    st = c.stub(c.vols[0])
    for call, req in ((st.VolumeCopy, jpb.EcShardsCopyRequest(volume_id=GEN_VID)),
                      (st.VolumeMarkReadonly, jpb.VolumeCommandRequest(volume_id=GEN_VID + 1000)),
                      (st.ReadVolumeFileStatus, jpb.VolumeFileStatusRequest(volume_id=GEN_VID + 1000))):
        assert call(req, timeout=30).error  # answered: a plain volume is not here
    ch = grpc.insecure_channel(f"127.0.0.1:{c.vols[0].grpc_port}")
    try:
        missing = ch.unary_unary(f"/{rpc.VOLUME_SERVICE}/NoSuchRpc",
                                 request_serializer=jpb.VolumeCommandRequest.SerializeToString,
                                 response_deserializer=jpb.VolumeCommandResponse.FromString)
        with pytest.raises(grpc.RpcError) as e:
            missing(jpb.VolumeCommandRequest(volume_id=GEN_VID), timeout=30)
        assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        ch.close()


def test_needle_rpcs_match_jax(mixed):
    """AllocateVolume, WriteNeedle, ReadNeedle, DeleteNeedle, VolumeUnmount,
    VolumeMount and VolumeDelete over gRPC: the same answers, and the
    same records with the append time normalised."""
    c, _items, _gens = mixed
    items = needles(31, 6, 20_000)
    answers = []
    for vs in c.vols[:2]:
        st = c.stub(vs)
        out = [st.AllocateVolume(jpb.AllocateVolumeRequest(volume_id=41), timeout=30)]
        for nid, cookie, body in items:
            out.append(st.WriteNeedle(jpb.WriteNeedleRequest(
                volume_id=41, needle_id=nid, cookie=cookie, data=body, name="n.bin",
                mime="application/x-t", flags=0), timeout=30))
        for nid, cookie, _ in items[:3]:
            r = st.ReadNeedle(jpb.ReadNeedleRequest(volume_id=41, needle_id=nid, cookie=cookie),
                              timeout=30)
            r.ClearField("last_modified")
            out.append(r)
        out.append(st.ReadNeedle(jpb.ReadNeedleRequest(volume_id=41, needle_id=5, cookie=1),
                                 timeout=30))
        out.append(st.DeleteNeedle(jpb.DeleteNeedleRequest(volume_id=41, needle_id=items[0][0]),
                                   timeout=30))
        out.append(st.DeleteNeedle(jpb.DeleteNeedleRequest(volume_id=41, needle_id=7), timeout=30))
        out.append([record(vs, 41, nid) for nid, _c, _b in items[1:]])
        out.append(st.VolumeUnmount(jpb.VolumeCommandRequest(volume_id=41), timeout=30))
        out.append(st.VolumeMount(jpb.AllocateVolumeRequest(volume_id=41), timeout=30))
        out.append(st.VolumeDelete(jpb.VolumeCommandRequest(volume_id=41), timeout=30))
        out.append(st.VolumeDelete(jpb.VolumeCommandRequest(volume_id=41), timeout=30))
        answers.append(out)
    assert answers[0] == answers[1]


# --------------------------------------------------- peer-fetch rebuild, both ways

SPLIT_VID = 12


def split_ec_volume(c: Cluster, holder, other, vid: int, items):
    """Encode one volume on `holder`, then split its shards so `holder` is
    a subset holder (4 of 14, below k) and `other` holds the rest. Returns
    the encoded shards' bytes."""
    base = volume_files(holder.store.locations[0].directory + "-src", vid, items)
    place(base, holder, vid)
    st_h, st_o = c.stub(holder), c.stub(other)
    st_h.VolumeMount(jpb.AllocateVolumeRequest(volume_id=vid), timeout=30)
    st_h.VolumeEcShardsGenerate(jpb.EcShardsGenerateRequest(volume_id=vid, backend="cpu"),
                                timeout=120)
    st_h.VolumeEcShardsMount(jpb.EcShardsMountRequest(volume_id=vid), timeout=30)
    st_h.VolumeDelete(jpb.VolumeCommandRequest(volume_id=vid), timeout=30)
    hbase = ec_base(holder, vid)
    ground = {i: open(hbase + f".ec{i:02d}", "rb").read() for i in range(TOTAL)}
    st_o.VolumeEcShardsCopy(jpb.EcShardsCopyRequest(
        volume_id=vid, shard_ids=MOVED, source_url=f"127.0.0.1:{holder.grpc_port}",
        copy_ecx=True, copy_ecj=True, copy_vif=True, copy_ecsum=True), timeout=120)
    st_o.VolumeEcShardsMount(jpb.EcShardsMountRequest(volume_id=vid), timeout=30)
    st_h.VolumeEcShardsUnmount(jpb.EcShardsUnmountRequest(volume_id=vid, shard_ids=MOVED),
                               timeout=30)
    st_h.VolumeEcShardsDelete(jpb.EcShardsDeleteRequest(volume_id=vid, shard_ids=MOVED),
                              timeout=30)
    wait_for(lambda: len(c.locs(vid)) == TOTAL and all(len(v) == 1 for v in c.locs(vid).values()),
             msg="the shard split did not reach the master")
    return ground


def cluster_heal(root, holder_pkg: str) -> dict:
    """One peer-fetch scenario at a subset holder of `holder_pkg` fed by a
    peer of the other package; returns what a client observes."""
    other_pkg = "jax" if holder_pkg == "port" else "port"
    c = Cluster(root, [holder_pkg, other_pkg])
    try:
        holder, other = c.vols
        items = needles(41, 30, 50_000)
        ground = split_ec_volume(c, holder, other, SPLIT_VID, items)
        seen: dict = {}
        # a degraded GET on `other` (shards 4-13) of a needle on shard 0:
        # the remote shard reader fetches its interval from the holder
        nid, cookie, body = items[0]
        fid = f"/{FileId(SPLIT_VID, nid, cookie)}"
        seen["remote_get"] = hreq(other, "GET", fid)
        assert seen["remote_get"] == (200, body)
        # quarantine shard 0 at the holder and lose shard 13 at `other`
        hbase = ec_base(holder, SPLIT_VID)
        os.replace(hbase + ".ec00", hbase + ".ec00.bad")
        holder.store.unmount_ec_shards(SPLIT_VID, [0])
        st_o = c.stub(other)
        st_o.VolumeEcShardsUnmount(jpb.EcShardsUnmountRequest(volume_id=SPLIT_VID, shard_ids=[13]),
                                   timeout=30)
        st_o.VolumeEcShardsDelete(jpb.EcShardsDeleteRequest(volume_id=SPLIT_VID, shard_ids=[13]),
                                  timeout=30)
        holder.notify_deleted_ec_shards(SPLIT_VID, "", [0])
        wait_for(lambda: not c.locs(SPLIT_VID).get(0) and not c.locs(SPLIT_VID).get(13),
                 msg="the losses did not reach the master")
        # the local rebuild refuses: 3 local shards < k
        with pytest.raises(grpc.RpcError) as e:
            c.stub(holder).VolumeEcShardsRebuild(jpb.EcShardsRebuildRequest(volume_id=SPLIT_VID),
                                                 timeout=60)
        seen["local_rebuild"] = e.value.code()
        r = c.stub(holder).VolumeEcShardsRebuild(
            jpb.EcShardsRebuildRequest(volume_id=SPLIT_VID, from_peers=True), timeout=120)
        seen["lists"] = (list(r.rebuilt_shard_ids), list(r.fetched_shard_ids),
                         list(r.distributed_shard_ids), list(r.repaired_shard_ids))
        for sid in (0, 13):
            assert open(hbase + f".ec{sid:02d}", "rb").read() == ground[sid], sid
        wait_for(lambda: c.locs(SPLIT_VID).get(0) == [f"127.0.0.1:{holder.port}"]
                 and c.locs(SPLIT_VID).get(13) == [f"127.0.0.1:{holder.port}"],
                 msg="the rebuilt shards are not advertised")
        # a re-run is an idempotent no-op
        r2 = c.stub(holder).VolumeEcShardsRebuild(
            jpb.EcShardsRebuildRequest(volume_id=SPLIT_VID, from_peers=True), timeout=120)
        seen["rerun"] = (list(r2.rebuilt_shard_ids), list(r2.distributed_shard_ids))
        # an EC delete at the holder reaches `other`'s journal
        nid, cookie, _ = items[1]
        fid = f"/{FileId(SPLIT_VID, nid, cookie)}"
        seen["delete"] = hreq(holder, "DELETE", fid)[0]
        seen["after_delete"] = (hreq(holder, "GET", fid)[0], hreq(other, "GET", fid)[0])
        # decode at the holder once it has every data shard
        c.stub(holder).VolumeEcShardsCopy(jpb.EcShardsCopyRequest(
            volume_id=SPLIT_VID, shard_ids=list(range(4, 10)),
            source_url=f"127.0.0.1:{other.grpc_port}"), timeout=120)
        c.stub(holder).VolumeEcShardsToVolume(
            jpb.EcShardsToVolumeRequest(volume_id=SPLIT_VID), timeout=120)
        # the last needle is live, so the decoded .dat is the whole original
        seen["decoded_dat_is_original"] = (
            sha(hbase + ".dat") == sha(holder.store.locations[0].directory + f"-src/{SPLIT_VID}.dat"))
        seen["decoded_reads"] = [hreq(holder, "GET", f"/{FileId(SPLIT_VID, n, ck)}")[0]
                                 for n, ck, _ in items[:4]]
        return seen
    finally:
        c.stop()


def test_peer_fetch_rebuild_matches_across_packages(tmp_path):
    runs = {pkg: cluster_heal(tmp_path / pkg, pkg) for pkg in PKGS}
    assert runs["port"] == runs["jax"]
    lists = runs["port"]["lists"]
    assert lists[0] == [0, 13] and len(lists[1]) == 7 and lists[2] == [13] and lists[3] == []
    assert runs["port"]["local_rebuild"] == grpc.StatusCode.FAILED_PRECONDITION
    assert runs["port"]["rerun"] == ([], [])
    assert runs["port"]["after_delete"] == (404, 404)
    assert runs["port"]["decoded_reads"] == [200, 404, 200, 200]
    assert runs["port"]["decoded_dat_is_original"]


# ------------------------------------------------------------- replica fan-out

REP_VID = 51


@pytest.mark.parametrize("native", [True, False], ids=["plane-leg", "grpc-leg"])
def test_replicated_writes_land_equal_records(tmp_path, monkeypatch, native):
    """A POST to a `001` volume on either package lands the same record on
    the other package's replica, over the plane leg (the replica's plane
    counts the write) or the gRPC leg (SEAWEED_EC_NATIVE=0: it does not);
    deletes fan out."""
    if not native:
        monkeypatch.setenv("SEAWEED_EC_NATIVE", "0")
    c = Cluster(tmp_path, ["port", "jax"])
    try:
        for vs in c.vols:
            c.stub(vs).AllocateVolume(jpb.AllocateVolumeRequest(volume_id=REP_VID,
                                                                replication="001"), timeout=30)
        wait_for(lambda: len(c.master.topo.lookup(REP_VID)) == 2, msg="replicas not registered")
        items = needles(61, 8, 30_000)
        for i, (nid, cookie, body) in enumerate(items):
            src, dst = (c.vols[i % 2], c.vols[1 - i % 2])
            writes0 = dst.net_plane.write_requests
            status, answer = hreq(src, "POST", f"/{FileId(REP_VID, nid, cookie)}", body)
            assert status == 201, answer
            assert dst.net_plane.write_requests - writes0 == (1 if native else 0)
            assert record(src, REP_VID, nid) == record(dst, REP_VID, nid)
        nid, cookie, _ = items[0]
        assert hreq(c.vols[0], "DELETE", f"/{FileId(REP_VID, nid, cookie)}")[0] == 202
        assert [hreq(vs, "GET", f"/{FileId(REP_VID, nid, cookie)}")[0] for vs in c.vols] == [404] * 2
    finally:
        c.stop()


def test_failed_master_lookup_port_refuses_jax_acknowledges(tmp_path):
    """On purpose: with no master answering, the JAX server acknowledges a
    replicated write with one copy; the port refuses it (and a delete),
    and still takes a write to a volume that asks for one copy."""
    dead = allocate_port()
    out = {}
    for pkg in PKGS:
        vs = server(pkg, tmp_path / pkg, f"127.0.0.1:{dead}")
        try:
            vs.store.allocate_volume(REP_VID, replica_placement="001")
            vs.store.allocate_volume(REP_VID + 1)
            out[pkg] = (hreq(vs, "POST", f"/{FileId(REP_VID, 5, 7)}", b"x" * 100),
                        hreq(vs, "DELETE", f"/{FileId(REP_VID, 5, 7)}")[0],
                        hreq(vs, "POST", f"/{FileId(REP_VID + 1, 5, 7)}", b"y" * 100)[0])
        finally:
            vs.stop()
    assert out["jax"][0][0] == 201 and out["jax"][1] == 202
    assert out["port"][0][0] == 500 and FAN_OUT_REFUSED in out["port"][0][1].decode()
    assert out["port"][1] == 500
    assert out["port"][2] == out["jax"][2] == 201


def test_master_naming_one_holder_acknowledges_one_copy(tmp_path):
    """The refusal covers a failed lookup only: where the master answers
    and names no other holder of a `001` volume (its second holder never
    registered it), both packages acknowledge the write and the delete
    with one copy, and the other server holds nothing."""
    c = Cluster(tmp_path, ["port", "jax"])
    try:
        out = {}
        for i, pkg in enumerate(PKGS):
            vs, other = c.vols[i], c.vols[1 - i]
            vid = REP_VID + 10 + i
            c.stub(vs).AllocateVolume(jpb.AllocateVolumeRequest(volume_id=vid, replication="001"),
                                      timeout=30)
            wait_for(lambda: len(c.master.topo.lookup(vid)) == 1, msg="volume not registered")
            fid = f"/{FileId(vid, 5, 7)}"
            out[pkg] = (hreq(vs, "POST", fid, b"z" * 100)[0], hreq(vs, "GET", fid)[1],
                        other.store.find_volume(vid), hreq(vs, "DELETE", fid)[0],
                        hreq(vs, "GET", fid)[0])
        assert out["port"] == out["jax"] == (201, b"z" * 100, None, 202, 404)
    finally:
        c.stop()


# --------------------------------------------------------- the stand-in master


def test_stand_in_master_answers_as_jax_master(mixed):
    """The master chip_smoke.py's cluster phases run, the port's
    MasterServer (it replaced the smoke's stand-in), and a JAX
    MasterServer fed the same heartbeats of a port and a JAX server give
    the same lookups, topology and KeepConnected snapshot."""
    from seaweedfs_tpu_torch.server.master import MasterServer as PortMasterServer

    c, _items, _gens = mixed
    hbs = [c.vols[0].cluster._full_heartbeat(), c.vols[1]._full_heartbeat()]
    jm = MasterServer(ip="127.0.0.1", port=allocate_port())
    sm = PortMasterServer(ip="127.0.0.1", port=allocate_port())
    jm.start()
    sm.start()
    chans, held_calls = [], []
    held = threading.Event()

    def feed(hb):
        yield hb
        held.wait(60)  # the stream stays open: a closed one unregisters the node

    try:
        answers = []
        for m in (jm, sm):
            ch = grpc.insecure_channel(f"127.0.0.1:{m.port + 10000}")
            chans.append(ch)
            st = rpc.master_stub(ch)
            streams = []
            for hb in hbs:  # one after the other: lookups list nodes in registration order
                call = st.SendHeartbeat(feed(hb))
                held_calls.append(call)  # a dropped call is cancelled
                streams.append(next(call))
            wait_for(lambda: st.Topology(pb.TopologyRequest(), timeout=10).nodes
                     and len(st.Topology(pb.TopologyRequest(), timeout=10).nodes) == 2,
                     msg="nodes did not register")
            topo = st.Topology(pb.TopologyRequest(), timeout=10)
            for n in topo.nodes:
                n.ClearField("id")
                n.location.ClearField("url")
            session = st.KeepConnected(pb.KeepConnectedRequest(client_id="t"))
            snapshot = []
            for u in session:
                if u.leader:  # the snapshot-complete marker
                    break
                snapshot.append(u)
            session.cancel()
            answers.append((
                sorted(snapshot, key=lambda u: u.url),
                streams,
                [st.LookupVolume(pb.LookupVolumeRequest(volume_ids=[v]), timeout=10)
                 for v in (GEN_VID, 99)],
                st.LookupEcVolume(pb.LookupEcVolumeRequest(volume_id=GEN_VID), timeout=10),
                st.LookupEcVolume(pb.LookupEcVolumeRequest(volume_id=99), timeout=10),
                topo,
            ))
        assert answers[0] == answers[1]
        assert len(answers[0][0]) == 2 and answers[0][0][0].new_ec_vids == [GEN_VID]
    finally:
        held.set()
        for ch in chans:
            ch.close()
        jm.stop()
        sm.stop()


def test_node_view_for_matches_jax():
    from seaweedfs_tpu.ec.placement import node_view_for as jax_node_view_for

    ents = [jpb.EcShardInfoMsg(id=3, collection="a", shard_bits=0b1011),
            jpb.EcShardInfoMsg(id=4, collection="b", shard_bits=0b11 << 12)]
    tele = {"chips": {"cuda:0": {"load": 5}, "cuda:1": {"load": 7, "breaker": "open"}},
            "breakers_open": 1, "stage_ewma_s": {"encode/h2d_dispatch": 0.5, "x/kernel": 9.0},
            "received_at": 1000.0}
    for kw in ({}, {"collection": "a"}, {"used_bytes": 10, "capacity_bytes": 100},
               {"ec_telemetry": tele, "now": 1010.0}, {"ec_telemetry": tele, "now": 5000.0},
               {"ec_telemetry": {"chips": "bad", "breakers_open": "x"}}):
        assert vars(node_view_for("n", "r", "d", 8, 2, ents, **kw)) == \
            vars(jax_node_view_for("n", "r", "d", 8, 2, ents, **kw)), kw
