"""PyTorch port: the volume server's admin RPCs of plain volumes
(server/volume_grpc.py VolumeCopy, VolumeConfigure, VolumeMarkReadonly,
VolumeMarkWritable, VacuumVolume, ScrubVolume, VolumeTierUpload,
VolumeTierDownload, VolumeTailSender, VolumeTailReceiver,
VolumeIncrementalCopy, ReadVolumeFileStatus), client/volume_sync.py,
storage/volume_scan.py and the native `scan_dat`, held against the JAX
package's VolumeServer on the CPU in mixed clusters on the JAX
`MasterServer`:

- each of the 12 RPCs on a port and a JAX server holding byte-identical
  volumes: equal answers field by field and equal files after;
- VolumeCopy from either package's server into the other's;
- the JAX shell's `ec.encode`, `volume.move`, `volume.vacuum` and
  `volume.sync` against port servers, with the bytes of the JAX server's;
- catch-up with tombstones (the 0x40 flag and the legacy marker) in both
  directions, the incremental copy's prefix guard, a VolumeTailSender
  stream ended by the server's `stop()`;
- the native scan against the port's and the JAX package's walk over a
  volume with rotted records and a torn tail.
"""

import os
import shutil
import threading
import time

import grpc
import pytest
import requests
from conftest import allocate_port, wait_for
from test_torch_volume_grpc import Cluster, hreq, needles, pinned_clock, sha
from test_torch_volume_server import _ports

from seaweedfs_tpu.pb import cluster_pb2 as jpb
from seaweedfs_tpu.pb import rpc as jrpc
from seaweedfs_tpu.shell.commands import ShellEnv, run_command
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.volume_scan import scan_volume_file as jax_scan
from seaweedfs_tpu_torch.client import volume_sync
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import actual_offset
from seaweedfs_tpu_torch.storage.volume_scan import scan_volume_file
from seaweedfs_tpu_torch.utils import native

TOTAL = 14


def build_volume(d, vid: int, items, deletes=(), snapshot_after=None) -> tuple[str, str | None]:
    """A volume's .dat and .idx written through the port's Store (the
    needles, then the deletes), in `d`. With `snapshot_after` = n, a copy
    of both files after the first n needles lands in `d`/stale. Returns
    the base path and the stale copy's base (or None)."""
    store = Store([str(d)], ec_backend="cpu")
    vol = store.allocate_volume(vid)
    base = vol.dat_path[:-4]
    stale = None
    for i, (nid, cookie, body) in enumerate(items):
        if i == snapshot_after:
            stale = os.path.join(str(d), "stale", str(vid))
            os.makedirs(os.path.dirname(stale), exist_ok=True)
            vol.flush()
            for ext in (".dat", ".idx"):
                shutil.copy(base + ext, stale + ext)
        store.write_needle(vid, Needle(cookie=cookie, needle_id=nid, data=body))
    for nid in deletes:
        store.delete_needle(vid, nid)
    store.close()
    return base, stale


def place(base: str, vs, vid: int) -> None:
    d = vs.store.locations[0].directory
    for ext in (".dat", ".idx"):
        shutil.copy(base + ext, os.path.join(d, f"{vid}{ext}"))


def vbase(vs, vid: int) -> str:
    return os.path.join(vs.store.locations[0].directory, str(vid))


def files(vs, vid: int) -> dict:
    """The volume's files on a server, flushed: ext -> sha256 (absent: None)."""
    v = vs.store.find_volume(vid)
    if v is not None:
        v.flush()
    out = {}
    for ext in (".dat", ".idx"):
        p = vbase(vs, vid) + ext
        out[ext] = sha(p) if os.path.exists(p) else None
    return out


def flip(path: str, at: int) -> None:
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0x5A]))


def record_offset(base: str, vid: int, nid: int) -> int:
    """Byte offset of a needle's live record, from a closed volume's .idx."""
    store = Store([os.path.dirname(base)], ec_backend="cpu")
    try:
        return actual_offset(store.find_volume(vid).needle_map.get(nid).offset)
    finally:
        store.close()


@pytest.fixture(scope="module")
def admin(tmp_path_factory):
    """A JAX master with two port and two JAX servers: vols[0] (port) and
    vols[1] (JAX) run each case, vols[2] (port) and vols[3] (JAX) are the
    peers they copy and tail from."""
    root = tmp_path_factory.mktemp("admin")
    c = Cluster(root, ["port", "jax", "port", "jax"])
    yield c
    c.stop()


@pytest.fixture(scope="module")
def cold_tier(tmp_path_factory):
    """The JAX package's master, volume server, filer and S3 gateway: the
    cold-tier endpoint both packages' volumes upload to."""
    from seaweedfs_tpu.filer import Filer, MemoryStore
    from seaweedfs_tpu.s3 import S3Server
    from seaweedfs_tpu.server.master import MasterServer
    from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer

    tmp = tmp_path_factory.mktemp("coldvol")
    mport = allocate_port()
    master = MasterServer(ip="localhost", port=mport)
    master.start()
    vs = JaxVolumeServer(directories=[str(tmp / "v")], master=f"localhost:{mport}", ip="localhost",
                         port=allocate_port(), ec_backend="cpu")
    vs.start()
    wait_for(lambda: master.topo.nodes, msg="the cold tier's volume server did not register")
    filer = Filer(MemoryStore(), master=f"localhost:{mport}", chunk_size=256 * 1024)
    s3 = S3Server(filer, ip="localhost", port=allocate_port(), lifecycle_interval=0)
    s3.start()
    url = f"http://localhost:{s3.port}"
    requests.put(f"{url}/cold", timeout=30)
    yield url
    s3.stop()
    filer.close()
    vs.stop()
    master.stop()


def mount(c, vs, vid: int) -> None:
    assert not c.stub(vs).VolumeMount(jpb.AllocateVolumeRequest(volume_id=vid), timeout=30).error


# ------------------------------------------------- each RPC against the JAX server

ITEMS = needles(51, 30, 40_000)
DELETED = [nid for nid, _, _ in ITEMS[3:9]]
MID = 18  # the tail cases start after the first MID needles


def case_volume_copy(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    out = [st.VolumeCopy(jpb.EcShardsCopyRequest(volume_id=vid, source_url=f"127.0.0.1:{c.vols[2].grpc_port}"),
                         timeout=60)]
    # a second copy of a volume already here is refused
    out.append(st.VolumeCopy(jpb.EcShardsCopyRequest(
        volume_id=vid, source_url=f"127.0.0.1:{c.vols[2].grpc_port}"), timeout=60))
    # a source without the volume: the .dat copy fails and nothing lands
    out.append(st.VolumeCopy(jpb.EcShardsCopyRequest(
        volume_id=vid + 1000, source_url=f"127.0.0.1:{c.vols[2].grpc_port}"), timeout=60))
    assert not os.path.exists(vbase(vs, vid + 1000) + ".dat.copying")
    return out


def case_volume_configure(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    return [st.VolumeConfigure(jpb.VolumeConfigureRequest(volume_id=vid, replication="001"), timeout=30),
            st.VolumeConfigure(jpb.VolumeConfigureRequest(volume_id=vid, replication="x9"), timeout=30),
            st.VolumeConfigure(jpb.VolumeConfigureRequest(volume_id=vid + 1000, replication="001"),
                               timeout=30),
            vs.store.find_volume(vid).super_block.replica_placement.__str__()]


def _read_only(vs, vid):
    return vs.store.find_volume(vid).read_only


def case_mark_readonly(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    r = st.VolumeMarkReadonly(jpb.VolumeCommandRequest(volume_id=vid), timeout=30)
    w = st.WriteNeedle(jpb.WriteNeedleRequest(volume_id=vid, needle_id=1, cookie=1, data=b"x"), timeout=30)
    return [r, _read_only(vs, vid), bool(w.error),
            st.VolumeMarkReadonly(jpb.VolumeCommandRequest(volume_id=vid + 1000), timeout=30)]


def case_mark_writable(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    st.VolumeMarkReadonly(jpb.VolumeCommandRequest(volume_id=vid), timeout=30)
    r = st.VolumeMarkWritable(jpb.VolumeCommandRequest(volume_id=vid), timeout=30)
    return [r, _read_only(vs, vid),
            st.VolumeMarkWritable(jpb.VolumeCommandRequest(volume_id=vid + 1000), timeout=30)]


def case_vacuum(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    out = [st.VacuumVolume(jpb.VacuumRequest(volume_id=vid, garbage_threshold=0.99), timeout=60),
           st.VacuumVolume(jpb.VacuumRequest(volume_id=vid, garbage_threshold=0.05), timeout=60),
           vs.store.find_volume(vid).super_block.compaction_revision]
    with pytest.raises(grpc.RpcError) as e:
        st.VacuumVolume(jpb.VacuumRequest(volume_id=vid + 1000), timeout=30)
    out.append((e.value.code(), e.value.details()))
    return out


def case_scrub(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    return [st.ScrubVolume(jpb.ScrubRequest(volume_id=vid), timeout=60),
            st.ScrubVolume(jpb.ScrubRequest(volume_id=vid + 1000), timeout=60)]


def _tier_url(cold, vs, vid):
    return f"{cold}/cold/{type(vs).__module__.split('.')[0]}-{vid}.dat"


def case_tier_upload(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    url = _tier_url(cold, vs, vid)
    out = [st.VolumeTierUpload(jpb.TierRequest(volume_id=vid, dest_url=url), timeout=60)]
    st.VolumeMarkReadonly(jpb.VolumeCommandRequest(volume_id=vid), timeout=30)
    with open(vbase(vs, vid) + ".dat", "rb") as f:
        dat = f.read()
    out.append(st.VolumeTierUpload(jpb.TierRequest(volume_id=vid, dest_url=url), timeout=60))
    out.append(requests.get(url, timeout=30).content == dat)
    out.append(st.VolumeTierUpload(jpb.TierRequest(volume_id=vid + 1000, dest_url=url), timeout=60))
    # served from the tier
    nid, cookie, body = ITEMS[-1]
    out.append(hreq(vs, "GET", f"/{FileId(vid, nid, cookie)}") == (200, body))
    return out


def case_tier_download(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    url = _tier_url(cold, vs, vid)
    st.VolumeMarkReadonly(jpb.VolumeCommandRequest(volume_id=vid), timeout=30)
    before = sha(vbase(vs, vid) + ".dat")
    assert not st.VolumeTierUpload(jpb.TierRequest(volume_id=vid, dest_url=url), timeout=60).error
    out = [st.VolumeTierDownload(jpb.TierRequest(volume_id=vid, delete_remote=True), timeout=60),
           sha(vbase(vs, vid) + ".dat") == before,
           requests.get(url, timeout=30).status_code,
           st.VolumeTierDownload(jpb.TierRequest(volume_id=vid), timeout=60),
           st.VolumeTierDownload(jpb.TierRequest(volume_id=vid + 1000), timeout=60)]
    return out


def _mid_ns(vs, vid):
    v = vs.store.find_volume(vid)
    nv = v.needle_map.get(ITEMS[MID - 1][0])
    return Needle.from_bytes(v._pread_record(actual_offset(nv.offset), nv.size)).append_at_ns


def case_tail_sender(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    out = [list(st.VolumeTailSender(jpb.VolumeTailRequest(
        volume_id=vid, since_ns=_mid_ns(vs, vid), idle_timeout_seconds=1), timeout=60))]
    with pytest.raises(grpc.RpcError) as e:
        list(st.VolumeTailSender(jpb.VolumeTailRequest(volume_id=vid + 1000, idle_timeout_seconds=1),
                                   timeout=30))
    out.append((e.value.code(), e.value.details()))
    return out


def case_tail_receiver(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    src = f"127.0.0.1:{c.vols[3].grpc_port}"
    return [st.VolumeTailReceiver(jpb.VolumeTailReceiverRequest(
                volume_id=vid, source_volume_server=src, idle_timeout_seconds=1), timeout=60),
            files(vs, vid) == files(c.vols[3], vid),
            st.VolumeTailReceiver(jpb.VolumeTailReceiverRequest(
                volume_id=vid + 1000, source_volume_server=src, idle_timeout_seconds=1), timeout=60)]


def case_incremental_copy(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    v = vs.store.find_volume(vid)
    out = [list(st.VolumeIncrementalCopy(jpb.VolumeIncrementalCopyRequest(
               volume_id=vid, since_ns=_mid_ns(vs, vid)), timeout=60)),
           list(st.VolumeIncrementalCopy(jpb.VolumeIncrementalCopyRequest(
               volume_id=vid, since_ns=v.last_append_at_ns()), timeout=60))]
    with pytest.raises(grpc.RpcError) as e:
        list(st.VolumeIncrementalCopy(jpb.VolumeIncrementalCopyRequest(volume_id=vid + 1000),
                                        timeout=30))
    out.append((e.value.code(), e.value.details()))
    return out


def case_file_status(c, tmp, vid, vs, cold):
    st = c.stub(vs)
    return [st.ReadVolumeFileStatus(jpb.VolumeFileStatusRequest(volume_id=vid), timeout=30),
            st.ReadVolumeFileStatus(jpb.VolumeFileStatusRequest(volume_id=vid + 1000), timeout=30)]


# name -> (case, build_volume arguments, which peer holds the full volume)
CASES = {
    "VolumeCopy": (case_volume_copy, {}, "source"),
    "VolumeConfigure": (case_volume_configure, {}, None),
    "VolumeMarkReadonly": (case_mark_readonly, {}, None),
    "VolumeMarkWritable": (case_mark_writable, {}, None),
    "VacuumVolume": (case_vacuum, {"deletes": DELETED}, None),
    "ScrubVolume": (case_scrub, {"deletes": DELETED}, None),
    "VolumeTierUpload": (case_tier_upload, {}, None),
    "VolumeTierDownload": (case_tier_download, {}, None),
    "VolumeTailSender": (case_tail_sender, {"deletes": DELETED}, None),
    "VolumeTailReceiver": (case_tail_receiver, {"deletes": DELETED, "snapshot_after": MID}, "stale"),
    "VolumeIncrementalCopy": (case_incremental_copy, {"deletes": DELETED}, None),
    "ReadVolumeFileStatus": (case_file_status, {"deletes": DELETED}, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_admin_rpc_matches_jax(admin, cold_tier, tmp_path, name):
    """The RPC on a port server and on a JAX server holding byte-identical
    copies of one volume: the same answers, field by field, and the same
    .dat and .idx after."""
    c = admin
    fn, kw, peer = CASES[name]
    vid = 200 + list(CASES).index(name)
    pair = c.vols[:2]
    base, stale = build_volume(tmp_path / "src", vid, ITEMS, **kw)
    if name == "ScrubVolume":
        # one live needle rotted, one superseded copy rotted (not reported)
        live = ITEMS[12]
        flip(base + ".dat", record_offset(base, vid, live[0]) + 16 + 4 + 7)
    if peer == "source":
        place(base, c.vols[2], vid)
        mount(c, c.vols[2], vid)
    elif peer == "stale":
        place(base, c.vols[3], vid)
        mount(c, c.vols[3], vid)
        base = stale
    if peer != "source":
        for vs in pair:
            place(base, vs, vid)
            mount(c, vs, vid)
    got = [fn(c, tmp_path, vid, vs, cold_tier) for vs in pair]
    assert got[0] == got[1]
    assert files(pair[0], vid) == files(pair[1], vid)
    assert EXPECT[name](got[0]), got[0]


# what each case's answers must also show
EXPECT = {
    "VolumeCopy": lambda g: not g[0].error and g[1].error == "volume already here" and g[2].error,
    "VolumeConfigure": lambda g: not g[0].error and g[1].error and g[2].error and g[3] == "001",
    "VolumeMarkReadonly": lambda g: not g[0].error and g[1] and g[2] and g[3].error == "not found",
    "VolumeMarkWritable": lambda g: not g[0].error and not g[1] and g[2].error == "not found",
    "VacuumVolume": lambda g: (g[0].reclaimed_bytes == 0 and g[1].reclaimed_bytes > 0 and g[2] == 1
                               and g[3][0] == grpc.StatusCode.NOT_FOUND),
    "ScrubVolume": lambda g: (list(g[0].bad_needles) == [ITEMS[12][0]]
                              and g[0].checked == len(ITEMS) - len(DELETED) and g[1].error),
    "VolumeTierUpload": lambda g: g[0].error and g[1].moved_bytes > 0 and g[2] and g[4],
    "VolumeTierDownload": lambda g: g[0].moved_bytes > 0 and g[1] and g[2] == 404 and g[3].error,
    "VolumeTailSender": lambda g: (sum(1 for ch in g[0] if ch.needle_header)
                                   == len(ITEMS) - MID + len(DELETED)
                                   and g[1][0] == grpc.StatusCode.NOT_FOUND),
    "VolumeTailReceiver": lambda g: g[0].received == len(ITEMS) - MID + len(DELETED) and g[1],
    "VolumeIncrementalCopy": lambda g: (g[0][0].has_start and g[0][0].start_offset > 8
                                        and len(g[1]) == 1 and not g[1][0].file_content),
    "ReadVolumeFileStatus": lambda g: g[0].dat_size > 0 and g[0].last_append_at_ns and g[1].error,
}


def test_volume_copy_across_packages(admin, tmp_path):
    """VolumeCopy port <- JAX and JAX <- port: the files equal the
    source's, the copy is mounted, and the master lists both holders."""
    c = admin
    for i, (src, dst) in enumerate(((c.vols[3], c.vols[0]), (c.vols[2], c.vols[1]))):
        vid = 230 + i
        base, _ = build_volume(tmp_path / f"src{i}", vid, ITEMS, deletes=DELETED[:2])
        place(base, src, vid)
        mount(c, src, vid)
        r = c.stub(dst).VolumeCopy(jpb.EcShardsCopyRequest(
            volume_id=vid, source_url=f"127.0.0.1:{src.grpc_port}"), timeout=60)
        assert not r.error
        assert files(dst, vid) == files(src, vid)
        nid, cookie, body = ITEMS[-1]
        assert hreq(dst, "GET", f"/{FileId(vid, nid, cookie)}") == (200, body)
        wait_for(lambda: len(c.master.topo.lookup(vid)) == 2, msg="both holders listed")


# ------------------------------------------------------------- the JAX shell


def shell(c) -> ShellEnv:
    env = ShellEnv(f"127.0.0.1:{c.mport}")
    env.lock_wait = 30.0
    return env


def lookup_urls(env, vid) -> list:
    try:
        return sorted(loc.url for loc in env.master.lookup(vid, refresh=True))
    except LookupError:
        return []


def test_shell_ec_encode_on_port_server_equals_jax(admin, tmp_path, monkeypatch):
    """`ec.encode` on a port holder and on a JAX holder of the same bytes:
    readonly, generate, mount, source deleted; the shards and index files
    sha256-equal."""
    c = admin
    pinned_clock(monkeypatch, 1_760_000_000_987_654_321)
    env = shell(c)
    try:
        vids = {}
        base, _ = build_volume(tmp_path / "src", 240, ITEMS, deletes=DELETED[:3])
        for vid, vs in ((240, c.vols[0]), (241, c.vols[1])):
            place(base, vs, vid)
            mount(c, vs, vid)
            wait_for(lambda vid=vid: lookup_urls(env, vid), msg="the master lists the volume")
            out = run_command(env, f"ec.encode -volumeId {vid} -backend cpu")
            assert out.startswith(f"ec.encode volume {vid}: generation "), out
            vids[vid] = vs
        (pv, port), (jv, jax) = vids.items()
        for ext in [f".ec{i:02d}" for i in range(TOTAL)] + [".ecx", ".ecsum"]:
            assert sha(vbase(port, pv) + ext) == sha(vbase(jax, jv) + ext), ext
        for vid, vs in vids.items():
            assert vs.store.find_volume(vid) is None and vs.store.find_ec_volume(vid) is not None
            assert not os.path.exists(vbase(vs, vid) + ".dat")
            nid, cookie, body = ITEMS[-1]
            assert hreq(vs, "GET", f"/{FileId(vid, nid, cookie)}") == (200, body)
    finally:
        env.close()


def test_shell_volume_move_both_ways(admin, tmp_path):
    """`volume.move` from a JAX server onto a port server and from a port
    server onto a JAX server: the target's files equal the source's, the
    source copy is gone, the master lists the target alone."""
    c = admin
    env = shell(c)
    try:
        for i, (src, dst) in enumerate(((c.vols[3], c.vols[0]), (c.vols[2], c.vols[1]))):
            vid = 250 + i
            base, _ = build_volume(tmp_path / f"src{i}", vid, ITEMS, deletes=DELETED[:2])
            place(base, src, vid)
            mount(c, src, vid)
            want = files(src, vid)
            wait_for(lambda vid=vid: lookup_urls(env, vid), msg="the master lists the volume")
            out = run_command(env, f"volume.move -volumeId {vid} -target 127.0.0.1:{dst.grpc_port}")
            assert out.startswith(f"moved volume {vid} "), out
            assert files(dst, vid) == want
            assert src.store.find_volume(vid) is None
            wait_for(lambda vid=vid, dst=dst: lookup_urls(env, vid) == [f"127.0.0.1:{dst.port}"],
                     msg="the master lists the target alone")
    finally:
        env.close()


def test_shell_volume_vacuum_equals_jax(admin, tmp_path):
    c = admin
    env = shell(c)
    try:
        base, _ = build_volume(tmp_path / "src", 260, ITEMS, deletes=DELETED)
        outs = []
        for vid, vs in ((260, c.vols[0]), (261, c.vols[1])):
            place(base, vs, vid)
            mount(c, vs, vid)
            wait_for(lambda vid=vid: lookup_urls(env, vid), msg="the master lists the volume")
            out = run_command(env, f"volume.vacuum -volumeId {vid} -garbageThreshold 0.05")
            outs.append(out.split(": ", 1)[1])
        assert outs[0] == outs[1] and not outs[0].startswith("reclaimed 0 ")
        assert files(c.vols[0], 260) == files(c.vols[1], 261)
    finally:
        env.close()


def test_shell_volume_sync_both_ways(admin, tmp_path):
    """`volume.sync` with a port target pulling from a JAX source, and a
    JAX target pulling from a port source: the target ends byte-identical
    to the source."""
    c = admin
    env = shell(c)
    try:
        for i, (src, dst) in enumerate(((c.vols[3], c.vols[0]), (c.vols[2], c.vols[1]))):
            vid = 270 + i
            base, stale = build_volume(tmp_path / f"src{i}", vid, ITEMS, deletes=DELETED,
                                       snapshot_after=MID)
            place(base, src, vid)
            mount(c, src, vid)
            place(stale, dst, vid)
            mount(c, dst, vid)
            wait_for(lambda vid=vid: len(lookup_urls(env, vid)) == 2, msg="both holders listed")
            out = run_command(env, f"volume.sync -volumeId {vid} -target 127.0.0.1:{dst.grpc_port} "
                                   f"-idleTimeout 1")
            n = len(ITEMS) - MID + len(DELETED)
            assert out == (f"synced volume {vid}: {n} records applied 127.0.0.1:{src.grpc_port} -> "
                           f"127.0.0.1:{dst.grpc_port}"), out
            assert files(dst, vid) == files(src, vid)
    finally:
        env.close()


# ------------------------------------------------------------- catch-up


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_catch_up_replays_tombstones(admin, tmp_path, direction):
    """A stale replica of either package catches up from a source of the
    other: 0x40 tombstones replay verbatim, a legacy tombstone (cookie 0,
    empty body) deletes, an empty body with a nonzero cookie is a put. The
    port and the JAX receivers leave the same bytes."""
    c = admin
    src, dst = (c.vols[3], c.vols[0]) if direction == "jax_to_port" else (c.vols[2], c.vols[1])
    vid = 280 + (direction == "port_to_jax")
    base, stale = build_volume(tmp_path / "src", vid, ITEMS, snapshot_after=MID)
    place(base, src, vid)
    mount(c, src, vid)
    place(stale, dst, vid)
    mount(c, dst, vid)
    v = src.store.find_volume(vid)
    cls = Needle if isinstance(src, VolumeServer) else JaxNeedle
    v.delete_needle(ITEMS[2][0])  # a 0x40 tombstone
    v.write_needle(cls(cookie=0, needle_id=ITEMS[4][0], data=b""))  # the legacy tombstone
    v.write_needle(cls(cookie=7, needle_id=ITEMS[5][0], data=b""))  # an empty put
    n = volume_sync.sync_replica(f"127.0.0.1:{dst.grpc_port}", f"127.0.0.1:{src.grpc_port}", vid,
                                 idle_timeout_s=1, timeout=60)
    assert n == len(ITEMS) - MID + 3
    d = dst.store.find_volume(vid)
    assert not d.has_needle(ITEMS[2][0]) and not d.has_needle(ITEMS[4][0])
    assert d.read_needle(ITEMS[5][0]).data == b"" and d.read_needle(ITEMS[5][0]).cookie == 7
    live = {nid for nid, _, _ in ITEMS} - {ITEMS[2][0], ITEMS[4][0]}
    assert {nid for nid in live if d.has_needle(nid)} == live
    # the other package's receiver over the same source leaves the same bytes
    other = c.vols[1] if direction == "jax_to_port" else c.vols[0]
    place(stale, other, vid)
    mount(c, other, vid)
    r = c.stub(other).VolumeTailReceiver(jpb.VolumeTailReceiverRequest(
        volume_id=vid, source_volume_server=f"127.0.0.1:{src.grpc_port}", idle_timeout_seconds=1),
        timeout=60)
    assert not r.error and r.received == n
    assert files(other, vid) == files(dst, vid)


def test_incremental_copy_prefix_guard(admin, tmp_path):
    """The stream starts at the follower's own .dat size, and the bytes
    appended there make the follower's .dat the source's; nothing newer
    gives start == size and no bytes."""
    c = admin
    vs = c.vols[0]
    vid = 290
    base, stale = build_volume(tmp_path / "src", vid, ITEMS, deletes=DELETED, snapshot_after=MID)
    place(base, vs, vid)
    mount(c, vs, vid)
    v = vs.store.find_volume(vid)
    mid_ns = _mid_ns(vs, vid)  # the follower's own last appendAtNs
    start, it = volume_sync.incremental_copy(f"127.0.0.1:{vs.grpc_port}", vid, mid_ns, timeout=60)
    tail = b"".join(it)
    prefix = open(stale + ".dat", "rb").read()
    assert start == len(prefix)
    with open(v.dat_path, "rb") as f:
        assert prefix + tail == f.read()
    start2, it2 = volume_sync.incremental_copy(f"127.0.0.1:{vs.grpc_port}", vid,
                                               v.last_append_at_ns(), timeout=60)
    assert start2 == os.path.getsize(v.dat_path) and b"".join(it2) == b""


def test_tail_sender_stream_ended_by_stop(tmp_path):
    """A VolumeTailSender stream with no idle timeout (it would follow
    forever) ends when the server stops."""
    vs = VolumeServer([str(tmp_path / "v")], ip="127.0.0.1", port=_ports(), ec_backend="cpu")
    vs.start()
    stopped = False
    try:
        vs.store.allocate_volume(7)
        vs.store.write_needle(7, Needle(cookie=1, needle_id=1, data=b"one"))
        got, done = [], threading.Event()

        def follow():
            with grpc.insecure_channel(f"127.0.0.1:{vs.grpc_port}") as ch:
                try:
                    for chunk in jrpc.volume_stub(ch).VolumeTailSender(
                            jpb.VolumeTailRequest(volume_id=7, idle_timeout_seconds=0), timeout=60):
                        got.append(chunk)
                except grpc.RpcError as e:
                    got.append(e.code())
            done.set()

        t = threading.Thread(target=follow, daemon=True)
        t.start()
        wait_for(lambda: len(got) >= 3, msg="the stream follows")
        t0 = time.monotonic()
        vs.stop()
        stopped = True
        assert done.wait(10), "the tail stream outlived stop()"
        t.join(5)
        assert not t.is_alive() and time.monotonic() - t0 < 10
        assert got[0].needle_header and got[1].is_last_chunk
    finally:
        if not stopped:
            vs.stop()


# ------------------------------------------------------------- the scanners


def test_native_scan_matches_both_walks(tmp_path):
    """scan_dat against the port's and the JAX package's volume_scan over
    a volume with two rotted live records, a rotted superseded copy, a
    tombstone and a torn tail."""
    items = needles(61, 40, 30_000)
    base, _ = build_volume(tmp_path, 9, items + [(items[0][0], 5, b"rewritten")], deletes=[items[1][0]])
    off0 = record_offset(base, 9, items[5][0])
    off1 = record_offset(base, 9, items[20][0])
    flip(base + ".dat", off0 + 16 + 4 + 3)
    flip(base + ".dat", off1 + 16 + 4 + len(items[20][2]) - 1)
    flip(base + ".dat", 8 + 16 + 4 + 1)  # the first copy of items[0], superseded
    with open(base + ".dat", "ab") as f:
        f.write(b"\x00" * 11)  # a torn tail
    ids, offs, sizes, ok = native.scan_dat(base + ".dat")
    got = list(zip(ids.tolist(), offs.tolist(), sizes.tolist(), ok.tolist()))
    for scan in (scan_volume_file, jax_scan):
        _, it = scan(base + ".dat")
        want = [(i.needle.needle_id, i.offset // 8, i.body_size, i.crc_ok) for i in it]
        assert got == want
    assert [r[0] for r in got if not r[3]] == [items[0][0], items[5][0], items[20][0]]
    assert len(got) == len(items) + 2
    with pytest.raises(OSError):
        native.scan_dat(str(tmp_path / "missing.dat"))
