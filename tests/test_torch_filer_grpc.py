"""PyTorch port: the filer's gRPC service (seaweedfs_tpu_torch/filer/
grpc_service.py) and the MetaAggregator, held against the JAX package on
the CPU. Each package's `FilerGrpcService` is hosted on a `grpc.server`
the test starts (as the JAX filer server hosts its own), over a `Filer`
on the twin clusters of tests/test_torch_filer.py:

- the same request sequence against both services gives equal responses
  once chunk fids, volume URLs, hard-link ids and timestamps are masked:
  every RPC, its errors included, and `DistributedLock` without a lock
  ring answering "lock ring not configured" in both;
- `SubscribeMetadata` from `since_ns=0` (equal events), live (an event
  written after the stream opened arrives), with `path_prefix` and
  `local_only`; `OUT_OF_RANGE` after the meta log rotated past the
  watermark; `UNIMPLEMENTED` without a meta log;
- mixed convergence: a port `MetaAggregator` following a JAX filer, and a
  JAX `MetaAggregator` following the port's service, each reach the
  origin's namespace entry for entry, so the wire format is one;
- `RunLifecycle` applies the S3 lifecycle rules alike: the same counters
  and survivors.
"""

import hashlib
import json
import threading
import time
import types
from concurrent import futures

import grpc
import numpy as np
import pytest
from conftest import wait_for
from test_torch_filer import PKGS, norm_entry, norm_event, twins  # noqa: F401 — the module fixture

import seaweedfs_tpu.filer.grpc_service as j_grpc
import seaweedfs_tpu.filer.meta_aggregator as j_agg
from seaweedfs_tpu.pb import rpc as jrpc
import seaweedfs_tpu_torch.filer.grpc_service as p_grpc
import seaweedfs_tpu_torch.filer.meta_aggregator as p_agg
from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.pb import rpc

SIDES = {
    "jax": types.SimpleNamespace(pkg=PKGS["jax"], grpc=j_grpc, agg=j_agg, rpc=jrpc),
    "port": types.SimpleNamespace(pkg=PKGS["port"], grpc=p_grpc, agg=p_agg, rpc=rpc),
}


def test_the_port_table_holds_every_filer_rpc_of_the_jax_table():
    want = jrpc.SERVICES[jrpc.FILER_SERVICE]
    got = rpc.SERVICES[rpc.FILER_SERVICE]
    assert rpc.FILER_SERVICE == jrpc.FILER_SERVICE == "swfiler.SeaweedFiler"
    assert {k: (v[0], v[1].DESCRIPTOR.full_name, v[2].DESCRIPTOR.full_name) for k, v in got.items()} \
        == {k: (v[0], v[1].DESCRIPTOR.full_name, v[2].DESCRIPTOR.full_name) for k, v in want.items()}
    assert len(got) == 15
    for name in got:
        assert callable(getattr(p_grpc.FilerGrpcService, name)), name


class Hosted:
    """A Filer of one package with a meta log, its FilerGrpcService on a
    grpc.server, and a stub at it."""

    def __init__(self, side: str, master: str, d, meta_log: bool = True):
        s = SIDES[side]
        self.side = s
        d.mkdir(parents=True, exist_ok=True)
        self.filer = s.pkg.filer.Filer(s.pkg.store.MemoryStore(), master=master,
                                       chunk_size=16 * 1024)
        self.meta_log = s.pkg.meta_log.MetaLog(str(d / "meta")) if meta_log else None
        if self.meta_log is not None:
            self.filer.subscribe(self.meta_log)
        self.service = s.grpc.FilerGrpcService(self.filer, self.meta_log)
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        s.rpc.add_service(self.server, s.rpc.FILER_SERVICE, self.service)
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()
        self.addr = f"127.0.0.1:{self.port}"
        self.channel = grpc.insecure_channel(self.addr)
        self.stub = rpc.filer_stub(self.channel)

    def close(self):
        self.channel.close()
        self.server.stop(grace=None)
        self.filer.close()
        if self.meta_log is not None:
            self.meta_log.close()


def norm_resp(resp) -> bytes:
    """A response with fids, URLs, tokens, hard-link ids and timestamps
    masked."""
    r = type(resp)()
    r.CopyFrom(resp)
    if isinstance(r, (fpb.LookupEntryResponse, fpb.ListEntriesResponse)):
        if r.HasField("entry"):
            e = fpb.Entry.FromString(norm_entry(r.entry))
            r.entry.CopyFrom(e)
    if isinstance(r, fpb.AssignVolumeResponse):
        r.fid = "fid" if r.fid else ""
        r.url = "url" if r.url else ""
        r.jwt = ""
    if isinstance(r, pb.LookupVolumeResponse):
        for vl in r.volume_locations:
            vl.volume_id = 0
            for loc in vl.locations:
                loc.Clear()
    return r.SerializeToString(deterministic=True)


def request_sequence(h: Hosted) -> list:
    st = h.stub
    out = []

    def call(name, req):
        try:
            out.append((name, norm_resp(getattr(st, name)(req, timeout=30))))
        except grpc.RpcError as e:
            out.append((name, e.code().name, e.details()))

    def stream(name, req):
        out.append((name, [norm_resp(r) for r in getattr(st, name)(req, timeout=30)]))

    e = fpb.Entry(name="hello.txt", content=b"grpc content")
    e.attributes.file_mode = 0o100644
    e.attributes.mtime = 1_700_000_000
    call("CreateEntry", fpb.CreateEntryRequest(directory="/docs", entry=e))
    call("CreateEntry", fpb.CreateEntryRequest(directory="docs//", entry=fpb.Entry(
        name="sub", is_directory=True)))
    call("CreateEntry", fpb.CreateEntryRequest(directory="/docs/hello.txt", entry=fpb.Entry(name="x")))
    call("CreateEntry", fpb.CreateEntryRequest(directory="/docs", entry=fpb.Entry(
        name="hello.txt", is_directory=True)))
    body = np.random.default_rng(30).bytes(40_000)
    h.filer.write_file("/docs/big.bin", body)
    for i in range(5):
        h.filer.write_file(f"/docs/p{i}", bytes([i]) * (100 + i))
    call("LookupDirectoryEntry", fpb.LookupEntryRequest(directory="/docs", name="hello.txt"))
    call("LookupDirectoryEntry", fpb.LookupEntryRequest(directory="/docs", name="big.bin"))
    call("LookupDirectoryEntry", fpb.LookupEntryRequest(directory="/docs", name="nope"))
    stream("ListEntries", fpb.ListEntriesRequest(directory="/docs"))
    stream("ListEntries", fpb.ListEntriesRequest(directory="/docs", limit=2, start_from="hello.txt"))
    stream("ListEntries", fpb.ListEntriesRequest(directory="/docs", prefix="p"))
    stream("ListEntries", fpb.ListEntriesRequest(directory="/nowhere"))
    upd = fpb.Entry(name="hello.txt", content=b"updated")
    upd.attributes.mtime = 1_700_000_001
    call("UpdateEntry", fpb.UpdateEntryRequest(directory="/docs", entry=upd))
    call("UpdateEntry", fpb.UpdateEntryRequest(directory="/docs", entry=fpb.Entry(name="missing")))
    call("LookupDirectoryEntry", fpb.LookupEntryRequest(directory="/docs", name="hello.txt"))
    call("HardLink", fpb.HardLinkRequest(src_path="/docs/big.bin", dst_path="/docs/link.bin"))
    call("HardLink", fpb.HardLinkRequest(src_path="/docs/big.bin", dst_path="/docs/link.bin"))
    call("HardLink", fpb.HardLinkRequest(src_path="/docs/none", dst_path="/docs/l2"))
    call("HardLink", fpb.HardLinkRequest(src_path="/docs/sub", dst_path="/docs/l3"))
    call("LookupDirectoryEntry", fpb.LookupEntryRequest(directory="/docs", name="link.bin"))
    call("AtomicRenameEntry", fpb.AtomicRenameEntryRequest(
        old_directory="/docs", old_name="link.bin", new_directory="/moved", new_name="l.bin"))
    call("AtomicRenameEntry", fpb.AtomicRenameEntryRequest(
        old_directory="/docs", old_name="gone", new_directory="/moved", new_name="x"))
    call("AtomicRenameEntry", fpb.AtomicRenameEntryRequest(
        old_directory="/docs", old_name="p0", new_directory="/docs", new_name="p0"))
    out.append(("read moved", hashlib.sha256(h.filer.read_file("/moved/l.bin")).hexdigest()
                == hashlib.sha256(body).hexdigest()))
    call("KvPut", fpb.FilerKvPutRequest(key=b"k1", value=b"v1"))
    call("KvGet", fpb.FilerKvGetRequest(key=b"k1"))
    call("KvPut", fpb.FilerKvPutRequest(key=b"k1"))  # an empty value deletes
    call("KvGet", fpb.FilerKvGetRequest(key=b"k1"))
    call("KvGet", fpb.FilerKvGetRequest(key=b"\x00never"))
    for req in (
        fpb.LockRangeRequest(path="/docs/big.bin", owner="a", start=0, end=100, exclusive=True, op=0),
        fpb.LockRangeRequest(path="/docs/big.bin", owner="b", start=50, end=60, exclusive=False, op=0),
        fpb.LockRangeRequest(path="/docs/big.bin", owner="b", start=50, end=60, exclusive=True, op=2),
        fpb.LockRangeRequest(path="/docs/big.bin", owner="b", start=100, end=0, exclusive=False, op=0),
        fpb.LockRangeRequest(path="/docs/big.bin", owner="a", lease_seconds=60, op=3),
        fpb.LockRangeRequest(path="/docs/big.bin", owner="c", op=3),
        fpb.LockRangeRequest(path="/docs/big.bin", owner="a", op=1),
        fpb.LockRangeRequest(path="/docs/big.bin", owner="b", start=0, end=10, op=2),
        fpb.LockRangeRequest(path="/docs/big.bin", owner="a", op=7),
    ):
        call("LockRange", req)
    call("DistributedLock", fpb.DlmRequest(op="lock", name="n", owner="o", ttl_seconds=5))
    call("AssignVolume", fpb.AssignVolumeRequest(count=1))
    a = st.AssignVolume(fpb.AssignVolumeRequest(count=1), timeout=30)
    vid = int(a.fid.split(",")[0])
    call("LookupVolume", pb.LookupVolumeRequest(volume_ids=[vid, 987654]))
    vl = st.LookupVolume(pb.LookupVolumeRequest(volume_ids=[vid]), timeout=30).volume_locations[0]
    out.append(("holder", [loc.url for loc in vl.locations] == [a.url]))
    fids = [c.fid for c in h.filer.find_entry("/moved/l.bin").chunks]
    call("DeleteEntry", fpb.DeleteEntryRequest(directory="/docs", name="sub"))
    call("DeleteEntry", fpb.DeleteEntryRequest(directory="/", name="moved"))
    call("DeleteEntry", fpb.DeleteEntryRequest(directory="/docs", name="big.bin", is_delete_data=True))
    call("DeleteEntry", fpb.DeleteEntryRequest(directory="/", name="moved", is_recursive=True,
                                               is_delete_data=True))
    h.filer.flush_gc()

    def gone():
        for fid in fids:
            try:
                h.filer.ops.read(fid, fast=False)
                return False
            except LookupError:
                continue
        return True

    wait_for(gone, timeout=20, msg="the deleted file's needles answer 404")
    stream("ListEntries", fpb.ListEntriesRequest(directory="/"))
    return out


def subscribe_all(stub, since: int, n: int, **kw) -> list:
    """The first n events of a SubscribeMetadata stream from `since`."""
    got = []
    call = stub.SubscribeMetadata(fpb.SubscribeMetadataRequest(client_name="t", since_ns=since, **kw),
                                  timeout=30)
    for ev in call:
        got.append(ev)
        if len(got) == n:
            break
    call.cancel()
    return got


def test_request_sequence_matches_jax(twins, tmp_path):
    got = {}
    for side in SIDES:
        h = Hosted(side, twins[side], tmp_path / side)
        try:
            out = request_sequence(h)
            records = h.meta_log.read_since(0, limit=100_000)
            evs = subscribe_all(h.stub, 0, len(records))
            out.append(("subscribe from 0", [norm_event(e) for e in evs]))
            assert [e.ts_ns for e in evs] == [r["tsNs"] for r in records]
            # a prefix: events of /docs and of its ancestors only
            pre = [r for r in records if r["directory"].startswith("/docs")
                   or "/docs".startswith(r["directory"])]
            evs = subscribe_all(h.stub, 0, len(pre), path_prefix="/docs/")
            out.append(("prefix", [norm_event(e) for e in evs]))
            # from a watermark in the middle
            mid = records[len(records) // 2]["tsNs"]
            evs = subscribe_all(h.stub, mid, len([r for r in records if r["tsNs"] > mid]))
            out.append(("from the middle", [norm_event(e) for e in evs]))
            got[side] = out
        finally:
            h.close()
    assert len(got["port"]) == len(got["jax"])
    for i, (p, j) in enumerate(zip(got["port"], got["jax"])):
        assert p == j, f"step {i}: {p[0]}"
    dl = [x for x in got["port"] if x[0] == "DistributedLock"][0]
    assert fpb.DlmResponse.FromString(dl[1]).error == "lock ring not configured"


@pytest.mark.parametrize("side", list(SIDES))
def test_subscribe_live_local_only_and_out_of_range(twins, tmp_path, side, monkeypatch):
    s = SIDES[side]
    h = Hosted(side, twins[side], tmp_path)
    try:
        h.filer.write_file("/live/before", b"1")
        last = h.meta_log.last_ts_ns
        got, opened = [], threading.Event()

        def follow():
            call = h.stub.SubscribeMetadata(
                fpb.SubscribeMetadataRequest(client_name="live", since_ns=last, local_only=True),
                timeout=30)
            opened.set()
            for ev in call:
                got.append(ev)
                if len(got) == 2:
                    call.cancel()
                    return

        t = threading.Thread(target=follow, daemon=True)
        t.start()
        opened.wait(10)
        time.sleep(0.2)
        # a remote event is re-logged with is_from_other_cluster: local_only skips it
        ev = fpb.FullEventNotification(directory="/live", ts_ns=time.time_ns() + 10**12)
        ev.event.new_entry.name = "remote"
        ev.event.new_entry.extended["sw-mts"] = str(ev.ts_ns).encode()
        assert h.filer.apply_remote_event(ev)
        h.filer.write_file("/live/after", b"2")
        h.filer.delete_entry("/live/after")
        t.join(15)
        assert not t.is_alive()
        assert [(e.directory, e.event.new_entry.name, e.event.old_entry.name) for e in got] == [
            ("/live", "after", ""), ("/live", "", "after")]
        # rotation past retention: a watermark below the dropped events
        monkeypatch.setattr(s.pkg.meta_log, "SEGMENT_BYTES", 500)
        monkeypatch.setattr(s.pkg.meta_log, "KEEP_SEGMENTS", 1)
        for i in range(12):
            h.filer.write_file(f"/rot/f{i}", bytes(10))
        assert h.meta_log.dropped_before_ts > 0
        with pytest.raises(grpc.RpcError) as ei:
            subscribe_all(h.stub, 1, 1)
        assert ei.value.code() == grpc.StatusCode.OUT_OF_RANGE
        assert "resync required" in ei.value.details()
        # from 0 replays what retention kept
        kept = h.meta_log.read_since(0, limit=1000)
        assert [e.ts_ns for e in subscribe_all(h.stub, 0, len(kept))] == [r["tsNs"] for r in kept]
    finally:
        h.close()
    bare = Hosted(side, twins[side], tmp_path / "bare", meta_log=False)
    try:
        with pytest.raises(grpc.RpcError) as ei:
            subscribe_all(bare.stub, 0, 1)
        assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        bare.close()


def test_run_lifecycle_matches_jax(twins, tmp_path):
    """RunLifecycle applies the stored S3 lifecycle rules where the
    metadata lives: the same counters and the same survivors in both."""
    rules = {
        "lc": [{"ID": "d", "Status": "Enabled", "Prefix": "old/", "ExpirationDate": "2020-01-01"},
               {"ID": "off", "Status": "Disabled", "Prefix": "", "ExpirationDays": 0}],
        "lcv": [{"ID": "e", "Status": "Enabled", "Prefix": "", "ExpirationDays": 0},
                {"ID": "a", "Status": "Enabled", "Prefix": "", "AbortMultipartDays": 0}],
    }
    got = {}
    for side in ("jax", "port"):
        h = Hosted(side, twins[side], tmp_path / side)
        try:
            f = h.filer
            for k in ("old/1", "old/deep/2", "new/1", "old1"):
                f.write_file(f"/buckets/lc/{k}", k.encode())
            f.write_file("/buckets/lcv/k", b"current")
            f.create_entry(SIDES[side].pkg.entry.new_entry("/buckets/.uploads/lcv/u1",
                                                            is_directory=True))
            f.store.kv_put(b"upload/u1", b"{}")
            f.store.kv_put(b"versioning/lcv", b"Enabled")
            for b, r in rules.items():
                f.store.kv_put(f"lifecycle-rules/{b}".encode(), json.dumps(r).encode())
            answers = [h.stub.RunLifecycle(fpb.LifecycleRunRequest(bucket=b), timeout=30)
                       .SerializeToString(deterministic=True) for b in ("nope", "lc", "", "lc")]
            survivors = sorted(e.full_path for d in ("/buckets/lc", "/buckets/lc/old",
                                                      "/buckets/lcv", "/buckets/.uploads/lcv")
                               for e in f.list_entries(d, limit=100))
            got[side] = (answers, survivors, f.store.kv_get(b"upload/u1"))
        finally:
            h.close()
    assert got["port"] == got["jax"]
    answers, survivors, upload = got["port"]
    assert fpb.LifecycleRunResponse.FromString(answers[1]).expired == 2
    r = fpb.LifecycleRunResponse.FromString(answers[2])
    assert (r.expired, r.aborted_uploads, r.error) == (1, 1, "")
    assert "/buckets/lc/old1" in survivors and "/buckets/lc/old/deep" in survivors
    assert upload is None


def mutate(f, seed: int) -> None:
    """A seeded run of writes, directories, renames, hard links and
    deletes on an origin filer."""
    rng = np.random.default_rng(seed)
    for i in range(8):
        f.write_file(f"/c/d{i % 3}/f{i}", rng.bytes(int(rng.choice([100, 600, 20_000]))))
    f.write_file("/c/tiny", b"x")
    f.hard_link("/c/d0/f0", "/c/link")
    f.write_file("/c/link", rng.bytes(700))
    f.rename("/c/d1", "/c/d1moved")
    f.rename("/c/tiny", "/c/d2/tiny")
    f.delete_entry("/c/d0/f3")
    f.mutate_entry("/c/d2/f2", lambda e: e.extended.__setitem__("tag", b"t"))
    f.delete_entry("/c/d2", recursive=True)
    f.write_file("/c/d2/again", b"back")


def namespace(f, d="/") -> list:
    out = []
    for e in f.store.list(d, limit=100_000):
        out.append((e.full_path, e.to_proto().SerializeToString(deterministic=True)))
        if e.is_directory:
            out += namespace(f, e.full_path)
    return out


@pytest.mark.parametrize("origin,follower", [("jax", "port"), ("port", "jax")])
def test_mixed_convergence(twins, tmp_path, origin, follower):
    """An aggregator of one package following the other's service reaches
    the origin's namespace entry for entry (a follower keeps the origin's
    entries verbatim, sw-mts included)."""
    o = Hosted(origin, twins[origin], tmp_path / "origin")
    s = SIDES[follower]
    fol = s.pkg.filer.Filer(s.pkg.store.MemoryStore(), master=twins[follower])
    agg = s.agg.MetaAggregator(fol, [o.addr], client_name=f"{follower}-follows-{origin}")
    try:
        o.filer.write_file("/c/first", b"before the aggregator")
        agg.start()
        mutate(o.filer, 31)
        want = namespace(o.filer)
        wait_for(lambda: namespace(fol) == want, timeout=30,
                 msg=f"the {follower} follower reaching the {origin} origin")
        n = len(o.meta_log.read_since(0, limit=100_000))
        last = o.meta_log.last_ts_ns
        # every event applied, and the watermark at the last one
        wait_for(lambda: agg.applied == n and agg._watermark.get(o.addr) == last, timeout=10,
                 msg="the aggregator's count and watermark")
        # the watermark persists in the follower's KV
        agg.stop()
        raw = fol.store.kv_get(f"meta-agg/{o.addr}".encode())
        assert int(raw) == o.meta_log.last_ts_ns
        # a restarted aggregator resumes from it and converges on new writes
        again = s.agg.MetaAggregator(fol, [o.addr])
        again.start()
        o.filer.write_file("/c/after-restart", b"later")
        want = namespace(o.filer)
        wait_for(lambda: namespace(fol) == want, timeout=30, msg="convergence after a restart")
        wait_for(lambda: again.applied == 1, timeout=10, msg="one event applied after the restart")
        again.stop()
    finally:
        agg.stop()
        fol.close()
        o.close()


def test_both_directions_converge_to_equal_namespaces(twins, tmp_path):
    """The namespace a port follower reaches from a JAX origin equals the
    one a JAX follower reaches from a port origin, once fids, hard-link ids
    and timestamps are masked."""
    got = {}
    for origin, follower in (("jax", "port"), ("port", "jax")):
        o = Hosted(origin, twins[origin], tmp_path / origin)
        s = SIDES[follower]
        fol = s.pkg.filer.Filer(s.pkg.store.MemoryStore(), master=twins[follower])
        agg = s.agg.MetaAggregator(fol, [o.addr])
        try:
            agg.start()
            mutate(o.filer, 32)
            want = namespace(o.filer)
            wait_for(lambda: namespace(fol) == want, timeout=30, msg="convergence")
            got[origin] = [(p, norm_entry(fpb.Entry.FromString(raw))) for p, raw in namespace(fol)]
        finally:
            agg.stop()
            fol.close()
            o.close()
    assert got["port"] == got["jax"]
    assert len(got["port"]) > 10
