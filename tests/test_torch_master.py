"""PyTorch port: the master (server/master.py, server/topology.py,
server/cluster_lock.py, client/master_client.py, the master, raft and
worker rows of pb/rpc.py), held against the JAX package's master on the CPU:

- the topology: the same heartbeat sequence (full and incremental
  heartbeats, telemetry, unregistration, dead nodes) into a port and a
  JAX `Topology` gives equal `to_proto`, `statistics`, `lookup`,
  `lookup_ec`, `plan_growth`, `garbage_candidates`, collections,
  writable and crowded buckets and KeepConnected updates, and equal
  `pick_for_write` draws from one seed;
- the master's RPCs: a port and a JAX `MasterServer` fed the same
  heartbeats over gRPC give equal Assign (picks, the bad-collection and
  bad-TTL errors, growth through AllocateVolume), VolumeGrow,
  CollectionList, CollectionDelete, Statistics, lock and VacuumControl
  answers, and a follower of an HA group answers every RPC as a JAX
  follower does;
- the HTTP plane: /dir/assign, /dir/lookup and /cluster/status equal
  (the fleet's EcFleetScrub and EcMigrations too), less the process-local
  EcStreams and EcResidency.local; /ui has the maintenance fleet's tables;
- mixed clusters: a JAX volume server under the port's master, and a port
  volume server under the JAX master, each assigned, written (a `001`
  write on two holders too), looked up and read back through the port's
  master client;
- the port's master, raft and worker tables have every row of the JAX
  ones.
"""

import http.client
import json
import random
import threading
import time

import grpc
import numpy as np
import pytest
from conftest import allocate_port, wait_for
from test_torch_volume_server import _ports

import seaweedfs_tpu.server.topology as jax_topology_mod
from seaweedfs_tpu.pb import rpc as jrpc
from seaweedfs_tpu.server.master import MasterServer as JaxMasterServer
from seaweedfs_tpu.server.topology import Topology as JaxTopology
from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer
from seaweedfs_tpu_torch.client.master_client import LockHeldError, MasterClient
from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.topology import Topology
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId

LIMIT = 1 << 20  # the volume size limit of every topology here
REPLICATIONS = ("", "000", "001", "010", "100", "011", "200", "002", "bad")
COLLECTIONS = ("", "pics", "logs")


# --------------------------------------------------------------- heartbeats


def node_hb(i: int, grpc_port: int = 0, **kw) -> pb.Heartbeat:
    return pb.Heartbeat(ip="127.0.0.1", port=9100 + i, public_url=f"pub{i}:80",
                        grpc_port=grpc_port or 19100 + i, max_volume_count=3 + i % 4,
                        data_center=f"dc{i % 2}", rack=f"r{i % 3}", **kw)


def rand_volume(rng, vid: int) -> pb.VolumeInfoMsg:
    size = int(rng.integers(0, LIMIT + LIMIT // 4))
    return pb.VolumeInfoMsg(
        id=vid, collection=str(rng.choice(COLLECTIONS)), size=size,
        file_count=int(rng.integers(0, 100)), deleted_count=int(rng.integers(0, 10)),
        deleted_bytes=int(rng.integers(0, size + 1)), read_only=bool(rng.random() < 0.2),
        replica_placement=str(rng.choice(["000", "001", "010"])), version=3,
        ttl=str(rng.choice(["", "", "3d"])), disk_type=str(rng.choice(["", "hdd", "ssd"])))


def rand_ec(rng, vid: int, gen: int = 1) -> pb.EcShardInfoMsg:
    return pb.EcShardInfoMsg(id=vid, collection=str(rng.choice(COLLECTIONS)),
                             shard_bits=int(rng.integers(1, 1 << 14)), shard_size=4096,
                             data_shards=10, parity_shards=4, generation=gen)


def hb_sequence(seed: int) -> list:
    """A seeded run of (op, node index, heartbeat) steps: registrations
    with full lists, full refreshes, incremental updates (new and deleted
    volumes, EC shards of older, equal and newer generations), telemetry,
    one unregistration and one dead node."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(6):
        vols = [rand_volume(rng, int(v)) for v in rng.choice(range(1, 30), size=int(rng.integers(0, 4)),
                                                              replace=False)]
        ecs = [rand_ec(rng, int(v)) for v in rng.choice(range(40, 50), size=int(rng.integers(0, 3)),
                                                        replace=False)]
        tele = json.dumps({"chips": {"cuda:0": {"load": int(rng.integers(0, 9))}},
                           "breakers_open": int(i == 2), "residency": {"budget": 4}}) if i % 2 else ""
        steps.append(("register", i, node_hb(i, volumes=vols, ec_shards=ecs,
                                               has_no_volumes=not vols, has_no_ec_shards=not ecs,
                                               ec_telemetry_json=tele)))
    for _ in range(14):
        i = int(rng.integers(0, 6))
        kind = rng.random()
        if kind < 0.3:
            vols = [rand_volume(rng, int(v)) for v in rng.choice(range(1, 30), size=2, replace=False)]
            steps.append(("sync", i, node_hb(i, volumes=vols, has_no_ec_shards=bool(rng.random() < .5))))
        else:
            steps.append(("incr", i, node_hb(
                i, new_volumes=[rand_volume(rng, int(rng.integers(1, 35)))],
                deleted_volumes=[int(rng.integers(1, 30))],
                new_ec_shards=[rand_ec(rng, int(rng.integers(40, 50)), gen=int(rng.integers(0, 3)))],
                deleted_ec_shards=[pb.EcShardInfoMsg(id=int(rng.integers(40, 50)),
                                                     shard_bits=int(rng.integers(1, 1 << 14)))],
                ec_telemetry_json="{not json" if kind > 0.9 else "")))
    steps.append(("unregister", int(rng.integers(0, 6)), None))
    steps.append(("dead", int(rng.integers(0, 6)), None))
    return steps


def copy(hb):
    """Each topology its own message: the heartbeat paths keep and mutate
    the EC entries they are given."""
    return pb.Heartbeat.FromString(hb.SerializeToString())


def apply_step(topo, registered: dict, op: str, i: int, hb) -> None:
    nid = f"127.0.0.1:{9100 + i}"
    if op == "register":
        node = topo.register_node(copy(hb))
        topo.sync_registration(node, copy(hb))
        registered[i] = node
    elif op == "unregister":
        topo.unregister_node(nid)
    elif op == "dead":
        node = topo.nodes.get(nid)
        if node is not None:
            node.last_seen = 0.0
    elif i in registered:
        node = registered[i]
        if op == "sync":
            topo.sync_registration(node, copy(hb))
        else:
            topo.incremental_update(node, copy(hb))


def ids(nodes) -> list:
    return [n.node_id for n in nodes]


def view(topo, seed: int) -> dict:
    """Everything the master answers from its topology, as plain data."""
    vids = range(0, 52)
    out = {
        "proto": topo.to_proto(),
        "stats": topo.statistics(),
        "lookup": [list(topo.lookup(v)) for v in vids],
        "lookup_ec": [sorted((s, list(locs)) for s, locs in topo.lookup_ec(v).items()) for v in vids],
        "collections": topo.collections(),
        "max_volume_id": topo.max_volume_id,
        "garbage": [topo.garbage_candidates(t) for t in (0.0, 0.3, 0.9)],
        "growth": [ids(topo.plan_growth(r)) for r in REPLICATIONS],
        "col_volumes": [sorted(topo.collection_volumes(c)) for c in COLLECTIONS],
        "col_ec": [sorted(topo.collection_ec_shards(c)) for c in COLLECTIONS],
        "telemetry": {n: {k: v for k, v in node.ec_telemetry.items() if k != "received_at"}
                      for n, node in sorted(topo.nodes.items())},
        "tree": {dc: {r: sorted(rack.nodes) for r, rack in d.racks.items()}
                 for dc, d in sorted(topo.data_centers.items())},
    }
    buckets = [(c, r, t, d) for c in COLLECTIONS for r in ("", "000", "001", "010")
               for t in ("", "3d") for d in ("", "hdd", "ssd")]
    out["writable"] = [[(v, ids(h)) for v, h in topo.writable_volumes(*b)] for b in buckets]
    out["crowded"] = [topo.all_crowded(*b) for b in buckets]
    picks = []
    for k, b in enumerate(buckets):
        if isinstance(topo, Topology):
            topo.rng = random.Random(seed * 1000 + k)
            got = topo.pick_for_write(*b)
        else:
            # the JAX draw comes from its module's `random`: a seeded
            # instance in its place for this one call
            saved = jax_topology_mod.random
            jax_topology_mod.random = random.Random(seed * 1000 + k)
            try:
                got = topo.pick_for_write(*b)
            finally:
                jax_topology_mod.random = saved
        picks.append(None if got is None else (got[0], ids(got[1])))
    out["picks"] = picks
    return out


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_topology_from_the_same_heartbeats_equals_jax(seed):
    port, jax = Topology(volume_size_limit=LIMIT), JaxTopology(volume_size_limit=LIMIT)
    qs = [port.subscribe()[0], jax.subscribe()[0]]
    regs = [{}, {}]
    for step, (op, i, hb) in enumerate(hb_sequence(seed)):
        for topo, reg in zip((port, jax), regs):
            apply_step(topo, reg, op, i, hb)
        if op == "dead":
            assert port.prune_dead() == jax.prune_dead()
        got, want = view(port, seed * 100 + step), view(jax, seed * 100 + step)
        for key in want:
            assert got[key] == want[key], (step, op, key)
        updates = []
        for q in qs:
            drained = []
            while not q.empty():
                drained.append(q.get_nowait())
            updates.append(drained)
        assert updates[0] == updates[1], (step, op)
    # a new session's snapshot, and the allocator's two paths
    assert port.subscribe()[1] == jax.subscribe()[1]
    for topo in (port, jax):
        topo.optimistic_add_volume(next(iter(topo.nodes.values())), pb.VolumeInfoMsg(id=77))
    assert port.apply_allocated_volume_id(5) == jax.apply_allocated_volume_id(5)
    assert port.next_volume_id() == jax.next_volume_id()
    assert port.to_proto() == jax.to_proto()
    port.publish_leader("m:1")
    jax.publish_leader("m:1")
    notes = [[q.get_nowait() for _ in range(q.qsize())] for q in qs]
    assert notes[0] == notes[1] and notes[0][-1] == pb.VolumeLocationUpdate(leader="m:1")


def test_prune_dead_and_stale_unregister_match_jax():
    port, jax = Topology(volume_size_limit=LIMIT), JaxTopology(volume_size_limit=LIMIT)
    out = []
    for topo in (port, jax):
        nodes = [topo.register_node(copy(node_hb(i, volumes=[pb.VolumeInfoMsg(id=i + 1)])))
                 for i in range(4)]
        for n in nodes:
            n.owner_token = object()
        nodes[1].last_seen = nodes[3].last_seen = time.time() - 60
        topo.unregister_node(nodes[0].node_id, owner_token=object())  # a stale stream: kept
        dead = topo.prune_dead()
        out.append((dead, sorted(topo.nodes), topo.statistics(), topo.to_proto()))
    assert out[0] == out[1]
    assert out[0][0] == ["127.0.0.1:9101", "127.0.0.1:9103"]


def test_topology_draw_is_seedable():
    hb = node_hb(0, volumes=[pb.VolumeInfoMsg(id=v, replica_placement="000") for v in range(1, 9)])
    picks = []
    for _ in range(2):
        topo = Topology(volume_size_limit=LIMIT, rng=random.Random(11))
        topo.sync_registration(topo.register_node(hb), hb)
        picks.append([topo.pick_for_write("", "000")[0] for _ in range(20)])
    assert picks[0] == picks[1] and len(set(picks[0])) > 1


# ---------------------------------------------------------- the master's RPCs


class Recorder:
    """A volume server's gRPC face that answers the RPCs a master sends
    (AllocateVolume, VolumeDelete, VolumeEcShardsUnmount and Delete,
    VacuumVolume) and records them; `fail` makes VolumeDelete answer an
    error."""

    METHODS = {
        "AllocateVolume": (pb.AllocateVolumeRequest, pb.AllocateVolumeResponse),
        "VolumeDelete": (pb.VolumeCommandRequest, pb.VolumeCommandResponse),
        "VolumeEcShardsUnmount": (pb.EcShardsUnmountRequest, pb.EcShardsUnmountResponse),
        "VolumeEcShardsDelete": (pb.EcShardsDeleteRequest, pb.EcShardsDeleteResponse),
        "VacuumVolume": (pb.VacuumRequest, pb.VacuumResponse),
    }

    def __init__(self):
        from concurrent import futures

        self.calls = []
        self.fail = set()
        self._lock = threading.Lock()
        self.port = allocate_port()
        self._grpc = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        handlers = {}
        for name, (req_t, resp_t) in self.METHODS.items():
            handlers[name] = grpc.unary_unary_rpc_method_handler(
                self._handler(name, resp_t), request_deserializer=req_t.FromString,
                response_serializer=resp_t.SerializeToString)
        self._grpc.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(rpc.VOLUME_SERVICE, handlers),))
        self._grpc.add_insecure_port(f"127.0.0.1:{self.port}")
        self._grpc.start()

    def _handler(self, name, resp_t):
        def handle(request, context):
            with self._lock:
                self.calls.append((name, request))
            if name == "VolumeDelete" and request.volume_id in self.fail:
                return resp_t(error="disk on fire")
            return resp_t()
        return handle

    def take(self) -> list:
        with self._lock:
            out, self.calls = sorted(self.calls, key=lambda c: (c[0], c[1].SerializeToString())), []
            return out

    def stop(self):
        self._grpc.stop(0)


class Fed:
    """A master fed heartbeats by hand over gRPC: each node's stream stays
    open (an ended stream unregisters the node)."""

    def __init__(self, master):
        self.master = master
        self.channel = grpc.insecure_channel(f"127.0.0.1:{master.port + 10000}")
        self.stub = rpc.master_stub(self.channel)
        self.raft = rpc.Stub(self.channel, rpc.RAFT_SERVICE)
        self._held = threading.Event()
        self._calls = []

    def feed(self, hbs):
        def one(hb):
            yield hb
            self._held.wait(120)

        for hb in hbs:  # one after the other: lookups list nodes in registration order
            call = self.stub.SendHeartbeat(one(copy(hb)))
            self._calls.append(call)
            assert next(call).volume_size_limit == LIMIT
        wait_for(lambda: len(self.master.topo.nodes) == len(hbs), msg="nodes did not register")

    def close(self):
        self._held.set()
        for c in self._calls:
            c.cancel()
        self.channel.close()


def masters(**kw):
    port = MasterServer(ip="127.0.0.1", port=allocate_port(), volume_size_limit=LIMIT,
                        vacuum_interval=3600, **kw)
    jax = JaxMasterServer(ip="127.0.0.1", port=allocate_port(), volume_size_limit=LIMIT,
                          vacuum_interval=3600, **kw)
    for m in (port, jax):
        m.start()
    wait_for(lambda: port.is_leader and jax.is_leader, msg="single masters did not lead")
    return port, jax


def cluster_hbs(recorder_port: int) -> list:
    """Four nodes on two racks, writable volumes in two collections, an
    EC volume, all behind the recorder's gRPC port."""
    vol = lambda vid, col="", rp="000", size=100, **kw: pb.VolumeInfoMsg(  # noqa: E731
        id=vid, collection=col, replica_placement=rp, size=size, version=3, **kw)
    return [
        node_hb(0, recorder_port, volumes=[vol(1), vol(2, "pics"), vol(5, "pics", "001")],
                ec_shards=[pb.EcShardInfoMsg(id=9, collection="logs", shard_bits=0b1111,
                                             data_shards=10, parity_shards=4)]),
        node_hb(1, recorder_port, volumes=[vol(3), vol(5, "pics", "001"), vol(4, size=LIMIT)],
                ec_shards=[pb.EcShardInfoMsg(id=9, collection="logs", shard_bits=0b11110000,
                                             data_shards=10, parity_shards=4)]),
        node_hb(2, recorder_port, volumes=[vol(6, "logs", deleted_bytes=90)]),
        node_hb(3, recorder_port, has_no_volumes=True, has_no_ec_shards=True),
    ]


@pytest.fixture
def fed_pair():
    rec = Recorder()
    port, jax = masters()
    fed = [Fed(port), Fed(jax)]
    for f in fed:
        f.feed(cluster_hbs(rec.port))
    yield fed, rec
    for f in fed:
        f.close()
    port.stop()
    jax.stop()
    rec.stop()


def each(fed, fn):
    """fn(fed master) on the port's, then the JAX one."""
    return [fn(f) for f in fed]


def norm_assign(r: pb.AssignResponse):
    out = pb.AssignResponse()
    out.CopyFrom(r)
    if out.fid:
        fid = FileId.parse(out.fid)
        out.fid = str(fid.volume_id)  # the needle id and cookie are fresh draws
    return out


ASSIGNS = [
    {},
    {"collection": "pics"},
    {"collection": "pics", "replication": "001"},
    {"collection": "logs", "count": 3},
    {"collection": "bad/name"},
    {"collection": "x\n"},
    {"ttl": "bogus"},
    {"ttl": "90"},
    {"replication": "300"},  # needs four data centers: growth fails
    {"disk_type": "ssd"},
]


@pytest.mark.parametrize("req", ASSIGNS, ids=lambda r: json.dumps(r, sort_keys=True))
def test_assign_matches_jax(fed_pair, monkeypatch, req):
    fed, rec = fed_pair
    answers, calls = [], []
    for k, f in enumerate(fed):
        if k == 0:
            f.master.topo.rng = random.Random(5)
        else:
            monkeypatch.setattr(jax_topology_mod, "random", random.Random(5))
        answers.append([norm_assign(f.stub.Assign(pb.AssignRequest(**req), timeout=30))
                        for _ in range(4)])
        calls.append(rec.take())
        answers[-1].append(f.stub.Topology(pb.TopologyRequest(), timeout=10))
    assert answers[0] == answers[1]
    assert calls[0] == calls[1]


def test_growth_allocates_through_the_log_and_registers(fed_pair, monkeypatch):
    fed, rec = fed_pair
    out = []
    fed[0].master.topo.rng = random.Random(2)
    monkeypatch.setattr(jax_topology_mod, "random", random.Random(2))
    for f in fed:
        grown = f.stub.VolumeGrow(pb.VolumeGrowRequest(count=2, collection="new", replication="100"),
                                  timeout=30)
        bad = [f.stub.VolumeGrow(pb.VolumeGrowRequest(collection="a/b"), timeout=30),
               f.stub.VolumeGrow(pb.VolumeGrowRequest(ttl="zz"), timeout=30)]
        a = norm_assign(f.stub.Assign(pb.AssignRequest(collection="new", replication="100"),
                                      timeout=30))
        out.append((grown, bad, a, rec.take(), f.stub.Topology(pb.TopologyRequest(), timeout=10),
                    f.master.raft.commit_index))
    assert out[0] == out[1]
    grown = out[0][0]
    assert list(grown.volume_ids) == [7, 8]  # past the heartbeats' max (6), through the log
    assert [c[0] for c in out[0][3]] == ["AllocateVolume"] * 4


def test_collections_statistics_and_delete_match_jax(fed_pair):
    fed, rec = fed_pair
    rec.fail = {6}
    out = []
    for f in fed:
        out.append((
            f.stub.CollectionList(pb.CollectionListRequest(), timeout=10),
            f.stub.Statistics(pb.StatisticsRequest(), timeout=10),
            f.stub.CollectionDelete(pb.CollectionDeleteRequest(name=""), timeout=10),
            f.stub.CollectionDelete(pb.CollectionDeleteRequest(name="logs"), timeout=30),
            f.stub.CollectionDelete(pb.CollectionDeleteRequest(name="pics"), timeout=30),
            rec.take(),
        ))
    assert out[0] == out[1]
    assert "volume 6@127.0.0.1: disk on fire" in out[0][3].error
    assert list(out[0][4].deleted_volume_ids) == [2, 5]


def test_locks_and_vacuum_control_match_jax(fed_pair):
    fed, _ = fed_pair
    out = []
    for f in fed:
        s = f.stub
        first = s.AdminLock(pb.LockRequest(name="shell", owner="alice", ttl_seconds=30), timeout=10)
        busy = s.AdminLock(pb.LockRequest(name="shell", owner="bob"), timeout=10)
        renew = s.AdminLock(pb.LockRequest(name="shell", owner="alice", ttl_seconds=5,
                                           token=first.token), timeout=10)
        other = s.AdminLock(pb.LockRequest(name="vol.7", owner="bob", ttl_seconds=10), timeout=10)
        status = s.AdminLockStatus(pb.LockStatusRequest(), timeout=10)
        wrong = s.AdminUnlock(pb.UnlockRequest(name="shell", token="nope"), timeout=10)
        right = s.AdminUnlock(pb.UnlockRequest(name="shell", token=first.token), timeout=10)
        again = s.AdminLock(pb.LockRequest(name="shell", owner="bob"), timeout=10)
        vc = [s.VacuumControl(pb.VacuumControlRequest(volume_id=6, disable=True), timeout=10)]
        off = f.master.topo.garbage_candidates(0.3)
        vc.append(s.VacuumControl(pb.VacuumControlRequest(volume_id=6, disable=False), timeout=10))
        on = f.master.topo.garbage_candidates(0.3)
        assert first.ok and renew.token == first.token and other.token != first.token
        for r in (first, busy, renew, other, again):
            assert 0 < r.expires_ns <= 60e9
            r.ClearField("token")
            r.ClearField("expires_ns")
        rows = [(r.name, r.owner, 0 < r.expires_ns <= 30e9) for r in status.locks]
        out.append((first, busy, renew, other, rows, wrong, right, again, vc, off, on))
    assert out[0] == out[1]
    assert out[0][1].error == "held by alice" and out[0][4] == [("shell", "alice", True),
                                                               ("vol.7", "bob", True)]
    assert out[0][9] == [] and out[0][10] == [(6, "127.0.0.1", out[0][10][0][2])]


def test_keepconnected_and_lookups_match_jax(fed_pair):
    fed, _ = fed_pair
    out = []
    for f in fed:
        session = f.stub.KeepConnected(pb.KeepConnectedRequest(client_id="t"))
        snapshot = []
        for u in session:
            if u.leader:  # the snapshot-complete marker names the serving master
                assert u.leader == f.master.node_id
                break
            snapshot.append(u)
        f.master.topo.optimistic_add_volume(f.master.topo.nodes["127.0.0.1:9103"],
                                            pb.VolumeInfoMsg(id=13))
        delta = next(session)
        session.cancel()
        out.append((
            sorted(snapshot, key=lambda u: u.url), delta,
            [f.stub.LookupVolume(pb.LookupVolumeRequest(volume_ids=[v]), timeout=10)
             for v in (1, 5, 9, 13, 99)],
            [f.stub.LookupEcVolume(pb.LookupEcVolumeRequest(volume_id=v), timeout=10) for v in (9, 1)],
        ))
    assert out[0] == out[1]
    assert list(out[0][1].new_vids) == [13]


# ------------------------------------------------------------ the follower


def group(cls, n: int, tmp_path, tag: str):
    ports = [allocate_port() for _ in range(n)]
    peers = [f"127.0.0.1:{p}" for p in ports]
    ms = []
    for i, p in enumerate(ports):
        d = tmp_path / f"{tag}{i}"
        d.mkdir()
        ms.append(cls(ip="127.0.0.1", port=p, peers=peers, meta_dir=str(d),
                      volume_size_limit=LIMIT, vacuum_interval=3600))
    for m in ms:
        m.start()
    return ms


def settled(ms) -> bool:
    leaders = [m for m in ms if m.is_leader]
    return len(leaders) == 1 and all(m.raft.leader == leaders[0].node_id for m in ms)


def test_follower_answers_match_jax(tmp_path):
    groups = [group(MasterServer, 2, tmp_path, "p"), group(JaxMasterServer, 2, tmp_path, "j")]
    chans = []
    try:
        out = []
        for ms in groups:
            wait_for(lambda: settled(ms), timeout=60, msg="no settled leader")
            leader = next(m for m in ms if m.is_leader)
            follower = next(m for m in ms if not m.is_leader)
            ch = grpc.insecure_channel(f"127.0.0.1:{follower.port + 10000}")
            chans.append(ch)
            s = rpc.master_stub(ch)
            answers = [
                s.Assign(pb.AssignRequest(), timeout=10),
                s.VolumeGrow(pb.VolumeGrowRequest(), timeout=10),
                s.LookupVolume(pb.LookupVolumeRequest(volume_ids=[1, 2]), timeout=10),
                s.LookupEcVolume(pb.LookupEcVolumeRequest(volume_id=3), timeout=10),
                s.AdminLock(pb.LockRequest(name="x", owner="o"), timeout=10),
                s.AdminUnlock(pb.UnlockRequest(name="x"), timeout=10),
                s.CollectionDelete(pb.CollectionDeleteRequest(name="c"), timeout=10),
                next(s.KeepConnected(pb.KeepConnectedRequest(client_id="t"))),
                next(s.SendHeartbeat(iter([node_hb(0)]))),
            ]
            for name, req in (("Statistics", pb.StatisticsRequest()),
                              ("Topology", pb.TopologyRequest()),
                              ("CollectionList", pb.CollectionListRequest()),
                              ("AdminLockStatus", pb.LockStatusRequest())):
                with pytest.raises(grpc.RpcError) as e:
                    getattr(s, name)(req, timeout=10)
                answers.append((e.value.code(), e.value.details()))
            text = str(answers).replace(leader.node_id, "<leader>")
            out.append(text)
            assert "<leader>" in text
        assert out[0] == out[1]
        assert "not leader; leader=<leader>" in out[0]
    finally:
        for ch in chans:
            ch.close()
        for ms in groups:
            for m in ms:
                m.stop()


# -------------------------------------------------------------- HTTP plane


def get(port: int, path: str):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


def status_doc(body: bytes) -> dict:
    doc = json.loads(body)
    doc.pop("EcStreams")  # process-local
    doc["EcResidency"].pop("local")
    for blob in doc["EcTelemetry"].values():
        blob.pop("received_at")
        blob["age_s"] = 0.0
    return doc


def test_http_plane_matches_jax(fed_pair, monkeypatch):
    fed, rec = fed_pair
    tele = json.dumps({"chips": {"cuda:0": {"load": 3}}, "breakers_open": 1,
                       "residency": {"budget": 4, "chips": {}}})
    out = []
    for k, f in enumerate(fed):
        if k == 0:
            f.master.topo.rng = random.Random(9)
        else:
            monkeypatch.setattr(jax_topology_mod, "random", random.Random(9))
        f.master.topo._absorb_telemetry(f.master.topo.nodes["127.0.0.1:9101"],
                                        pb.Heartbeat(ec_telemetry_json=tele))
        p = f.master.port
        answers = []
        for path in ("/dir/assign", "/dir/assign?collection=pics&count=2",
                     "/dir/assign?collection=../x", "/dir/assign?ttl=zz",
                     "/dir/assign?collection=new&replication=001", "/dir/lookup?volumeId=5",
                     "/dir/lookup?volumeId=9,0a0b", "/dir/lookup?volumeId=77", "/nope"):
            code, ctype, body = get(p, path)
            doc = json.loads(body)
            if "fid" in doc:
                doc["fid"] = doc["fid"].split(",")[0]
            answers.append((path, code, ctype, doc))
        code, ctype, body = get(p, "/cluster/status")
        answers.append((code, ctype, status_doc(body)))
        answers.append(get(p, "/dir/status")[0])
        answers.append(rec.take())
        out.append(answers)
    assert out[0] == out[1]
    assert out[0][0][1] == 200 and out[0][2][1] == 500 and out[0][7][1] == 404
    doc = out[0][9][2]
    assert doc["IsLeader"] and doc["EcTelemetry"]["127.0.0.1:9101"]["stale"] is False
    assert doc["EcResidency"]["nodes"] == {"127.0.0.1:9101": {"budget": 4, "chips": {}}}
    # the port's other pages
    p = fed[0].master.port
    code, ctype, body = get(p, "/ui")
    assert code == 200 and ctype.startswith("text/html") and b"127.0.0.1:9100" in body
    assert b"<h2>maintenance fleet</h2>" in body and b"no workers" in body and b"no tasks" in body
    code, _, body = get(p, "/metrics")
    assert code == 200 and b"sw_ec_queue_load" in body
    code, _, body = get(p, "/debug/slo")
    assert code == 200 and isinstance(json.loads(body), dict)


def test_master_and_raft_tables_have_every_jax_row():
    for service in (rpc.MASTER_SERVICE, rpc.RAFT_SERVICE, rpc.WORKER_SERVICE):
        got = {n: (k, a.DESCRIPTOR.full_name, b.DESCRIPTOR.full_name)
               for n, (k, a, b) in rpc.SERVICES[service].items()}
        want = {n: (k, a.DESCRIPTOR.full_name, b.DESCRIPTOR.full_name)
                for n, (k, a, b) in jrpc.SERVICES[service].items()}
        assert got == want, service
    assert len(rpc.SERVICES[rpc.MASTER_SERVICE]) == 14 and len(rpc.SERVICES[rpc.RAFT_SERVICE]) == 5
    assert len(rpc.SERVICES[rpc.WORKER_SERVICE]) == 6


# --------------------------------------------------------- mixed clusters


def http_req(url: str, method: str, path: str, body: bytes | None = None):
    host, _, port = url.partition(":")
    c = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        c.request(method, path, body=body)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


@pytest.mark.parametrize("layout", ["port master, jax servers", "jax master, port servers"])
def test_mixed_cluster_assigns_writes_and_looks_up(tmp_path, layout):
    master_cls, vs_cls = ((MasterServer, JaxVolumeServer) if layout.startswith("port")
                          else (JaxMasterServer, VolumeServer))
    mport = allocate_port()
    master = master_cls(ip="127.0.0.1", port=mport, vacuum_interval=3600)
    master.start()
    vols = []
    mc = MasterClient(f"127.0.0.1:{mport}")
    try:
        for i in range(2):
            vs = vs_cls([str(tmp_path / f"v{i}")], master=f"127.0.0.1:{mport}", ip="127.0.0.1",
                        port=_ports(), ec_backend="cpu", rack=f"r{i}")
            vs.start()
            vols.append(vs)
        wait_for(lambda: len(master.topo.nodes) == 2, timeout=30, msg="servers did not register")
        rng = np.random.default_rng(3)
        written = {}
        for replication in ("", "010"):
            for _ in range(5):
                a = mc.assign(collection="mix", replication=replication)
                body = rng.bytes(int(rng.integers(1, 50_000)))
                code, answer = http_req(a.url, "POST", f"/{a.fid}", body)
                assert code == 201, answer
                written[a.fid] = (body, 1 + (replication == "010"))
        for fid, (body, copies) in written.items():
            vid = FileId.parse(fid).volume_id
            locs = mc.lookup(vid, refresh=True)
            assert len(locs) == copies
            for loc in locs:  # every holder the master names reads the write back
                assert http_req(loc.url, "GET", f"/{fid}") == (200, body)
        vids = sorted({FileId.parse(f).volume_id for f in written})
        assert len(vids) == 2 and mc.collections() == ["mix"]
        assert mc.statistics().volume_count == 2 and mc.statistics().node_count == 2
        token = mc.lock("admin", "t1", ttl=5)
        with pytest.raises(LockHeldError) as e:
            mc.lock("admin", "t2")
        assert e.value.holder == "t1" and mc.unlock("admin", token)
        assert sorted(mc.collection_delete("mix")) == vids
        wait_for(lambda: not mc.collections(), timeout=30, msg="the collection did not go")
    finally:
        mc.close()
        for vs in vols:
            vs.stop()
        master.stop()
