"""PyTorch port: raft HA of the master (server/raft.py under
server/master.py), on the CPU, in-process on free loopback ports:

- a three-node port group elects one leader, fails over when it stops,
  and never hands out a volume id twice; a follower answers `not leader;
  leader=...` and the port's master client follows that hint;
- a follower lost while the log was compacted is replaced, and its
  replacement, whose entries the leader no longer holds, is caught up by
  InstallSnapshot;
- membership changes: a single master grown to three (the
  RaftChangeMembership RPC, then `add_server`), failover in the grown
  group, then shrunk to one that commits alone; and a dead member removed
  from a group of two;
- one mixed group of two port nodes and one JAX node elects a leader,
  commits allocations on every node, and fails over;
- the `raft.jsonl` state file: the same proposals write byte-identical
  files in both packages, and a `-mdir` written by either package is
  loaded by the other with the same `max_volume_id`; compaction bounds it;
- a KeepConnected client and a volume server re-home after failover, and
  the new leader grows a volume with an id never handed out.

Every wait is on a condition with a deadline; the election timeouts are
the master's defaults (0.4-0.8 s), wide enough for a loaded CPU.
"""

import json
import os
import time

import grpc
import pytest
from conftest import allocate_port, wait_for
from test_torch_volume_server import _ports

from seaweedfs_tpu.server.master import MasterServer as JaxMasterServer
from seaweedfs_tpu.server.raft import RaftNode as JaxRaftNode
from seaweedfs_tpu_torch.client.master_client import MasterClient
from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.raft import RaftNode
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

ELECT_S = 45.0  # deadline of an election under a loaded CPU


def start_master(cls, port: int, peers, d, **kw):
    os.makedirs(d, exist_ok=True)
    m = cls(ip="127.0.0.1", port=port, peers=peers, meta_dir=str(d), vacuum_interval=3600, **kw)
    m.start()
    return m


def start_group(tmp_path, classes, tag="m"):
    ports = [allocate_port() for _ in classes]
    peers = [f"127.0.0.1:{p}" for p in ports]
    return [start_master(cls, p, peers, tmp_path / f"{tag}{i}")
            for i, (cls, p) in enumerate(zip(classes, ports))], peers


def leader_of(ms, timeout=ELECT_S):
    """The one leader that every live member follows."""
    holder = {}

    def settled():
        leaders = [m for m in ms if m.is_leader]
        if len(leaders) != 1:
            return False
        holder["m"] = leaders[0]
        return all(m.raft.leader == leaders[0].node_id for m in ms)

    wait_for(settled, timeout=timeout, msg="no leader that every member follows")
    return holder["m"]


def stop_all(ms):
    for m in ms:
        try:
            m.stop()
        except Exception:  # noqa: BLE001 — already stopped
            pass


def applied(ms, index: int) -> bool:
    return all(m.raft.last_applied >= index for m in ms)


def test_three_node_group_elects_fails_over_and_reuses_no_id(tmp_path):
    ms, peers = start_group(tmp_path, [MasterServer] * 3)
    mc = None
    try:
        leader = leader_of(ms)
        before = [leader._alloc_volume_id() for _ in range(4)]
        assert before == sorted(set(before))
        idx = leader.raft.commit_index
        wait_for(lambda: applied(ms, idx), timeout=ELECT_S, msg="followers did not apply")
        assert {m.topo.max_volume_id for m in ms} == {before[-1]}
        follower = next(m for m in ms if m is not leader)
        r = follower.service.Assign(pb.AssignRequest(), None)
        assert r.error == f"not leader; leader={leader.node_id}"
        # the client tries the follower first and follows its hint
        mc = MasterClient(",".join([follower.node_id, leader.node_id]))
        token = mc.lock("t", "me")
        assert token and mc._leader == leader.node_id
        assert mc.raft_status().role == "leader"
        leader.stop()
        rest = [m for m in ms if m is not leader]
        new = leader_of(rest)
        after = [new._alloc_volume_id() for _ in range(4)]
        assert min(after) > max(before), (before, after)
        assert new is not leader
    finally:
        if mc is not None:
            mc.close()
        stop_all(ms)


def test_lagging_follower_is_caught_up_by_install_snapshot(tmp_path):
    """A follower is lost while the log is compacted; the member that
    replaces it starts with an empty log, which the leader no longer holds
    the entries for: InstallSnapshot catches it up."""
    ms, peers = start_group(tmp_path, [MasterServer] * 3)
    try:
        leader = leader_of(ms)
        lost = next(m for m in ms if m is not leader)
        lost.stop()
        leader.raft.compact_threshold = 32
        last = 0
        for _ in range(150):
            last = leader._alloc_volume_id()
        assert leader.raft.snap_index > 0  # the early entries are gone from the log
        assert leader.raft.remove_server(lost.node_id) == sorted(set(peers) - {lost.node_id})
        port = allocate_port()
        fresh = start_master(MasterServer, port, [*peers, f"127.0.0.1:{port}"], tmp_path / "fresh")
        ms.append(fresh)
        live = [m for m in ms if m is not lost]
        leader.raft.add_server(fresh.node_id)
        target = leader.raft.last_applied
        wait_for(lambda: fresh.raft.last_applied >= target, timeout=ELECT_S,
                 msg="the new follower did not catch up")
        # its own threshold is 1024: a snapshot this early came from the leader
        assert fresh.raft.snap_index > 0 and fresh.topo.max_volume_id >= last
        assert leader_of(live) is leader
    finally:
        stop_all(ms)


def test_membership_grow_shrink_and_failover(tmp_path):
    ports = [allocate_port() for _ in range(3)]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    ms = [start_master(MasterServer, ports[0], [addrs[0]], tmp_path / "m0")]
    try:
        leader = leader_of(ms)
        ids = [leader._alloc_volume_id() for _ in range(3)]
        # the second joins through the RPC, the third through add_server
        ms.append(start_master(MasterServer, ports[1], addrs[:2], tmp_path / "m1"))
        with grpc.insecure_channel(f"127.0.0.1:{ports[0] + 10000}") as ch:
            resp = rpc.Stub(ch, rpc.RAFT_SERVICE).RaftChangeMembership(
                pb.RaftChangeRequest(op="add", server=addrs[1]), timeout=30)
        assert not resp.error and sorted(resp.members) == sorted(addrs[:2])
        ms.append(start_master(MasterServer, ports[2], addrs, tmp_path / "m2"))
        assert leader.raft.add_server(addrs[2]) == sorted(addrs)
        idx = leader.raft.commit_index
        wait_for(lambda: applied(ms, idx), timeout=ELECT_S, msg="the joiners did not converge")
        assert all(sorted({m.raft.node_id, *m.raft.peers}) == sorted(addrs) for m in ms)
        # failover in the grown group
        leader.stop()
        rest = ms[1:]
        new = leader_of(rest)
        more = new._alloc_volume_id()
        assert more > max(ids)
        # shrink: the stopped leader goes, then the other survivor; the new
        # leader commits alone
        other = next(m for m in rest if m is not new)
        assert new.raft.remove_server(leader.node_id) == sorted([new.node_id, other.node_id])
        assert new.raft.remove_server(other.node_id) == [new.node_id]
        other.stop()
        assert new._alloc_volume_id() > more
        with grpc.insecure_channel(f"127.0.0.1:{new.port + 10000}") as ch:
            bad = rpc.Stub(ch, rpc.RAFT_SERVICE).RaftChangeMembership(
                pb.RaftChangeRequest(op="swap", server="x"), timeout=10)
        assert bad.error == "bad op 'swap'"
    finally:
        stop_all(ms)


def test_dead_member_removed_from_two_node_group(tmp_path):
    ms, _ = start_group(tmp_path, [MasterServer] * 2)
    try:
        leader = leader_of(ms)
        dead = next(m for m in ms if m is not leader)
        dead.stop()
        assert leader.raft.remove_server(dead.node_id) == [leader.node_id]
        assert leader._alloc_volume_id() > 0  # a group of one commits alone
    finally:
        stop_all(ms)


def test_mixed_group_elects_commits_and_fails_over(tmp_path):
    ms, _ = start_group(tmp_path, [MasterServer, MasterServer, JaxMasterServer])
    try:
        leader = leader_of(ms)
        before = [leader._alloc_volume_id() for _ in range(5)]
        assert before == sorted(set(before))
        idx = leader.raft.commit_index
        wait_for(lambda: applied(ms, idx), timeout=ELECT_S, msg="the group did not apply")
        assert {m.topo.max_volume_id for m in ms} == {before[-1]}
        assert {m.raft.commit_index for m in ms} == {idx}
        leader.stop()
        rest = [m for m in ms if m is not leader]
        new = leader_of(rest)
        after = [new._alloc_volume_id() for _ in range(3)]
        assert min(after) > max(before)
        idx = new.raft.commit_index
        wait_for(lambda: applied(rest, idx), timeout=ELECT_S, msg="the survivors did not apply")
        assert {m.topo.max_volume_id for m in rest} == {after[-1]}
    finally:
        stop_all(ms)


# ------------------------------------------------------------ state file


def run_node(cls, d, proposals: int, threshold: int) -> int:
    """One single-node raft over a max-volume-id state machine, as the
    master wires it; returns the last allocated id."""
    state = {"max_volume_id": 0}

    def apply(kind, value):
        if kind == "alloc_volume_id":
            state["max_volume_id"] = max(state["max_volume_id"], value) + 1
            return state["max_volume_id"]
        return 0

    n = cls("n1:9333", [], state_dir=str(d), apply_fn=apply, compact_threshold=threshold,
            snapshot_fn=lambda: dict(state),
            restore_fn=lambda s: state.update(max_volume_id=max(state["max_volume_id"],
                                                                s.get("max_volume_id", 0))))
    n.start()
    try:
        last = 0
        for k in range(proposals):
            last = n.propose("alloc_volume_id", k % 3)
        return last
    finally:
        n.stop()


@pytest.mark.parametrize("proposals", [5, 40])
def test_same_proposals_write_byte_identical_state_files(tmp_path, proposals):
    lasts, files = [], []
    for cls, tag in ((RaftNode, "port"), (JaxRaftNode, "jax")):
        d = tmp_path / tag
        d.mkdir()
        lasts.append(run_node(cls, d, proposals, threshold=16))
        lasts.append(run_node(cls, d, 3, threshold=16))  # a restart appends to the file
        files.append((d / "raft.jsonl").read_bytes())
    assert lasts[:2] == lasts[2:]
    assert files[0] == files[1]
    recs = [json.loads(line) for line in files[0].splitlines()]
    assert {r["t"] for r in recs} >= ({"entry", "snapshot", "term"} if proposals > 16 else {"entry"})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mdir_written_by_one_package_loads_in_the_other(tmp_path, writer):
    classes = {"port": MasterServer, "jax": JaxMasterServer}
    port = allocate_port()
    me = [f"127.0.0.1:{port}"]
    m = start_master(classes[writer], port, me, tmp_path / "mdir")
    try:
        leader_of([m])
        m.raft.compact_threshold = 16
        issued = [m._alloc_volume_id() for _ in range(40)]
    finally:
        m.stop()
    reader = "jax" if writer == "port" else "port"
    loaded = {}
    for pkg in (reader, writer):
        m = start_master(classes[pkg], port, me, tmp_path / "mdir")
        try:
            leader_of([m])
            loaded[pkg] = (m.topo.max_volume_id, m.raft.snap_index)
        finally:
            m.stop()
    assert loaded[reader][0] == issued[-1] and loaded[reader][1] > 0
    # the reader's own restart records (term, noop) load back in the writer
    assert loaded[writer][0] == issued[-1]


def test_compaction_bounds_the_state_file_and_restart_continues(tmp_path):
    last = run_node(RaftNode, tmp_path, 400, threshold=64)
    assert os.path.getsize(tmp_path / "raft.jsonl") < 64 * 200
    assert run_node(RaftNode, tmp_path, 1, threshold=64) > last


# -------------------------------------------------------- clients re-home


def test_client_and_volume_server_rehome_after_failover(tmp_path):
    ms, peers = start_group(tmp_path, [MasterServer] * 3)
    vs = mc = None
    try:
        leader = leader_of(ms)
        vs = VolumeServer([str(tmp_path / "vol")], master=",".join(peers), ip="127.0.0.1",
                          port=_ports(), ec_backend="cpu")
        vs.start()
        wait_for(lambda: f"127.0.0.1:{vs.port}" in leader.topo.nodes, timeout=ELECT_S,
                 msg="the volume server did not reach the leader")
        mc = MasterClient(",".join(peers))
        a = mc.assign(collection="one")
        vid = int(a.fid.split(",")[0])
        wait_for(lambda: mc._synced.is_set() and vid in mc._vidmap, timeout=ELECT_S,
                 msg="the session did not learn the grown volume")
        handed = leader.topo.max_volume_id
        leader.stop()
        rest = [m for m in ms if m is not leader]
        new = leader_of(rest)
        wait_for(lambda: f"127.0.0.1:{vs.port}" in new.topo.nodes, timeout=ELECT_S,
                 msg="the volume server did not re-home")

        def assign():
            try:
                return mc.assign(collection="two")
            except Exception:  # noqa: BLE001 — until the client has re-homed
                return None

        holder = {}
        wait_for(lambda: holder.setdefault("a", assign()) is not None or holder.pop("a"),
                 timeout=ELECT_S, msg="assigns did not resume")
        vid2 = int(holder["a"].fid.split(",")[0])
        assert vid2 > handed >= vid
        assert [loc.url for loc in mc.lookup(vid2, refresh=True)] == [f"127.0.0.1:{vs.port}"]
    finally:
        if mc is not None:
            mc.close()
        if vs is not None:
            vs.stop()
        stop_all(ms)
