"""PyTorch port: the worker fleet (seaweedfs_tpu_torch/worker), the
master's worker half and pb/worker_pb2, held against the JAX package on
the CPU.

Twin clusters, one of each package (a master, one or two volume servers
and a worker, `backend="cpu"`), start from volume directories written
once through the port's `Store` and copied into both, and run the same
scenario:

- the scenarios of `tests/test_worker.py`: `ec_encode` through
  `task.submit`, a failure report, requeue when a worker's stream dies
  and no pick of a worker without the kind, the full-volume scanner
  (called directly, and from the maintenance loop after a live
  `maintenance.config`), `balance` and `ec_balance`;
- the fleet scrub -> peer-fetch rebuild loop of
  `tests/test_ec_cluster_chaos.py::test_fleet_scrub_dispatches_peer_fetch_and_heals`;
- the gravity scanner's `ec_migrate` dispatch of
  `tests/test_ec_rebalance.py::test_scan_for_ec_rebalance_dispatches_on_heat_delta`,
  and an `ec_migrate` task driven on the twins;

each with equal task lists, equal JSON reports (timestamps and ids
apart), sha256-equal volume and shard files and the same
`/cluster/status` keys. Also an `s3_lifecycle` task handed to a filer's
`RunLifecycle` (the same reports and survivors), `SetMaintenanceConfig`'s
refusals, the worker's refusal of `-backend tpu`, its default
capabilities and descriptors (the `iceberg` kind's included, as in the
JAX worker; its task runs in tests/test_torch_remote.py), and
`worker_pb2`'s bytes.

Every wait is on a condition with a deadline.
"""

import hashlib
import json
import math
import os
import queue
import re
import shutil
import subprocess
import sys
import threading
import types
import urllib.request
import uuid

import grpc
import numpy as np
import pytest
from conftest import wait_for
from test_torch_volume_server import _ports

import seaweedfs_tpu.ec.encoder as jax_encoder
import seaweedfs_tpu.pb.worker_pb2 as jax_wk
import seaweedfs_tpu.worker.control as jax_control
from seaweedfs_tpu.server.master import MasterServer as JaxMasterServer
from seaweedfs_tpu.server.topology import DataNode as JaxDataNode
from seaweedfs_tpu.server.topology import Topology as JaxTopology
from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer
from seaweedfs_tpu.shell import commands as jax_shell
from seaweedfs_tpu.worker.worker import Worker as JaxWorker
import seaweedfs_tpu_torch.ec.encoder as port_encoder
from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.pb import worker_pb2 as wk
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.topology import DataNode, Topology
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import commands as port_shell
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.worker import __main__ as worker_main
from seaweedfs_tpu_torch.worker import control as port_control
from seaweedfs_tpu_torch.worker.worker import Worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": types.SimpleNamespace(master=JaxMasterServer, volume=JaxVolumeServer,
                                 worker=JaxWorker, shell=jax_shell, control=jax_control,
                                 topology=JaxTopology, node=JaxDataNode),
    "port": types.SimpleNamespace(master=MasterServer, volume=VolumeServer, worker=Worker,
                                  shell=port_shell, control=port_control,
                                  topology=Topology, node=DataNode),
}
# the volume kinds both workers take (their default adds s3_lifecycle,
# run on its own below, and iceberg, run in tests/test_torch_remote.py)
CAPS = ("ec_encode", "vacuum", "balance", "ec_balance", "ec_scrub", "ec_rebuild", "ec_migrate")
RACKS = ("r1", "r2")
GEN_NS = 1_760_000_000_777_000_001
TIMEOUT = 45.0
_ADDR = re.compile(r"127\.0\.0\.1:(\d+)")
_FILE_EXTS = re.compile(r"\.(dat|idx|ec\d\d|ecx|ecj|vif|ecsum)$")


def needles(seed: int, n: int, hi: int):
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(1, 1 << 20), n, replace=False)
    return [(int(nid), int(rng.integers(1, 1 << 32)), rng.bytes(int(rng.integers(1, hi))))
            for nid in ids]


def build_initial(root, layout: dict) -> dict:
    """{server index: [(vid, collection, seed, needles, max body)]} written
    once through the port's Store: {server index: directory}."""
    dirs = {}
    for i, vols in layout.items():
        d = dirs[i] = root / f"init{i}"
        store = Store([str(d)], ec_backend="cpu")
        for vid, col, seed, n, hi in vols:
            store.allocate_volume(vid, collection=col, replica_placement="000")
            for nid, cookie, body in needles(seed, n, hi):
                store.write_needle(vid, Needle(cookie=cookie, needle_id=nid, data=body))
        store.close()
    return dirs


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class Side:
    """One twin: a master, volume servers on ascending ports (both masters
    list nodes in registration order then) and the shell, all of `pkg`."""

    def __init__(self, root, pkg: str, initial: dict, n_servers: int,
                 vacuum_interval: float = 3600.0):
        self.pkg = pkg
        self.P = PKGS[pkg]
        self.root = root
        self.mport = _ports()
        self.master = self.P.master(ip="127.0.0.1", port=self.mport,
                                    vacuum_interval=vacuum_interval)
        self.master.start()
        self.ctrl = self.master.worker_control
        self.names = {self.mport: "m", self.mport + 10000: "m.grpc"}
        self.vols, self.dirs, self.workers = [], [], []
        ports = sorted(_ports() for _ in range(n_servers))
        assert len({len(str(p)) for p in ports}) == 1
        try:
            for i in range(n_servers):
                d = root / f"s{i}"
                if i in initial:
                    shutil.copytree(initial[i], d)
                vs = self.P.volume([str(d)], master=f"127.0.0.1:{self.mport}", ip="127.0.0.1",
                                   port=ports[i], ec_backend="cpu", rack=RACKS[i])
                vs.start()
                self.vols.append(vs)
                self.dirs.append(d)
                self.names[vs.port] = f"s{i}"
                self.names[vs.grpc_port] = f"s{i}.grpc"
                wait_for(lambda: len(self.master.topo.nodes) == i + 1, timeout=TIMEOUT,
                         msg="a volume server did not register")
            self.env = self.P.shell.ShellEnv(f"127.0.0.1:{self.mport}")
        except BaseException:
            self.stop()
            raise
        self.reports: list = []  # (kind, state, error, detail) of every terminal update

    def g(self, i: int) -> str:
        return f"127.0.0.1:{self.vols[i].grpc_port}"

    def run(self, line: str) -> str:
        return self.P.shell.run_command(self.env, line)

    def start_worker(self, worker_id: str = "w0", capabilities=CAPS):
        w = self.P.worker(master=f"127.0.0.1:{self.mport}", backend="cpu",
                          worker_id=worker_id, capabilities=capabilities)
        report = w._report

        def recorded(task_id, state, progress=0.0, error="", detail=""):
            if state in ("done", "failed"):
                with self.ctrl._lock:
                    t = self.ctrl._tasks.get(task_id)
                self.reports.append((t.kind if t else "?", state, error, detail))
            report(task_id, state, progress, error, detail)

        w._report = recorded
        threading.Thread(target=w.run, daemon=True).start()
        self.workers.append(w)
        wait_for(lambda: worker_id in self.ctrl._workers, timeout=TIMEOUT,
                 msg="the worker did not register")
        return w

    def stop_worker(self, w) -> None:
        w.stop()
        wait_for(lambda: w.worker_id not in self.ctrl._workers, timeout=TIMEOUT,
                 msg="the worker did not leave")
        self.workers.remove(w)

    def tasks(self) -> list:
        _, rows = self.ctrl.snapshot()
        return sorted(rows, key=lambda t: t["created"])

    def settled_tasks(self, n: int) -> list:
        """The task rows once there are n, every one terminal."""
        def done():
            rows = self.tasks()
            return len(rows) == n and all(t["state"] in ("done", "failed") for t in rows)

        wait_for(done, timeout=TIMEOUT, msg=f"{self.pkg}: tasks did not finish: {self.tasks()}")
        return [(t["kind"], t["volume_id"], t["state"], self.mask(t["error"]))
                for t in self.tasks()]

    def mask(self, text: str) -> str:
        text = _ADDR.sub(lambda m: self.names.get(int(m[1]), "?"), text)
        text = re.sub(r"grpc=(\d+)", lambda m: f"grpc={self.names.get(int(m[1]), '?')}", text)
        text = text.replace(str(self.root), "<root>")
        text = text.replace(self.env.owner, "<owner>") if hasattr(self, "env") else text
        return re.sub(r"\b[0-9a-f]{12}\b", "<task>", text)

    def topology(self) -> list:
        with grpc.insecure_channel(f"127.0.0.1:{self.mport + 10000}") as ch:
            topo = rpc.master_stub(ch).Topology(pb.TopologyRequest(), timeout=30)
        return [(self.names[int(n.id.rsplit(":", 1)[1])], n.rack,
                 sorted((v.id, v.collection, v.size, v.file_count, v.read_only)
                        for v in n.volumes),
                 sorted((e.id, e.collection, e.shard_bits) for e in n.ec_shards))
                for n in topo.nodes]

    def stores(self) -> list:
        out = []
        for i, vs in enumerate(self.vols):
            s = vs.store.status()
            bits = [sum(1 << sid for sid in e["shards"]) for e in s["ec_volumes"]]
            out.append((f"s{i}", RACKS[i],
                        sorted((v["id"], v["collection"], v["size"], v["file_count"],
                                v["read_only"]) for v in s["volumes"]),
                        sorted((e["id"], e["collection"], b)
                               for e, b in zip(s["ec_volumes"], bits))))
        return out

    def settle(self) -> None:
        """Wait until the master's topology is what the servers hold."""
        def same():
            try:
                return self.topology() == self.stores()
            except grpc.RpcError:
                return False

        wait_for(same, timeout=TIMEOUT, msg=f"{self.pkg}: the topology did not settle")

    def files(self) -> dict:
        out = {}
        for i, (vs, d) in enumerate(zip(self.vols, self.dirs)):
            for v in vs.store.status()["volumes"]:
                vol = vs.store.find_volume(v["id"])
                if vol is not None and hasattr(vol, "flush"):
                    vol.flush()
            if not d.exists():
                continue
            for name in sorted(os.listdir(d)):
                if _FILE_EXTS.search(name):
                    out[f"s{i}/{name}"] = sha(d / name)
        return out

    def http_json(self, path: str):
        with urllib.request.urlopen(f"http://127.0.0.1:{self.mport}{path}", timeout=30) as r:
            return json.loads(r.read())

    def read_back(self, i: int, vid: int, items) -> bool:
        for nid, cookie, body in items:
            url = f"http://127.0.0.1:{self.vols[i].port}/{FileId(vid, nid, cookie)}"
            with urllib.request.urlopen(url, timeout=30) as r:
                if r.read() != body:
                    return False
        return True

    def stop(self) -> None:
        for w in list(self.workers):
            w.stop()
        if hasattr(self, "env"):
            self.env.close()
        for vs in self.vols:
            vs.stop()
        self.master.stop()


@pytest.fixture
def pinned(monkeypatch):
    """Both encoders stamp the generation with time.time_ns() and the
    sidecar with a uuid4 (pinned for the encoders' sink only: task ids and
    lease tokens are uuids too)."""
    for mod in (jax_encoder, port_encoder):
        fake = types.SimpleNamespace(**{k: getattr(mod.time, k) for k in dir(mod.time)
                                        if not k.startswith("__")})
        fake.time_ns = lambda: GEN_NS
        monkeypatch.setattr(mod, "time", fake)
    real = uuid.uuid4

    def uuid4():
        caller = sys._getframe(1).f_globals.get("__name__", "")
        return uuid.UUID(int=GEN_NS) if caller.endswith(".ec.pipeline") else real()

    monkeypatch.setattr(uuid, "uuid4", uuid4)


@pytest.fixture
def make_twins(tmp_path, pinned):
    """make_twins(layout, servers, vacuum_interval) -> (jax side, port side)
    over the same initial volume directories; stopped at the test's end."""
    sides = []

    def make(layout: dict, n: int, interval: float = 3600.0):
        initial = build_initial(tmp_path, layout)
        for pkg in ("jax", "port"):
            (tmp_path / pkg).mkdir()
            sides.append(Side(tmp_path / pkg, pkg, initial, n, vacuum_interval=interval))
        for s in sides:
            s.settle()
        return sides

    try:
        yield make
    finally:
        for s in sides:
            s.stop()


def both(twins, scenario):
    """The scenario's outputs on each twin, masked; asserts they are equal."""
    outs = []
    for s in twins:
        out = scenario(s)
        outs.append([s.mask(o) if isinstance(o, str) else o for o in out])
    assert len(outs[0]) == len(outs[1])
    for i, (theirs, ours) in enumerate(zip(*outs)):
        assert theirs == ours, i
    return outs[1]


def _split(side, vid: int, moved) -> dict:
    """Shards `moved` of s0's EC volume copied to s1 and dropped at s0 (s0
    a subset holder below k); returns every shard's bytes as generated."""
    base = side.vols[0].service._ec_base(vid, "")
    ground = {i: open(base + f".ec{i:02d}", "rb").read() for i in range(14)}
    with grpc.insecure_channel(side.g(0)) as c0, grpc.insecure_channel(side.g(1)) as c1:
        s0, s1 = rpc.volume_stub(c0), rpc.volume_stub(c1)
        s1.VolumeEcShardsCopy(pb.EcShardsCopyRequest(
            volume_id=vid, shard_ids=moved, source_url=side.g(0), copy_ecx=True,
            copy_ecj=True, copy_vif=True, copy_ecsum=True), timeout=60)
        s1.VolumeEcShardsMount(pb.EcShardsMountRequest(volume_id=vid), timeout=30)
        s0.VolumeEcShardsUnmount(pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=moved),
                                 timeout=30)
        s0.VolumeEcShardsDelete(pb.EcShardsDeleteRequest(volume_id=vid, shard_ids=moved),
                                timeout=30)
    side.settle()
    return ground


def _encode(side, vid: int) -> str:
    """`task.submit -kind ec_encode` of vid at its holder, run by the worker."""
    n = len(side.tasks())
    out = side.run(f"task.submit -kind ec_encode -volumeId {vid}")
    side.settled_tasks(n + 1)
    side.settle()
    return out


# --------------------------------------------------- the worker's tasks


VOL1 = (1, "", 301, 40, 20_000)


def test_ec_encode_task_and_failure_report_against_jax(make_twins):
    twins = make_twins({0: [VOL1]}, 1, 3600.0)

    def scenario(s):
        out = [s.run("worker.list")]
        s.start_worker()
        out += [s.run("worker.list"), s.run("cluster.ps"), _encode(s, 1), s.run("task.list"),
                s.read_back(0, 1, needles(*VOL1[2:]))]
        # a volume nobody holds: the task fails with the lookup's error
        out.append(s.run("task.submit -kind ec_encode -volumeId 424242"))
        out += [s.settled_tasks(2), s.run("task.list")]
        # refused at submit: no volume, an unknown kind, params outside the
        # descriptors, a param without =
        out += [s.run(line) for line in (
            "task.submit -kind ec_encode", "task.submit -kind bogus -volumeId 1",
            "task.submit -kind ec_encode -volumeId 1 -param batch_mb=0",
            "task.submit -kind ec_encode -volumeId 1 -param nope=1",
            "task.submit -kind vacuum -volumeId 1 -param garbage_threshold=x",
            "task.submit -kind ec_encode -volumeId 1 -param k")]
        return out + [s.reports, s.topology(), s.files()]

    out = both(twins, scenario)
    assert out[4].count("ec_encode vol=1 done worker=w0") == 1
    assert out[5] is True and "ec_encode vol=424242 failed worker=w0 error=" in out[8]
    assert twins[1].topology()[0][3] == [(1, "", (1 << 14) - 1)]


def test_requeue_on_worker_death_against_jax(make_twins):
    """A task waits with no worker and with a worker that lacks its kind;
    the stream of the worker it was assigned to dies: it is pending again,
    and the next capable worker runs it."""
    twins = make_twins({}, 1, 3600.0)

    def scenario(s):
        tid = s.ctrl.submit("ec_encode", 7777)
        row = lambda: next(t for t in s.tasks() if t["task_id"] == tid)  # noqa: E731
        steps = [(row()["state"], row()["worker_id"])]
        s.start_worker("vac", capabilities=("vacuum",))
        q: queue.Queue = queue.Queue()
        got = []

        def messages():
            yield wk.WorkerMessage(register=wk.Register(
                worker_id="ghost", capabilities=["ec_encode"], max_concurrent=1, backend="cpu"))
            while (m := q.get()) is not None:
                yield m

        ch = grpc.insecure_channel(f"127.0.0.1:{s.mport + 10000}")
        call = rpc.worker_stub(ch).WorkerStream(messages())
        reader = threading.Thread(target=lambda: got.extend(call), daemon=True)
        reader.start()
        wait_for(lambda: row()["state"] == "assigned", timeout=TIMEOUT, msg="no assign")
        steps.append((row()["state"], row()["worker_id"]))
        wait_for(lambda: any(m.WhichOneof("body") == "assign" for m in got), timeout=TIMEOUT)
        q.put(None)  # the ghost's stream ends mid-task
        wait_for(lambda: row()["state"] == "pending", timeout=TIMEOUT, msg="no requeue")
        reader.join(timeout=TIMEOUT)
        ch.close()
        steps.append((row()["state"], row()["worker_id"]))
        assign = [m.assign for m in got if m.WhichOneof("body") == "assign"]
        steps.append([(a.kind, a.volume_id, a.backend) for a in assign])
        steps.append(s.run("worker.list"))
        s.start_worker("w0")
        return steps + [s.settled_tasks(1), s.reports]

    out = both(twins, scenario)
    assert out[:3] == [("pending", ""), ("assigned", "ghost"), ("pending", "")]
    assert out[3] == [("ec_encode", 7777, "cpu")]


VOL2 = (2, "", 302, 30, 20_000)


def test_full_volume_scanner_against_jax(make_twins):
    """The scanner called as tests/test_worker.py calls it, then the
    maintenance loop's auto-EC turned on live by `maintenance.config`."""
    twins = make_twins({0: [VOL1, VOL2]}, 1, 0.2)

    def scenario(s):
        limit = s.master.topo.volume_size_limit
        out = [s.ctrl.scan_for_ec_candidates(s.master.topo, 0.9, limit)]
        tids = s.ctrl.scan_for_ec_candidates(s.master.topo, 0.5, 1000)
        out.append(sorted(t["volume_id"] for t in s.tasks() if t["task_id"] in tids))
        s.start_worker()
        out.append(s.settled_tasks(2))
        s.settle()
        # a third volume, written over RPCs, encoded by the loop once its
        # size has held for ec_quiet_seconds
        with grpc.insecure_channel(s.g(0)) as ch:
            st = rpc.volume_stub(ch)
            st.AllocateVolume(pb.AllocateVolumeRequest(volume_id=3, replication="000"),
                              timeout=10)
            for nid, cookie, body in needles(303, 20, 20_000):
                st.WriteNeedle(pb.WriteNeedleRequest(volume_id=3, needle_id=nid, cookie=cookie,
                                                     data=body, is_replicate=True), timeout=10)
        s.settle()
        size = dict((v[0], v[2]) for v in s.topology()[0][2])[3]
        f = 0.5 * size / limit
        out.append(s.run(f"maintenance.config -set ec_auto_fullness={f!r} "
                         "-set ec_quiet_seconds=0.3"))
        out.append(s.settled_tasks(3))
        s.settle()
        out.append(s.run("maintenance.config -set ec_auto_fullness=0"))
        return out + [s.topology()]

    out = both(twins, scenario)
    assert out[0] == [] and out[1] == [1, 2]
    assert [t[:3] for t in out[4]][2] == ("ec_encode", 3, "done")


def test_balance_task_against_jax(make_twins):
    twins = make_twins({0: [(31, "", 331, 3, 5000), (32, "", 332, 3, 5000),
                              (33, "", 333, 3, 5000)]}, 2, 3600.0)

    def scenario(s):
        s.start_worker()
        tids = s.ctrl.scan_for_balance_candidates(s.master.topo, spread=2)
        out = [len(tids), s.settled_tasks(1)]
        s.settle()
        return out + [s.topology(), s.files(), s.reports,
                      s.ctrl.scan_for_balance_candidates(s.master.topo, spread=2)]

    out = both(twins, scenario)
    assert out[0] == 1 and out[1] == [("balance", 31, "done", "")]
    assert [n[2][0][0] for n in out[2] if n[0] == "s1"] == [31]


def test_ec_balance_and_ec_migrate_tasks_against_jax(make_twins):
    """The EC balance scanner's task spreads a 14-0 shard set over both
    nodes; an `ec_migrate` task then moves s1's set back to s0."""
    twins = make_twins({0: [VOL1]}, 2, 3600.0)

    def scenario(s):
        s.start_worker()
        out = [_encode(s, 1)]
        tids = s.ctrl.scan_for_ec_balance(s.master.topo)
        # a direct submit dedupes onto the live scanner task
        out += [len(tids), s.ctrl.submit("ec_balance", 0) == tids[0], s.settled_tasks(2)]
        s.settle()
        out += [s.topology(), s.ctrl.scan_for_ec_balance(s.master.topo)]
        held = [sid for sid in range(14) if s.topology()[1][3][0][2] >> sid & 1]
        out.append(s.run(f"task.submit -kind ec_migrate -volumeId 1 -param source={s.g(1)} "
                         f"-param target={s.g(0)} -param shards={','.join(map(str, held))}"))
        out.append(s.settled_tasks(3))
        s.settle()
        return out + [s.topology(), s.files(), s.read_back(0, 1, needles(*VOL1[2:])),
                      [(k, st, e, s.mask(d)) for k, st, e, d in s.reports]]

    out = both(twins, scenario)
    spread = [bin(n[3][0][2]).count("1") for n in out[4]]
    assert sorted(spread)[-1] < 14 and sum(spread) == 14 and out[5] == []
    assert out[8][0][3] == [(1, "", (1 << 14) - 1)] and out[10] is True
    migrate = json.loads(out[11][2][3])
    assert migrate and out[11][2][:2] == ("ec_migrate", "done")


# ------------------------------------------------- the fleet scrub loop


def _fleet_json(side, vid: int) -> dict:
    summary = side.ctrl.scrub_summary()
    for r in summary["reports"].values():
        r.pop("ts")
    return json.loads(side.mask(json.dumps(summary, sort_keys=True)))


def test_fleet_scrub_dispatches_peer_fetch_and_heals_against_jax(make_twins):
    """tests/test_ec_cluster_chaos.py's loop: s0 keeps shards 0-3 and
    quarantines shard 0; the fleet scrub finds it unrebuildable, the master
    dispatches `ec_rebuild -fromPeers`, the worker heals it bit-exact; the
    next period reports the holder healed and dispatches nothing."""
    twins = make_twins({0: [VOL1]}, 2, 3600.0)

    def scenario(s):
        s.start_worker()
        disp = s.P.control._fleet_dispatch
        d0 = disp._values.get((), 0.0)
        out = [_encode(s, 1)]
        ground = _split(s, 1, list(range(4, 14)))
        base = s.vols[0].service._ec_base(1, "")
        os.replace(base + ".ec00", base + ".ec00.bad")
        s.vols[0].store.unmount_ec_shards(1, [0])
        s.settle()
        tids = s.ctrl.scan_for_ec_scrub(s.master.topo, 0.001)
        out += [len(tids), s.ctrl.scan_for_ec_scrub(s.master.topo, 3600.0)]
        wait_for(lambda: s.ctrl.scrub_reports.get(1), timeout=TIMEOUT, msg="no scrub report")
        out.append(_fleet_json(s, 1))
        wait_for(lambda: 0 in s.vols[0].store.find_ec_volume(1).shard_fds, timeout=TIMEOUT,
                 msg="the dispatched peer-fetch rebuild did not heal the shard")
        out.append(s.settled_tasks(3))
        out.append(open(base + ".ec00", "rb").read() == ground[0])
        d1 = disp._values.get((), 0.0)
        out.append(d1 - d0)
        cs = s.http_json("/cluster/status")
        out += [sorted(cs), cs["EcFleetScrub"]["unrebuildable_volumes"], cs["EcMigrations"]]
        # the next period: healed, the forensic .bad left, no new dispatch
        ts0 = s.ctrl.scrub_reports[1]["ts"]
        out.append(len(s.ctrl.scan_for_ec_scrub(s.master.topo, 0.001)))
        wait_for(lambda: s.ctrl.scrub_reports[1]["ts"] > ts0, timeout=TIMEOUT,
                 msg="no second scrub report")
        out += [_fleet_json(s, 1), s.settled_tasks(4), os.path.exists(base + ".ec00.bad")]
        s.settle()
        reports = [(k, st, e, json.loads(s.mask(d)) if d else d) for k, st, e, d in s.reports]
        return out + [reports, s.topology(), s.files(), s.read_back(1, 1, needles(*VOL1[2:]))]

    out = both(twins, scenario)
    first, healed = out[3], out[11]
    assert first["unrebuildable_volumes"] == [1]
    assert first["reports"]["1"]["holders"]["s0"]["quarantined"] == [0]
    assert [t[:3] for t in out[4]] == [("ec_encode", 1, "done"), ("ec_scrub", 1, "done"),
                                       ("ec_rebuild", 1, "done")]
    assert out[5] is True and out[6] == 1 and "EcFleetScrub" in out[7]
    assert healed["unrebuildable_volumes"] == [] and healed["corrupt_shards"] == 0
    assert not healed["reports"]["1"]["holders"]["s0"]["quarantined"]
    assert [t[0] for t in out[12]].count("ec_rebuild") == 1 and out[13] is True


# ---------------------------------------------- the gravity scanner


def _tele(chips=0, vols=None):
    """tests/test_ec_rebalance.py's heartbeat telemetry blob."""
    import time as _time

    now = _time.time()
    blob = {"chips": {f"cuda:{i}": {"load": 0.0, "breaker": "closed"} for i in range(chips)},
            "breakers_open": 0, "ts": now, "received_at": now}
    if vols:
        blob["ec_volumes"] = {str(v): {"read_bytes": rb, "reconstructed_bytes": xb}
                              for v, (rb, xb) in vols.items()}
    return blob


def _rebalance_scan(P) -> list:
    """tests/test_ec_rebalance.py's scanner case in the package `P`."""
    topo = P.topology()
    wc = P.control.WorkerControl(topo=topo)
    try:
        w = P.control._Worker(
            worker_id="w1", capabilities={"ec_migrate"}, max_concurrent=1, backend="cpu",
            descriptors={d.kind: d for d in P.worker(backend="cpu").descriptors
                         if d.kind == "ec_migrate"})
        with wc._lock:
            wc._workers["w1"] = w

        def node(nid, port, chips, vols):
            n = P.node(node_id=nid, ip="h", port=port, public_url=nid, grpc_port=port + 10000,
                       rack="r1")
            n.ec_shards = {vid: pb.EcShardInfoMsg(id=vid, shard_bits=bits, shard_size=1 << 20,
                                                  data_shards=10, parity_shards=4)
                           for vid, bits in vols.items()}
            n.ec_telemetry = _tele(chips=chips, vols={vid: (0, 0) for vid in vols})
            return n

        a = node("h:1", 1, 0, {7: 0b11111})
        b = node("h:2", 2, 8, {})
        topo.nodes = {a.node_id: a, b.node_id: b}
        out = [wc.scan_for_ec_rebalance(topo, min_heat=1 << 20)]
        a.ec_telemetry = _tele(chips=0, vols={7: (64 << 20, 0)})
        tids = wc.scan_for_ec_rebalance(topo, min_heat=1 << 20)
        with wc._lock:
            params = dict(wc._tasks[tids[0]].params)
        _, tasks = wc.snapshot()
        migs = [{k: v for k, v in m.items() if k not in ("ts", "task_id")}
                for m in wc.last_migrations]
        # (the dispatcher may already have assigned it to w1: no state)
        out += [len(tids), params, [(t["kind"], t["volume_id"]) for t in tasks],
                migs, wc.scan_for_ec_rebalance(topo, min_heat=1 << 20)]
    finally:
        wc.stop()
    return out


def test_scan_for_ec_rebalance_dispatches_on_heat_delta_as_jax():
    ours = _rebalance_scan(PKGS["port"])
    assert ours == _rebalance_scan(PKGS["jax"])
    assert ours[:4] == [[], 1, {"source": "h:10001", "target": "h:10002", "shards": "0,1,2,3,4"},
                        [("ec_migrate", 7)]]
    assert ours[4][0]["volume_id"] == 7 and ours[5] == []


# -------------------------------------------- the maintenance config


@pytest.fixture(scope="module")
def masters():
    ms = []
    try:
        for P in (PKGS["jax"], PKGS["port"]):
            m = P.master(ip="127.0.0.1", port=_ports(), vacuum_interval=3600)
            m.start()
            ms.append(m)
        yield ms
    finally:
        for m in ms:
            m.stop()


def _maint(m, method, req):
    with grpc.insecure_channel(f"127.0.0.1:{m.grpc_port}") as ch:
        return getattr(rpc.worker_stub(ch), method)(req, timeout=10)


@pytest.mark.parametrize("knob, value", [
    ("ec_auto_fullness", math.nan),
    ("vacuum_interval_seconds", math.inf),
    ("ec_auto_fullness", 1.5),
    ("garbage_threshold", 0.0),
    ("vacuum_interval_seconds", 0.0),
    ("ec_quiet_seconds", -1.0),
    ("ec_scrub_interval_seconds", -5.0),
    ("ec_rebalance_interval_seconds", -1.0),
    ("balance_spread", -2.0),
    ("ec_scrub_interval_seconds", 30.0),  # accepted, then set back
])
def test_set_maintenance_config_answers_as_jax(masters, knob, value):
    answers = []
    for m in masters:
        before = _maint(m, "GetMaintenanceConfig", wk.GetMaintenanceConfigRequest())
        r = _maint(m, "SetMaintenanceConfig", wk.MaintenanceConfig(**{knob: value}))
        after = _maint(m, "GetMaintenanceConfig", wk.GetMaintenanceConfigRequest())
        if not r.error:
            _maint(m, "SetMaintenanceConfig", wk.MaintenanceConfig(**{knob: getattr(before, knob)}))
        answers.append((r.error, before.SerializeToString(), after.SerializeToString()))
    assert answers[0] == answers[1]
    error, before, after = answers[1]
    assert bool(error) == (value != 30.0)
    assert (before == after) == bool(error)


def test_s3_lifecycle_task_against_jax(make_twins):
    """The worker hands an `s3_lifecycle` task to the filer that owns the
    metadata (RunLifecycle): the same task rows, reports and survivors;
    a task without a filer fails alike."""
    from concurrent import futures

    import seaweedfs_tpu.filer as j_filer
    import seaweedfs_tpu.filer.grpc_service as j_grpc
    import seaweedfs_tpu.pb.rpc as j_rpc
    import seaweedfs_tpu_torch.filer as p_filer
    import seaweedfs_tpu_torch.filer.grpc_service as p_grpc

    mods = {"jax": (j_filer, j_grpc, j_rpc), "port": (p_filer, p_grpc, rpc)}
    twins = make_twins({}, 1, 3600.0)

    def scenario(s):
        fmod, gmod, rmod = mods[s.pkg]
        f = fmod.Filer(fmod.MemoryStore(), master=f"127.0.0.1:{s.mport}")
        for k in ("old/1", "old/2", "new/1"):
            f.write_file(f"/buckets/lc/{k}", k.encode())
        f.store.kv_put(b"lifecycle-rules/lc", json.dumps(
            [{"ID": "d", "Status": "Enabled", "Prefix": "old/",
              "ExpirationDate": "2020-01-01"}]).encode())
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        rmod.add_service(server, rmod.FILER_SERVICE, gmod.FilerGrpcService(f))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        s.names[port] = "filer.grpc"
        try:
            s.start_worker(capabilities=("s3_lifecycle",))
            s.ctrl.submit("s3_lifecycle", 0, params={"filer": f"127.0.0.1:{port}",
                                                     "bucket": "lc"})
            out = [s.settled_tasks(1)]
            s.ctrl.submit("s3_lifecycle", 0, params={"bucket": "lc"})
            out += [s.settled_tasks(2), sorted(s.reports)]
            out.append(sorted(e.full_path for d in ("/buckets/lc", "/buckets/lc/old")
                              for e in f.list_entries(d, limit=100)))
            return out
        finally:
            server.stop(grace=None)
            f.close()

    out = both(twins, scenario)
    assert out[1] == [("s3_lifecycle", 0, "done", ""),
                      ("s3_lifecycle", 0, "failed", "s3_lifecycle needs a filer param")]
    assert out[3] == ["/buckets/lc/new", "/buckets/lc/old"]


# --------------------------------------------------- the entry point


@pytest.mark.parametrize("argv, want", [
    (["-backend", "tpu"], "-backend tpu: the port runs its EC on cuda, cpu or auto"),
])
def test_worker_refuses_tpu_and_the_filer_and_s3_kinds(capsys, argv, want):
    with pytest.raises(SystemExit) as e:
        worker_main.main(["-master", "127.0.0.1:1", *argv])
    assert e.value.code == 2 and want in capsys.readouterr().err


def test_worker_defaults_to_cuda_and_leaves_out_the_filer_and_s3_kinds(monkeypatch):
    seen = {}

    class Fake:
        worker_id = "fake"

        def __init__(self, **kw):
            seen.update(kw)

        def run(self):
            pass

    monkeypatch.setattr(worker_main, "Worker", Fake)
    monkeypatch.setattr(worker_main.signal, "signal", lambda *a: None)
    assert worker_main.main(["-master", "127.0.0.1:1"]) == 0
    assert seen["backend"] == "cuda" and seen["capabilities"] == ("ec_encode", "vacuum")
    w = Worker()
    assert w.backend == "cuda"
    jax_kinds = [d.kind for d in JaxWorker().descriptors]
    assert [d.kind for d in w.descriptors] == jax_kinds and "iceberg" in jax_kinds
    assert w.capabilities == JaxWorker().capabilities
    theirs = {d.kind: d.SerializeToString() for d in JaxWorker().descriptors}
    for ours in w.descriptors:
        assert ours.SerializeToString() == theirs[ours.kind]
    assert port_control.KNOWN_KINDS == jax_control.KNOWN_KINDS
    assert port_control.VOLUME_INDEPENDENT_KINDS == jax_control.VOLUME_INDEPENDENT_KINDS


def test_module_entry_point_refuses_tpu_before_it_connects():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.worker", "-master",
                           "127.0.0.1:1", "-backend", "tpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert proc.stderr.strip().splitlines()[-1] == (
        "seaweedfs_tpu_torch.worker: error: -backend tpu: the port runs its EC on cuda, cpu "
        "or auto")


_MASTER_ALONE = r"""
import sys
from seaweedfs_tpu_torch.server.master import MasterServer

ms = MasterServer(ip="127.0.0.1", port=int(sys.argv[1]), vacuum_interval=3600)
ms.start()
ms.worker_control.submit("ec_encode", 1)
ms.worker_control.scan_for_ec_scrub(ms.topo, 1.0)
ms.stop()
print("LOADED", sorted(m for m in ("torch", "seaweedfs_tpu_torch.ec.backend") if m in sys.modules))
"""


def test_a_master_with_its_worker_control_imports_no_torch():
    """A master alone stays light: its WorkerControl and scanners load no
    EC package (a torch import takes seconds on the card's host)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _MASTER_ALONE, str(_ports())], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


# ------------------------------------------------------ worker_pb2


def test_worker_pb2_is_the_jax_file_and_serialises_the_same_bytes():
    with open(os.path.join(REPO, "seaweedfs_tpu", "pb", "worker_pb2.py"), "rb") as f:
        theirs = f.read()
    with open(os.path.join(REPO, "seaweedfs_tpu_torch", "pb", "worker_pb2.py"), "rb") as f:
        assert f.read() == theirs
    assert wk.DESCRIPTOR.serialized_pb == jax_wk.DESCRIPTOR.serialized_pb
    msgs = []
    for mod in (wk, jax_wk):
        m = mod.WorkerMessage(register=mod.Register(
            worker_id="w", capabilities=["ec_encode"], max_concurrent=2, backend="cuda",
            descriptors=[mod.TaskDescriptor(kind="ec_encode", fields=[mod.ConfigField(
                name="batch_mb", type="int", default="16", min=1, max=256)])]))
        a = mod.TaskAssign(task_id="t", kind="ec_encode", volume_id=3, backend="cuda")
        a.params["batch_mb"] = "8"
        cfg = mod.MaintenanceConfig(ec_auto_fullness=0.5, lifecycle_filer="f")
        msgs.append([m.SerializeToString(), a.SerializeToString(), cfg.SerializeToString()])
    assert msgs[0] == msgs[1]
    back = jax_wk.MaintenanceConfig.FromString(msgs[0][2])
    assert back.HasField("ec_auto_fullness") and not back.HasField("ec_quiet_seconds")
    assert wk.MaintenanceConfig.FromString(msgs[1][2]) == back
