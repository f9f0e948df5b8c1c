"""PyTorch port: the shell (seaweedfs_tpu_torch/shell), client/operations,
utils/urls, the rest of ec/placement (`plan_ec_balance` and its stages)
and ec/rebalance, held against the JAX package on the CPU:

- every ported command but remote storage's 7 (`remote.*`, held against
  the JAX shell in tests/test_torch_remote.py), 75 in all, run through the JAX shell and
  through the port's on twin clusters built from the same bytes: the
  output equal line for line once addresses, the shell's owner id, fid
  cookies, paths and timings are masked, the master's topology equal,
  and every volume and shard file sha256-equal (the needles `upload`
  writes carry the server's clock: their records are compared with
  `append_at_ns` and `last_modified` normalised). Twin clusters of two kinds: a port master
  with four port volume servers, and a JAX master with JAX and port
  volume servers side by side (the port shell against JAX servers);
- the worker fleet's commands (`task.submit`, `task.list`, `worker.list`,
  `cluster.ps`, `maintenance.config`) with a worker of the shell's
  package registered at each twin's master;
- S3's 15 commands (`s3.*`) against each twin's filer, its KV and its
  /buckets tree equal after every step;
- the registry: the port's commands are 82 of the JAX `COMMANDS`,
  with the JAX help texts apart from `-backend`; each command left for a
  later item answers one error line naming its ROADMAP.md item; a
  `-backend` the port does not run (`tpu`) is refused before any RPC;
- `Operations` over `http.client`: uploads and reads at a port and a JAX
  server over the net plane and over HTTP, records equal to the JAX
  `Operations`'; a 4xx answer not retried and a 5xx answer retried;
- `plan_ec_balance` (with and without gravity) and `plan_hot_migrations`
  equal to the JAX planners on hypothesis-generated topologies, and
  `drive_migration` moving a shard set between two port servers;
- a master group given as `-master`: both shells fail the same way where
  they parse the raw string, and succeed the same way through the master
  client;
- `python -m seaweedfs_tpu_torch.shell -c help` as a subprocess.
"""

import contextlib
import hashlib
import http.client
import http.server
import json
import os
import random
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
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_torch_volume_admin import cold_tier  # noqa: F401 — the module fixture
from test_torch_volume_server import _ports

import seaweedfs_tpu.ec.encoder as jax_encoder
import seaweedfs_tpu.ec.placement as jax_placement
import seaweedfs_tpu.ec.rebalance as jax_rebalance
import seaweedfs_tpu.server.topology as jax_topology
from seaweedfs_tpu.client.operations import Operations as JaxOperations
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.filer import MemoryStore as JaxMemoryStore
from seaweedfs_tpu.filer.entry import new_entry as jax_new_entry
from seaweedfs_tpu.filer.lock_ring import DlmClient as JaxDlmClient
from seaweedfs_tpu.server.filer_server import FilerServer as JaxFilerServer
from seaweedfs_tpu.pb import rpc as jrpc
from seaweedfs_tpu.server.master import MasterServer as JaxMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer
from seaweedfs_tpu.shell import commands as jax_shell
import seaweedfs_tpu_torch.ec.encoder as port_encoder
from seaweedfs_tpu_torch.client import operations as port_ops
from seaweedfs_tpu_torch.client.master_client import AssignResult
from seaweedfs_tpu_torch.ec import placement, rebalance
from seaweedfs_tpu_torch.filer import Filer, MemoryStore
from seaweedfs_tpu_torch.filer.entry import new_entry
from seaweedfs_tpu_torch.filer.lock_ring import DlmClient
from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import commands as port_shell
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import actual_offset
from seaweedfs_tpu_torch.utils import urls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORTED = {
    "cluster.status", "cluster.check", "cluster.raft.ps", "cluster.raft.add",
    "cluster.raft.remove",
    "volume.list", "volume.grow", "volume.vacuum", "volume.delete", "volume.mark", "volume.sync",
    "volume.move", "volume.tier.upload", "volume.tier.download", "volume.tier.move",
    "volume.fix.replication", "volume.scrub", "volume.check.disk", "volume.balance",
    "volume.deleteEmpty", "volume.copy", "volume.mount", "volume.unmount",
    "volume.configure.replication", "volume.vacuum.disable", "volume.vacuum.enable",
    "ec.encode", "ec.check.replication", "ec.rebuild", "ec.decode", "ec.balance", "ec.scrub",
    "collection.list", "collection.delete", "upload", "download", "lock", "unlock", "lock.status",
    "task.submit", "task.list", "worker.list", "cluster.ps", "maintenance.config",
    "fs.cat", "fs.configure", "fs.cp", "fs.du", "fs.ls", "fs.meta.cat", "fs.meta.load",
    "fs.meta.save", "fs.mkdir", "fs.mv", "fs.rm", "fs.stat", "fs.tree", "fs.verify",
    "volume.fsck", "cluster.lock.ring",
    "s3.configure", "s3.user.list", "s3.user.delete", "s3.accesskey.create",
    "s3.accesskey.delete", "s3.policy.put", "s3.policy.get", "s3.policy.delete",
    "s3.bucket.list", "s3.bucket.create", "s3.bucket.delete", "s3.clean.uploads",
    "s3.bucket.quota.set", "s3.bucket.quota.get", "s3.bucket.quota.enforce",
}
# the remote.* commands, held against the JAX shell's in tests/test_torch_remote.py
REMOTE_COMMANDS = {
    "remote.configure", "remote.mount", "remote.unmount", "remote.cache", "remote.uncache",
    "remote.mount.buckets", "remote.meta.sync",
}
FS_COLLECTION = "fs"  # the twins' filers write their chunks here
S3_BUCKETS = ("b1", "b2", "b3")  # the s3.* steps' buckets, b1's objects in collection b1
FS_CHUNK = 64 * 1024

# the initial volumes: (server, vid, collection, replica placement, needles, deleted)
RACKS = ("r1", "r1", "r2", "r2")
KINDS = {"port": ("port", "port", "port", "port"), "mixed": ("jax", "port", "jax", "port")}
GEN_NS = 1_760_000_000_555_000_001


def needles(seed: int, n: int, hi: int):
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(1, 1 << 20), n, replace=False)
    return [(int(nid), int(rng.integers(1, 1 << 32)), rng.bytes(int(rng.integers(1, hi))))
            for nid in ids]


def build_initial(root) -> dict:
    """Each server's initial directory, written once through the port's
    Store and copied into both twins: {server index: directory}."""
    dirs = {i: root / f"init{i}" for i in range(4)}
    stores = {i: Store([str(d)], ec_backend="cpu") for i, d in dirs.items()}

    def fill(i, vid, col, rp, items, deleted=()):
        stores[i].allocate_volume(vid, collection=col, replica_placement=rp)
        for nid, cookie, body in items:
            stores[i].write_needle(vid, Needle(cookie=cookie, needle_id=nid, data=body))
        for nid in deleted:
            stores[i].delete_needle(vid, nid)

    fill(0, 1, "", "000", needles(211, 60, 60_000))  # the EC volume
    n2 = needles(212, 30, 30_000)
    fill(1, 2, "c2", "000", n2, [nid for nid, _, _ in n2[::4]])  # garbage to vacuum
    n3 = needles(213, 30, 20_000)
    fill(0, 3, "", "010", n3[:20])
    vol3 = stores[0].find_volume(3)
    vol3.flush()
    for ext in (".dat", ".idx"):  # the replica on s2 misses the last 10 writes
        shutil.copy(vol3.dat_path[:-4] + ext, dirs[2] / f"3{ext}")
    for nid, cookie, body in n3[20:]:
        stores[0].write_needle(3, Needle(cookie=cookie, needle_id=nid, data=body))
    fill(1, 4, "", "001", needles(214, 10, 20_000))  # under-replicated
    fill(3, 5, "e", "000", [])  # empty
    fill(3, 6, "m", "000", needles(216, 12, 30_000))  # moved, then tiered
    fill(3, 7, "cp", "000", needles(217, 8, 30_000))  # copied, unmounted, mounted
    for s in stores.values():
        s.close()
    return dirs


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


_ADDR = re.compile(r"127\.0\.0\.1:(\d+)")
_FILE_EXTS = re.compile(r"\.(dat|idx|ec\d\d|ecx|ecj|vif|ecsum)$")


class Side:
    """One twin: a master, four volume servers of the kind's packages on
    two racks, and the shell of `shell` ("jax" or "port") at the master."""

    def __init__(self, root, kind: str, shell: str, initial: dict, cold: str):
        self.root = root
        self.kind = kind
        self.shell = shell
        self.tag = f"{kind}-{shell}"
        self.cold = cold
        self.mport = _ports()
        master_cls = MasterServer if kind == "port" else JaxMasterServer
        self.master = master_cls(ip="127.0.0.1", port=self.mport, vacuum_interval=3600)
        self.master.start()
        self.names = {self.mport: "m", self.mport + 10000: "m.grpc"}
        self.vols = []
        self.dirs = []
        self.clock_stamped: set[str] = set()  # collections written over HTTP
        # masters list nodes by id ("127.0.0.1:<port>") or in registration
        # order: ascending ports of one length make both orders s0..s3
        ports = sorted(_ports() for _ in KINDS[kind])
        assert len({len(str(p)) for p in ports}) == 1
        for i, pkg in enumerate(KINDS[kind]):
            d = root / f"s{i}"
            shutil.copytree(initial[i], d)
            cls = VolumeServer if pkg == "port" else JaxVolumeServer
            vs = cls([str(d)], master=f"127.0.0.1:{self.mport}", ip="127.0.0.1", port=ports[i],
                     ec_backend="cpu", rack=RACKS[i])
            vs.start()
            # one at a time: the topology lists nodes in registration order
            wait_for(lambda: len(self.master.topo.nodes) == i + 1, timeout=30,
                     msg="a volume server did not register")
            self.vols.append(vs)
            self.dirs.append(d)
            self.names[vs.port] = f"s{i}"
            self.names[vs.grpc_port] = f"s{i}.grpc"
        self._mch = grpc.insecure_channel(f"127.0.0.1:{self.mport + 10000}")
        self.mstub = rpc.master_stub(self._mch)
        # a filer of the shell's package, its gRPC on port + 10000 (where
        # the shells dial it), chunks in a collection of its own
        fcls, fscls, store = ((JaxFiler, JaxFilerServer, JaxMemoryStore) if shell == "jax"
                              else (Filer, FilerServer, MemoryStore))
        self.filer = fcls(store(), master=f"127.0.0.1:{self.mport}", collection=FS_COLLECTION,
                          chunk_size=FS_CHUNK)
        self.fport = _ports()
        self.filer_server = fscls(self.filer, ip="127.0.0.1", port=self.fport,
                                  grpc_port=self.fport + 10000)
        self.filer_server.start()
        self.names[self.fport] = "f"
        self.names[self.fport + 10000] = "f.grpc"
        self.clock_stamped.add(FS_COLLECTION)
        mod = jax_shell if shell == "jax" else port_shell
        self.env = mod.ShellEnv(f"127.0.0.1:{self.mport}", f"127.0.0.1:{self.fport}")
        self.ran: set[str] = set()

    def g(self, i: int) -> str:
        return f"127.0.0.1:{self.vols[i].grpc_port}"

    def run(self, line: str) -> str:
        mod = jax_shell if self.shell == "jax" else port_shell
        self.ran.add(line.split()[0])
        return mod.run_command(self.env, line)

    def seed_picks(self, seed: int) -> None:
        """The master's volume placement picks, from a fresh seeded rng."""
        if self.kind == "port":
            self.master.topo.rng = random.Random(seed)
        else:
            jax_topology.random = random.Random(seed)

    def mask(self, text: str) -> str:
        text = _ADDR.sub(lambda m: self.names.get(int(m[1]), "?"), text)
        text = text.replace(str(self.root), "<root>").replace(self.tag, "<side>")
        text = text.replace(self.env.owner, "<owner>")
        text = re.sub(r"\b(\d+),[0-9a-f]{9,}\b", r"\1,<fid>", text)
        text = re.sub(r"\d+\.\ds left", "<t>s left", text)
        text = re.sub(r"age=\S+s", "age=<t>s", text)
        # the filer's clocks: entry and chunk times, lease seconds
        text = re.sub(r"(mtime:\s+)\d+", r"\1<t>", text)
        text = re.sub(r'"(mtime|crtime|modifiedTsNs|Mtime)": ?\d+', r'"\1": <t>', text)
        text = re.sub(r'"sw-mts": "[0-9a-f]+"', '"sw-mts": "<t>"', text)
        text = re.sub(r"needle [0-9a-f]{12,}\b", "needle <id>", text)  # the sequencer's clock
        text = re.sub(r" +\d+\.\ds$", " <t>s", text, flags=re.MULTILINE)
        return re.sub(r"n=\d+ p50=\S+ p99=\S+", "n=<n> p50=<t> p99=<t>", text)

    def topology(self) -> list:
        topo = self.mstub.Topology(pb.TopologyRequest(), timeout=30)
        return [(self.names[int(n.id.rsplit(":", 1)[1])], n.rack,
                 sorted((v.id, v.collection, v.size, v.file_count, v.deleted_count, v.read_only,
                         v.replica_placement) for v in n.volumes),
                 sorted((e.id, e.collection, e.shard_bits) for e in n.ec_shards))
                for n in topo.nodes]

    def stores(self) -> list:
        out = []
        for i, vs in enumerate(self.vols):
            s = vs.store.status()
            bits = [sum(1 << sid for sid in e["shards"]) for e in s["ec_volumes"]]
            out.append((f"s{i}", RACKS[i],
                        sorted((v["id"], v["collection"], v["size"], v["file_count"],
                                v["deleted_count"], v["read_only"], v["replica_placement"])
                               for v in s["volumes"]),
                        sorted((e["id"], e["collection"], b) for e, b in zip(s["ec_volumes"], bits))))
        return out

    def settle(self) -> None:
        """Wait until the master's topology is what the servers hold."""
        def same():
            try:
                return self.topology() == self.stores()
            except grpc.RpcError:
                return False

        wait_for(same, timeout=30, msg=f"{self.tag}: the master's topology did not settle")

    def files(self) -> dict:
        """Every volume and shard file of every server: name -> sha256
        (the files of a collection written through the master's Assign
        hold its sequencer's needle ids and the server's clocks: "stamped",
        their records are compared normalised)."""
        out = {}
        for i, (vs, d) in enumerate(zip(self.vols, self.dirs)):
            for v in vs.store.status()["volumes"]:
                vol = vs.store.find_volume(v["id"])
                if vol is not None and hasattr(vol, "flush"):
                    vol.flush()
            for name in sorted(os.listdir(d)):
                if not _FILE_EXTS.search(name):
                    continue
                key = f"s{i}/{name}"
                if name.split("_")[0] in self.clock_stamped:
                    out[key] = "stamped"
                else:
                    out[key] = sha(d / name)
        return out

    def fput(self, path: str, body: bytes) -> int:
        """A file written through the filer's HTTP plane: the status."""
        c = http.client.HTTPConnection("127.0.0.1", self.fport, timeout=60)
        try:
            c.request("PUT", path, body=body)
            r = c.getresponse()
            r.read()
            return r.status
        finally:
            c.close()

    def filer_entry(self, path: str, directory: bool = False):
        """A new entry of the filer's package."""
        return (jax_new_entry if self.shell == "jax" else new_entry)(path, is_directory=directory)

    def s3_state(self) -> list:
        """What the s3.* commands keep in the filer: the identity config
        and the buckets' quota keys in its KV, and the /buckets tree
        (path, directory or not, size, extended attributes but the
        filer's clock, `sw-mts`)."""
        kv = self.filer.store.kv_get
        keys = [b"s3/identity.json"] + [f"{k}/{b}".encode() for k in ("quota", "quota-exceeded")
                                        for b in S3_BUCKETS]
        tree, stack = [], ["/buckets"]
        while stack:
            d = stack.pop()
            if not self.filer.exists(d):
                continue
            for e in self.filer.list_entries(d, limit=100_000):
                ext = sorted((k, v) for k, v in e.extended.items() if k != "sw-mts")
                tree.append((e.full_path, e.is_directory, e.file_size, ext))
                if e.is_directory:
                    stack.append(e.full_path)
        return [(k, kv(k)) for k in keys] + sorted(tree)

    def fs_settle(self) -> None:
        """The filer's chunk deletes done, the master's topology settled."""
        self.filer.flush_gc()
        self.settle()

    def stop(self) -> None:
        self.env.close()
        self._mch.close()
        self.filer_server.stop()
        for vs in self.vols:
            vs.stop()
        self.master.stop()


@pytest.fixture(scope="module", params=sorted(KINDS))
def twins(request, tmp_path_factory, cold_tier):  # noqa: F811
    root = tmp_path_factory.mktemp(f"shell-{request.param}")
    initial = build_initial(root)
    sides = []
    try:
        for shell in ("jax", "port"):
            (root / shell).mkdir()
            sides.append(Side(root / shell, request.param, shell, initial, cold_tier))
        for s in sides:
            s.settle()
        yield sides
    finally:
        for s in sides:
            s.stop()


@pytest.fixture
def pinned(monkeypatch):
    """Both encoders stamp the generation with time.time_ns() (in those
    modules only) and the sidecar with a uuid4."""
    for mod in (jax_encoder, port_encoder):
        fake = types.SimpleNamespace(**{k: getattr(mod.time, k) for k in dir(mod.time)
                                        if not k.startswith("__")})
        fake.time_ns = lambda: GEN_NS
        monkeypatch.setattr(mod, "time", fake)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=GEN_NS))
    saved = jax_topology.random
    yield
    jax_topology.random = saved


# ------------------------------------------------------------ the scenario
#
# Each step runs on one side and returns what it compares: the commands'
# output (masked by the caller) and any facts of its own. Steps run in
# this order on both twins.


def _unmount_delete(side, i: int, vid: int, sids) -> None:
    with grpc.insecure_channel(side.g(i)) as ch:
        st = jrpc.volume_stub(ch)
        st.VolumeEcShardsUnmount(pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=sids), timeout=30)
        st.VolumeEcShardsDelete(pb.EcShardsDeleteRequest(volume_id=vid, shard_ids=sids), timeout=30)


def step_listing(side):
    return [side.run(c) for c in ("cluster.status", "cluster.check", "volume.list",
                                  "collection.list", "lock.status", "ec.check.replication",
                                  "cluster.raft.ps", "volume.check.disk")]


def step_lock(side):
    out = [side.run("lock"), side.run("lock.status"), side.run("lock -ttl 30"),
           side.run("volume.mark -volumeId 4 -readonly"), side.run("unlock"), side.run("unlock")]
    return out + [side.run("volume.mark -volumeId 4 -writable"), side.run("lock.status")]


def step_raft(side):
    me = f"127.0.0.1:{side.mport}"
    return [side.run(f"cluster.raft.add -server {me}"),
            side.run("cluster.raft.remove -server 127.0.0.1:1"),
            side.run(f"cluster.raft.remove -server {me}"), side.run("cluster.raft.ps")]


def step_sync(side):
    out = [side.run(f"volume.sync -volumeId 3 -target {side.g(2)} -idleTimeout 1")]
    side.settle()
    out.append(side.run("volume.check.disk"))
    return out + [sha(side.dirs[0] / "3.dat") == sha(side.dirs[2] / "3.dat")]


def step_fix_replication(side):
    out = [side.run("volume.fix.replication")]
    side.settle()
    return out + [side.run("volume.fix.replication"), side.run("cluster.check")]


def step_plain_volume(side):
    out = [side.run("volume.scrub -volumeId 2"),
           side.run("volume.vacuum -volumeId 2 -garbageThreshold 0.1"),
           side.run("volume.mark -volumeId 2 -readonly")]
    side.settle()
    out += [side.run("volume.list"), side.run("volume.mark -volumeId 2 -writable"),
            side.run("volume.configure.replication -volumeId 2 -replication 001"),
            side.run("volume.configure.replication -volumeId 2 -replication x9"),
            side.run("volume.vacuum.disable -volumeId 2"),
            side.run("volume.vacuum.enable -volumeId 2"),
            side.run("volume.scrub -volumeId 99")]
    side.settle()
    return out


def step_copy_mount(side):
    out = [side.run(f"volume.copy -volumeId 7 -target {side.g(2)} -collection cp")]
    side.settle()
    out += [side.run("volume.check.disk"), side.run(f"volume.unmount -volumeId 7 -node {side.g(2)}")]
    side.settle()
    out += [side.run("volume.list"),
            side.run(f"volume.mount -volumeId 7 -node {side.g(2)} -collection cp")]
    side.settle()
    out.append(side.run("volume.delete -volumeId 7"))
    side.settle()
    return out


def step_move_tier(side):
    out = [side.run(f"volume.move -volumeId 6 -target {side.g(1)} -collection m"),
           side.run(f"volume.move -volumeId 6 -target {side.g(1)} -collection m")]
    side.settle()
    out.append(side.run("volume.tier.move -volumeId 6 -targetDiskType hdd -collection m"))
    side.settle()
    out.append(side.run("volume.tier.move -volumeId 6 -targetDiskType ssd"))
    dest = f"{side.cold}/cold/{side.tag}-6.dat"
    out.append(side.run(f"volume.tier.upload -volumeId 6 -dest {dest}"))
    side.settle()
    out += [side.run("volume.list"), side.run("volume.tier.download -volumeId 6 -deleteRemote")]
    side.settle()
    return out


def step_grow_delete_empty(side):
    side.seed_picks(7)
    out = [side.run("volume.grow -count 2 -collection g")]
    side.settle()
    out += [side.run("volume.deleteEmpty -collection g"), side.run("volume.deleteEmpty -collection g -force")]
    side.settle()
    out += [side.run("volume.deleteEmpty"), side.run("volume.deleteEmpty -force")]
    side.settle()
    return out


def step_volume_balance(side):
    out = [side.run("volume.balance")]
    out.append(side.run("volume.balance -apply"))
    side.settle()
    return out + [side.run("volume.balance"), side.run("volume.list")]


def step_ec_encode(side):
    out = [side.run("ec.encode -volumeId 1 -backend cpu")]
    side.settle()
    return out + [side.run("ec.check.replication"), side.run("volume.list")]


def step_ec_balance(side):
    out = [side.run("ec.balance -dryRun"), side.run("ec.balance")]
    side.settle()
    # a holder finds an EC volume by its collection: another one is not found
    return out + [side.run("ec.balance -dryRun"), side.run("volume.list"),
                  side.run("ec.scrub -volumeId 1"), side.run("ec.scrub -volumeId 1 -collection c2")]


def step_ec_rebuild(side):
    topo = side.topology()
    # the last server's shards of volume 1 lost
    lost = [sid for _, _, _, ecs in topo[3:] for vid, _, bits in ecs if vid == 1
            for sid in range(14) if bits >> sid & 1]
    _unmount_delete(side, 3, 1, lost)
    side.settle()
    out = [lost, side.run("ec.check.replication"), side.run("ec.rebuild -volumeId 1 -backend cpu")]
    side.settle()
    out.append(side.run("ec.rebuild -volumeId 1 -fromPeers -backend cpu"))
    side.settle()
    return out + [side.run("ec.check.replication"), side.run("volume.list"),
                  side.run("ec.scrub -volumeId 1"), side.run("ec.rebuild -volumeId 99")]


def step_ec_decode(side):
    out = [side.run("ec.decode -volumeId 1")]
    side.settle()
    return out + [side.run("volume.list"), side.run("volume.scrub -volumeId 1"),
                  side.run("ec.decode -volumeId 1")]


def step_upload_download(side):
    src = side.root.parent / "upload.bin"  # one path: the needle's name is the path
    src.write_bytes(np.random.default_rng(221).bytes(3 << 20 | 12345))
    side.seed_picks(11)
    side.clock_stamped.add("up")
    fid = side.run(f"upload {src} -collection up")
    side.settle()
    got = side.root / "download.bin"
    out = [fid, side.run(f"download -fid {fid} -o {got}"), got.read_bytes() == src.read_bytes()]
    f = FileId.parse(fid)
    for vs in side.vols:
        vol = vs.store.find_volume(f.volume_id)
        if vol is not None:
            nv = vol.needle_map.get(f.needle_id)
            n = Needle.from_bytes(bytes(vol._pread_record(actual_offset(nv.offset), nv.size)))
            # the master's sequencer and the server stamp ids and clocks
            n.append_at_ns, n.last_modified, n.cookie, n.needle_id = 1, 1, 1, 1
            out.append(n.to_bytes())
    return out + [side.run("volume.list"), side.run("download -fid 999,01637037d6 -o /nonexistent")]


def step_collections(side):
    out = [side.run("collection.list"), side.run("collection.delete -collection c2")]
    side.settle()
    return out + [side.run("collection.list"), side.run("cluster.status"), side.run("cluster.check")]


# the filer's commands: one step each, on files written through each
# twin's filer (its package the shell's), in this order


def step_fs_mkdir(side):
    rng = np.random.default_rng(241)
    side.seed_picks(13)
    out = [side.run("fs.mkdir /fs/a"), side.run("fs.mkdir /fs/b/c"), side.run("fs.mkdir /fs/a")]
    # files: inlined, one chunk, several chunks, in three directories
    for path, n in (("/fs/a/small.txt", 300), ("/fs/a/one.bin", 40_000),
                    ("/fs/big.bin", 5 * FS_CHUNK + 321), ("/fs/b/c/deep.bin", 70_000),
                    ("/fs/b/mid.bin", 2 * FS_CHUNK)):
        out.append(side.fput(path, rng.bytes(n)))
    out.append(side.fput("/fs/a/text.txt", b"hello from the filer\n" * 3))
    side.fs_settle()
    return out


def step_fs_ls(side):
    return [side.run(c) for c in ("fs.ls /fs", "fs.ls /fs/a", "fs.ls /fs/a/small.txt",
                                  "fs.ls /nowhere", "fs.ls")]


def step_fs_cat(side):
    return [side.run("fs.cat /fs/a/text.txt"), side.run("fs.cat /fs/nowhere")]


def step_fs_stat(side):
    return [side.run(f"fs.stat {p}") for p in ("/fs/big.bin", "/fs/a", "/fs/a/small.txt",
                                               "/fs/nowhere")] + [side.run("fs.stat")]


def step_fs_meta_cat(side):
    return [side.run(f"fs.meta.cat {p}") for p in ("/fs/big.bin", "/fs/a/text.txt", "/fs/b",
                                                   "/fs/nowhere")]


def step_fs_tree(side):
    return [side.run("fs.tree /fs"), side.run("fs.tree /fs/b"), side.run("fs.tree /nowhere")]


def step_fs_du(side):
    return [side.run("fs.du /fs"), side.run("fs.du /fs/a"), side.run("fs.du /nowhere"),
            side.run("fs.du /fs/big.bin")]


def step_fs_mv(side):
    out = [side.run("fs.mv /fs/a/one.bin /fs/b/one.bin"), side.run("fs.mv /fs/nowhere /fs/x"),
           side.run("fs.mv /fs/b/c /fs/moved")]
    return out + [side.run("fs.tree /fs")]


def step_fs_cp(side):
    out = [side.run("fs.cp /fs/big.bin /fs/b/big.copy"), side.run("fs.cp /fs/a /fs/x"),
           side.run("fs.cp /fs/nowhere /fs/x"), side.run("fs.cp /fs/a/text.txt")]
    side.fs_settle()
    return out + [side.run("fs.ls /fs/b")]


def step_fs_verify(side):
    return [side.run(f"fs.verify {p}") for p in ("/fs/big.bin", "/fs/b/big.copy", "/fs/nowhere",
                                                 "/fs/a/small.txt")] + [side.run("fs.verify")]


def step_fs_meta_save(side):
    dump = side.root / "meta.jsonl"
    out = [side.run(f"fs.meta.save /fs -o {dump}"), side.run("fs.meta.save /nowhere -o /dev/null")]
    return out + [side.mask(dump.read_text())]


def step_fs_rm(side):
    out = [side.run("fs.rm /fs/b"), side.run("fs.rm -r /fs/moved"), side.run("fs.rm /fs/a/text.txt"),
           side.run("fs.rm /fs/nowhere")]
    side.fs_settle()
    return out + [side.run("fs.tree /fs")]


def step_fs_meta_load(side):
    out = [side.run(f"fs.meta.load {side.root / 'meta.jsonl'}")]
    side.fs_settle()
    return out + [side.run("fs.tree /fs")]


def step_fs_configure(side):
    out = [side.run("fs.configure"),
           side.run("fs.configure -locationPrefix /fs/rules -collection fsr -ttlSec 60"),
           side.run("fs.configure -locationPrefix /fs/other -replication 000"),
           side.run("fs.configure -show"),
           side.run("fs.configure -locationPrefix /fs/rules -delete")]
    return out + [side.run("fs.configure -show"), side.run("lock.status")]


def step_volume_fsck(side):
    out = [side.run("volume.fsck -path /fs"), side.run("volume.fsck -path /nowhere")]
    # one chunk's needle deleted behind the filer's back: fsck finds it
    chunks = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{side.fport}/fs/big.bin?chunks=true", timeout=30).read())["chunks"]
    fid = chunks[2]
    (loc,) = side.env.master.lookup(FileId.parse(fid).volume_id, refresh=True)
    req = urllib.request.Request(f"http://{loc.url}/{fid}", method="DELETE")
    out.append(urllib.request.urlopen(req, timeout=30).status)
    side.fs_settle()
    return out + [side.run("volume.fsck"), side.run("volume.fsck -path /fs/a")]


def step_cluster_lock_ring(side):
    cls = JaxDlmClient if side.shell == "jax" else DlmClient
    c = cls([f"127.0.0.1:{side.fport + 10000}"])
    try:
        out = [side.run("cluster.lock.ring")]
        r = c.lock("jobs/fs", "ring-owner", ttl=30.0)
        out += [r.ok, side.run("cluster.lock.ring"),
                side.run(f"cluster.lock.ring -filers 127.0.0.1:{side.fport + 10000},127.0.0.1:1")]
        out.append(c.unlock("jobs/fs", r.token).ok)
    finally:
        c.close()
    return out + [side.run("cluster.lock.ring")]


# S3's commands: one step each, against each twin's filer (its package the
# shell's): identities and policies in its KV, buckets under /buckets, the
# objects of b1 in the collection b1, as the gateway stores them


@contextlib.contextmanager
def minted(seed: int):
    """s3.accesskey.create's key pairs from a seeded rng (both packages
    mint them through the `secrets` module)."""
    import base64
    import secrets
    from unittest import mock

    rng = random.Random(seed)
    with mock.patch.object(secrets, "token_hex", lambda n: rng.randbytes(n).hex()), \
            mock.patch.object(secrets, "token_urlsafe", lambda n: base64.urlsafe_b64encode(
                rng.randbytes(n)).rstrip(b"=").decode()):
        yield


S3_POLICY = json.dumps({"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:GetObject", "s3:ListBucket"],
     "Resource": ["arn:aws:s3:::b1", "arn:aws:s3:::b1/*"]},
    {"Effect": "Deny", "Action": "s3:DeleteObject", "Resource": "*"}]})


def step_s3_user_list(side):
    out = [side.run("s3.user.list")]
    side.run("s3.configure -user ann -access_key AKANN -secret_key SKANN -actions Read,List")
    return out + [side.run("s3.user.list")]


def step_s3_configure(side):
    return [side.run(c) for c in (
        "s3.configure -user ann -actions Read",
        "s3.configure -user bob -actions Read",
        "s3.configure -user bob",
        "s3.configure -user bob -access_key AKBOB",
        "s3.configure -user dan -access_key AKDAN -secret_key SKDAN",
        "s3.configure -user ann -access_key AKANN2 -secret_key SKANN2",
        "s3.configure -user dan -access_key AKDAN -secret_key SKDAN2 -actions Write",
        "s3.user.list")]


def step_s3_accesskey_create(side):
    with minted(31):
        return [side.run("s3.accesskey.create -user eve -actions Read,Write"),
                side.run("s3.accesskey.create -user fay"), side.run("s3.user.list")]


def step_s3_policy_put(side):
    return [side.run(f"s3.policy.put -user fay -policy '{S3_POLICY}'"),
            side.run("s3.policy.put -user fay -policy '{not json'"),
            side.run("""s3.policy.put -user fay -policy '{"Version": "2012-10-17"}'"""),
            side.run(f"s3.policy.put -user nobody -policy '{S3_POLICY}'"),
            side.run("s3.user.list")]


def step_s3_policy_get(side):
    return [side.run("s3.policy.get -user fay"), side.run("s3.policy.get -user ann"),
            side.run("s3.policy.get -user nobody")]


def step_s3_policy_delete(side):
    out = [side.run("s3.policy.delete -user fay -actions Read,List"),
           side.run("s3.policy.get -user fay")]
    side.run(f"s3.policy.put -user fay -policy '{S3_POLICY}'")
    return out + [side.run("s3.policy.delete -user nobody"), side.run("s3.user.list")]


def step_s3_accesskey_delete(side):
    return [side.run("s3.accesskey.delete -access_key AKANN"),
            side.run("s3.accesskey.delete -access_key AKNONE"), side.run("s3.user.list")]


def step_s3_user_delete(side):
    return [side.run("s3.user.delete -user dan"), side.run("s3.user.delete -user dan"),
            side.run("s3.user.list")]


def step_s3_bucket_create(side):
    out = [side.run("s3.bucket.create -name b1"), side.run("s3.bucket.create -name b2"),
           side.run("s3.bucket.create -name b1")]
    # b1's objects: inlined and chunked, the chunks in the collection b1
    rng = np.random.default_rng(251)
    side.seed_picks(17)
    side.clock_stamped.add("b1")
    for key, n in (("small.txt", 200), ("dir/one.bin", 3 * FS_CHUNK + 77), ("dir/two.bin", 9000)):
        side.filer.write_file(f"/buckets/b1/{key}", rng.bytes(n), collection="b1", inline=n < 1024)
    side.filer.create_entry(side.filer_entry("/buckets/.hidden", directory=True))
    side.fs_settle()
    return out + [side.run("collection.list")]


def step_s3_bucket_list(side):
    return [side.run("s3.bucket.list")]


def step_s3_bucket_quota_set(side):
    return [side.run("s3.bucket.quota.set -name b1 -bytes 4096"),
            side.run("s3.bucket.quota.set -name b2 -bytes 1048576"),
            side.run("s3.bucket.quota.set -name b3 -bytes 5"),
            side.run("s3.bucket.quota.set -name b3 -bytes 0")]


def step_s3_bucket_quota_get(side):
    return [side.run(f"s3.bucket.quota.get -name {b}") for b in S3_BUCKETS]


def step_s3_bucket_quota_enforce(side):
    out = [side.run("s3.bucket.quota.enforce")]
    out.append(side.run("s3.bucket.quota.set -name b1 -bytes 1000000"))
    return out + [side.run("s3.bucket.quota.enforce"), side.run("s3.bucket.quota.get -name b1")]


def step_s3_clean_uploads(side):
    for name in ("up1", "up2"):
        side.filer.create_entry(side.filer_entry(f"/buckets/b1/.uploads/{name}", directory=True))
        side.filer.write_file(f"/buckets/b1/.uploads/{name}/00001.part", b"part" * 50)
    return [side.run("s3.clean.uploads"), side.run("s3.clean.uploads -timeAgo 0"),
            side.run("s3.clean.uploads -timeAgo 0")]


def step_s3_bucket_delete(side):
    out = [side.run("s3.bucket.delete -name b1"), side.run("s3.bucket.delete -name b2")]
    out.append(side.run("s3.bucket.delete -name b1 -force"))
    side.fs_settle()
    return out + [side.run("s3.bucket.list"), side.run("collection.list")]


STEPS = [step_listing, step_lock, step_raft, step_sync, step_fix_replication, step_plain_volume,
         step_copy_mount, step_move_tier, step_grow_delete_empty, step_volume_balance, step_ec_encode,
         step_ec_balance, step_ec_rebuild, step_ec_decode, step_upload_download, step_collections,
         step_fs_mkdir, step_fs_ls, step_fs_cat, step_fs_stat, step_fs_meta_cat, step_fs_tree,
         step_fs_du, step_fs_mv, step_fs_cp, step_fs_verify, step_fs_meta_save, step_fs_rm,
         step_fs_meta_load, step_fs_configure, step_volume_fsck, step_cluster_lock_ring,
         step_s3_user_list, step_s3_configure, step_s3_accesskey_create, step_s3_policy_put,
         step_s3_policy_get, step_s3_policy_delete, step_s3_accesskey_delete, step_s3_user_delete,
         step_s3_bucket_create, step_s3_bucket_list, step_s3_bucket_quota_set,
         step_s3_bucket_quota_get, step_s3_bucket_quota_enforce, step_s3_clean_uploads,
         step_s3_bucket_delete]


def _masked(side, out):
    return [side.mask(o) if isinstance(o, str) else o for o in out]


@pytest.mark.parametrize("step", STEPS, ids=lambda f: f.__name__[5:])
def test_shell_step_against_jax(twins, pinned, step):
    jax_side, port_side = twins
    outs = [_masked(s, step(s)) for s in twins]
    assert outs[0] == outs[1]
    assert jax_side.topology() == port_side.topology()
    assert jax_side.files() == port_side.files()
    assert jax_side.s3_state() == port_side.s3_state()


def test_fleet_commands_against_jax(twins):
    """The five fleet commands on each twin, a worker of the shell's package
    registered for part of it (the mixed twin's master is the JAX one)."""
    from seaweedfs_tpu.worker.worker import Worker as JaxWorker
    from seaweedfs_tpu_torch.worker.worker import Worker

    outs = []
    for side in twins:
        out = [side.run(c) for c in (
            "worker.list", "cluster.ps", "maintenance.config",
            "maintenance.config -set ec_quiet_seconds=30 -set ec_scrub_interval_seconds=0",
            "maintenance.config -set nope=1", "maintenance.config -set ec_auto_fullness=2",
            "task.list")]
        cls = JaxWorker if side.shell == "jax" else Worker
        w = cls(master=f"127.0.0.1:{side.mport}", backend="cpu", worker_id="w-shell",
                capabilities=("vacuum", "ec_scrub"))
        threading.Thread(target=w.run, daemon=True).start()
        try:
            wait_for(lambda: "w-shell" in side.run("worker.list"), timeout=30,
                     msg="the worker did not register")
            out += [side.run("worker.list"), side.run("cluster.ps"),
                    side.run("task.submit -kind vacuum"),
                    side.run("task.submit -kind vacuum -volumeId 4 -param garbage_threshold=0.9"),
                    side.run("task.submit -kind ec_scrub -volumeId 4")]
            wait_for(lambda: all(f" {st}" not in side.run("task.list")
                                 for st in ("pending", "assigned", "running")),
                     timeout=30, msg="the tasks did not finish")
            out.append(side.run("task.list"))
        finally:
            w.stop()
        wait_for(lambda: side.run("worker.list") == "no workers connected", timeout=30,
                 msg="the worker did not leave")
        side.settle()
        out.append(side.run("maintenance.config -set ec_quiet_seconds=60"))
        grpc_port = lambda m: f"grpc={side.names[int(m[1])]}"  # noqa: E731
        outs.append([re.sub(r"\b[0-9a-f]{12}\b", "<task>",
                            re.sub(r"grpc=(\d+)", grpc_port, side.mask(o))) for o in out])
    assert outs[0] == outs[1]
    assert "vacuum vol=4 done worker=w-shell" in outs[1][-2]
    assert twins[0].topology() == twins[1].topology()
    assert twins[0].files() == twins[1].files()


def test_every_ported_command_ran_against_jax(twins):
    jax_side, port_side = twins
    assert port_side.ran == jax_side.ran == PORTED


# ------------------------------------------------------------ the registry


def test_registry_is_the_39_commands_of_the_jax_shell():
    assert set(port_shell.COMMANDS) == PORTED | REMOTE_COMMANDS and len(PORTED) == 75
    assert len(port_shell.COMMANDS) == 82
    assert len(port_shell.DEFERRED) == 9 and "12b" not in port_shell.DEFERRED.values()
    assert "18" not in port_shell.DEFERRED.values()
    assert "13b" not in port_shell.DEFERRED.values()
    assert set(port_shell.COMMANDS) <= set(jax_shell.COMMANDS)
    assert set(port_shell.COMMANDS) | set(port_shell.DEFERRED) == set(jax_shell.COMMANDS)
    assert not set(port_shell.COMMANDS) & set(port_shell.DEFERRED)
    for name, (_, help_text) in port_shell.COMMANDS.items():
        want = jax_shell.COMMANDS[name][1]
        assert help_text == want.replace("cpu|tpu|auto", "cpu|cuda|auto"), name
    assert "cuda" in port_shell.COMMANDS["ec.encode"][1]


@pytest.mark.parametrize("name", sorted(port_shell.DEFERRED))
def test_command_left_for_later_names_its_item(name):
    env = types.SimpleNamespace()  # reaches no master
    item = port_shell.DEFERRED[name]
    assert port_shell.run_command(env, f"{name} -x 1") == (
        f"error: {name} is not ported yet: it comes with ROADMAP.md item {item}")
    roadmap = open(os.path.join(REPO, "ROADMAP.md")).read()
    assert re.search(rf"^- {re.escape(item)}\. \*\*", roadmap, re.MULTILINE), item


def test_help_and_unknown_commands_answer_as_jax():
    env = types.SimpleNamespace()
    lines = port_shell.run_command(env, "help").splitlines()
    jax_lines = [ln for ln in jax_shell.run_command(env, "help").splitlines()
                 if ln.split()[0] in PORTED | REMOTE_COMMANDS]
    assert lines == [ln.replace("cpu|tpu|auto", "cpu|cuda|auto") for ln in jax_lines]
    assert port_shell.run_command(env, "?") == port_shell.run_command(env, "help")
    assert port_shell.run_command(env, "nope.cmd") == jax_shell.run_command(env, "nope.cmd")
    assert port_shell.run_command(env, "   ") == jax_shell.run_command(env, "   ") == ""


@pytest.mark.parametrize("line", ["ec.encode -volumeId 1 -backend tpu",
                                  "ec.rebuild -volumeId 1 -backend=tpu -fromPeers",
                                  "task.submit -kind ec_encode -volumeId 1 -backend tpu"])
def test_backend_the_port_does_not_run_is_refused_before_any_rpc(line):
    class NoMaster:
        def __getattr__(self, name):
            raise AssertionError(f"the shell reached the master ({name})")

    env = types.SimpleNamespace(master=NoMaster())
    assert port_shell.run_command(env, line) == (
        "error: -backend tpu: the port runs its EC on cuda, cpu or auto")


def test_ec_encode_defaults_to_cuda(monkeypatch):
    """The default `-backend` reaches VolumeEcShardsGenerate as "cuda"."""
    seen = []

    class Stub:
        def __getattr__(self, name):
            def call(req, **kw):
                if name == "VolumeEcShardsGenerate":
                    seen.append(req.backend)
                return types.SimpleNamespace(generation=5, error="")
            return call

    loc = pb.Location(url="127.0.0.1:1", grpc_port=2)
    master = types.SimpleNamespace(
        topology=lambda: pb.TopologyResponse(), lookup=lambda vid, refresh=False: [loc],
        lock=lambda *a, **k: "tok", unlock=lambda *a, **k: True)
    env = types.SimpleNamespace(master=master, owner="o", lock_wait=0, admin_token="",
                                _auto_admin_token="")
    monkeypatch.setattr(port_shell, "_volume_stub", lambda loc: (contextlib.nullcontext(), Stub()))
    assert port_shell.run_command(env, "ec.encode -volumeId 3") == (
        "ec.encode volume 3: generation 5 on 127.0.0.1:1")
    assert seen == ["cuda"]


# ------------------------------------------------------- the master group


def test_master_group_fails_alike_in_both_shells(twins):
    """`-master a,b,c`: the master client finds the leader in the group,
    but `_master_channel`, `_raft_stub` and the HTTP reads take the raw
    string, in both shells (ROADMAP.md Queue 3). So do `cluster.ps`,
    `worker.list` and `maintenance.config`; `task.*` dial the master
    client's leader, the group's first master until a call re-homes it."""
    side = twins[1]
    group = f"127.0.0.1:{side.mport},127.0.0.1:1,127.0.0.1:2"
    envs = [jax_shell.ShellEnv(group), port_shell.ShellEnv(group)]
    try:
        errs = []
        for mod, env in zip((jax_shell, port_shell), envs):
            with pytest.raises(ValueError) as e:
                mod.run_command(env, "volume.vacuum.disable -volumeId 2")
            errs.append(str(e.value))
            for c in ("cluster.raft.ps", "cluster.ps", "worker.list", "maintenance.config"):
                with pytest.raises(ValueError) as e:
                    mod.run_command(env, c)
                errs.append(str(e.value))
        assert errs[:5] == errs[5:] and "invalid literal for int()" in errs[0]
        assert len(set(errs)) == 1
        # the second submit dedupes onto the first: one pending task
        submitted = [mod.run_command(env, "task.submit -kind vacuum -volumeId 424242")
                     for mod, env in zip((jax_shell, port_shell), envs)]
        assert submitted[0] == submitted[1] and re.fullmatch(r"task \w+ submitted", submitted[0])
        outs = [side.mask(mod.run_command(env, c)).replace(group, "<group>")
                for mod, env in zip((jax_shell, port_shell), envs)
                for c in ("volume.list", "cluster.check", "lock.status", "task.list",
                          "cluster.status")]
        assert outs[:4] == outs[5:9]
        assert f"{submitted[0].split()[1]} vacuum vol=424242 pending" in outs[3]
        status = [outs[4].splitlines(), outs[9].splitlines()]
        assert status[0][:-1] == status[1][:-1]
        assert all(s[-1].startswith("  (telemetry unavailable: ") for s in status)
    finally:
        for env in envs:
            env.close()


# ------------------------------------------------------------ the entry point


def test_module_entry_point_runs_help_as_a_subprocess():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.shell", "-master",
                           "127.0.0.1:1", "-c", "help"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [ln.split()[0] for ln in proc.stdout.splitlines()] == sorted(PORTED | REMOTE_COMMANDS)
    proc = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.shell", "-master",
                           "127.0.0.1:1"], cwd=REPO, env=env, input="help\nmq.topic.list\nexit\n",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "error: mq.topic.list is not ported yet: it comes with ROADMAP.md item 14a" in proc.stdout


# ------------------------------------------------------- client/operations


def test_urls_match_jax():
    from seaweedfs_tpu.utils import urls as jax_urls

    for hp, path in (("h:1", ""), ("h:1", "/x?y=1"), ("https://h:2", "/p"), ("http://h", "")):
        assert urls.service_url(hp, path) == jax_urls.service_url(hp, path)
    assert urls.scheme() == "http"


@pytest.fixture(scope="module", params=["port-server", "jax-server"])
def ops_cluster(request, tmp_path_factory):
    """A JAX master with one volume server of the named package."""
    root = tmp_path_factory.mktemp("ops")
    mport = _ports()
    master = JaxMasterServer(ip="127.0.0.1", port=mport, vacuum_interval=3600)
    master.start()
    cls = VolumeServer if request.param == "port-server" else JaxVolumeServer
    vs = cls([str(root / "v")], master=f"127.0.0.1:{mport}", ip="127.0.0.1", port=_ports(),
             ec_backend="cpu")
    vs.start()
    try:
        wait_for(lambda: len(master.topo.nodes) == 1, timeout=30, msg="the server did not register")
        yield mport, vs
    finally:
        vs.stop()
        master.stop()


def _record(vs, fid: str) -> bytes:
    """A needle's record with the server's clocks (append_at_ns,
    last_modified), its cookie and its id normalised."""
    f = FileId.parse(fid)
    vol = vs.store.find_volume(f.volume_id)
    nv = vol.needle_map.get(f.needle_id)
    n = Needle.from_bytes(bytes(vol._pread_record(actual_offset(nv.offset), nv.size)))
    n.append_at_ns, n.last_modified, n.cookie, n.needle_id = 1, 1, 1, 1
    return n.to_bytes()


@pytest.mark.parametrize("plane", ["net", "http"])
def test_operations_upload_and_read_as_jax(ops_cluster, monkeypatch, plane):
    mport, vs = ops_cluster
    if plane == "http":
        monkeypatch.setenv("SEAWEED_CHUNK_NET_PLANE", "0")
        monkeypatch.setenv("SEAWEED_CHUNK_NET_PLANE_WRITE", "0")
    col = f"ops{plane}"
    mine, theirs = port_ops.Operations(f"127.0.0.1:{mport}"), JaxOperations(f"127.0.0.1:{mport}")
    try:
        body = np.random.default_rng(31).bytes(700_001)
        fids = []
        for ops in (mine, theirs):
            fid = ops.upload(body, name='a "q".bin', mime="application/x-test", collection=col)
            fids.append(fid)
            assert ops.read(fid) == body and ops.read(fid, fast=False) == body
        assert mine.read(fids[1]) == theirs.read(fids[0]) == body
        assert _record(vs, fids[0]) == _record(vs, fids[1])
        empty = [ops.upload(b"", collection=col) for ops in (mine, theirs)]
        assert mine.read(empty[1]) == theirs.read(empty[0]) == b""
        assert _record(vs, empty[0]) == _record(vs, empty[1])
        mine.delete(fids[1])
        theirs.delete(fids[0])
        mine.delete(fids[0])  # already deleted: a 404 is an answer, as in JAX
        for ops in (mine, theirs):
            for f in fids:
                with pytest.raises(LookupError):
                    ops.read(f, fast=False)
    finally:
        mine.close()
        theirs.close()


class _Answer(http.server.BaseHTTPRequestHandler):
    codes: list = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        code = self.codes.pop(0) if self.codes else 201
        _Answer.seen.append(code)
        self.send_response(code)
        self.send_header("Content-Length", "4")
        self.end_headers()
        self.wfile.write(b"nope")


@pytest.mark.parametrize("codes, attempts, raises", [
    ([400], 1, "400 for http://"),
    ([403], 1, "403 for http://"),
    ([500, 503], 3, None),
    ([500, 500, 500, 500], 4, "500 for http://"),
])
def test_upload_retries_5xx_and_not_4xx(monkeypatch, codes, attempts, raises):
    _Answer.codes, _Answer.seen = list(codes), []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Answer)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    ops = port_ops.Operations("127.0.0.1:1")
    try:
        monkeypatch.setattr(ops.master, "assign", lambda **kw: AssignResult(
            fid="3,01637037d6", url=f"127.0.0.1:{srv.server_address[1]}", public_url="",
            grpc_port=0, replicas=[]))
        if raises:
            with pytest.raises(port_ops.HTTPStatusError, match=re.escape(raises)) as e:
                ops.upload(b"x")
            assert isinstance(e.value, OSError)
        else:
            assert ops.upload(b"x") == "3,01637037d6"
        assert _Answer.seen == (codes + [201])[:attempts]
    finally:
        ops.close()
        srv.shutdown()
        srv.server_close()


# ------------------------------------------------------------ the planners


def _views(mod, spec):
    return [mod.NodeView(id=n["id"], rack=n["rack"], data_center=n["dc"], free_slots=n["free"],
                         shards={v: set(s) for v, s in n["shards"].items()},
                         free_bytes=n["bytes"], ec_load=n["load"], ec_breakers_open=n["open"],
                         ec_chips=n["chips"]) for n in spec]


@st.composite
def topologies(draw):
    n_nodes = draw(st.integers(2, 7))
    n_racks = draw(st.integers(1, 3))
    vids = draw(st.lists(st.integers(1, 9), min_size=1, max_size=3, unique=True))
    nodes = [{"id": f"n{i}", "rack": f"r{draw(st.integers(0, n_racks - 1))}", "dc": "dc1",
              "free": draw(st.integers(0, 40)), "shards": {},
              "bytes": draw(st.sampled_from([-1, 0, 1 << 20, 1 << 30])),
              "load": draw(st.sampled_from([-1.0, 0.0, 1.5e7, 6.7e7, 3e8])),
              "open": draw(st.integers(0, 1)), "chips": draw(st.integers(0, 4))}
             for i in range(n_nodes)]
    for vid in vids:
        total = draw(st.sampled_from([6, 14]))
        for sid in range(total):
            for i in draw(st.lists(st.integers(0, n_nodes - 1), min_size=0, max_size=2, unique=True)):
                nodes[i]["shards"].setdefault(vid, []).append(sid)
    return nodes


def _plan(mod, spec, gravity: bool):
    views = _views(mod, spec)
    drops, moves = mod.plan_ec_balance(views, data_gravity=gravity, max_gravity_moves=3)
    return ([(d.vid, d.shard_id, d.node) for d in drops],
            [(m.vid, m.shard_id, m.src, m.dst, m.reason) for m in moves],
            [(v.id, sorted((k, sorted(s)) for k, s in v.shards.items()), v.free_slots) for v in views])


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(spec=topologies(), gravity=st.booleans())
def test_plan_ec_balance_equals_jax(spec, gravity):
    assert _plan(placement, spec, gravity) == _plan(jax_placement, spec, gravity)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(spec=topologies(), heat_seed=st.integers(0, 2**31), max_moves=st.integers(1, 3),
       sizes=st.sampled_from([None, {1: 1 << 19, 2: 1 << 20}]))
def test_plan_hot_migrations_equals_jax(spec, heat_seed, max_moves, sizes):
    rng = random.Random(heat_seed)
    heat = {n["id"]: {v: rng.choice([0, 1 << 19, 3 << 20, 9 << 20]) for v in n["shards"]}
            for n in spec if rng.random() < 0.7}
    plans = []
    for mod in (rebalance, jax_rebalance):
        got = mod.plan_hot_migrations(_views(placement if mod is rebalance else jax_placement, spec),
                                      heat, shard_bytes=sizes, min_heat=1 << 20,
                                      max_migrations=max_moves, min_gain=1.5)
        plans.append([(m.vid, m.src, m.dst, m.shard_ids, m.heat, m.src_gravity, m.dst_gravity,
                       m.rank()) for m in got])
    assert plans[0] == plans[1]


def test_volume_heat_and_env_knobs_match_jax(monkeypatch):
    blobs = [None, {}, {"ec_volumes": []}, {"ec_volumes": {"3": {"read_bytes": 7,
                                                               "reconstructed_bytes": 2},
                                                         "x": {}, "4": {"read_bytes": "bad"}}}]
    for b in blobs:
        assert rebalance.volume_heat(b) == jax_rebalance.volume_heat(b)
    for val in ("2", "0.5", "junk"):
        monkeypatch.setenv("SEAWEED_EC_REBALANCE_MIN_HEAT_MB", val)
        monkeypatch.setenv("SEAWEED_EC_REBALANCE_MAX_MOVES", val)
        monkeypatch.setenv("SEAWEED_EC_REBALANCE_MIN_GAIN", val)
        for f in ("min_heat_bytes", "max_migrations_per_sweep", "min_gravity_gain"):
            assert getattr(rebalance, f)() == getattr(jax_rebalance, f)()


def test_drive_migration_moves_a_shard_set_between_port_servers(tmp_path):
    from seaweedfs_tpu_torch.utils import metrics

    servers = []
    channels = []
    try:
        for name in "ab":
            vs = VolumeServer([str(tmp_path / name)], ip="127.0.0.1", port=_ports(), ec_backend="cpu")
            vs.start()
            servers.append(vs)
        a, b = servers
        a.store.allocate_volume(9)
        for nid, cookie, body in needles(231, 20, 40_000):
            a.store.write_needle(9, Needle(cookie=cookie, needle_id=nid, data=body))

        def stub_for(addr):
            ch = grpc.insecure_channel(addr)
            channels.append(ch)
            return rpc.volume_stub(ch)

        ga, gb = f"127.0.0.1:{a.grpc_port}", f"127.0.0.1:{b.grpc_port}"
        sa = stub_for(ga)
        sa.VolumeEcShardsGenerate(pb.EcShardsGenerateRequest(volume_id=9), timeout=60)
        sa.VolumeEcShardsMount(pb.EcShardsMountRequest(volume_id=9), timeout=30)
        want = {sid: sha(tmp_path / "a" / f"9.ec{sid:02d}") for sid in (2, 5, 11)}
        before = rebalance._migrations_total.snapshot()
        out = rebalance.drive_migration(9, "", ga, gb, [11, 5, 2], stub_for=stub_for)
        assert out == {"migrated": [2, 5, 11], "copied": [2, 5, 11], "src": ga, "dst": gb}
        for sid, digest in want.items():
            assert sha(tmp_path / "b" / f"9.ec{sid:02d}") == digest
            assert not (tmp_path / "a" / f"9.ec{sid:02d}").exists()
        assert sorted(b.store.find_ec_volume(9).shard_ids) == [2, 5, 11]
        assert 2 not in a.store.find_ec_volume(9).shard_ids
        for ext in (".ecx", ".vif", ".ecsum"):
            assert sha(tmp_path / "b" / f"9{ext}") == sha(tmp_path / "a" / f"9{ext}")
        # a re-run where the destination already serves the set only cleans up
        again = rebalance.drive_migration(9, "", ga, gb, [2, 5, 11], stub_for=stub_for,
                                          lookup_ec=lambda: {2: [gb], 5: [gb], 11: [gb]})
        assert again["copied"] == [] and sorted(b.store.find_ec_volume(9).shard_ids) == [2, 5, 11]
        assert rebalance.drive_migration(9, "", ga, gb, [], stub_for=stub_for) == {
            "migrated": [], "skipped": "empty shard set"}
        after = rebalance._migrations_total.snapshot()
        assert after != before and b"sw_ec_migrations_total" in metrics.REGISTRY.render()
    finally:
        for ch in channels:
            ch.close()
        for vs in servers:
            vs.stop()


def test_a_minted_secret_that_starts_with_a_dash(twins):
    """s3.accesskey.create hands its minted pair to s3.configure's parser.
    A secret that starts with "-" (`token_urlsafe`, 1 in 64) exits the
    JAX shell (argparse's SystemExit); the port's passes it as
    `-secret_key=<secret>`, stores it and answers it."""
    import secrets
    from unittest import mock

    jax_side, port_side = twins
    dash = "-" + "Ab_-" * 10
    with mock.patch.object(secrets, "token_urlsafe", lambda n: dash):
        with pytest.raises(SystemExit):
            jax_side.run("s3.accesskey.create -user dash")
        out = port_side.run("s3.accesskey.create -user dash")
    assert out.startswith("user=dash\naccess_key=SW") and out.endswith(f"\nsecret_key={dash}")
    assert "dash " in port_side.run("s3.user.list")
    assert port_side.run("s3.user.delete -user dash") == "deleted 1 credential(s) of dash"
    assert "dash " not in port_side.run("s3.user.list")

