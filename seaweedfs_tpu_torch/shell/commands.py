"""Shell commands: the ops surface (`weed shell` analog).

Port of seaweedfs_tpu/shell/commands.py (reference weed/shell/commands.go,
command_ec_encode.go:102 doEcEncode: mark readonly -> generate -> mount ->
delete source; command_ec_rebuild.go, command_ec_decode.go,
command_ec_common.go, the volume.* family).

Each command is a function(env, args) -> str; the registry drives both
the REPL and one-shot `python -m seaweedfs_tpu_torch.shell -c "..."`.

The port has the registry, the shared helpers and 82 commands: the
cluster (`cluster.status`, `cluster.check`, `cluster.ps`, `cluster.raft.*`),
volume, EC, collection and lock commands, `upload` and `download`, the
worker fleet's (`task.submit`, `task.list`, `worker.list`,
`maintenance.config`), the filer's (`fs.*`, `volume.fsck`,
`cluster.lock.ring`), S3's (`s3.*`: identities, policies, buckets and
their quotas, in the filer) and remote storage's (`remote.*`, the filer's
`/~remote/<op>`). The JAX shell's other commands need modules
the port has not taken yet (MQ and mount);
each answers one error line naming the ROADMAP.md item it comes with
(`DEFERRED`).

Where the port differs from the JAX shell:
- the master's HTTP reads (`cluster.status`, `ec.balance -dataGravity`)
  go over `urllib`, as best-effort as the JAX `requests` reads, and the
  filer's (`fs.*`, `volume.fsck`, `remote.*`) over `http.client`, `fs.cp` streaming
  its copy out chunked as the JAX `requests` POST of a generator does;
- `ec.encode -backend` takes `cuda|cpu|auto` and defaults to `cuda`, as
  every port entry point does; a mutating command given another backend
  (the JAX `tpu`) answers an error line before any RPC, and so does
  `task.submit -backend tpu`. `ec.rebuild`'s and `task.submit`'s default
  stays "", the server's `ec_backend` or the worker's backend;
- `s3.accesskey.create` hands its minted secret to `s3.configure` as
  `-secret_key=<secret>`: a secret that starts with "-" (1 in 64) makes
  the JAX shell's parser exit it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shlex
import urllib.error
import urllib.request
import uuid as _uuid
from urllib.parse import urlsplit

import grpc

from ..client.master_client import (
    LockHeldError,
    MasterClient,
    volume_channel,
)
from ..ec import fleet
from ..pb import cluster_pb2 as pb
from ..pb import rpc
from ..utils import trace
from ..utils import urls
from ..utils.urls import service_url

# the backends a port server's EC runs on (ec/backend.py get_backend)
BACKENDS = ("cuda", "cpu", "auto")

# The JAX shell's commands that wait for modules the port has not taken
# yet, each with the ROADMAP.md item that brings it. They are not in
# COMMANDS: run_command answers them with one error line.
DEFERRED: dict[str, str] = {
    **{c: "14a" for c in (
        "mq.schema.get", "mq.schema.set", "mq.topic.compact", "mq.topic.configure",
        "mq.topic.delete", "mq.topic.describe", "mq.topic.list", "mq.topic.truncate")},
    "mount.configure": "16",
}


class ShellEnv:
    def __init__(self, master: str = "localhost:9333", filer: str = "localhost:8888"):
        self.master_addr = master
        self.filer_addr = filer
        self.master = MasterClient(master)
        self.owner = f"shell-{_uuid.uuid4().hex[:8]}"
        # how long mutating commands wait for a busy cluster lock
        self.lock_wait = 10.0
        # set by the explicit `lock` command: held across the session
        self.admin_token = ""
        # set while a mutating command auto-holds the admin lease
        # (makes nested cluster_guard calls re-entrant)
        self._auto_admin_token = ""

    def close(self):
        if self.admin_token:
            self.master.unlock("admin", self.admin_token)
            self.admin_token = ""
        self.master.close()


@contextlib.contextmanager
def cluster_guard(env: ShellEnv, vids=(), ttl: float = 600.0, wait: float | None = None):
    """Exclusive cluster lock for a mutating command (reference
    confirmIsLocked): the global admin lease plus a per-volume lease for
    every touched volume, so two shells — or a shell and the worker
    fleet — cannot race destructive steps on the same volume. The admin
    lease is auto-acquired per command unless the session holds it via
    the `lock` command."""
    import threading as _threading

    if wait is None:
        wait = env.lock_wait
    held = env.admin_token or env._auto_admin_token
    admin_tok = env.master.lock(
        "admin", env.owner, ttl=ttl, token=held, wait=wait
    )
    outer = not held
    if outer:
        env._auto_admin_token = admin_tok
    vol_toks: list[tuple[str, str]] = []
    stop_renew = _threading.Event()

    def _renew_loop():
        # a command outliving its ttl must not silently lose mutual
        # exclusion: renew all held leases at ttl/3 cadence (renewal
        # never shortens a lease server-side)
        while not stop_renew.wait(max(ttl / 3.0, 1.0)):
            try:
                env.master.lock(
                    "admin", env.owner, ttl=ttl, token=admin_tok, wait=0
                )
                for name, tok in vol_toks:
                    env.master.lock(name, env.owner, ttl=ttl, token=tok, wait=0)
            except Exception:  # noqa: BLE001 — lease lost (e.g. failover)
                return

    try:
        for vid in vids:
            name = f"volume/{int(vid)}"
            vol_toks.append(
                (name, env.master.lock(name, env.owner, ttl=ttl, wait=wait))
            )
        _threading.Thread(target=_renew_loop, daemon=True).start()
        yield
    finally:
        stop_renew.set()
        for name, tok in vol_toks:
            env.master.unlock(name, tok)
        if outer:
            env._auto_admin_token = ""
            if not env.admin_token:
                env.master.unlock("admin", admin_tok)


@contextlib.contextmanager
def volume_lease(env: ShellEnv, vid: int, ttl: float = 600.0):
    """Per-volume cluster lease for commands that discover their target
    volumes at runtime (ec.balance, fix.replication, collection.delete):
    the admin lease alone does not exclude the worker fleet, which holds
    only volume/<vid> leases."""
    name = f"volume/{int(vid)}"
    tok = env.master.lock(name, env.owner, ttl=ttl, wait=env.lock_wait)
    try:
        yield
    finally:
        env.master.unlock(name, tok)


COMMANDS: dict[str, tuple] = {}


def command(name: str, help_text: str, mutating: bool = False):
    """`mutating=True` gates the command on the exclusive cluster admin
    lease (reference confirmIsLocked) — two shells cannot interleave
    destructive cluster operations."""

    def deco(fn):
        if mutating:
            import functools

            @functools.wraps(fn)
            def wrapped(env, args):
                refused = _unserved_backend(args)
                if refused:
                    return refused
                # the command's -volumeId targets get per-volume leases
                # too, so worker tasks on those volumes cannot interleave
                vids: list[int] = []
                for i, tok in enumerate(args):
                    if tok == "-volumeId" and i + 1 < len(args):
                        vids = [
                            int(v)
                            for v in str(args[i + 1]).split(",")
                            if v.strip().isdigit()
                        ]
                with cluster_guard(env, vids=vids):
                    return fn(env, args)

            COMMANDS[name] = (wrapped, help_text)
            return fn
        COMMANDS[name] = (fn, help_text)
        return fn

    return deco


def _unserved_backend(args) -> str:
    """The error line for a `-backend` the port's servers do not run
    (the JAX `tpu`), else "": answered before the lease and any RPC."""
    for i, tok in enumerate(args):
        name = None
        if tok == "-backend" and i + 1 < len(args):
            name = args[i + 1]
        elif tok.startswith("-backend="):
            name = tok.split("=", 1)[1]
        if name is not None and name and name not in BACKENDS:
            return f"error: -backend {name}: the port runs its EC on cuda, cpu or auto"
    return ""


def _get_json(url: str, timeout: float = 5.0):
    """The JSON body of one GET over urllib (an error status's body is
    parsed too, as `requests.get(url).json()` does)."""
    try:
        with urls.urlopen(url, timeout=timeout) as r:
            body = r.read()
    except urllib.error.HTTPError as e:
        body = e.read()
    return json.loads(body)


def run_command(env: ShellEnv, line: str) -> str:
    parts = shlex.split(line)
    if not parts:
        return ""
    name, args = parts[0], parts[1:]
    if name in ("help", "?"):
        return "\n".join(
            f"{n:28s} {h}" for n, (_, h) in sorted(COMMANDS.items())
        )
    entry = COMMANDS.get(name)
    if entry is None and name in DEFERRED:
        return (f"error: {name} is not ported yet: it comes with ROADMAP.md item "
                f"{DEFERRED[name]}")
    if entry is None:
        return f"unknown command {name!r} (try `help`)"
    # one request id per shell command: every server an `ec.rebuild`
    # or `ec.scrub` touches logs the same id (utils/request_id.py)
    from ..utils.request_id import ensure as _rid_ensure

    _rid_ensure()
    try:
        return entry[0](env, args)
    except grpc.RpcError as e:
        return f"error: {e.code().name}: {e.details()}"
    except (LookupError, LockHeldError, RuntimeError, OSError) as e:
        return f"error: {e}"


def _locate_volume(env: ShellEnv, vid: int) -> pb.Location:
    locs = env.master.lookup(vid, refresh=True)
    if not locs:
        raise LookupError(f"volume {vid} has no locations")
    return locs[0]


def _volume_stub(loc: pb.Location):
    ch = volume_channel(loc)
    return ch, rpc.volume_stub(ch)


def _volume_holders(topo):
    """{vid: [DataNodeInfo...]}, {vid: (collection, replica_placement)} —
    the shared input for replication checks/repair."""
    holders: dict[int, list] = {}
    meta: dict[int, tuple] = {}
    for n in topo.nodes:
        for v in n.volumes:
            holders.setdefault(v.id, []).append(n)
            meta[v.id] = (v.collection, v.replica_placement)
    return holders, meta




@command("cluster.status", "show nodes, volume/EC counts, chip telemetry, SLOs")
def cluster_status(env: ShellEnv, args) -> str:
    topo = env.master.topology()
    lines = [f"max volume id: {topo.max_volume_id}"]
    for n in topo.nodes:
        lines.append(
            f"  node {n.id} rack={n.rack or '-'} "
            f"volumes={len(n.volumes)} ec={len(n.ec_shards)}"
        )
    # heartbeat-learned chip telemetry + master-side SLO surface ride
    # the master's HTTP status endpoints (best-effort: a master without
    # them, or an unreachable HTTP port, degrades to the gRPC-only
    # listing above)
    try:
        st = _get_json(service_url(env.master_addr, "/cluster/status"))
        from ..ec.placement import node_view_for
        from ..ec.rebalance import volume_heat

        for node_id, tele in sorted(st.get("EcTelemetry", {}).items()):
            chips = tele.get("chips", {}) or {}
            flag = " DEGRADED" if tele.get("degraded") else ""
            if tele.get("stale"):
                flag += " STALE"
            # gravity column: the same score placement/rebalance rank
            # with (ec/placement.NodeView.gravity_score), so the
            # operator sees where bytes want to drift
            gv = node_view_for(
                node_id, "", "", 8, 0, [], ec_telemetry=tele
            )
            heat = volume_heat(tele)
            lines.append(
                f"  chips {node_id}: {len(chips)} chip(s), "
                f"breakers_open={tele.get('breakers_open', 0)} "
                f"gravity={gv.gravity_score():.2f} "
                f"age={tele.get('age_s', '-')}s "
                f"heat={sum(heat.values())}B{flag}"
            )
            for chip, c in sorted(chips.items()):
                lines.append(
                    f"    {chip} load={c.get('load', 0)} "
                    f"breaker={c.get('breaker') or '-'}"
                )
            for vid, hb in sorted(
                heat.items(), key=lambda kv: -kv[1]
            )[:5]:
                lines.append(f"    ec {vid} heat={hb}B")
        for mig in st.get("EcMigrations", [])[:5]:
            lines.append(
                f"  migration: ec {mig.get('volume_id')} "
                f"{mig.get('src')} -> {mig.get('dst')} "
                f"shards={mig.get('shards')} heat={mig.get('heat')}B "
                f"gravity {mig.get('src_gravity')} -> "
                f"{mig.get('dst_gravity')}"
            )
        slo = _get_json(service_url(env.master_addr, "/debug/slo"))
        if slo:
            lines.append("  slo (master, ms):")
            for op, s in sorted(slo.items()):
                lines.append(
                    f"    {op}: n={s['count']} p50={s['p50_ms']} "
                    f"p99={s['p99_ms']}"
                )
    except Exception as e:  # noqa: BLE001 — status must stay best-effort
        lines.append(f"  (telemetry unavailable: {e})")
    return "\n".join(lines)


@command("volume.list", "list volumes and EC shard sets per node")
def volume_list(env: ShellEnv, args) -> str:
    topo = env.master.topology()
    lines = []
    for n in topo.nodes:
        lines.append(f"node {n.id}:")
        for v in sorted(n.volumes, key=lambda v: v.id):
            lines.append(
                f"  volume {v.id} col={v.collection or '-'} size={v.size} "
                f"files={v.file_count} del={v.deleted_count} "
                f"{'RO' if v.read_only else 'RW'} rp={v.replica_placement}"
            )
        for e in sorted(n.ec_shards, key=lambda e: e.id):
            shards = [i for i in range(32) if e.shard_bits & (1 << i)]
            lines.append(
                f"  ec {e.id} col={e.collection or '-'} shards={shards} "
                f"{e.data_shards}+{e.parity_shards} gen={e.generation}"
            )
    return "\n".join(lines) or "no nodes"


@command("volume.grow", "-count N [-collection c] [-replication xyz]")
def volume_grow(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.grow")
    p.add_argument("-count", type=int, default=1)
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    a = p.parse_args(args)
    vids = env.master.grow(a.count, a.collection, a.replication)
    return f"grew volumes: {vids}"


@command("volume.vacuum", "-volumeId N [-garbageThreshold 0.3]", mutating=True)
def volume_vacuum(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.vacuum")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-garbageThreshold", type=float, default=0.0)
    a = p.parse_args(args)
    out = []
    for loc in env.master.lookup(a.volumeId, refresh=True):
        ch, stub = _volume_stub(loc)
        with ch:
            r = stub.VacuumVolume(
                pb.VacuumRequest(
                    volume_id=a.volumeId, garbage_threshold=a.garbageThreshold
                ),
                timeout=600,
            )
        out.append(f"{loc.url}: reclaimed {r.reclaimed_bytes} (ratio {r.garbage_ratio:.2f})")
    return "\n".join(out)


@command("volume.delete", "-volumeId N", mutating=True)
def volume_delete(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.delete")
    p.add_argument("-volumeId", type=int, required=True)
    a = p.parse_args(args)
    out = []
    for loc in env.master.lookup(a.volumeId, refresh=True):
        ch, stub = _volume_stub(loc)
        with ch:
            r = stub.VolumeDelete(
                pb.VolumeCommandRequest(volume_id=a.volumeId), timeout=60
            )
        out.append(f"{loc.url}: {r.error or 'deleted'}")
    return "\n".join(out)


@command("volume.mark", "-volumeId N -readonly|-writable", mutating=True)
def volume_mark(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.mark")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-readonly", action="store_true")
    p.add_argument("-writable", action="store_true")
    a = p.parse_args(args)
    out = []
    for loc in env.master.lookup(a.volumeId, refresh=True):
        ch, stub = _volume_stub(loc)
        with ch:
            req = pb.VolumeCommandRequest(volume_id=a.volumeId)
            r = (
                stub.VolumeMarkWritable(req, timeout=30)
                if a.writable
                else stub.VolumeMarkReadonly(req, timeout=30)
            )
        out.append(f"{loc.url}: {r.error or 'ok'}")
    return "\n".join(out)


# ---------------------------------------------------------------------- ec


@command(
    "ec.encode",
    "-volumeId N[,N2,...] [-collection c] [-backend cpu|cuda|auto] "
    "[-keepSource] [-maxParallelization P]",
    mutating=True,
)
def ec_encode(env: ShellEnv, args) -> str:
    """Reference doEcEncode (command_ec_encode.go:346): mark replicas
    readonly -> generate shards on one holder -> mount -> delete the
    source volume replicas (unless -keepSource). Multiple volumes encode
    concurrently (the reference's -maxParallelization batches)."""
    p = argparse.ArgumentParser(prog="ec.encode")
    p.add_argument("-volumeId", required=True, help="id or comma-separated ids")
    p.add_argument("-collection", default="")
    p.add_argument("-backend", default="cuda")
    p.add_argument("-keepSource", action="store_true")
    p.add_argument("-maxParallelization", type=int, default=4)
    a = p.parse_args(args)
    try:
        vids = [int(v) for v in a.volumeId.split(",") if v.strip()]
    except ValueError:
        return f"error: -volumeId wants an id or comma-separated ids, got {a.volumeId!r}"
    # resolve each volume's collection from the topology: EC artifact
    # paths are collection-prefixed on disk
    topo = env.master.topology()
    vol_collection = {
        v.id: v.collection for n in topo.nodes for v in n.volumes
    }

    def encode_one(vid: int) -> str:
        # one failing volume must not discard the batch's other results:
        # destructive steps (readonly-mark, source delete) already ran
        # for volumes that succeeded
        try:
            return _encode_one(vid)
        except grpc.RpcError as e:
            return f"volume {vid}: error: {e.code().name}: {e.details()}"
        except (LookupError, RuntimeError, OSError) as e:
            return f"volume {vid}: error: {e}"

    def _encode_one(vid: int) -> str:
        collection = a.collection or vol_collection.get(vid, "")
        locs = env.master.lookup(vid, refresh=True)
        if not locs:
            return f"volume {vid}: not found"
        for loc in locs:  # 1. freeze every replica
            ch, stub = _volume_stub(loc)
            with ch:
                stub.VolumeMarkReadonly(
                    pb.VolumeCommandRequest(volume_id=vid), timeout=30
                )
        gen_loc = locs[0]
        ch, stub = _volume_stub(gen_loc)
        with ch:  # 2. generate + 3. mount on the first holder
            r = stub.VolumeEcShardsGenerate(
                pb.EcShardsGenerateRequest(
                    volume_id=vid, collection=collection, backend=a.backend
                ),
                timeout=3600,
            )
            generation = r.generation
            stub.VolumeEcShardsMount(
                pb.EcShardsMountRequest(volume_id=vid, collection=collection),
                timeout=60,
            )
        if not a.keepSource:  # 4. drop source replicas
            for loc in locs:
                ch, stub = _volume_stub(loc)
                with ch:
                    stub.VolumeDelete(
                        pb.VolumeCommandRequest(volume_id=vid), timeout=60
                    )
        return (
            f"volume {vid}: generation {generation} on {gen_loc.url}"
            f"{' (source kept)' if a.keepSource else ''}"
        )

    # admin + per-volume leases come from the mutating-command wrapper
    if len(vids) == 1:
        return "ec.encode " + encode_one(vids[0])
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(a.maxParallelization, 1)) as ex:
        results = list(ex.map(encode_one, vids))
    return "ec.encode\n" + "\n".join(results)


@command("ec.check.replication", "verify every EC volume has a full shard set")
def ec_check_replication(env: ShellEnv, args) -> str:
    topo = env.master.topology()
    by_vid: dict[int, tuple[set, int]] = {}
    for n in topo.nodes:
        for e in n.ec_shards:
            sids, total = by_vid.get(e.id, (set(), 0))
            sids = sids | {i for i in range(32) if e.shard_bits & (1 << i)}
            by_vid[e.id] = (sids, e.data_shards + e.parity_shards or 14)
    lines = []
    for vid, (sids, total) in sorted(by_vid.items()):
        missing = sorted(set(range(total)) - sids)
        if missing:
            lines.append(f"ec volume {vid}: MISSING shards {missing} (run ec.rebuild)")
        else:
            lines.append(f"ec volume {vid}: all {total} shards present")
    return "\n".join(lines) or "no EC volumes"


@command("cluster.check", "cluster health summary")
def cluster_check(env: ShellEnv, args) -> str:
    topo = env.master.topology()
    stats = env.master.statistics()
    lines = [
        f"nodes: {stats.node_count}",
        f"volumes: {stats.volume_count} ({stats.file_count} files, "
        f"{stats.used_size:,} bytes)",
        f"ec volumes: {stats.ec_volume_count}",
    ]
    problems = []
    if stats.node_count == 0:
        problems.append("no volume servers registered")
    from ..server.topology import _replica_copies

    holders, meta = _volume_holders(topo)
    for vid, hs in sorted(holders.items()):
        want = _replica_copies(meta[vid][1])
        if len(hs) < want:
            problems.append(
                f"volume {vid} under-replicated: {len(hs)}/{want} copies"
            )
    lines += [f"PROBLEM: {x}" for x in problems] or ["all checks passed"]
    return "\n".join(lines)


@command(
    "ec.rebuild",
    "-volumeId N [-collection c] [-backend cpu|cuda|auto] "
    "[-fromPeers] [-holder host:grpcPort]",
    mutating=True,
)
def ec_rebuild(env: ShellEnv, args) -> str:
    """Local rebuild picks the BIGGEST holder (most local sources).
    -fromPeers drives the cluster self-healing path instead: the
    SMALLEST holder (the subset holder a local rebuild refuses on)
    streams sibling shards from peers, rebuilds on its device, and
    distributes regenerated cluster-lost shards to planned holders.
    -holder pins a specific server either way."""
    p = argparse.ArgumentParser(prog="ec.rebuild")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-backend", default="")
    p.add_argument("-fromPeers", action="store_true")
    p.add_argument("-holder", default="", help="grpc host:port to rebuild on")
    a = p.parse_args(args)
    shard_locs = env.master.lookup_ec(a.volumeId, refresh=True)
    if not shard_locs:
        return f"ec volume {a.volumeId} not found"
    by_url, loc_by_url = fleet.holder_maps(shard_locs)
    if a.holder:
        url = next(
            (
                u
                for u, loc in loc_by_url.items()
                if a.holder in (u, fleet.grpc_addr(loc))
            ),
            "",
        )
        if not url:
            return f"no holder {a.holder!r} for ec volume {a.volumeId}"
    else:
        url = fleet.pick_rebuild_holder(by_url, smallest=a.fromPeers)
    ch, stub = _volume_stub(loc_by_url[url])
    with ch:
        r = stub.VolumeEcShardsRebuild(
            pb.EcShardsRebuildRequest(
                volume_id=a.volumeId,
                collection=a.collection,
                backend=a.backend,
                from_peers=a.fromPeers,
            ),
            timeout=3600,
            metadata=trace.grpc_metadata(),
        )
        if not a.fromPeers:
            # the peer-fetch path mounts exactly what it owns/adopts;
            # a blanket mount would also advertise unmounted handoff
            # copies kept after a failed distribute
            stub.VolumeEcShardsMount(
                pb.EcShardsMountRequest(
                    volume_id=a.volumeId, collection=a.collection
                ),
                timeout=60,
                metadata=trace.grpc_metadata(),
            )
    extra = ""
    if a.fromPeers:
        extra = (
            f" (fetched {list(r.fetched_shard_ids)} from peers, "
            f"distributed {list(r.distributed_shard_ids)})"
        )
    if r.repaired_shard_ids:
        # rot was leaf-localized: patched in place under the repair
        # journal instead of a whole-shard rebuild
        extra += f", leaf-repaired {list(r.repaired_shard_ids)} in place"
    return f"rebuilt shards {list(r.rebuilt_shard_ids)} on {url}{extra}"


@command("ec.decode", "-volumeId N [-collection c]", mutating=True)
def ec_decode(env: ShellEnv, args) -> str:
    """Collect all shards onto the node already holding the most, decode
    there, then clean the EC artifacts off every node (reference
    command_ec_decode.go: collectEcShards -> VolumeEcShardsToVolume ->
    delete shards)."""
    p = argparse.ArgumentParser(prog="ec.decode")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    a = p.parse_args(args)
    shard_locs = env.master.lookup_ec(a.volumeId, refresh=True)
    if not shard_locs:
        return f"ec volume {a.volumeId} not found"
    by_url: dict[str, set[int]] = {}
    loc_by_url = {}
    for sid, locs in shard_locs.items():
        for loc in locs:
            by_url.setdefault(loc.url, set()).add(sid)
            loc_by_url[loc.url] = loc
    target_url = max(by_url, key=lambda u: len(by_url[u]))
    target = loc_by_url[target_url]
    have = by_url[target_url]

    ch, stub = _volume_stub(target)
    with ch:
        copied_index = False
        for sid in sorted(shard_locs):
            if sid in have:
                continue
            src = next(
                l for l in shard_locs[sid] if l.url != target_url
            )
            stub.VolumeEcShardsCopy(
                pb.EcShardsCopyRequest(
                    volume_id=a.volumeId,
                    collection=a.collection,
                    shard_ids=[sid],
                    source_url=f"{src.url.split(':')[0]}:{src.grpc_port}",
                    copy_ecx=not copied_index and not have,
                    copy_ecj=not copied_index and not have,
                    copy_vif=not copied_index and not have,
                    copy_ecsum=not copied_index and not have,
                ),
                timeout=3600,
            )
            copied_index = True
        stub.VolumeEcShardsToVolume(
            pb.EcShardsToVolumeRequest(
                volume_id=a.volumeId, collection=a.collection
            ),
            timeout=3600,
        )
    # clean EC artifacts off the other nodes
    all_sids = sorted(shard_locs)
    for url, sids in by_url.items():
        if url == target_url:
            continue
        ch, stub = _volume_stub(loc_by_url[url])
        with ch:
            stub.VolumeEcShardsUnmount(
                pb.EcShardsUnmountRequest(volume_id=a.volumeId, shard_ids=all_sids),
                timeout=60,
            )
            stub.VolumeEcShardsDelete(
                pb.EcShardsDeleteRequest(
                    volume_id=a.volumeId,
                    collection=a.collection,
                    shard_ids=all_sids,
                ),
                timeout=60,
            )
    return f"decoded ec volume {a.volumeId} back to a normal volume on {target_url}"


@command(
    "volume.sync",
    "-volumeId N -target host:grpcPort [-source host:grpcPort] "
    "(incremental replica catch-up via VolumeTailReceiver)",
    mutating=True,
)
def volume_sync(env: ShellEnv, args) -> str:
    """Needle-granular catch-up: the TARGET replica pulls every record
    appended at the source since the target's own last appendAtNs
    (reference volume_grpc_tail.go VolumeTailReceiver + weed backup's
    incremental model). A replica that missed writes while down
    converges without a full re-copy."""
    p = argparse.ArgumentParser(prog="volume.sync")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-target", required=True, help="replica to heal (grpc)")
    p.add_argument("-source", default="", help="replica to pull from (grpc)")
    p.add_argument("-sinceNs", type=int, default=0)
    p.add_argument("-idleTimeout", type=int, default=3)
    a = p.parse_args(args)
    locs = env.master.lookup(a.volumeId, refresh=True)
    if not locs:
        return f"volume {a.volumeId} not found"
    import socket as _socket

    def _resolved(addr: str) -> tuple[str, str]:
        host, _, port = addr.partition(":")
        try:
            return _socket.gethostbyname(host), port
        except OSError:
            return host, port

    src_grpc = a.source
    if not src_grpc:
        # resolve hostnames before comparing: 'localhost' vs
        # '127.0.0.1' must not make the target pull from itself
        for loc in locs:
            cand = f"{loc.url.split(':')[0]}:{loc.grpc_port}"
            if _resolved(cand) != _resolved(a.target):
                src_grpc = cand
                break
        if not src_grpc:
            return f"volume {a.volumeId} has no replica besides the target"
    from ..client.volume_sync import sync_replica

    try:
        n = sync_replica(
            a.target, src_grpc, a.volumeId,
            since_ns=a.sinceNs, idle_timeout_s=a.idleTimeout,
        )
    except (RuntimeError, grpc.RpcError) as e:
        detail = e.details() if isinstance(e, grpc.RpcError) else str(e)
        return f"error: {detail}"
    return (
        f"synced volume {a.volumeId}: {n} records applied "
        f"{src_grpc} -> {a.target}"
    )


@command("volume.move", "-volumeId N -target host:grpcPort (move one volume)", mutating=True)
def volume_move(env: ShellEnv, args) -> str:
    """Copy to target, load there, delete at source (reference
    volume.move: mark-readonly -> copy -> mount -> delete)."""
    p = argparse.ArgumentParser(prog="volume.move")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-target", required=True, help="grpc address host:port")
    p.add_argument(
        "-source",
        default="",
        help="grpc address of the REPLICA to move (default: first found)",
    )
    p.add_argument("-collection", default="")
    a = p.parse_args(args)
    locs = env.master.lookup(a.volumeId, refresh=True)
    if not locs:
        return f"volume {a.volumeId} not found"
    src = locs[0]
    if a.source:
        # replicated volumes: the caller (e.g. volume.balance) names
        # WHICH replica moves; defaulting to locs[0] would drain the
        # wrong node and never converge
        for loc in locs:
            if f"{loc.url.split(':')[0]}:{loc.grpc_port}" == a.source:
                src = loc
                break
        else:
            return f"volume {a.volumeId} has no replica at {a.source}"
    src_grpc = f"{src.url.split(':')[0]}:{src.grpc_port}"
    if src_grpc == a.target:
        return "volume already on target"
    ch, stub = _volume_stub(src)
    with ch:
        stub.VolumeMarkReadonly(
            pb.VolumeCommandRequest(volume_id=a.volumeId), timeout=30
        )
    try:
        with grpc.insecure_channel(a.target) as ch2:
            r = rpc.Stub(ch2, rpc.VOLUME_SERVICE).VolumeCopy(
                pb.EcShardsCopyRequest(
                    volume_id=a.volumeId,
                    collection=a.collection,
                    source_url=src_grpc,
                ),
                timeout=3600,
            )
        if r.error:
            raise RuntimeError(f"copy failed: {r.error}")
    except (grpc.RpcError, RuntimeError) as e:
        # failed move must not strand the source readonly
        ch, stub = _volume_stub(src)
        with ch:
            stub.VolumeMarkWritable(
                pb.VolumeCommandRequest(volume_id=a.volumeId), timeout=30
            )
        detail = e.details() if isinstance(e, grpc.RpcError) else str(e)
        return f"error: {detail} (source volume restored writable)"
    ch, stub = _volume_stub(src)
    with ch:
        stub.VolumeDelete(pb.VolumeCommandRequest(volume_id=a.volumeId), timeout=60)
    return f"moved volume {a.volumeId} {src.url} -> {a.target}"


@command(
    "volume.tier.upload",
    "-volumeId N -dest http://host/bucket/key (move sealed .dat to cold tier)",
    mutating=True,
)
def volume_tier_upload(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.tier.upload")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-dest", required=True, help="S3-style object URL")
    p.add_argument("-keepLocal", action="store_true")
    a = p.parse_args(args)
    loc = _locate_volume(env, a.volumeId)
    ch, stub = _volume_stub(loc)
    with ch:
        stub.VolumeMarkReadonly(
            pb.VolumeCommandRequest(volume_id=a.volumeId), timeout=30
        )
        r = stub.VolumeTierUpload(
            pb.TierRequest(
                volume_id=a.volumeId,
                dest_url=a.dest,
                keep_local=a.keepLocal,
            ),
            timeout=3600,
        )
    if r.error:
        return f"error: {r.error}"
    return (
        f"volume {a.volumeId}: {r.moved_bytes:,} bytes -> {a.dest}"
        f"{' (local copy kept)' if a.keepLocal else ''}"
    )


@command(
    "volume.tier.download",
    "-volumeId N [-deleteRemote] (bring cold .dat back to local disk)",
    mutating=True,
)
def volume_tier_download(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.tier.download")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-deleteRemote", action="store_true")
    a = p.parse_args(args)
    loc = _locate_volume(env, a.volumeId)
    ch, stub = _volume_stub(loc)
    with ch:
        r = stub.VolumeTierDownload(
            pb.TierRequest(
                volume_id=a.volumeId, delete_remote=a.deleteRemote
            ),
            timeout=3600,
        )
    if r.error:
        return f"error: {r.error}"
    return f"volume {a.volumeId}: {r.moved_bytes:,} bytes fetched from cold tier"


@command("volume.fix.replication", "re-replicate under-replicated volumes", mutating=True)
def volume_fix_replication(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.fix.replication")
    p.add_argument("-collection", default="")
    a = p.parse_args(args)
    topo = env.master.topology()
    holders, meta = _volume_holders(topo)
    from ..server.topology import _replica_copies

    fixed = []
    for vid, hs in sorted(holders.items()):
        col, rp = meta[vid]
        want = _replica_copies(rp)
        if len(hs) >= want:
            continue
        candidates = [
            n for n in topo.nodes if all(h.id != n.id for h in hs)
        ]
        src = hs[0]
        src_grpc = f"{src.location.url.split(':')[0]}:{src.location.grpc_port}"
        # freeze writes while the copy streams, restore after — a live
        # append between the .dat and .idx copies would tear the replica
        with volume_lease(env, vid):
            src_ch, src_stub = _volume_stub(src.location)
            with src_ch:
                src_stub.VolumeMarkReadonly(
                    pb.VolumeCommandRequest(volume_id=vid), timeout=30
                )
                try:
                    for n in candidates[: want - len(hs)]:
                        with grpc.insecure_channel(
                            f"{n.location.url.split(':')[0]}:{n.location.grpc_port}"
                        ) as ch:
                            r = rpc.Stub(ch, rpc.VOLUME_SERVICE).VolumeCopy(
                                pb.EcShardsCopyRequest(
                                    volume_id=vid, collection=col, source_url=src_grpc
                                ),
                                timeout=3600,
                            )
                        if not r.error:
                            fixed.append(f"volume {vid} -> {n.id}")
                finally:
                    src_stub.VolumeMarkWritable(
                        pb.VolumeCommandRequest(volume_id=vid), timeout=30
                    )
    return "\n".join(fixed) or "all volumes sufficiently replicated"


@command(
    "ec.balance",
    "spread EC shards evenly across racks and nodes "
    "[-dataGravity drifts shards toward chip-rich low-load hosts]",
    mutating=True,
)
def ec_balance(env: ShellEnv, args) -> str:
    """Rack-aware balance (reference command_ec_common.go:60 EcBalance):
    dedupe shard copies, spread each volume across racks, even within
    racks, then flatten per-rack totals — planned by ec/placement.py,
    executed here as copy+mount / unmount+delete pairs. `-dataGravity`
    appends the gravity stage: bounded moves from chip-poor/loaded
    nodes toward chip-rich low-load ones (heartbeat telemetry), never
    violating the spread/slot invariants."""
    from ..ec.placement import node_view_for, plan_ec_balance

    p = argparse.ArgumentParser(prog="ec.balance")
    p.add_argument("-collection", default="")
    p.add_argument("-dryRun", action="store_true")
    p.add_argument("-dataGravity", action="store_true")
    p.add_argument("-maxGravityMoves", type=int, default=4)
    a = p.parse_args(args)
    topo = env.master.topology()
    nodes = {n.id: n for n in topo.nodes}
    if len(nodes) < 2:
        return "nothing to balance (fewer than 2 nodes)"
    # gravity needs the heartbeat telemetry, which rides the master's
    # HTTP status plane (best-effort: absent telemetry = static plan)
    tele: dict = {}
    if a.dataGravity:
        try:
            tele = _get_json(
                service_url(env.master_addr, "/cluster/status")
            ).get("EcTelemetry", {}) or {}
        except Exception:  # noqa: BLE001 — gravity degrades to static
            tele = {}
    vol_collection: dict[int, str] = {}
    views = []
    for n in topo.nodes:
        for e in n.ec_shards:
            if not a.collection or e.collection == a.collection:
                vol_collection[e.id] = e.collection
        views.append(
            node_view_for(
                n.id,
                n.rack,
                n.data_center,
                n.max_volume_count,
                len(n.volumes),
                n.ec_shards,
                a.collection,
                ec_telemetry=tele.get(n.id),
            )
        )
    drops, moves = plan_ec_balance(
        views, data_gravity=a.dataGravity,
        max_gravity_moves=a.maxGravityMoves,
    )
    if a.dryRun:
        return "\n".join(
            [f"drop ec {d.vid}.{d.shard_id:02d} on {d.node}" for d in drops]
            + [
                f"move ec {m.vid}.{m.shard_id:02d}: {m.src} -> {m.dst} ({m.reason})"
                for m in moves
            ]
        ) or "already balanced"

    def _grpc_addr(nid: str) -> str:
        n = nodes[nid]
        return f"{n.location.url.split(':')[0]}:{n.location.grpc_port}"

    out = []
    for d in drops:
        with volume_lease(env, d.vid):
            with grpc.insecure_channel(_grpc_addr(d.node)) as ch:
                stub = rpc.Stub(ch, rpc.VOLUME_SERVICE)
                stub.VolumeEcShardsUnmount(
                    pb.EcShardsUnmountRequest(
                        volume_id=d.vid, shard_ids=[d.shard_id]
                    ),
                    timeout=60,
                )
                stub.VolumeEcShardsDelete(
                    pb.EcShardsDeleteRequest(
                        volume_id=d.vid,
                        collection=vol_collection.get(d.vid, ""),
                        shard_ids=[d.shard_id],
                    ),
                    timeout=60,
                )
        out.append(f"dedupe ec {d.vid}.{d.shard_id:02d} on {d.node}")
    # live per-(node, vid) shard counts: drops and move-sources remove
    # entries (a node whose last shard left also lost its .ecx — the
    # next copy TO it must bring the index files again)
    shard_count: dict[tuple[str, int], int] = {}
    for n in topo.nodes:
        for e in n.ec_shards:
            shard_count[(n.id, e.id)] = bin(e.shard_bits).count("1")
    for d in drops:
        k = (d.node, d.vid)
        shard_count[k] = max(shard_count.get(k, 1) - 1, 0)
    for m in moves:
        col = vol_collection.get(m.vid, "")
        first_on_dst = shard_count.get((m.dst, m.vid), 0) == 0
        with volume_lease(env, m.vid):
            with grpc.insecure_channel(_grpc_addr(m.dst)) as ch:
                stub = rpc.Stub(ch, rpc.VOLUME_SERVICE)
                stub.VolumeEcShardsCopy(
                    pb.EcShardsCopyRequest(
                        volume_id=m.vid,
                        collection=col,
                        shard_ids=[m.shard_id],
                        source_url=_grpc_addr(m.src),
                        copy_ecx=first_on_dst,
                        copy_ecj=first_on_dst,
                        copy_vif=first_on_dst,
                        copy_ecsum=first_on_dst,
                    ),
                    timeout=3600,
                )
                stub.VolumeEcShardsMount(
                    pb.EcShardsMountRequest(volume_id=m.vid, collection=col),
                    timeout=60,
                )
            with grpc.insecure_channel(_grpc_addr(m.src)) as ch:
                stub = rpc.Stub(ch, rpc.VOLUME_SERVICE)
                stub.VolumeEcShardsUnmount(
                    pb.EcShardsUnmountRequest(
                        volume_id=m.vid, shard_ids=[m.shard_id]
                    ),
                    timeout=60,
                )
                stub.VolumeEcShardsDelete(
                    pb.EcShardsDeleteRequest(
                        volume_id=m.vid, collection=col, shard_ids=[m.shard_id]
                    ),
                    timeout=60,
                )
        shard_count[(m.dst, m.vid)] = shard_count.get((m.dst, m.vid), 0) + 1
        ks = (m.src, m.vid)
        shard_count[ks] = max(shard_count.get(ks, 1) - 1, 0)
        out.append(
            f"ec {m.vid}.{m.shard_id:02d}: {m.src} -> {m.dst} ({m.reason})"
        )
    return "\n".join(out) or "already balanced"


@command("volume.scrub", "-volumeId N (CRC-verify all live needles)")
def volume_scrub(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.scrub")
    p.add_argument("-volumeId", type=int, required=True)
    a = p.parse_args(args)
    locs = env.master.lookup(a.volumeId, refresh=True)
    if not locs:
        return f"volume {a.volumeId} not found"
    out = []
    for loc in locs:
        ch, stub = _volume_stub(loc)
        with ch:
            r = stub.ScrubVolume(
                pb.ScrubRequest(volume_id=a.volumeId), timeout=3600,
                metadata=trace.grpc_metadata(),
            )
        if r.error:
            out.append(f"{loc.url}: error: {r.error}")
        else:
            bad = list(r.bad_needles)
            out.append(
                f"{loc.url}: checked {r.checked} needles"
                + (f", CORRUPT: {[hex(b) for b in bad]}" if bad else ", all clean")
            )
    return "\n".join(out)


@command(
    "ec.scrub",
    "-volumeId N [-collection c] [-repair] (verify shards vs .ecsum; "
    "-repair rebuilds corrupt/missing shards on the holder)",
)
def ec_scrub(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="ec.scrub")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-repair", action="store_true")
    a = p.parse_args(args)
    shard_locs = env.master.lookup_ec(a.volumeId, refresh=True)
    if not shard_locs:
        return f"ec volume {a.volumeId} not found"
    # k from the topology: a holder with fewer than k verified-good
    # local shards cannot rebuild locally; skip the doomed RPC and point
    # at ec.rebuild (which picks the biggest holder) instead
    data_shards = 0
    for n in env.master.topology().nodes:
        for e in n.ec_shards:
            if e.id == a.volumeId:
                data_shards = e.data_shards
    if not data_shards:
        # topology gap (heartbeat lag): fall back to the default ratio
        # so the guard stays conservative rather than vanishing
        from ..ec.context import DATA_SHARDS

        data_shards = DATA_SHARDS
    holder_sids, loc_by_url = fleet.holder_maps(shard_locs)
    out = []
    fleet_checked = fleet_bad = fleet_missing = fleet_quar = 0
    unrebuildable: list[str] = []
    for url, loc in sorted(loc_by_url.items()):
        ch, stub = _volume_stub(loc)
        with ch:
            r = stub.ScrubEcVolume(
                pb.ScrubRequest(volume_id=a.volumeId, collection=a.collection),
                timeout=3600,
                metadata=trace.grpc_metadata(),
            )
            if r.error:
                out.append(f"{url}: error: {r.error}")
                continue
            # the same per-holder verdict kernel the fleet worker uses
            # (ec/fleet.py): real per-sid missing set difference, with
            # the count-comparison degrade for pre-checked_shards
            # servers, and the < k verified-good unrebuildable call
            facts = fleet.holder_scrub_facts(
                r, holder_sids.get(url, set()), data_shards
            )
            bad = facts["bad"]
            gone = bool(facts["missing"] or facts["legacy_gone"])
            if facts["legacy_gone"]:
                gone_note = (
                    f" ({facts['legacy_gone']} advertised "
                    f"shard files MISSING)"
                )
            else:
                gone_note = (
                    f" (advertised shards {facts['missing']} "
                    f"MISSING locally)"
                )
            quarantined = facts["quarantined"]
            out.append(
                f"{url}: checked {r.checked} shards"
                + (f", BITROT in shards {bad}" if bad else ", all clean")
                + (gone_note if gone else "")
                + (
                    f" (quarantined: {quarantined})" if quarantined else ""
                )
                + (
                    f" ({r.repair_journal_recovered} repair journal(s) "
                    f"recovered)"
                    if r.repair_journal_recovered
                    else ""
                )
            )
            fleet_checked += r.checked
            fleet_bad += len(bad)
            fleet_quar += len(quarantined)
            # legacy holders report losses only as a count — still real
            # shard loss, still in the roll-up the operator alerts on
            fleet_missing += len(facts["missing"]) + facts["legacy_gone"]
            if facts["unrebuildable"]:
                unrebuildable.append(url)
            # gate on the kernel's `hurt` verdict, exactly like the
            # fleet worker: a quarantine-only holder (rot pulled from
            # service, canonical file gone) is repairable too
            if not facts["hurt"] or not a.repair:
                continue
            if facts["good"] < data_shards:
                out.append(
                    f"{url}: repair skipped: {facts['good']} "
                    f"verified-good local shards < {data_shards} needed; "
                    f"use `ec.rebuild -fromPeers` to stream sibling "
                    f"shards from peer holders"
                )
                continue
            # rebuild_ec_files' verify-and-exclude reclassifies the
            # corrupt shards as missing and regenerates them (and any
            # locally-lost mounted shards) from the verified-good
            # remainder (fail-closed on its own)
            try:
                rr = stub.VolumeEcShardsRebuild(
                    pb.EcShardsRebuildRequest(
                        volume_id=a.volumeId, collection=a.collection
                    ),
                    timeout=3600,
                    metadata=trace.grpc_metadata(),
                )
                out.append(
                    f"{url}: rebuilt shards {sorted(rr.rebuilt_shard_ids)}"
                )
            except grpc.RpcError as e:
                out.append(f"{url}: rebuild REFUSED: {e.details()}")
    # fleet roll-up: the one line an operator (or the master's fleet
    # scrub aggregation) alerts on
    out.append(
        f"fleet: {len(loc_by_url)} holders, {fleet_checked} shards checked, "
        f"{fleet_bad} bitrot, {fleet_missing} missing, "
        f"{fleet_quar} quarantined"
        + (
            f"; unrebuildable holders {unrebuildable} -> "
            f"ec.rebuild -fromPeers"
            if unrebuildable
            else ""
        )
    )
    return "\n".join(out)


@command("collection.list", "list collections")
def collection_list(env: ShellEnv, args) -> str:
    return "\n".join(env.master.collections()) or "(none)"


@command("collection.delete", "-collection name (drop all its volumes)", mutating=True)
def collection_delete(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="collection.delete")
    p.add_argument("-collection", required=True)
    a = p.parse_args(args)
    # lease every volume of the collection first so a worker task
    # (ec_encode/vacuum) can't be mid-flight on one while it vanishes
    topo = env.master.topology()
    vids = sorted(
        {
            v.id
            for n in topo.nodes
            for v in n.volumes
            if v.collection == a.collection
        }
        | {
            e.id
            for n in topo.nodes
            for e in n.ec_shards
            if e.collection == a.collection
        }
    )
    with contextlib.ExitStack() as stack:
        for vid in vids:
            stack.enter_context(volume_lease(env, vid))
        deleted = env.master.collection_delete(a.collection)
    return f"deleted collection {a.collection!r}: volumes {deleted}"


@command("volume.check.disk", "compare replicas of each volume and report divergence")
def volume_check_disk(env: ShellEnv, args) -> str:
    """Cross-replica consistency check (reference volume.check.disk):
    flags replicas whose file counts / sizes disagree."""
    topo = env.master.topology()
    holders: dict[int, list] = {}
    for n in topo.nodes:
        for v in n.volumes:
            holders.setdefault(v.id, []).append((n.id, v))
    lines = []
    for vid, hs in sorted(holders.items()):
        if len(hs) < 2:
            continue
        sizes = {h[1].size for h in hs}
        counts = {h[1].file_count for h in hs}
        dels = {h[1].deleted_count for h in hs}
        if len(sizes) > 1 or len(counts) > 1 or len(dels) > 1:
            detail = "; ".join(
                f"{nid}: size={v.size} files={v.file_count} del={v.deleted_count}"
                for nid, v in hs
            )
            lines.append(f"volume {vid} DIVERGED: {detail}")
        else:
            lines.append(f"volume {vid}: {len(hs)} replicas consistent")
    return "\n".join(lines) or "no replicated volumes"


# ------------------------------------------------------------------- blobs


@command("upload", "upload a local file; prints fid")
def upload(env: ShellEnv, args) -> str:
    from ..client.operations import Operations

    p = argparse.ArgumentParser(prog="upload")
    p.add_argument("path")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    a = p.parse_args(args)
    ops = Operations(env.master_addr)
    try:
        with open(a.path, "rb") as f:
            fid = ops.upload(
                f.read(), name=a.path, collection=a.collection,
                replication=a.replication,
            )
        return fid
    finally:
        ops.close()


@command("download", "download -fid <fid> -o <path>")
def download(env: ShellEnv, args) -> str:
    from ..client.operations import Operations

    p = argparse.ArgumentParser(prog="download")
    p.add_argument("-fid", required=True)
    p.add_argument("-o", required=True)
    a = p.parse_args(args)
    ops = Operations(env.master_addr)
    try:
        data = ops.read(a.fid)
        with open(a.o, "wb") as f:
            f.write(data)
        return f"{len(data)} bytes -> {a.o}"
    finally:
        ops.close()


# -------------------------------------------------------------------- lock


@command("lock", "hold the exclusive cluster admin lease for this session")
def lock_cmd(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="lock")
    p.add_argument("-ttl", type=float, default=600.0)
    a = p.parse_args(args)
    env.admin_token = env.master.lock(
        "admin", env.owner, ttl=a.ttl, token=env.admin_token, wait=5.0
    )
    return f"locked as {env.owner} (ttl {a.ttl:.0f}s; renew with `lock`)"


@command("unlock", "release this session's cluster admin lease")
def unlock_cmd(env: ShellEnv, args) -> str:
    if not env.admin_token:
        return "not holding the admin lease"
    ok = env.master.unlock("admin", env.admin_token)
    env.admin_token = ""
    return "unlocked" if ok else "lease already expired"


@command("lock.status", "show live cluster leases")
def lock_status_cmd(env: ShellEnv, args) -> str:
    rows = env.master.lock_status()
    if not rows:
        return "no live leases"
    return "\n".join(
        f"{name:24s} {owner:24s} {remaining:6.1f}s left"
        for name, owner, remaining in rows
    )


# ------------------------------------------------------------ volume.balance


def _balance_plan(topo, collection: str):
    """Greedy per-disk-type move plan toward equal fullness ratios
    (reference command_volume_balance.go balanceVolumeServers: ratio =
    volumes / max_volume_count per disk type; move from the fullest
    node to the emptiest while the spread shrinks)."""
    nodes = list(topo.nodes)
    disk_types = sorted(
        {(v.disk_type or "hdd") for n in nodes for v in n.volumes} or {"hdd"}
    )
    plan: list[tuple[int, str, object, object]] = []  # vid, col, src, dst
    for dt in disk_types:
        entries = []
        for n in nodes:
            vols = {
                v.id: v
                for v in n.volumes
                if (v.disk_type or "hdd") == dt
                and (not collection or v.collection == collection)
            }
            entries.append(
                {
                    "node": n,
                    "vols": vols,
                    # replica safety: a volume must never move to a node
                    # already holding ANY copy of it (regardless of
                    # collection filter / disk type)
                    "all_vids": {v.id for v in n.volumes},
                    "cap": max(int(n.max_volume_count) or 8, 1),
                }
            )
        if len(entries) < 2:
            continue
        while True:
            entries.sort(key=lambda e: len(e["vols"]) / e["cap"])
            lo, hi = entries[0], entries[-1]
            # does moving one volume from hi to lo reduce the spread?
            if (len(hi["vols"]) - 1) / hi["cap"] < (len(lo["vols"]) + 1) / lo[
                "cap"
            ] - 1e-9:
                break
            cand = next(
                (
                    v
                    for v in hi["vols"].values()
                    if v.id not in lo["all_vids"] and not v.read_only
                ),
                None,
            )
            if cand is None:
                break
            plan.append((cand.id, cand.collection, hi["node"], lo["node"]))
            del hi["vols"][cand.id]
            hi["all_vids"].discard(cand.id)
            lo["vols"][cand.id] = cand
            lo["all_vids"].add(cand.id)
    return plan


@command(
    "volume.balance",
    "[-collection c] [-apply] (plan/execute moves toward equal fullness per disk type)",
    mutating=True,
)
def volume_balance(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.balance")
    p.add_argument("-collection", default="")
    p.add_argument("-apply", action="store_true")
    a = p.parse_args(args)
    topo = env.master.topology()
    plan = _balance_plan(topo, a.collection)
    if not plan:
        return "already balanced"
    lines = [
        f"move volume {vid} ({col or 'default'}): {src.id} -> {dst.id}"
        for vid, col, src, dst in plan
    ]
    if not a.apply:
        return "\n".join(lines) + f"\n{len(plan)} move(s) planned (use -apply)"
    done = []
    for (vid, col, src, dst), line in zip(plan, lines):
        dst_grpc = f"{dst.location.url.split(':')[0]}:{dst.location.grpc_port}"
        src_grpc = f"{src.location.url.split(':')[0]}:{src.location.grpc_port}"
        cmd = (
            f"volume.move -volumeId {vid} -target {dst_grpc}"
            f" -source {src_grpc}"
        )
        if col:
            cmd += f" -collection {col}"
        out = run_command(env, cmd)
        done.append(f"{line}: {out}")
        # success is ONLY the "moved ..." confirmation; other statuses
        # ("volume N not found", "has no replica at") mean the plan is
        # stale — stop rather than keep applying against it
        if not out.startswith("moved"):
            done.append("error: stopping after failed move")
            break
    return "\n".join(done)


# ------------------------------------------------------------ raft cluster


def _raft_stub(env: ShellEnv, master: str | None = None):
    addr = master or env.master_addr
    host, _, port = addr.partition(":")
    ch = grpc.insecure_channel(f"{host}:{int(port or 9333) + 10000}")
    return ch, rpc.Stub(ch, rpc.RAFT_SERVICE)


@command("cluster.raft.ps", "raft membership + roles of every master")
def cluster_raft_ps(env: ShellEnv, args) -> str:
    ch, stub = _raft_stub(env)
    with ch:
        st = stub.RaftStatus(pb.RaftStatusRequest(), timeout=10)
    rows = [
        f"node {st.node_id}: {st.role} term={st.term} "
        f"commit={st.commit_index} applied={st.applied_index}"
    ]
    rows.append(f"leader: {st.leader or '?'}")
    rows.append(
        "members: " + ", ".join(sorted({st.node_id, *st.peers}))
    )
    return "\n".join(rows)


def _raft_change(env: ShellEnv, op: str, server: str) -> str:
    """Route the change to the LEADER (retrying once on redirect)."""
    target = None
    for _ in range(3):
        ch, stub = _raft_stub(env, target)
        with ch:
            r = stub.RaftChangeMembership(
                pb.RaftChangeRequest(op=op, server=server), timeout=15
            )
        if r.error == "not the leader" and r.leader:
            target = r.leader
            continue
        if r.error:
            return f"error: {r.error}"
        return f"members now: {', '.join(r.members)}"
    return "error: could not find the raft leader"


@command(
    "cluster.raft.add",
    "-server host:port (grow the master raft group by one)",
    mutating=True,
)
def cluster_raft_add(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="cluster.raft.add")
    p.add_argument("-server", required=True)
    a = p.parse_args(args)
    return _raft_change(env, "add", a.server)


@command(
    "cluster.raft.remove",
    "-server host:port (shrink the master raft group by one)",
    mutating=True,
)
def cluster_raft_remove(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="cluster.raft.remove")
    p.add_argument("-server", required=True)
    a = p.parse_args(args)
    return _raft_change(env, "remove", a.server)


@command(
    "volume.deleteEmpty",
    "[-collection c] [-force] (drop volumes holding zero live files)",
    mutating=True,
)
def volume_delete_empty(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.deleteEmpty")
    p.add_argument("-collection", default="")
    p.add_argument("-force", action="store_true")
    a = p.parse_args(args)
    topo = env.master.topology()
    plan: list[tuple[int, object]] = []
    for n in topo.nodes:
        for v in n.volumes:
            if v.file_count == 0 and (
                not a.collection or v.collection == a.collection
            ):
                plan.append((v.id, n))
    if not plan:
        return "no empty volumes"
    if not a.force:
        return "\n".join(
            f"would delete empty volume {vid} on {n.id}" for vid, n in plan
        ) + f"\n{len(plan)} deletion(s) planned (use -force)"
    done = []
    for vid, n in plan:
        with volume_lease(env, vid):
            ch, stub = _volume_stub(n.location)
            with ch:
                # freeze writes, then RE-CHECK emptiness on the live
                # volume server (the planning snapshot is heartbeat-
                # stale; a write landing in between must not be
                # destroyed — reference guards this the same way)
                stub.VolumeMarkReadonly(
                    pb.VolumeCommandRequest(volume_id=vid), timeout=30
                )
                st = stub.VolumeServerStatus(
                    pb.VolumeServerStatusRequest(), timeout=30
                )
                live = next(
                    (v for v in st.volumes if v.id == vid), None
                )
                if live is None or live.file_count > 0:
                    stub.VolumeMarkWritable(
                        pb.VolumeCommandRequest(volume_id=vid), timeout=30
                    )
                    done.append(
                        f"skipped volume {vid} on {n.id}: no longer empty"
                    )
                    continue
                stub.VolumeDelete(
                    pb.VolumeCommandRequest(volume_id=vid), timeout=60
                )
        done.append(f"deleted empty volume {vid} on {n.id}")
    return "\n".join(done)


@command(
    "volume.copy",
    "-volumeId N -target host:grpcPort [-source host:grpcPort] "
    "(copy a volume; source keeps its replica)",
    mutating=True,
)
def volume_copy(env: ShellEnv, args) -> str:
    """Reference volume.copy: pull .dat/.idx/.vif onto the target and
    mount there; unlike volume.move the source keeps serving."""
    p = argparse.ArgumentParser(prog="volume.copy")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-target", required=True)
    p.add_argument("-source", default="")
    p.add_argument("-collection", default="")
    a = p.parse_args(args)
    src_grpc = a.source
    if not src_grpc:
        loc = _locate_volume(env, a.volumeId)
        src_grpc = f"{loc.url.split(':')[0]}:{loc.grpc_port}"
    with grpc.insecure_channel(a.target) as ch:
        r = rpc.Stub(ch, rpc.VOLUME_SERVICE).VolumeCopy(
            pb.EcShardsCopyRequest(
                volume_id=a.volumeId,
                collection=a.collection,
                source_url=src_grpc,
            ),
            timeout=3600,
        )
    if r.error:
        return f"error: {r.error}"
    return f"copied volume {a.volumeId} {src_grpc} -> {a.target}"


@command(
    "volume.mount",
    "-volumeId N -node host:grpcPort [-collection c] (load volume files)",
    mutating=True,
)
def volume_mount(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.mount")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-node", required=True)
    p.add_argument("-collection", default="")
    a = p.parse_args(args)
    with grpc.insecure_channel(a.node) as ch:
        r = rpc.Stub(ch, rpc.VOLUME_SERVICE).VolumeMount(
            pb.AllocateVolumeRequest(
                volume_id=a.volumeId, collection=a.collection
            ),
            timeout=60,
        )
    return f"error: {r.error}" if r.error else f"mounted volume {a.volumeId} on {a.node}"


@command(
    "volume.unmount",
    "-volumeId N -node host:grpcPort (release a volume, keep its files)",
    mutating=True,
)
def volume_unmount(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.unmount")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-node", required=True)
    a = p.parse_args(args)
    with grpc.insecure_channel(a.node) as ch:
        r = rpc.Stub(ch, rpc.VOLUME_SERVICE).VolumeUnmount(
            pb.VolumeCommandRequest(volume_id=a.volumeId), timeout=60
        )
    return f"error: {r.error}" if r.error else f"unmounted volume {a.volumeId} on {a.node}"


@command(
    "volume.configure.replication",
    "-volumeId N -replication xyz (rewrite replica placement in place)",
    mutating=True,
)
def volume_configure_replication(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="volume.configure.replication")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-replication", required=True)
    a = p.parse_args(args)
    locs = env.master.lookup(a.volumeId, refresh=True)
    if not locs:
        return f"volume {a.volumeId} not found"
    changed = []
    for loc in locs:
        ch, stub = _volume_stub(loc)
        with ch:
            r = stub.VolumeConfigure(
                pb.VolumeConfigureRequest(
                    volume_id=a.volumeId, replication=a.replication
                ),
                timeout=30,
            )
        if r.error:
            return f"error on {loc.url}: {r.error}"
        changed.append(loc.url)
    return (
        f"volume {a.volumeId} replication -> {a.replication} on "
        + ", ".join(changed)
    )


# not `mutating`: it only reads topology itself and DELEGATES to
# volume.move, which takes the admin + per-volume leases — taking them
# here too would deadlock against our own nested invocation
@command(
    "volume.tier.move",
    "-volumeId N -targetDiskType t (move to a node of that disk type)",
)
def volume_tier_move(env: ShellEnv, args) -> str:
    """Reference volume.tier.move: relocate a volume onto a node whose
    disks match the requested type (readonly -> copy -> delete)."""
    p = argparse.ArgumentParser(prog="volume.tier.move")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-targetDiskType", required=True)
    p.add_argument("-collection", default="")
    a = p.parse_args(args)
    ch0, mstub = _master_channel(env)
    with ch0:
        topo = mstub.Topology(pb.TopologyRequest(), timeout=30)
    src = _locate_volume(env, a.volumeId)
    target = None
    for n in topo.nodes:
        has_vid = any(v.id == a.volumeId for v in n.volumes)
        disk_types = {v.disk_type or "hdd" for v in n.volumes}
        node_addr = f"{n.location.url.split(':')[0]}:{n.location.grpc_port}"
        src_addr = f"{src.url.split(':')[0]}:{src.grpc_port}"
        # an EMPTY node's disk type is unknowable from topology: only
        # the default tier may claim it; never silently call an
        # unknown disk an ssd
        matches = a.targetDiskType in disk_types or (
            not disk_types and a.targetDiskType == "hdd"
        )
        if not has_vid and node_addr != src_addr and matches:
            target = node_addr
            break
    if target is None:
        return f"no {a.targetDiskType} node available for volume {a.volumeId}"
    return run_command(
        env,
        f"volume.move -volumeId {a.volumeId} -target {target}"
        + (f" -collection {a.collection}" if a.collection else ""),
    )


@command("volume.vacuum.disable", "-volumeId N (skip in auto vacuum)", mutating=True)
def volume_vacuum_disable(env: ShellEnv, args) -> str:
    return _vacuum_toggle(env, args, disable=True)


@command("volume.vacuum.enable", "-volumeId N (re-enable auto vacuum)", mutating=True)
def volume_vacuum_enable(env: ShellEnv, args) -> str:
    return _vacuum_toggle(env, args, disable=False)


def _vacuum_toggle(env: ShellEnv, args, disable: bool) -> str:
    p = argparse.ArgumentParser(
        prog=f"volume.vacuum.{'disable' if disable else 'enable'}"
    )
    p.add_argument("-volumeId", type=int, required=True)
    a = p.parse_args(args)
    ch, stub = _master_channel(env)
    with ch:
        r = stub.VacuumControl(
            pb.VacuumControlRequest(volume_id=a.volumeId, disable=disable),
            timeout=30,
        )
    if r.error:
        return f"error: {r.error}"
    state = "disabled" if disable else "enabled"
    return f"auto vacuum {state} for volume {a.volumeId}"


# -------------------------------------------------------------- the fleet


@command(
    "task.submit",
    "-kind ec_encode|vacuum|balance|ec_balance|s3_lifecycle|iceberg "
    "[-volumeId N] [-backend b] [-param k=v ...]",
)
def task_submit(env: ShellEnv, args) -> str:
    from ..pb import worker_pb2 as wk
    from ..worker.control import VOLUME_INDEPENDENT_KINDS

    refused = _unserved_backend(args)
    if refused:
        return refused
    p = argparse.ArgumentParser(prog="task.submit")
    p.add_argument("-kind", required=True)
    # volume-independent kinds (ec_balance, s3_lifecycle) run with 0; every
    # other kind acts on ONE volume, and a forgotten -volumeId would submit
    # a doomed volume-0 task that only fails in task.list
    p.add_argument("-volumeId", type=int, default=None)
    p.add_argument("-collection", default="")
    p.add_argument("-backend", default="")
    p.add_argument("-param", action="append", default=[],
                   help="k=v, validated against the kind's descriptor")
    a = p.parse_args(args)
    if a.volumeId is None and a.kind not in VOLUME_INDEPENDENT_KINDS:
        return f"error: -volumeId is required for kind {a.kind}"
    params = {}
    for kv in a.param:
        k, sep, v = kv.partition("=")
        if not sep or not k:
            return f"error: -param wants k=v, got {kv!r}"
        params[k] = v
    req = wk.SubmitTaskRequest(kind=a.kind, volume_id=a.volumeId or 0,
                               collection=a.collection, backend=a.backend)
    for k, v in params.items():
        req.params[k] = v
    with grpc.insecure_channel(env.master.grpc_addr) as ch:
        r = rpc.worker_stub(ch).SubmitTask(req, timeout=30)
    if r.error:
        return f"error: {r.error}"
    return f"task {r.task_id} submitted"


@command("task.list", "show the maintenance task queue")
def task_list(env: ShellEnv, args) -> str:
    from ..pb import worker_pb2 as wk

    with grpc.insecure_channel(env.master.grpc_addr) as ch:
        r = rpc.worker_stub(ch).ListTasks(wk.ListTasksRequest(), timeout=30)
    return "\n".join(
        f"{t.task_id} {t.kind} vol={t.volume_id} {t.state}"
        + (f" ({t.progress:.0%})" if t.state == "running" else "")
        + (f" worker={t.worker_id}" if t.worker_id else "")
        + (f" error={t.error}" if t.error else "")
        for t in r.tasks
    ) or "(no tasks)"


@command("cluster.ps", "list cluster processes (masters, volume servers, workers)")
def cluster_ps(env: ShellEnv, args) -> str:
    from ..pb import worker_pb2 as wk

    lines = []
    ch, _stub = _master_channel(env)
    with ch:
        try:
            rs = rpc.Stub(ch, rpc.RAFT_SERVICE).RaftStatus(pb.RaftStatusRequest(), timeout=10)
            lines.append(f"master {rs.node_id} role={rs.role} term={rs.term}")
            for peer in rs.peers:
                lines.append(f"master {peer} (peer)")
        except grpc.RpcError:
            lines.append(f"master {env.master_addr}")
        topo = rpc.master_stub(ch).Topology(pb.TopologyRequest(), timeout=30)
        for n in topo.nodes:
            lines.append(
                f"volumeServer {n.location.url} grpc={n.location.grpc_port} "
                f"volumes={len(n.volumes)} ec={len(n.ec_shards)} "
                f"dc={n.data_center or 'default'} rack={n.rack or 'default'}")
        try:
            ws = rpc.worker_stub(ch).ListWorkers(wk.ListWorkersRequest(), timeout=10)
            for w in ws.workers:
                lines.append(f"worker {w.worker_id} caps={','.join(w.capabilities)} "
                             f"active={w.active}")
        except grpc.RpcError:
            pass
    return "\n".join(lines)


@command("worker.list", "list registered maintenance workers")
def worker_list(env: ShellEnv, args) -> str:
    from ..pb import worker_pb2 as wk

    ch, _ = _master_channel(env)
    with ch:
        r = rpc.worker_stub(ch).ListWorkers(wk.ListWorkersRequest(), timeout=10)
    if not r.workers:
        return "no workers connected"
    return "\n".join(
        f"{w.worker_id} caps={','.join(w.capabilities)} "
        f"active={w.active}/{w.max_concurrent} backend={w.backend}"
        for w in r.workers)


@command(
    "maintenance.config",
    "[-set key=value ...] show or tune the maintenance policy live",
    mutating=True,
)
def maintenance_config(env: ShellEnv, args) -> str:
    from ..pb import worker_pb2 as wk

    p = argparse.ArgumentParser(prog="maintenance.config")
    p.add_argument("-set", action="append", default=[])
    a = p.parse_args(args)
    ch, _ = _master_channel(env)
    with ch:
        stub = rpc.worker_stub(ch)
        if a.set:
            req = wk.MaintenanceConfig()
            for kv in a.set:
                key, _, val = kv.partition("=")
                if key == "lifecycle_filer":
                    req.lifecycle_filer = val
                else:
                    try:
                        setattr(req, key, float(val))
                    except (AttributeError, ValueError):
                        return f"unknown or invalid knob {kv!r}"
            r = stub.SetMaintenanceConfig(req, timeout=10)
            if r.error:
                return f"error: {r.error}"
        cfg = stub.GetMaintenanceConfig(wk.GetMaintenanceConfigRequest(), timeout=10)
    return json.dumps({
        "ec_auto_fullness": cfg.ec_auto_fullness,
        "ec_quiet_seconds": cfg.ec_quiet_seconds,
        "garbage_threshold": cfg.garbage_threshold,
        "vacuum_interval_seconds": cfg.vacuum_interval_seconds,
        "balance_spread": cfg.balance_spread,
        "lifecycle_interval_seconds": cfg.lifecycle_interval_seconds,
        "lifecycle_filer": cfg.lifecycle_filer,
        "ec_balance_interval_seconds": cfg.ec_balance_interval_seconds,
        "ec_scrub_interval_seconds": cfg.ec_scrub_interval_seconds,
        "ec_rebalance_interval_seconds": cfg.ec_rebalance_interval_seconds,
    })


def _master_channel(env: ShellEnv, service: str = ""):
    host, _, port = env.master_addr.partition(":")
    ch = grpc.insecure_channel(f"{host}:{int(port or 9333) + 10000}")
    return ch, rpc.Stub(ch, service or rpc.MASTER_SERVICE)


# ------------------------------------------------------------ the filer
#
# fs.*, volume.fsck and cluster.lock.ring: the filer's HTTP face through
# `_filer_http` (http.client, where the JAX shell uses `requests`: the
# card's host has none), its gRPC face through `_filer_grpc` (the filer's
# port + 10000), and the lock ring through filer/lock_ring.py `DlmClient`.


def _filer_url(env: ShellEnv, path: str) -> str:
    from urllib.parse import quote

    if not path.startswith("/"):
        path = "/" + path
    return service_url(env.filer_addr, quote(path))


@contextlib.contextmanager
def _filer_http(env: ShellEnv, method: str, path: str, query: str = "", timeout: float = 30,
                body=None, headers=None):
    """One request to the filer at `path` (quoted here) and `query`;
    yields the response, its body unread."""
    url = _filer_url(env, path)
    conn = urls.connection(url, timeout)
    try:
        target = urlsplit(url).path + (f"?{query}" if query else "")
        conn.request(method, target, body=body, headers=headers or {})
        yield conn.getresponse()
    finally:
        conn.close()


def _filer_grpc(env: ShellEnv):
    host, _, port = env.filer_addr.partition(":")
    ch = grpc.insecure_channel(f"{host}:{int(port or 8888) + 10000}")
    return ch, rpc.filer_stub(ch)


def _text(body: bytes) -> str:
    return body.decode("utf-8", errors="replace")


@command("fs.ls", "fs.ls /path (filer listing)")
def fs_ls(env: ShellEnv, args) -> str:
    path = args[0] if args else "/"
    with _filer_http(env, "GET", path) as r:
        body = r.read()
    if r.status != 200:
        return f"error: {_text(body)}"
    # the filer marks real directory listings; a stored .json file must
    # not be mistaken for one
    if r.getheader("X-Filer-Listing") != "true":
        return f"{path}: file ({len(body)} bytes)"
    return "\n".join(
        f"{'d' if e['IsDirectory'] else '-'} {e['FileSize']:>12} {e['FullPath']}"
        for e in json.loads(body).get("Entries", [])
    ) or "(empty)"


@command("fs.cat", "fs.cat /path")
def fs_cat(env: ShellEnv, args) -> str:
    with _filer_http(env, "GET", args[0], timeout=60) as r:
        body = r.read()
    if r.status != 200:
        return f"error: {_text(body)}"
    return _text(body)


@command("fs.rm", "fs.rm [-r] /path")
def fs_rm(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="fs.rm")
    p.add_argument("-r", action="store_true")
    p.add_argument("path")
    a = p.parse_args(args)
    with _filer_http(env, "DELETE", a.path, "recursive=true" if a.r else "", timeout=60) as r:
        body = r.read()
    return "ok" if r.status in (200, 204) else f"error: {_text(body)}"


@command("fs.tree", "fs.tree /path (recursive listing)")
def fs_tree(env: ShellEnv, args) -> str:
    from ..client.filer_client import FilerListingError, list_dir

    root = args[0] if args else "/"
    lines = [root]
    # explicit pre-order work list: correct nesting without Python
    # recursion limits on deep namespaces
    work: list = [("dir", root, 1, True)]
    try:
        while work:
            item = work.pop()
            if item[0] == "line":
                lines.append(item[1])
                continue
            _, path, depth, strict = item
            sub: list = []
            for e in list_dir(env.filer_addr, path, strict=strict):
                name = e["FullPath"].rsplit("/", 1)[-1]
                sub.append(("line", "  " * depth + name + ("/" if e["IsDirectory"] else "")))
                if e["IsDirectory"]:
                    sub.append(("dir", e["FullPath"], depth + 1, False))
            work.extend(reversed(sub))
    except FilerListingError as e:
        return f"error: {e}"
    return "\n".join(lines)


@command("fs.du", "fs.du /path (recursive size)")
def fs_du(env: ShellEnv, args) -> str:
    from ..client.filer_client import FilerListingError, walk

    root = args[0] if args else "/"
    total = files = dirs = 0
    try:
        for e in walk(env.filer_addr, root, strict=True):
            if e["IsDirectory"]:
                dirs += 1
            else:
                files += 1
                total += e["FileSize"]
    except FilerListingError as e:
        return f"error: {e}"
    return f"{total:,} bytes in {files} files, {dirs} directories under {root}"


@command("volume.fsck", "cross-check filer chunk references against volumes")
def volume_fsck(env: ShellEnv, args) -> str:
    """Referential check (reference volume.fsck direction filer->volume):
    every chunk a filer entry references must be readable on a volume.
    (The reverse direction, unreferenced volume needles, is not scanned:
    raw blob-API uploads are legitimately filer-less.)"""
    from ..client.filer_client import FilerListingError, walk
    from ..storage.file_id import FileId, FileIdError

    p = argparse.ArgumentParser(prog="volume.fsck")
    p.add_argument("-path", default="/")
    a = p.parse_args(args)
    referenced: dict[int, set] = {}
    entries = 0
    skipped = 0
    try:
        for e in walk(env.filer_addr, a.path, strict=True):
            if e["IsDirectory"]:
                continue
            entries += 1
            with _filer_http(env, "GET", e["FullPath"], "chunks=true") as r:
                body = r.read()
            if r.getheader("X-Filer-Chunks") != "true":
                skipped += 1  # filer without the chunk-manifest endpoint
                continue
            for fid in json.loads(body).get("chunks", []):
                try:
                    f = FileId.parse(fid)
                except FileIdError:
                    continue
                referenced.setdefault(f.volume_id, set()).add(f.needle_id)
    except FilerListingError as e:
        return f"error: {e}"
    broken = []
    checked = 0
    for vid, nids in sorted(referenced.items()):
        try:
            loc = _locate_volume(env, vid)
        except LookupError:
            broken.extend((vid, n, "volume has no locations") for n in nids)
            continue
        try:
            ch, stub = _volume_stub(loc)
            with ch:
                for nid in nids:
                    checked += 1
                    r2 = stub.ReadNeedle(pb.ReadNeedleRequest(volume_id=vid, needle_id=nid),
                                         timeout=30)
                    if r2.error:
                        broken.append((vid, nid, r2.error))
        except grpc.RpcError as e:
            # one dead server must not discard the rest of the scan
            broken.extend((vid, n, f"holder unreachable: {e.code().name}") for n in nids)
    out = [f"fsck: {entries} entries, {checked} chunk references checked"]
    if skipped:
        out.append(f"WARNING: {skipped} entries skipped (no chunk manifest endpoint)")
    if broken:
        out += [f"BROKEN: volume {v} needle {n:x} ({why})" for v, n, why in broken]
    else:
        out.append("no broken chunk references")
    return "\n".join(out)


@command("fs.mkdir", "fs.mkdir /path")
def fs_mkdir(env: ShellEnv, args) -> str:
    with _filer_http(env, "POST", args[0], "mkdir=true") as r:
        body = r.read()
    return "ok" if r.status == 201 else f"error: {_text(body)}"


@command("fs.meta.save", "fs.meta.save /path -o meta.jsonl (export filer metadata)")
def fs_meta_save(env: ShellEnv, args) -> str:
    """Walk the filer tree and export entry metadata as NDJSON
    (reference fs.meta.save)."""
    from ..client.filer_client import FilerListingError, walk

    p = argparse.ArgumentParser(prog="fs.meta.save")
    p.add_argument("path", nargs="?", default="/")
    p.add_argument("-o", required=True)
    a = p.parse_args(args)
    count = 0
    try:
        with open(a.o, "w") as out:
            for e in walk(env.filer_addr, a.path, strict=True):
                out.write(json.dumps(e, separators=(",", ":")) + "\n")
                count += 1
    except FilerListingError as e:
        return f"error: {e}"
    return f"saved {count} entries -> {a.o}"


@command("fs.meta.load", "fs.meta.load meta.jsonl (recreate dirs; files need data)")
def fs_meta_load(env: ShellEnv, args) -> str:
    """Recreate the directory skeleton from a fs.meta.save export. (File
    content lives in volumes; restoring bytes is filer.sync / volume
    restore territory.)"""
    p = argparse.ArgumentParser(prog="fs.meta.load")
    p.add_argument("file")
    a = p.parse_args(args)
    dirs = files = failed = 0
    with open(a.file) as f:
        for line in f:
            e = json.loads(line)
            if e["IsDirectory"]:
                with _filer_http(env, "POST", e["FullPath"], "mkdir=true") as r:
                    r.read()
                if r.status == 201:
                    dirs += 1
                else:
                    failed += 1
            else:
                files += 1
    out = f"recreated {dirs} directories ({files} file entries listed)"
    if failed:
        out += f"; {failed} FAILED"
    return out


@command("fs.mv", "fs.mv /src /dst")
def fs_mv(env: ShellEnv, args) -> str:
    from urllib.parse import quote

    src, dst = args
    with _filer_http(env, "POST", dst, f"mv.from={quote(src, safe='')}", timeout=60) as r:
        body = r.read()
    return "ok" if r.status == 200 else f"error: {_text(body)}"


@command("fs.cp", "fs.cp /src /dst (server-side file copy via the filer)")
def fs_cp(env: ShellEnv, args) -> str:
    if len(args) != 2:
        return "usage: fs.cp /src /dst"
    src, dst = args
    total = 0
    with _filer_http(env, "GET", src, timeout=300) as r:
        if r.status != 200 or r.getheader("X-Filer-Listing") == "true":
            return f"error: {src}: not a readable file"

        def chunks():
            nonlocal total
            while True:  # constant memory on huge files
                c = r.read(1 << 20)
                if not c:
                    return
                total += len(c)
                yield c

        # a body of unknown length goes out chunked, as the JAX shell's
        # streamed POST does
        with _filer_http(env, "POST", dst, timeout=300, body=chunks(),
                         headers={"Content-Type": r.getheader("Content-Type", "")}) as w:
            w.read()
    if w.status != 201:
        return f"error: write {dst}: {w.status}"
    return f"copied {src} -> {dst} ({total} bytes)"


def _lookup_entry(env: ShellEnv, path: str):
    """-> (entry, None) or (None, error string); one shared parse and
    lookup for the fs.* metadata commands."""
    from ..pb import filer_pb2 as fpb

    directory, _, name = path.rstrip("/").rpartition("/")
    ch, stub = _filer_grpc(env)
    with ch:
        r = stub.LookupDirectoryEntry(fpb.LookupEntryRequest(directory=directory or "/", name=name),
                                      timeout=10)
    if r.error:
        return None, f"error: {r.error}"
    return r.entry, None


@command("fs.stat", "fs.stat /path (full entry metadata)")
def fs_stat(env: ShellEnv, args) -> str:
    if not args:
        return "usage: fs.stat /path"
    path = args[0]
    e, err = _lookup_entry(env, path)
    if err:
        return err
    a = e.attributes
    lines = [
        f"path:      {path}",
        f"type:      {'directory' if e.is_directory else 'file'}",
        f"size:      {a.file_size}",
        f"mode:      {oct(a.file_mode)}",
        f"uid:gid:   {a.uid}:{a.gid}",
        f"mtime:     {a.mtime}",
        f"mime:      {a.mime or '-'}",
        f"chunks:    {len(e.chunks)}",
        f"inline:    {len(e.content)} bytes",
        f"hardlinks: {max(e.hard_link_counter, 1)}",
    ]
    if a.symlink_target:
        lines.append(f"symlink -> {a.symlink_target}")
    if e.extended:
        lines.append("extended:  " + ", ".join(sorted(e.extended)))
    return "\n".join(lines)


@command("fs.verify", "fs.verify /path (read every byte; report size+md5)")
def fs_verify(env: ShellEnv, args) -> str:
    import hashlib

    if not args:
        return "usage: fs.verify /path"
    h = hashlib.md5()
    total = 0
    with _filer_http(env, "GET", args[0], timeout=600) as r:
        if r.status != 200:
            return f"error: {r.status}"
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
            total += len(chunk)
    return f"{args[0]}: {total} bytes readable, md5 {h.hexdigest()}"


@command("cluster.lock.ring", "[-filers a,b,...] live leases across the filer lock ring")
def cluster_lock_ring(env: ShellEnv, args) -> str:
    from ..filer.lock_ring import DlmClient

    p = argparse.ArgumentParser(prog="cluster.lock.ring")
    p.add_argument("-filers", default="")
    a = p.parse_args(args)
    if a.filers:
        members = [m.strip() for m in a.filers.split(",") if m.strip()]
    else:
        host, _, port = env.filer_addr.partition(":")
        members = [f"{host}:{int(port or 8888) + 10000}"]
    c = DlmClient(members)
    try:
        rows = c.status()
    finally:
        c.close()
    return "\n".join(f"{n:40s} {o:20s} {r:6.1f}s" for n, o, r in rows) or "no live leases"


@command("fs.meta.cat", "fs.meta.cat /path (raw entry metadata as JSON)")
def fs_meta_cat(env: ShellEnv, args) -> str:
    if not args:
        return "usage: fs.meta.cat /path"
    e, err = _lookup_entry(env, args[0])
    if err:
        return err
    a = e.attributes
    doc = {
        "name": e.name,
        "isDirectory": e.is_directory,
        "attributes": {
            "mtime": a.mtime, "crtime": a.crtime, "fileMode": a.file_mode, "uid": a.uid,
            "gid": a.gid, "mime": a.mime, "ttlSec": a.ttl_sec, "userName": a.user_name,
            "groupNames": list(a.group_names), "symlinkTarget": a.symlink_target,
            "md5": a.md5.hex(), "fileSize": a.file_size, "rdev": a.rdev, "inode": a.inode,
        },
        "chunks": [
            {"fid": c.fid, "offset": c.offset, "size": c.size, "modifiedTsNs": c.modified_ts_ns,
             "etag": c.etag, "cipherKey": c.cipher_key.hex(), "isCompressed": c.is_compressed,
             "isChunkManifest": c.is_chunk_manifest}
            for c in e.chunks
        ],
        "extended": {k: v.hex() for k, v in e.extended.items()},
        "hardLinkId": e.hard_link_id.hex(),
        "hardLinkCounter": e.hard_link_counter,
        "wormEnforcedAtTsNs": e.worm_enforced_at_ts_ns,
        "inlineContentBytes": len(e.content),
    }
    return json.dumps(doc, indent=2)


@command(
    "fs.configure",
    "[-locationPrefix /p -collection c -replication xyz -ttlSec n] "
    "[-delete] [-show] (per-path storage rules)",
    mutating=True,
)
def fs_configure(env: ShellEnv, args) -> str:
    from ..pb import filer_pb2 as fpb

    p = argparse.ArgumentParser(prog="fs.configure")
    p.add_argument("-locationPrefix", default="")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttlSec", type=int, default=0)
    p.add_argument("-delete", action="store_true")
    p.add_argument("-show", action="store_true")
    a = p.parse_args(args)
    ch, stub = _filer_grpc(env)
    with ch:
        cur = stub.KvGet(fpb.FilerKvGetRequest(key=b"fs.configure"), timeout=10)
        conf = json.loads(cur.value) if cur.found else {"locations": []}
        if a.show or not a.locationPrefix:
            return json.dumps(conf, indent=2)
        locs = [r for r in conf.get("locations", []) if r.get("location_prefix") != a.locationPrefix]
        if not a.delete:
            locs.append({"location_prefix": a.locationPrefix, "collection": a.collection,
                         "replication": a.replication, "ttl_sec": a.ttlSec})
        conf["locations"] = locs
        stub.KvPut(fpb.FilerKvPutRequest(key=b"fs.configure", value=json.dumps(conf).encode()),
                   timeout=10)
    verb = "deleted rule for" if a.delete else "configured"
    return f"{verb} {a.locationPrefix} ({len(locs)} rule(s) total)"


# ------------------------------------------------------------ the s3 family
#
# s3.*: the gateway's identities (`s3/identity.json` in the filer's KV,
# which s3/config.py `FilerIdentityStore` reads), its buckets (the
# directories of /buckets; a bucket's objects go to the collection of its
# name) and their quotas (`quota/<b>` and `quota-exceeded/<b>` in the
# KV), all over the filer's gRPC face.


def _s3_conf_load(stub) -> dict:
    from ..pb import filer_pb2 as fpb
    from ..s3.config import S3_IDENTITY_KV

    r = stub.KvGet(fpb.FilerKvGetRequest(key=S3_IDENTITY_KV), timeout=10)
    if not r.found or not r.value:
        return {"identities": []}
    try:
        return json.loads(r.value)
    except json.JSONDecodeError:
        return {"identities": []}


def _s3_conf_save(stub, conf: dict) -> None:
    from ..pb import filer_pb2 as fpb
    from ..s3.config import S3_IDENTITY_KV

    stub.KvPut(
        fpb.FilerKvPutRequest(key=S3_IDENTITY_KV, value=json.dumps(conf, indent=2).encode()),
        timeout=10,
    )


@command(
    "s3.configure",
    "-user name [-actions A,B] [-access_key K -secret_key S] [-delete] (identity CRUD)",
)
def s3_configure(env: ShellEnv, args) -> str:
    """Reference command_s3_configure.go: maintain the gateway identity
    config (persisted in the filer; every gateway reloads it live)."""
    p = argparse.ArgumentParser(prog="s3.configure")
    p.add_argument("-user", required=True)
    p.add_argument("-actions", default="")
    p.add_argument("-access_key", default="")
    p.add_argument("-secret_key", default="")
    p.add_argument("-delete", action="store_true")
    a = p.parse_args(args)
    ch, stub = _filer_grpc(env)
    with ch:
        conf = _s3_conf_load(stub)
        idents = conf.setdefault("identities", [])
        if a.delete:
            before = len(idents)
            conf["identities"] = [i for i in idents if i.get("name") != a.user]
            _s3_conf_save(stub, conf)
            return f"deleted {before - len(conf['identities'])} credential(s) of {a.user}"
        if bool(a.access_key) != bool(a.secret_key):
            return "error: -access_key and -secret_key go together"
        actions = [s for s in a.actions.split(",") if s]
        existing = [i for i in idents if i.get("name") == a.user]
        if a.access_key:
            entry = {
                "name": a.user,
                "accessKey": a.access_key,
                "secretKey": a.secret_key,
                "actions": actions
                or (existing[0].get("actions", ["Admin"]) if existing else ["Admin"]),
            }
            idents[:] = [i for i in idents if i.get("accessKey") != a.access_key] + [entry]
        elif actions:
            if not existing:
                return f"error: user {a.user} has no credentials yet (use s3.accesskey.create)"
            for i in existing:
                i["actions"] = actions
        else:
            return "error: nothing to do (-actions or key pair or -delete)"
        _s3_conf_save(stub, conf)
    return f"configured {a.user}"


@command("s3.user.list", "list configured S3 identities")
def s3_user_list(env: ShellEnv, args) -> str:
    ch, stub = _filer_grpc(env)
    with ch:
        conf = _s3_conf_load(stub)
    rows = [
        f"{i.get('name', '?'):20s} {i.get('accessKey', ''):24s} "
        f"{','.join(i.get('actions', [])) or 'policies:' + str(len(i.get('policies', [])))}"
        for i in conf.get("identities", [])
    ]
    return "\n".join(rows) or "no identities configured (gateway is in open mode)"


@command("s3.user.delete", "-user name (drop all the user's credentials)")
def s3_user_delete(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="s3.user.delete")
    p.add_argument("-user", required=True)
    a = p.parse_args(args)
    return s3_configure(env, ["-user", a.user, "-delete"])


@command("s3.accesskey.create", "-user name [-actions A,B] (generate a key pair)")
def s3_accesskey_create(env: ShellEnv, args) -> str:
    from ..s3.config import mint_key_pair

    p = argparse.ArgumentParser(prog="s3.accesskey.create")
    p.add_argument("-user", required=True)
    p.add_argument("-actions", default="")
    a = p.parse_args(args)
    access_key, secret_key = mint_key_pair()
    # "=": a minted secret may start with "-" (token_urlsafe), which
    # argparse would take for an option and exit the shell on
    out = s3_configure(
        env,
        ["-user", a.user, "-access_key", access_key, f"-secret_key={secret_key}"]
        + (["-actions", a.actions] if a.actions else []),
    )
    if out.startswith("error"):
        return out
    return f"user={a.user}\naccess_key={access_key}\nsecret_key={secret_key}"


@command("s3.accesskey.delete", "-access_key K")
def s3_accesskey_delete(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="s3.accesskey.delete")
    p.add_argument("-access_key", required=True)
    a = p.parse_args(args)
    ch, stub = _filer_grpc(env)
    with ch:
        conf = _s3_conf_load(stub)
        before = len(conf.get("identities", []))
        conf["identities"] = [
            i for i in conf.get("identities", []) if i.get("accessKey") != a.access_key
        ]
        _s3_conf_save(stub, conf)
    return f"deleted {before - len(conf['identities'])} credential(s)"


@command(
    "s3.policy.put",
    "-user name -policy '<json document>' (attach an IAM policy, replacing actions)",
)
def s3_policy_put(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="s3.policy.put")
    p.add_argument("-user", required=True)
    p.add_argument("-policy", required=True)
    a = p.parse_args(args)
    try:
        doc = json.loads(a.policy)
    except json.JSONDecodeError as e:
        return f"error: policy is not JSON: {e}"
    if "Statement" not in doc:
        return "error: policy has no Statement"
    ch, stub = _filer_grpc(env)
    with ch:
        conf = _s3_conf_load(stub)
        hit = [i for i in conf.get("identities", []) if i.get("name") == a.user]
        if not hit:
            return f"error: user {a.user} has no credentials yet"
        for i in hit:
            i["policies"] = [doc]
            i["actions"] = []
        _s3_conf_save(stub, conf)
    return f"policy attached to {a.user} ({len(hit)} credential(s))"


@command("s3.policy.get", "-user name")
def s3_policy_get(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="s3.policy.get")
    p.add_argument("-user", required=True)
    a = p.parse_args(args)
    ch, stub = _filer_grpc(env)
    with ch:
        conf = _s3_conf_load(stub)
    for i in conf.get("identities", []):
        if i.get("name") == a.user and i.get("policies"):
            return json.dumps(i["policies"], indent=2)
    return f"user {a.user} has no attached policies"


@command("s3.policy.delete", "-user name (detach policies, restoring action-based auth)")
def s3_policy_delete(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="s3.policy.delete")
    p.add_argument("-user", required=True)
    p.add_argument("-actions", default="Admin")
    a = p.parse_args(args)
    ch, stub = _filer_grpc(env)
    with ch:
        conf = _s3_conf_load(stub)
        hit = [i for i in conf.get("identities", []) if i.get("name") == a.user]
        for i in hit:
            i.pop("policies", None)
            i["actions"] = [s for s in a.actions.split(",") if s]
        _s3_conf_save(stub, conf)
    return f"policies detached from {len(hit)} credential(s)"


@command("s3.bucket.list", "list buckets (via the filer)")
def s3_bucket_list(env: ShellEnv, args) -> str:
    from ..pb import filer_pb2 as fpb

    ch, stub = _filer_grpc(env)
    rows = []
    with ch:
        for r in stub.ListEntries(fpb.ListEntriesRequest(directory="/buckets", limit=10000),
                                  timeout=30):
            if r.entry.is_directory and not r.entry.name.startswith("."):
                rows.append(r.entry.name)
    return "\n".join(sorted(rows)) or "no buckets"


@command("s3.bucket.create", "-name bucket")
def s3_bucket_create(env: ShellEnv, args) -> str:
    from ..pb import filer_pb2 as fpb

    p = argparse.ArgumentParser(prog="s3.bucket.create")
    p.add_argument("-name", required=True)
    a = p.parse_args(args)
    entry = fpb.Entry(name=a.name, is_directory=True)
    entry.attributes.file_mode = 0o40755
    ch, stub = _filer_grpc(env)
    with ch:
        r = stub.LookupDirectoryEntry(fpb.LookupEntryRequest(directory="/buckets", name=a.name),
                                      timeout=10)
        if not r.error:
            return f"bucket {a.name} exists"
        r = stub.CreateEntry(fpb.CreateEntryRequest(directory="/buckets", entry=entry),
                             timeout=10)
    return r.error or f"created bucket {a.name}"


@command("s3.bucket.delete", "-name bucket [-force] (force = delete objects too)", mutating=True)
def s3_bucket_delete(env: ShellEnv, args) -> str:
    from ..pb import filer_pb2 as fpb

    p = argparse.ArgumentParser(prog="s3.bucket.delete")
    p.add_argument("-name", required=True)
    p.add_argument("-force", action="store_true")
    a = p.parse_args(args)
    ch, stub = _filer_grpc(env)
    with ch:
        if not a.force:
            for _ in stub.ListEntries(
                fpb.ListEntriesRequest(directory=f"/buckets/{a.name}", limit=2), timeout=10
            ):
                return f"error: bucket {a.name} not empty (use -force)"
        r = stub.DeleteEntry(
            fpb.DeleteEntryRequest(directory="/buckets", name=a.name, is_recursive=True,
                                   is_delete_data=True),
            timeout=60,
        )
    if r.error:
        return f"error: {r.error}"
    with contextlib.suppress(Exception):
        env.master.collection_delete(a.name)
    return f"deleted bucket {a.name}"


@command("s3.clean.uploads", "[-timeAgo hours] purge stale multipart uploads")
def s3_clean_uploads(env: ShellEnv, args) -> str:
    import time as _time

    from ..pb import filer_pb2 as fpb

    p = argparse.ArgumentParser(prog="s3.clean.uploads")
    p.add_argument("-timeAgo", type=float, default=24.0)
    a = p.parse_args(args)
    cutoff = _time.time() - a.timeAgo * 3600
    ch, stub = _filer_grpc(env)
    removed = []
    with ch:
        buckets = [
            r.entry.name
            for r in stub.ListEntries(fpb.ListEntriesRequest(directory="/buckets", limit=10000),
                                      timeout=30)
            if r.entry.is_directory and not r.entry.name.startswith(".")
        ]
        for b in buckets:
            updir = f"/buckets/{b}/.uploads"
            for r in stub.ListEntries(fpb.ListEntriesRequest(directory=updir, limit=10000),
                                      timeout=30):
                if r.entry.attributes.mtime < cutoff:
                    rr = stub.DeleteEntry(
                        fpb.DeleteEntryRequest(directory=updir, name=r.entry.name,
                                               is_recursive=True, is_delete_data=True),
                        timeout=60,
                    )
                    if not rr.error:
                        removed.append(f"{b}/{r.entry.name}")
    return "\n".join(removed) or "no stale uploads"


def _list_all_entries(stub, directory: str):
    """Full listing with PAGINATION — a flat limit would silently
    undercount directories beyond it."""
    from ..pb import filer_pb2 as fpb

    start = ""
    while True:
        page = list(stub.ListEntries(
            fpb.ListEntriesRequest(directory=directory, limit=10000, start_from=start),
            timeout=60,
        ))
        for r in page:
            yield r.entry
        if len(page) < 10000:
            return
        start = page[-1].entry.name


def _bucket_usage_bytes(stub, bucket: str) -> int:
    """Recursive size walk of /buckets/<b> over the filer gRPC."""
    total = 0
    stack = [f"/buckets/{bucket}"]
    while stack:
        d = stack.pop()
        for e in _list_all_entries(stub, d):
            if e.is_directory:
                stack.append(f"{d}/{e.name}")
            else:
                total += e.attributes.file_size or (len(e.content) + sum(c.size for c in e.chunks))
    return total


@command("s3.bucket.quota.set", "-name bucket -bytes N (0 = remove the quota)")
def s3_bucket_quota_set(env: ShellEnv, args) -> str:
    from ..pb import filer_pb2 as fpb

    p = argparse.ArgumentParser(prog="s3.bucket.quota.set")
    p.add_argument("-name", required=True)
    p.add_argument("-bytes", type=int, required=True)
    a = p.parse_args(args)
    ch, stub = _filer_grpc(env)
    with ch:
        key = f"quota/{a.name}".encode()
        if a.bytes > 0:
            stub.KvPut(fpb.FilerKvPutRequest(key=key, value=str(a.bytes).encode()), timeout=10)
            return f"quota for {a.name}: {a.bytes:,} bytes"
        stub.KvPut(fpb.FilerKvPutRequest(key=key, value=b""), timeout=10)
        stub.KvPut(fpb.FilerKvPutRequest(key=f"quota-exceeded/{a.name}".encode(), value=b""),
                   timeout=10)
        return f"quota removed for {a.name}"


@command("s3.bucket.quota.get", "-name bucket")
def s3_bucket_quota_get(env: ShellEnv, args) -> str:
    from ..pb import filer_pb2 as fpb

    p = argparse.ArgumentParser(prog="s3.bucket.quota.get")
    p.add_argument("-name", required=True)
    a = p.parse_args(args)
    ch, stub = _filer_grpc(env)
    with ch:
        r = stub.KvGet(fpb.FilerKvGetRequest(key=f"quota/{a.name}".encode()), timeout=10)
        usage = _bucket_usage_bytes(stub, a.name)
    if not r.found or not r.value:
        return f"{a.name}: no quota (usage {usage:,} bytes)"
    quota = int(r.value)
    return f"{a.name}: quota {quota:,} bytes, usage {usage:,} ({100.0 * usage / quota:.1f}%)"


@command(
    "s3.bucket.quota.enforce",
    "check every quota'd bucket; flag over-quota ones read-only for the gateway",
    mutating=True,
)
def s3_bucket_quota_enforce(env: ShellEnv, args) -> str:
    """Reference command_s3_bucketquota.go: enforcement is a periodic
    sweep (cron/worker), not per-request accounting — the gateway just
    honors the exceeded flag on writes."""
    from ..pb import filer_pb2 as fpb

    ch, stub = _filer_grpc(env)
    out = []
    with ch:
        buckets = [
            e.name
            for e in _list_all_entries(stub, "/buckets")
            if e.is_directory and not e.name.startswith(".")
        ]
        for b in buckets:
            q = stub.KvGet(fpb.FilerKvGetRequest(key=f"quota/{b}".encode()), timeout=10)
            if not q.found or not q.value:
                continue
            quota = int(q.value)
            usage = _bucket_usage_bytes(stub, b)
            flag_key = f"quota-exceeded/{b}".encode()
            if usage > quota:
                stub.KvPut(fpb.FilerKvPutRequest(key=flag_key, value=b"1"), timeout=10)
                out.append(f"{b}: OVER quota ({usage:,} > {quota:,}) — writes blocked")
            else:
                stub.KvPut(fpb.FilerKvPutRequest(key=flag_key, value=b""), timeout=10)
                out.append(f"{b}: ok ({usage:,} / {quota:,})")
    return "\n".join(out) or "no buckets carry quotas"


# ------------------------------------------------------- remote storage
#
# The filer's remote-mount control plane (POST /~remote/<op>), over
# `_filer_http` where the JAX shell uses `requests`.


def _remote_post(env: ShellEnv, op: str, body: dict) -> str:
    with _filer_http(env, "POST", f"/~remote/{op}", timeout=300,
                     body=json.dumps(body).encode()) as r:
        data = r.read()
    try:
        payload = json.loads(data)
    except ValueError:
        payload = {"error": _text(data)[:200]}
    if r.status != 200:
        return f"error: {payload.get('error', r.status)}"
    return ", ".join(f"{k}={v}" for k, v in payload.items())


@command(
    "remote.configure",
    "-name n -endpoint http://host:port [-accessKey k -secretKey s -region r]",
)
def remote_configure(env: ShellEnv, args) -> str:
    """Store an S3-compatible remote's credentials in the filer
    (reference remote.configure)."""
    p = argparse.ArgumentParser(prog="remote.configure")
    p.add_argument("-name", required=True)
    p.add_argument("-endpoint", required=True)
    p.add_argument("-accessKey", default="")
    p.add_argument("-secretKey", default="")
    p.add_argument("-region", default="us-east-1")
    a = p.parse_args(args)
    return _remote_post(
        env,
        "configure",
        {
            "name": a.name,
            "endpoint": a.endpoint,
            "access_key": a.accessKey,
            "secret_key": a.secretKey,
            "region": a.region,
        },
    )


@command(
    "remote.mount",
    "-dir /path -remote name -bucket b [-prefix p] (lazy cloud mount)",
)
def remote_mount(env: ShellEnv, args) -> str:
    """Materialize a bucket listing as a filer directory; file bytes
    stream through on read until remote.cache pins them
    (reference remote.mount + filer_lazy_remote)."""
    p = argparse.ArgumentParser(prog="remote.mount")
    p.add_argument("-dir", required=True)
    p.add_argument("-remote", required=True)
    p.add_argument("-bucket", required=True)
    p.add_argument("-prefix", default="")
    a = p.parse_args(args)
    return _remote_post(
        env,
        "mount",
        {
            "dir": a.dir,
            "remote": a.remote,
            "bucket": a.bucket,
            "prefix": a.prefix,
        },
    )


@command("remote.unmount", "-dir /path (drop the mount view; remote untouched)")
def remote_unmount(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="remote.unmount")
    p.add_argument("-dir", required=True)
    a = p.parse_args(args)
    return _remote_post(env, "unmount", {"dir": a.dir})


@command("remote.cache", "-path /file (pin remote bytes into local chunks)")
def remote_cache(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="remote.cache")
    p.add_argument("-path", required=True)
    a = p.parse_args(args)
    return _remote_post(env, "cache", {"path": a.path})


@command("remote.uncache", "-path /file (drop local copy, keep mapping)")
def remote_uncache(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="remote.uncache")
    p.add_argument("-path", required=True)
    a = p.parse_args(args)
    return _remote_post(env, "uncache", {"path": a.path})


@command(
    "remote.mount.buckets",
    "-dir /path -remote name [-prefix p] (mount every remote bucket)",
    mutating=True,
)
def remote_mount_buckets(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="remote.mount.buckets")
    p.add_argument("-dir", required=True)
    p.add_argument("-remote", required=True)
    p.add_argument("-prefix", default="")
    a = p.parse_args(args)
    return _remote_post(
        env,
        "mount.buckets",
        {"dir": a.dir, "remote": a.remote, "prefix": a.prefix},
    )


@command(
    "remote.meta.sync",
    "-dir /path (refresh mounted remote metadata: add/update/remove)",
    mutating=True,
)
def remote_meta_sync(env: ShellEnv, args) -> str:
    p = argparse.ArgumentParser(prog="remote.meta.sync")
    p.add_argument("-dir", required=True)
    a = p.parse_args(args)
    return _remote_post(env, "meta.sync", {"dir": a.dir})
