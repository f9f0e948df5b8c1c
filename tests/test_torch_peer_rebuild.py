"""PyTorch port: peer-fetch rebuild (ec/peer_rebuild.py) held against the
JAX package on the CPU.

Every case of the JAX package's tests/test_ec_peer_rebuild.py and the
five ranged-fetch cases of tests/test_ec_leaf_repair.py runs through
both packages' `rebuild_from_peers`: the same shard set (RS 4+2, shards
of 3 x 4096 + 57 bytes, seeded with numpy, v1 or v2 sidecar), the same
holders and the same injected `fetch`. The port rebuilds on
`TorchBackend(ctx, device="cpu")`, the JAX package on its `CpuBackend`.
Each case holds both runs to the JAX test's own assertions, and the two
runs to each other: every file left in the directory (staging
included), every `PeerRebuildReport` field, which calls raise `ECError`
and the fetch calls each made must be equal. A `.peerfetch-` staging
directory left by a crash (a child process killed right after the first
publish) in either package is swept by a rerun in the other, which
converges to the same files.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from seaweedfs_tpu import faults as jax_faults
from seaweedfs_tpu.ec import CpuBackend as JaxCpuBackend
from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec import ECError as JaxECError
from seaweedfs_tpu.ec import peer_rebuild as jax_pr
from seaweedfs_tpu.utils.retry import RetryPolicy as JaxRetryPolicy
from seaweedfs_tpu_torch import faults as port_faults
from seaweedfs_tpu_torch.ec import ECContext, ECError, TorchBackend
from seaweedfs_tpu_torch.ec import peer_rebuild as port_pr
from seaweedfs_tpu_torch.ec.bitrot import BitrotProtection, ShardChecksumBuilder
from seaweedfs_tpu_torch.ec.repair_journal import journal_path
from seaweedfs_tpu_torch.utils.retry import RetryPolicy

CTX = ECContext(4, 2)
JCTX = JaxECContext(4, 2)
BLOCK = 4096
LEAF = 1024
SHARD_SIZE = 3 * BLOCK + 57  # partial final granule on purpose

# zero-sleep policies: retry schedules run in no wall time
JAX = SimpleNamespace(
    name="jax", pr=jax_pr, faults=jax_faults, ECError=JaxECError, ctx=JCTX,
    backend=lambda: JaxCpuBackend(JCTX),
    policy=JaxRetryPolicy(max_attempts=3, base_delay=0.0, max_delay=0.0, jitter=0.0),
)
PORT = SimpleNamespace(
    name="port", pr=port_pr, faults=port_faults, ECError=ECError, ctx=CTX,
    backend=lambda: TorchBackend(CTX, device="cpu"),
    policy=RetryPolicy(max_attempts=3, base_delay=0.0, max_delay=0.0, jitter=0.0),
)
ALL_PEERS = {sid: ["peerB"] for sid in range(CTX.total)}
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clear_registries():
    port_faults.clear()
    jax_faults.clear()
    yield
    port_faults.clear()
    jax_faults.clear()


def shard_blobs(seed: int) -> dict[int, bytes]:
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (CTX.data_shards, SHARD_SIZE), dtype=np.uint8)
    shards = np.concatenate([data, TorchBackend(CTX, device="cpu").encode(data)], axis=0)
    return {i: shards[i].tobytes() for i in range(CTX.total)}


def synth(d, local, seed=0, leaf=0, generation=3) -> tuple[str, dict[int, bytes]]:
    """RS-consistent 4+2 shard set in directory `d` as volume 1, with a
    v1 sidecar (leaf=0) or a v2 one with `leaf`-byte leaves (a fixed
    uuid, so two calls write the same bytes); only `local` shard files
    exist. Returns (base, sid -> bytes)."""
    blobs = shard_blobs(seed)
    builders = [ShardChecksumBuilder(BLOCK, leaf_size=leaf) for _ in range(CTX.total)]
    for i in range(CTX.total):
        builders[i].write(blobs[i])
    os.makedirs(str(d), exist_ok=True)
    base = os.path.join(str(d), "1")
    prot = BitrotProtection.from_builders(CTX, builders, generation=generation)
    prot.uuid = bytes(16)  # both packages' runs get the same sidecar bytes
    prot.save(base + ".ecsum")
    for i in local:
        with open(base + CTX.to_ext(i), "wb") as f:
            f.write(blobs[i])
    return base, blobs


def rot_leaf(base, sid, leaf, at=11):
    with open(base + CTX.to_ext(sid), "r+b") as f:
        f.seek(leaf * LEAF + at)
        b = f.read(1)
        f.seek(leaf * LEAF + at)
        f.write(bytes([b[0] ^ 0x42]))


def shard(base, sid) -> bytes:
    with open(base + CTX.to_ext(sid), "rb") as f:
        return f.read()


def files(d) -> dict[str, bytes]:
    """Every file under `d`, by relative path."""
    out = {}
    for root, _dirs, names in os.walk(str(d)):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, str(d))] = f.read()
    return dict(sorted(out.items()))


def serving_fetch(blobs, log=None):
    def fetch(peer, sid, off, size):
        if log is not None:
            log.append((peer, sid, off, size))
        return blobs[sid][off : off + size]

    return fetch


def run(P, base, holders, fetch, **kw):
    """rebuild_from_peers of package P; the report as a dict, or the
    refusal as ("ECError", message)."""
    kw.setdefault("backend", P.backend())
    kw.setdefault("policy", P.policy)
    try:
        rep = P.pr.rebuild_from_peers(base, holders, fetch, **kw)
    except P.ECError as e:
        return ("ECError", str(e).replace(base, "<base>"))
    return dataclasses.asdict(rep)


# ------------------------------------------ tests/test_ec_peer_rebuild.py


def case_bit_identical(P, d):
    base, blobs = synth(d, local=(0, 1))
    calls = []
    rep = run(P, base, {2: ["peerB"], 3: ["peerB"], 4: ["peerB"]},
              serving_fetch(blobs, calls), targets=[5])
    assert rep["rebuilt"] == [5] and shard(base, 5) == blobs[5]
    assert sorted(rep["fetched"]) == [2, 3]  # k - local, lowest ids first
    assert rep["local_sources"] == [0, 1] and not rep["excluded_peers"]
    assert not os.path.exists(P.pr.staging_dir(base))
    for sid in (2, 3, 4):  # sources never published locally
        assert not os.path.exists(base + CTX.to_ext(sid))
    return rep, calls


def case_enough_local_fetches_nothing(P, d):
    base, blobs = synth(d, local=(0, 1, 2, 3))
    calls = []
    rep = run(P, base, ALL_PEERS, serving_fetch(blobs, calls), targets=[4])
    assert rep["rebuilt"] == [4] and not rep["fetched"] and not calls
    assert shard(base, 4) == blobs[4]
    return rep, calls


def case_transient_retries_then_succeeds(P, d):
    base, blobs = synth(d, local=(0, 1))
    state = {"failed": 0}

    def flaky(peer, sid, off, size):
        if (sid, off) not in state:  # first attempt of every (sid, off) dies
            state[(sid, off)] = True
            state["failed"] += 1
            raise P.pr.PeerFetchTransient("connection reset mid-stream")
        return blobs[sid][off : off + size]

    rep = run(P, base, {2: ["peerB"], 3: ["peerB"]}, flaky, targets=[5])
    assert rep["rebuilt"] == [5] and state["failed"] >= 2
    assert not rep["excluded_peers"], "transient failures must not exclude"
    assert shard(base, 5) == blobs[5]
    return rep, state["failed"]


def case_retry_exhaustion_refuses_clean(P, d):
    base, blobs = synth(d, local=(0, 1))

    def dead(peer, sid, off, size):
        raise P.pr.PeerFetchTransient("peer down")

    rep = run(P, base, ALL_PEERS, dead, targets=[5])
    assert rep[0] == "ECError" and "refusing" in rep[1]
    assert not os.path.exists(base + CTX.to_ext(5))
    assert not os.path.exists(P.pr.staging_dir(base))
    for sid in (0, 1):
        assert shard(base, sid) == blobs[sid]
    return rep


def case_corrupt_peer_excluded_and_replanned(P, d):
    base, blobs = synth(d, local=(0, 1))

    def fetch(peer, sid, off, size):
        chunk = blobs[sid][off : off + size]
        if peer == "rotten" and sid == 2:
            return bytes([chunk[0] ^ 0xFF]) + chunk[1:]  # persistent rot
        return chunk

    rep = run(P, base, {2: ["rotten", "clean"], 3: ["clean"]}, fetch, targets=[5])
    assert rep["rebuilt"] == [5] and rep["excluded_peers"] == ["rotten"]
    assert rep["fetched"] == {2: "clean", 3: "clean"}
    assert shard(base, 5) == blobs[5]
    return rep


def case_corrupt_exclusion_below_k_refuses(P, d):
    base, blobs = synth(d, local=(0, 1))

    def rotten(peer, sid, off, size):
        chunk = blobs[sid][off : off + size]
        return bytes([chunk[0] ^ 0x01]) + chunk[1:]

    rep = run(P, base, ALL_PEERS, rotten, targets=[5])
    assert rep[0] == "ECError" and "refusing" in rep[1]
    assert not os.path.exists(base + CTX.to_ext(5))
    assert not os.path.exists(P.pr.staging_dir(base))
    return rep


def case_transient_wire_corruption_rereads(P, d):
    base, blobs = synth(d, local=(0, 1))
    state = {"flipped": False}

    def once_flipped(peer, sid, off, size):
        chunk = blobs[sid][off : off + size]
        if not state["flipped"]:
            state["flipped"] = True
            return bytes([chunk[0] ^ 0x80]) + chunk[1:]
        return chunk

    rep = run(P, base, {2: ["peerB"], 3: ["peerB"]}, once_flipped, targets=[5])
    assert state["flipped"] and rep["rebuilt"] == [5] and not rep["excluded_peers"]
    assert shard(base, 5) == blobs[5]
    return rep


def case_reread_fetches_only_the_bad_granule(P, d):
    base, blobs = synth(d, local=(0, 1))
    calls = []

    def shifty(peer, sid, off, size):
        chunk = blobs[sid][off : off + size]
        if sid == 2:
            calls.append((off, size))
            if len(calls) == 1:  # granule 1 bad
                pos = BLOCK + 7
                return chunk[:pos] + bytes([chunk[pos] ^ 0x80]) + chunk[pos + 1 :]
        return chunk

    rep = run(P, base, {2: ["peerB"], 3: ["peerB"], 4: ["peerB"]}, shifty, targets=[5])
    assert len(calls) == 2 and calls[1] == (BLOCK, BLOCK), calls
    assert rep["rebuilt"] == [5] and not rep["excluded_peers"]
    assert shard(base, 5) == blobs[5]
    return rep, calls


def case_corrupt_local_source_replaced(P, d):
    base, blobs = synth(d, local=(0, 1, 2))
    with open(base + CTX.to_ext(2), "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff")
    rep = run(P, base, {3: ["peerB"], 4: ["peerB"], 5: ["peerB"]}, serving_fetch(blobs),
              targets=[])
    assert rep["corrupt_local"] == [2] and 2 in rep["rebuilt"]
    assert shard(base, 2) == blobs[2]
    return rep


def case_refuses_without_sidecar(P, d):
    base, blobs = synth(d, local=(0, 1))
    os.unlink(base + ".ecsum")
    rep = run(P, base, ALL_PEERS, serving_fetch(blobs), targets=[5])
    assert rep[0] == "ECError" and "ecsum" in rep[1]
    return rep


def case_crash_between_publishes_rerun_converges(P, d):
    base, blobs = synth(d, local=(0, 1))
    with P.faults.injected("ec.peer_rebuild.after_publish", P.faults.crash(),
                           when=P.faults.nth_call(1)):
        with pytest.raises(P.faults.InjectedCrash):
            run(P, base, ALL_PEERS, serving_fetch(blobs), targets=[4, 5])
    published = [sid for sid in (4, 5) if os.path.exists(base + CTX.to_ext(sid))]
    assert len(published) == 1, "crash fired after exactly one publish"
    rep = run(P, base, ALL_PEERS, serving_fetch(blobs), targets=[4, 5])
    assert rep["rebuilt"] == [sid for sid in (4, 5) if sid not in published]
    for sid in (4, 5):
        assert shard(base, sid) == blobs[sid]
    assert not os.path.exists(P.pr.staging_dir(base))
    return rep, published


def case_stale_staging_swept(P, d):
    base, blobs = synth(d, local=(0, 1))
    sdir = P.pr.staging_dir(base)
    os.makedirs(sdir)
    with open(os.path.join(sdir, "1.ec05.fetching"), "wb") as f:
        f.write(b"junk from a crashed run")
    rep = run(P, base, ALL_PEERS, serving_fetch(blobs), targets=[5])
    assert rep["rebuilt"] == [5] and shard(base, 5) == blobs[5]
    assert not os.path.exists(sdir)
    return rep


def case_corrupt_error_carries_context(P, d):
    e = P.pr.PeerCorruptError("p1", 7, 3)
    assert e.peer == "p1" and e.shard == 7 and "granule 3" in str(e)
    return str(e), e.peer, e.shard


# ------------------------- ranged cases of tests/test_ec_leaf_repair.py


def case_ranged_request_shape(P, d):
    base, blobs = synth(d, local=(0, 1, 2), seed=13, leaf=LEAF)
    rot_leaf(base, 2, 2)
    calls = []
    rep = run(P, base, {s: ["peerB"] for s in range(CTX.total)},
              serving_fetch(blobs, calls), targets=[])
    assert rep["leaf_repaired"] == {2: [2]} and shard(base, 2) == blobs[2]
    assert rep["rebuilt"] == [] and not os.path.exists(P.pr.staging_dir(base))
    assert calls and all(off == 2 * LEAF and size == LEAF for _, _, off, size in calls), calls
    assert rep["repair_wire_bytes"] == (CTX.data_shards - 2) * LEAF
    assert rep["repair_wire_bytes"] <= 2 * CTX.data_shards * LEAF
    return rep, calls


def case_ranged_corrupt_peer_excluded(P, d):
    base, blobs = synth(d, local=(0, 1, 2), seed=14, leaf=LEAF)
    rot_leaf(base, 0, 1)

    def fetch(peer, sid, off, size):
        chunk = blobs[sid][off : off + size]
        if peer == "rotten":
            return bytes([chunk[0] ^ 0xFF]) + chunk[1:]
        return chunk

    rep = run(P, base, {s: ["rotten", "clean"] for s in range(CTX.total)}, fetch, targets=[])
    assert rep["leaf_repaired"] == {0: [1]} and rep["excluded_peers"] == ["rotten"]
    assert shard(base, 0) == blobs[0]
    return rep


def case_ranged_then_whole_shard(P, d):
    base, blobs = synth(d, local=(0, 1, 2, 3), seed=15, leaf=LEAF)
    rot_leaf(base, 2, 1)  # leaf-repairable
    os.truncate(base + CTX.to_ext(3), SHARD_SIZE - 100)  # not leaf-repairable
    rep = run(P, base, {s: ["peerB"] for s in range(CTX.total)}, serving_fetch(blobs),
              targets=[])
    assert rep["leaf_repaired"] == {2: [1]} and 3 in rep["rebuilt"]
    assert shard(base, 2) == blobs[2] and shard(base, 3) == blobs[3]
    return rep


def case_ranged_local_read_error_falls_to_peers(P, d):
    base, blobs = synth(d, local=(0, 1, 2), seed=17, leaf=LEAF)
    rot_leaf(base, 2, 1)
    fetched = []

    with P.faults.injected("ec.repair.source_read", P.faults.io_error("flaky local disk")):
        rep = run(P, base, {s: ["peerB"] for s in range(CTX.total)},
                  serving_fetch(blobs, fetched), targets=[])
    assert rep["leaf_repaired"] == {2: [1]} and shard(base, 2) == blobs[2]
    assert {sid for _, sid, _, _ in fetched} >= {0, 1}, fetched
    return rep, fetched


def case_ranged_unreachable_peers_refuse(P, d):
    base, blobs = synth(d, local=(0, 1, 2), seed=16, leaf=LEAF)
    rot_leaf(base, 2, 0)
    pre = shard(base, 2)

    def dead(peer, sid, off, size):
        raise IOError("peer down")

    rep = run(P, base, {s: ["peerB"] for s in range(CTX.total)}, dead, targets=[])
    assert rep[0] == "ECError" and "refusing" in rep[1]
    assert shard(base, 2) == pre
    assert not os.path.exists(journal_path(base + CTX.to_ext(2)))
    return rep


CASES = [
    case_bit_identical,
    case_enough_local_fetches_nothing,
    case_transient_retries_then_succeeds,
    case_retry_exhaustion_refuses_clean,
    case_corrupt_peer_excluded_and_replanned,
    case_corrupt_exclusion_below_k_refuses,
    case_transient_wire_corruption_rereads,
    case_reread_fetches_only_the_bad_granule,
    case_corrupt_local_source_replaced,
    case_refuses_without_sidecar,
    case_crash_between_publishes_rerun_converges,
    case_stale_staging_swept,
    case_corrupt_error_carries_context,
    case_ranged_request_shape,
    case_ranged_corrupt_peer_excluded,
    case_ranged_then_whole_shard,
    case_ranged_local_read_error_falls_to_peers,
    case_ranged_unreachable_peers_refuse,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_peer_rebuild_matches_jax(case, tmp_path):
    """The case's JAX assertions hold in both packages, and the two
    runs agree: what the case returns (reports, refusals, fetch calls)
    and every file left under the volume's directory."""
    got = {}
    for P in (JAX, PORT):
        d = tmp_path / P.name
        got[P.name] = (case(P, d), files(d))
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]


# A child that dies (exit code 137, no `finally` runs) right after the
# first target's publish: it leaves the staging directory behind.
CRASH_CHILD = r"""
import importlib, os, sys
pkg, base, peer_dir = sys.argv[1:4]
faults = importlib.import_module(pkg + ".faults")
ec = importlib.import_module(pkg + ".ec")
ctx = ec.ECContext(4, 2)
if pkg == "seaweedfs_tpu":
    backend = ec.CpuBackend(ctx)
else:
    backend = ec.TorchBackend(ctx, device="cpu")

def fetch(peer, sid, off, size):
    with open(os.path.join(peer_dir, "1") + ctx.to_ext(sid), "rb") as f:
        f.seek(off)
        return f.read(size)

faults.inject("ec.peer_rebuild.after_publish", faults.hard_exit(137))
ec.rebuild_from_peers(base, {s: ["peerB"] for s in range(6)}, fetch, targets=[4, 5],
                      backend=backend)
sys.exit(3)  # the armed point never fired
"""


@pytest.mark.parametrize("crasher,rerunner", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-crash-port-rerun", "port-crash-jax-rerun"])
def test_staging_left_by_a_crash_is_swept_by_the_other_package(tmp_path, crasher, rerunner):
    """A child process of one package dies right after the first
    publish, leaving a `.peerfetch-` staging directory and one published
    target; the other package's rerun sweeps the staging and converges
    to the files a clean run gives."""
    base, blobs = synth(tmp_path / "v", local=(0, 1))
    peer_dir = tmp_path / "peer"
    synth(peer_dir, local=range(CTX.total))
    pkg = "seaweedfs_tpu" if crasher is JAX else "seaweedfs_tpu_torch"
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", CRASH_CHILD, pkg, base, str(peer_dir)],
                          cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 137, proc.stdout + proc.stderr
    sdir = crasher.pr.staging_dir(base)
    assert os.path.isdir(sdir) and os.listdir(sdir), "the crash left no staging"
    assert rerunner.pr.staging_dir(base) == sdir
    published = [sid for sid in (4, 5) if os.path.exists(base + CTX.to_ext(sid))]
    assert len(published) == 1
    rep = run(rerunner, base, ALL_PEERS, serving_fetch(blobs), targets=[4, 5])
    assert rep["rebuilt"] == [sid for sid in (4, 5) if sid not in published]
    assert not os.path.exists(sdir)
    clean, _ = synth(tmp_path / "clean", local=(0, 1))
    run(rerunner, clean, ALL_PEERS, serving_fetch(blobs), targets=[4, 5])
    assert files(tmp_path / "v") == files(tmp_path / "clean")
