"""PyTorch port: crash-safe leaf repair and scrub (ec/repair_journal.py,
ec/scrub.py, the journal recovery at `EcVolume` mount) held against the
JAX package on the CPU.

Sizes are the JAX leaf-repair tests' (RS 4+2, 4 KiB blocks, 1 KiB
leaves, shards of 3 blocks + 57 bytes, so the tail leaf is partial).
The port runs its backend on the CPU (`TorchBackend(device="cpu")`, and
the native `CpuBackend` where an `EcVolume` mounts by the name "cpu"),
the JAX package its `CpuBackend`. Every comparison is exact:

- journal format: each package loads the journal the other wrote, to
  the same bytes, and both call the same torn journals torn;
- cross-recovery: one package's repair is killed in a child process at
  each journal window (and one recovery is killed mid-replay); the
  other recovers the directory it leaves, through
  `recover_volume_journals` and through its own `EcVolume` mount, to
  the shard, sidecar and result of the crashing package's own recovery
  of a copy;
- scrub parity: one damaged volume, copied, is scrubbed by each
  package; every `ScrubReport` field and every file left must agree.
"""

import dataclasses
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from seaweedfs_tpu import faults as jax_faults
from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec import EcVolume as JaxEcVolume
from seaweedfs_tpu.ec import repair_journal as jax_rj
from seaweedfs_tpu.ec.backend import CpuBackend
from seaweedfs_tpu.ec.bitrot import BitrotProtection as JaxBitrotProtection
from seaweedfs_tpu.ec.scrub import scrub_ec_volume as jax_scrub
from seaweedfs_tpu.utils.retry import RetryPolicy as JaxRetryPolicy
from seaweedfs_tpu_torch import faults as port_faults
from seaweedfs_tpu_torch.ec import (
    ECContext,
    ECError,
    EcVolume,
    TorchBackend,
    VolumeInfo,
    get_backend,
    reconstruct_leaves,
    scrub_ec_volume,
)
from seaweedfs_tpu_torch.ec import repair_journal as port_rj
from seaweedfs_tpu_torch.ec.bitrot import BitrotProtection, ShardChecksumBuilder
from seaweedfs_tpu_torch.ec.context import QUARANTINE_SUFFIX
from seaweedfs_tpu_torch.utils.crc import crc32c
from seaweedfs_tpu_torch.utils.retry import RetryPolicy

REPO = pathlib.Path(__file__).resolve().parent.parent
CTX = ECContext(4, 2)
JCTX = JaxECContext(4, 2)
BLOCK = 4096
LEAF = 1024
SHARD_SIZE = 3 * BLOCK + 57  # partial final leaf on purpose
CHILD_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _clear_port_registry():
    port_faults.clear()
    yield
    port_faults.clear()


def synth(d, local=None, seed=0, leaf_size=LEAF) -> dict[int, bytes]:
    """RS-consistent 4+2 shard files in directory `d` as volume 1 (base
    <d>/1), with a sidecar (v2 unless leaf_size is 0), a .vif naming the
    ratio and an empty .ecx, so both packages' `EcVolume` mount it.
    `local` limits which shard files exist. Returns sid -> bytes."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (CTX.data_shards, SHARD_SIZE), dtype=np.uint8)
    be = TorchBackend(CTX, device="cpu")
    shards = np.concatenate([data, be.encode(data)], axis=0)
    blobs = {i: shards[i].tobytes() for i in range(CTX.total)}
    builders = [ShardChecksumBuilder(BLOCK, leaf_size=leaf_size) for _ in range(CTX.total)]
    for i in range(CTX.total):
        builders[i].write(blobs[i])
    os.makedirs(str(d), exist_ok=True)
    base = os.path.join(str(d), "1")
    BitrotProtection.from_builders(CTX, builders, generation=7).save(base + ".ecsum")
    VolumeInfo(ec_ctx=CTX).save(base + ".vif")
    open(base + ".ecx", "wb").close()
    for i in range(CTX.total) if local is None else local:
        with open(base + CTX.to_ext(i), "wb") as f:
            f.write(blobs[i])
    return blobs


def rot(d, sid, leaf, at=11):
    with open(os.path.join(str(d), "1") + CTX.to_ext(sid), "r+b") as f:
        f.seek(leaf * LEAF + at)
        b = f.read(1)
        f.seek(leaf * LEAF + at)
        f.write(bytes([b[0] ^ 0x42]))


def snapshot(d) -> dict[str, bytes]:
    """Every file of the directory, by name (the mount's .ecj and the
    JAX mount's .heat are bookkeeping of the mount itself, left out)."""
    out = {}
    for name in sorted(os.listdir(str(d))):
        if not name.endswith((".ecj", ".heat")):
            with open(os.path.join(str(d), name), "rb") as f:
                out[name] = f.read()
    return out


def _norm(value, d):
    """Paths in a result -> basenames, recursively."""
    if isinstance(value, str):
        return value.replace(str(d) + os.sep, "")
    if isinstance(value, list):
        return [_norm(v, d) for v in value]
    if isinstance(value, dict):
        return {k: _norm(v, d) for k, v in value.items()}
    return value


def _copy(src, dst):
    shutil.copytree(str(src), str(dst))
    return dst


# ------------------------------------------------------- journal format


def _journal(pkg):
    patches = [
        pkg.LeafPatch(3, 3 * LEAF, bytes(range(256)) * 4, 123),
        pkg.LeafPatch(12, 12 * LEAF, b"z" * 57, 9),
    ]
    return pkg.RepairJournal(2, 7, b"u" * 16, LEAF, SHARD_SIZE, patches)


def _fields(j):
    return (j.shard_id, j.generation, j.uuid, j.leaf_size, j.shard_size,
            [(p.leaf, p.offset, p.data, p.crc) for p in j.patches])


def _torn(raw: bytes, how: str) -> bytes:
    if how == "flipped_byte":
        bad = bytearray(raw)
        bad[len(raw) // 2] ^= 0x10
        return bytes(bad)
    if how == "bad_magic":
        return b"XXXX" + raw[4:]
    return raw[: {"prefix_1": 1, "prefix_half": len(raw) // 2, "prefix_minus_1": len(raw) - 1}[how]]


@pytest.mark.parametrize("case", [
    "port_writes_jax_reads", "jax_writes_port_reads", "file_bytes_identical",
    "prefix_1", "prefix_half", "prefix_minus_1", "flipped_byte", "bad_magic",
    "content_changing_patch_flips_sidecar",
])
def test_journal_format_matches_jax(tmp_path, case):
    if case == "port_writes_jax_reads":
        raw = _journal(port_rj).to_bytes()
        assert _fields(jax_rj.RepairJournal.from_bytes(raw)) == _fields(_journal(port_rj))
        assert jax_rj.RepairJournal.from_bytes(raw).to_bytes() == raw
    elif case == "jax_writes_port_reads":
        raw = _journal(jax_rj).to_bytes()
        assert _fields(port_rj.RepairJournal.from_bytes(raw)) == _fields(_journal(jax_rj))
        assert port_rj.RepairJournal.from_bytes(raw).to_bytes() == raw
    elif case == "file_bytes_identical":
        port_rj._write_journal(str(tmp_path / "p.repair"), _journal(port_rj))
        jax_rj._write_journal(str(tmp_path / "j.repair"), _journal(jax_rj))
        assert (tmp_path / "p.repair").read_bytes() == (tmp_path / "j.repair").read_bytes()
    elif case == "content_changing_patch_flips_sidecar":
        # a patch whose CRC differs from the sidecar's row publishes a
        # sidecar (leaf row + re-folded block row), the same in both
        blobs = synth(tmp_path / "port", seed=5)
        _copy(tmp_path / "port", tmp_path / "jax")
        before = (tmp_path / "port" / "1.ecsum").read_bytes()
        new_leaf = bytes(255 - b for b in blobs[0][LEAF : 2 * LEAF])
        for pkg, prot_cls, d in ((port_rj, BitrotProtection, "port"),
                                 (jax_rj, JaxBitrotProtection, "jax")):
            base = str(tmp_path / d / "1")
            patch = pkg.LeafPatch(1, LEAF, new_leaf, crc32c(new_leaf))
            pkg.apply_leaf_repair(base + ".ec00", 0, prot_cls.load(base + ".ecsum"), [patch])
        assert snapshot(tmp_path / "port") == snapshot(tmp_path / "jax")
        assert snapshot(tmp_path / "port")["1.ecsum"] != before
        prot = BitrotProtection.load(str(tmp_path / "port" / "1.ecsum"))
        assert prot.verify_shard_file(str(tmp_path / "port" / "1.ec00"), 0) == []
    else:
        raw = _torn(_journal(port_rj).to_bytes(), case)
        with pytest.raises(port_rj.JournalError):
            port_rj.RepairJournal.from_bytes(raw)
        with pytest.raises(jax_rj.JournalError):
            jax_rj.RepairJournal.from_bytes(raw)


# ------------------------------------------------ cross-package recovery

# Every window of the journal protocol: (point the child dies at, mutate
# point torn at the same seam, whether recovery must roll forward).
WINDOWS = [
    ("ec.repair.journal_write", "ec.repair.journal_bytes", False),
    ("ec.repair.journal_write", None, False),  # bytes usually survive a kill
    ("ec.repair.after_journal", None, True),
    ("ec.repair.patch_write", "ec.repair.patch_bytes", True),
    ("ec.repair.patch_write", None, True),
    ("ec.repair.after_patch", None, True),
    ("ec.repair.after_sidecar", None, True),
]
RECOVERY_CRASH = ("ec.repair.patch_write", None, True)  # recovery itself dies

_CRASH_CHILD = r"""
import importlib, sys
pkg, base, sid, point, mutate_point, mode = sys.argv[1:7]
faults = importlib.import_module(pkg + ".faults")
rj = importlib.import_module(pkg + ".ec.repair_journal")
ctx = importlib.import_module(pkg + ".ec.context").ECContext(4, 2)
faults.inject(point, faults.hard_exit(137))
if mutate_point != "-":
    faults.inject(mutate_point, faults.truncate(0.5))
if mode == "recover":
    rj.recover_volume_journals(base, ctx)
else:
    sid = int(sid)
    prot = importlib.import_module(pkg + ".ec.bitrot").BitrotProtection.load(base + ".ecsum")
    if pkg == "seaweedfs_tpu":
        from seaweedfs_tpu.ec.backend import CpuBackend
        backend = CpuBackend(ctx)
    else:
        from seaweedfs_tpu_torch.ec.backend import TorchBackend
        backend = TorchBackend(ctx, device="cpu")

    def read_range(s, lo, size):
        with open(base + ctx.to_ext(s), "rb") as f:
            f.seek(lo)
            return f.read(size)

    bad = rj.leaf_verdict(base + ctx.to_ext(sid), sid, prot)
    patches = rj.reconstruct_leaves(
        prot, ctx, sid, bad, read_range, [i for i in range(6) if i != sid], backend=backend
    )
    rj.apply_leaf_repair(base + ctx.to_ext(sid), sid, prot, patches)
sys.exit(3)  # the armed point never fired
"""

PKGS = {
    "jax": ("seaweedfs_tpu", jax_rj, JCTX,
            lambda d: JaxEcVolume(str(d), 1, backend_name="cpu")),
    "port": ("seaweedfs_tpu_torch", port_rj, CTX,
             lambda d: EcVolume(str(d), 1, backend="cpu")),
}


def _crash_child(pkg, d, sid, point, mutate_point, mode):
    proc = subprocess.run(
        [sys.executable, "-c", _CRASH_CHILD, PKGS[pkg][0], str(d / "1"), str(sid),
         point, mutate_point or "-", mode],
        cwd=str(REPO), capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
    )
    assert proc.returncode == 137, proc.stdout + proc.stderr


@pytest.mark.parametrize("crasher,other", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize(
    "window", WINDOWS + [RECOVERY_CRASH],
    ids=[f"{w[0]}{'+' + w[1] if w[1] else ''}" for w in WINDOWS] + ["recovery_crash"],
)
def test_crash_recovered_by_either_package(tmp_path, crasher, other, window):
    point, mutate_point, expect_new = window
    recovery_crash = window is RECOVERY_CRASH
    sid, leaf = 2, 1
    crashed = tmp_path / "crashed"
    blobs = synth(crashed, seed=3)
    rot(crashed, sid, leaf)
    pre_repair = (crashed / "1.ec02").read_bytes()
    _, crasher_rj, crasher_ctx, _ = PKGS[crasher]
    if recovery_crash:
        # a valid pending journal that carries the right bytes
        good = blobs[sid][leaf * LEAF : (leaf + 1) * LEAF]
        prot = BitrotProtection.load(str(crashed / "1.ecsum"))
        crasher_rj._write_journal(
            str(crashed / "1.ec02.repair"),
            crasher_rj.RepairJournal(
                sid, prot.generation, prot.uuid, LEAF, SHARD_SIZE,
                [crasher_rj.LeafPatch(leaf, leaf * LEAF, good, crc32c(good))],
            ),
        )
    _crash_child(crasher, crashed, sid, point, mutate_point,
                 "recover" if recovery_crash else "repair")
    assert (crashed / "1.ec02.repair").exists()

    # the crashing package's own recovery of a copy is the reference
    ref_dir = _copy(crashed, tmp_path / "ref")
    want = crasher_rj.recover_volume_journals(str(ref_dir / "1"), crasher_ctx)
    want_files = snapshot(ref_dir)
    # the other package: through recover_volume_journals ...
    rec_dir = _copy(crashed, tmp_path / "rec")
    got = PKGS[other][1].recover_volume_journals(str(rec_dir / "1"), PKGS[other][2])
    assert _norm(got, rec_dir) == _norm(want, ref_dir)
    assert snapshot(rec_dir) == want_files
    # ... and through its own EcVolume mount, before any fd opens
    mount_dir = _copy(crashed, tmp_path / "mount")
    ev = PKGS[other][3](mount_dir)
    try:
        if other == "port":
            assert _norm(ev.journal_recovery, mount_dir) == _norm(want, ref_dir)
    finally:
        ev.close()
    assert snapshot(mount_dir) == want_files

    # fully new or fully old, never a mix; no journal left either way
    assert "1.ec02.repair" not in want_files
    shard = want_files["1.ec02"]
    assert shard in (blobs[sid], pre_repair)
    if expect_new:
        assert shard == blobs[sid] and want["replayed"] == {sid: [leaf]}


def test_port_mount_opens_fds_only_after_recovery(tmp_path, monkeypatch):
    """The replay runs before the first shard fd opens: an fd opened
    earlier would be a view of the shard before its patch."""
    import seaweedfs_tpu_torch.ec.ec_volume as ecv

    blobs = synth(tmp_path, seed=4)
    rot(tmp_path, 0, 1)
    good = blobs[0][LEAF : 2 * LEAF]
    prot = BitrotProtection.load(str(tmp_path / "1.ecsum"))
    port_rj._write_journal(
        str(tmp_path / "1.ec00.repair"),
        port_rj.RepairJournal(0, prot.generation, prot.uuid, LEAF, SHARD_SIZE,
                              [port_rj.LeafPatch(1, LEAF, good, crc32c(good))]),
    )
    order = []
    real_recover, real_open = ecv.recover_volume_journals, os.open

    def recover(*args):
        order.append("recover")
        return real_recover(*args)

    def shard_open(path, flags, *args):
        if flags == os.O_RDONLY and re.search(r"\.ec\d\d$", path):
            order.append("open")
        return real_open(path, flags, *args)

    monkeypatch.setattr(ecv, "recover_volume_journals", recover)
    monkeypatch.setattr(os, "open", shard_open)
    ev = EcVolume(str(tmp_path), 1, backend="cpu")
    try:
        assert order == ["recover"] + ["open"] * CTX.total
        assert ev.journal_recovery == {"replayed": {0: [1]}, "rolled_back": [], "kept": []}
        assert os.pread(ev.shard_fds[0], LEAF, LEAF) == good
    finally:
        ev.close()


# ----------------------------------------------------------- scrub parity

# name -> (damage(dir), synth kwargs, scrub kwargs, passes)
def _stale_journal(d):
    data = b"\x00" * LEAF
    port_rj._write_journal(
        str(d / "1.ec03.repair"),
        port_rj.RepairJournal(3, 999999, b"x" * 16, LEAF, SHARD_SIZE,
                              [port_rj.LeafPatch(0, 0, data, crc32c(data))]),
    )


def _stale_quarantine(d):
    (d / "1.ec01.bad").write_bytes(b"old forensic copy")
    (d / "1.ec01.bad.leaves").write_text(json.dumps({"leaf_size": LEAF, "leaves": [3]}))
    (d / "1.ec04.bad.leaves").write_text(json.dumps({"leaf_size": LEAF, "leaves": [0]}))
    rot(d, 1, 3)


def _pending_journal(d):
    rot(d, 3, 2)
    prot = BitrotProtection.load(str(d / "1.ecsum"))
    with open(str(d / "1.ec03"), "rb") as f:
        good = bytearray(f.read()[2 * LEAF : 3 * LEAF])
    good[11] ^= 0x42  # undo the rot: the journal carries the right bytes
    port_rj._write_journal(
        str(d / "1.ec03.repair"),
        port_rj.RepairJournal(3, prot.generation, prot.uuid, LEAF, SHARD_SIZE,
                              [port_rj.LeafPatch(2, 2 * LEAF, bytes(good), crc32c(bytes(good)))]),
    )


SCRUB_CASES = {
    "data_leaf": (lambda d: (rot(d, 2, 1), rot(d, 2, 12)), {}, {}, 1),
    "parity_leaf": (lambda d: rot(d, 5, 3), {}, {}, 1),
    "rotten_sibling_excluded": (lambda d: (rot(d, 0, 1), rot(d, 5, 1)), {}, {}, 1),
    "fewer_than_k_sources": (lambda d: rot(d, 2, 0), {"local": (0, 1, 2)},
                             {"expected_shards": [0, 1, 2]}, 1),
    "size_rot_quarantined_and_rebuilt": (
        lambda d: os.truncate(str(d / "1.ec03"), SHARD_SIZE - 100), {}, {}, 1),
    "v1_sidecar": (lambda d: rot(d, 4, 2), {"leaf_size": 0}, {}, 1),
    "more_than_parity_refused": (lambda d: (rot(d, 0, 0), rot(d, 1, 5), rot(d, 4, 9)), {}, {}, 1),
    # 5 blocks a slice = 20 of the 78 leaves: the fourth slice completes
    "budget_pause_and_resume": (lambda d: (rot(d, 1, 2), rot(d, 4, 11)), {}, {"max_blocks": 5}, 4),
    "stale_journal_ttl_swept": (_stale_journal, {}, {"journal_ttl_s": 0.0}, 1),
    "bad_age_out": (_stale_quarantine, {}, {"bad_retention_s": 0.0}, 1),
    "pending_journal_replayed": (_pending_journal, {}, {}, 1),
}


def _report(r, d) -> dict:
    return _norm(dataclasses.asdict(r), d)


@pytest.mark.parametrize("case", sorted(SCRUB_CASES))
def test_scrub_matches_jax(tmp_path, case):
    damage, synth_kw, scrub_kw, passes = SCRUB_CASES[case]
    blobs = synth(tmp_path / "seed", seed=11, **synth_kw)
    damage(tmp_path / "seed")
    jdir = _copy(tmp_path / "seed", tmp_path / "jax")
    pdir = _copy(tmp_path / "seed", tmp_path / "port")
    jreports, preports = [], []
    for _ in range(passes):
        jreports.append(_report(jax_scrub(
            str(jdir / "1"), JCTX, backend=CpuBackend(JCTX), repair=True,
            rebuild_policy=JaxRetryPolicy(max_attempts=1), **scrub_kw,
        ), jdir))
        stages: dict = {}
        preports.append(_report(scrub_ec_volume(
            str(pdir / "1"), CTX, backend=TorchBackend(CTX, device="cpu"), repair=True,
            rebuild_policy=RetryPolicy(max_attempts=1), stages=stages, **scrub_kw,
        ), pdir))
        assert preports[-1] == jreports[-1]
        assert snapshot(pdir) == snapshot(jdir)
        if preports[-1]["leaf_repaired"]:
            assert stages["reconstruct"] > 0 and stages["repair_patch"] > 0
    final = preports[-1]
    assert final["complete"]
    if case in ("data_leaf", "parity_leaf", "rotten_sibling_excluded", "bad_age_out",
                "budget_pause_and_resume"):
        assert final["leaf_repaired"] and not final["quarantined"]
    if case == "size_rot_quarantined_and_rebuilt":
        assert final["rebuilt"] == [3] and final["quarantined"] == ["1.ec03" + QUARANTINE_SUFFIX]
    if case == "budget_pause_and_resume":
        assert not preports[0]["complete"]
    if not final["refused"]:
        for i in range(CTX.total):
            assert (pdir / f"1.ec{i:02d}").read_bytes() == blobs[i]
    else:
        assert "refusing" in final["refused"]


# ---------------------------------------------------- fault points, no card


def test_port_rebuild_publish_seams_crash_and_converge(tmp_path):
    """A crash at each rebuild publish seam leaves the old state or
    temps; the next rebuild converges to the same bytes."""
    from seaweedfs_tpu_torch.ec import rebuild_ec_files

    blobs = synth(tmp_path, seed=6)
    be = TorchBackend(CTX, device="cpu")
    for point in ("ec.rebuild.before_fsync", "ec.rebuild.before_rename",
                  "ec.rebuild.after_rename"):
        os.unlink(str(tmp_path / "1.ec01"))
        os.unlink(str(tmp_path / "1.ec04"))
        with port_faults.injected(point, port_faults.crash()) as h:
            with pytest.raises(port_faults.InjectedCrash):
                rebuild_ec_files(str(tmp_path / "1"), CTX, backend=be)
        assert h.fired == 1
        published = [i for i in (1, 4) if (tmp_path / f"1.ec0{i}").exists()]
        assert published == ([1] if point == "ec.rebuild.after_rename" else [])
        for i in published:
            os.unlink(str(tmp_path / f"1.ec0{i}"))
        assert rebuild_ec_files(str(tmp_path / "1"), CTX, backend=be) == [1, 4]
        for i in range(CTX.total):
            assert (tmp_path / f"1.ec0{i}").read_bytes() == blobs[i]


def test_port_shard_read_point_matches_jax(tmp_path):
    """`ec.volume.shard_read` armed in each package with the same seeded
    bit flip gives both mounts the same corrupted bytes."""
    blobs = synth(tmp_path, seed=8)
    got = {}
    for name, F in (("port", port_faults), ("jax", jax_faults)):
        ev = PKGS[name][3](tmp_path)
        try:
            with F.injected("ec.volume.shard_read", F.bit_flip(seed=9, flips=2)):
                flipped = [ev._read_shard_interval(s, 100 * s, 700) for s in range(4)]
            # a failed pread is served by verified reconstruction
            with F.injected("ec.volume.shard_read", F.io_error()):
                healed = ev._read_shard_interval(0, 100, 700)
            got[name] = (flipped, healed)
        finally:
            ev.close()
    assert got["port"] == got["jax"]
    flipped, healed = got["port"]
    assert healed == blobs[0][100:800]
    assert [f != blobs[s][100 * s : 100 * s + 700] for s, f in enumerate(flipped)] == [True] * 4


def test_no_backend_means_the_card(tmp_path, monkeypatch):
    """With no backend, leaf reconstruction and a repairing scrub take
    the card, and raise without one: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    synth(tmp_path, seed=12)
    rot(tmp_path, 2, 1)
    prot = BitrotProtection.load(str(tmp_path / "1.ecsum"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reconstruct_leaves(prot, CTX, 2, [1], lambda s, lo, n: None, [0, 1, 3, 4])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scrub_ec_volume(str(tmp_path / "1"), CTX, repair=True)
    # a verify-only pass needs no backend
    r = scrub_ec_volume(str(tmp_path / "1"), CTX, repair=False)
    assert r.corrupt_leaves == {2: [1]} and not r.leaf_repaired


def test_clean_repairing_scrub_needs_no_card(tmp_path, monkeypatch):
    """A repairing scrub resolves its default backend only where it
    repairs, as the JAX package's does: a clean pass runs without a
    card, and a missing shard's rebuild raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blobs = synth(tmp_path, seed=14)
    r = scrub_ec_volume(str(tmp_path / "1"), CTX, repair=True)
    assert r.healthy and not r.leaf_repaired and not r.rebuilt and not r.refused
    os.unlink(str(tmp_path / "1") + CTX.to_ext(5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scrub_ec_volume(str(tmp_path / "1"), CTX, repair=True)
    assert not os.path.exists(str(tmp_path / "1") + CTX.to_ext(5))
    # the native CPU backend, named, repairs it
    r = scrub_ec_volume(str(tmp_path / "1"), CTX, backend=get_backend("cpu", 4, 2), repair=True)
    assert r.rebuilt == [5]
    assert (tmp_path / "1.ec05").read_bytes() == blobs[5]


def test_reconstruct_leaves_refuses_rotten_sources(tmp_path):
    """Fewer than k verified sources refuses (ECError), and so does a
    reconstruction that fails the target's own leaf CRCs."""
    synth(tmp_path, seed=13)
    prot = BitrotProtection.load(str(tmp_path / "1.ecsum"))
    be = TorchBackend(CTX, device="cpu")
    for s in (0, 1):
        rot(tmp_path, s, 1)

    def read_range(s, lo, size):
        with open(str(tmp_path / "1") + CTX.to_ext(s), "rb") as f:
            f.seek(lo)
            return f.read(size)

    with pytest.raises(ECError, match="verified sibling sources"):
        reconstruct_leaves(prot, CTX, 2, [1], read_range, [0, 1, 3, 4, 5], backend=be)
    with pytest.raises(jax_rj.ECError, match="verified sibling sources"):
        jax_rj.reconstruct_leaves(
            JaxBitrotProtection.load(str(tmp_path / "1.ecsum")), JCTX, 2, [1],
            read_range, [0, 1, 3, 4, 5], backend=CpuBackend(JCTX),
        )
