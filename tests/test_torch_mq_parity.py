"""PyTorch port: the MQ durable-parity partition (mq/stream_parity.py)
held against the JAX package on the CPU.

Small stripes and a tight lag deadline, as the JAX package's own tests
set them (16 KiB blocks, 4 KiB small blocks, 40 ms), and
SEAWEED_EC_STREAM_BACKEND=cpu: the port's partitions run its native
`CpuBackend`, the JAX package's its own `CpuBackend`.
Checked exactly:

- the record framing and the dense frame scan against the JAX parser;
- a partition fed, flushed and recovered without a broker; rotation and
  prune; a non-dense feed cutting a generation;
- generations written by one package recovered by the other, to the
  same records and the same files;
- a partition killed in a child process at each `ec.stream.*` crash
  window, recovered by both packages to the same dense prefix;
- the knobs the port refuses: backend names it does not know (remote
  roots, once refused, are now parsed as the JAX package parses them),
  and no card with no backend (resolved at the first generation or recovery, as
  the JAX package resolves it).
"""

import pathlib
import shutil
import subprocess
import sys
import threading
import time

import pytest
import torch

from seaweedfs_tpu.mq import log_buffer as jax_log_buffer
from seaweedfs_tpu.mq import stream_parity as jax_sp
from seaweedfs_tpu_torch import faults as port_faults
from seaweedfs_tpu_torch.ec import ECContext, ECError, TorchBackend, recover_stream
from seaweedfs_tpu_torch.ec.stream_encode import load_stream_journal
from seaweedfs_tpu_torch.mq import stream_parity as port_sp

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 60
PKGS = {"port": port_sp, "jax": jax_sp}


@pytest.fixture(autouse=True)
def _small_stripes(monkeypatch):
    monkeypatch.setenv("SEAWEED_EC_STREAM_BLOCK_KB", "16")
    monkeypatch.setenv("SEAWEED_EC_STREAM_SMALL_KB", "4")
    monkeypatch.setenv("SEAWEED_EC_STREAM_MAX_LAG_MS", "40")
    monkeypatch.setenv("SEAWEED_EC_STREAM_BACKEND", "cpu")
    monkeypatch.delenv("SEAWEED_EC_STREAM_REMOTE_ROOTS", raising=False)
    port_faults.clear()
    yield
    port_faults.clear()


def _msg(i: int) -> tuple[bytes, bytes]:
    # ~1 KiB values, as the JAX package's tests: a few hundred records
    # span several 16 KiB-block stripes
    return (b"k%06d" % i, b"value-%06d-" % i + b"x" * (900 + i % 191))


def _records(lo: int, hi: int):
    return [(i, 1_000_000 + i, *_msg(i)) for i in range(lo, hi)]


def _feed(pp, records, flush_every=0):
    for n, (off, ts, k, v) in enumerate(records, 1):
        pp.append_record(off, ts, k, v)
        if flush_every and n % flush_every == 0:
            pp.flush()


def _files(d: pathlib.Path) -> dict[str, bytes]:
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def _gen_numbers(d: pathlib.Path) -> list[int]:
    return sorted({
        int(p.name[len(port_sp.GEN_PREFIX):].split(".", 1)[0])
        for p in d.iterdir() if p.name.startswith(port_sp.GEN_PREFIX)
    })


# ------------------------------------------------------------ framing


def test_encode_record_matches_jax():
    for off, ts, k, v in [(0, 0, b"", b""), (7, -3, b"key", b"v" * 1000), (2**40, 2**62, b"k" * 300, b"")]:
        assert port_sp.encode_record(off, ts, k, v) == jax_log_buffer.encode_record(off, ts, k, v)


def _wire(lo, hi):
    return b"".join(port_sp.encode_record(*r) for r in _records(lo, hi))


# name -> (raw bytes, base offset)
SCANS = {
    "whole": (_wire(0, 20), 0),
    "empty": (b"", 0),
    "torn_header": (_wire(0, 5)[:-1050] + _wire(5, 6)[:10], 0),
    "torn_body": (_wire(0, 6)[:-7], 0),
    "one_byte_short_of_a_header": (_wire(0, 3) + _wire(3, 4)[:21], 0),
    "offset_gap": (_wire(0, 4) + _wire(5, 9), 0),
    "wrong_base": (_wire(10, 15), 9),
    "nonzero_base": (_wire(10, 15), 10),
    "zero_tail": (_wire(0, 4) + b"\0" * 4096, 0),
}


@pytest.mark.parametrize("case", list(SCANS))
def test_dense_frame_scan_and_decode_match_jax(case):
    raw, base = SCANS[case]
    assert port_sp.dense_frame_scan(base)(raw) == jax_sp.dense_frame_scan(base)(raw)
    assert list(port_sp.decode_dense(raw, base)) == list(jax_sp.decode_dense(raw, base))


@pytest.mark.parametrize("spec", ["6+3", "4+2", "bad", "20+20"])
def test_parity_context_matches_jax(monkeypatch, spec):
    monkeypatch.setenv("SEAWEED_EC_STREAM_SHARDS", spec)
    a, b = port_sp.parity_context(), jax_sp.parity_context()
    assert (a.data_shards, a.parity_shards) == (b.data_shards, b.parity_shards)


# ------------------------------------------------------------ partition


def test_partition_direct_recover_roundtrip(tmp_path):
    """PartitionParity without a broker: feed, flush, recover."""
    pp = port_sp.PartitionParity(str(tmp_path), "ns", "t", 0)
    msgs = [(i, 10 + i, *_msg(i)) for i in range(50)]
    _feed(pp, msgs)
    pp.flush()
    pp.close()
    pp2 = port_sp.PartitionParity(str(tmp_path), "ns", "t", 0)
    assert pp2.recover() == msgs
    # recovery leaves the partition on a fresh generation
    pp2.append_record(50, 60, b"k", b"v")
    pp2.flush()
    pp2.close()
    pp3 = port_sp.PartitionParity(str(tmp_path), "ns", "t", 0)
    assert pp3.recover()[-1] == (50, 60, b"k", b"v")
    assert len(_gen_numbers(tmp_path / "ns" / "t" / "0000")) == 2
    pp3.close()


def test_flush_policy_bytes_and_lag(tmp_path):
    pp = port_sp.PartitionParity(str(tmp_path), "ns", "t", 0, flush_bytes=8192)
    assert not pp.needs_flush() and pp.pending_bytes() == 0 and pp.parity_lag_s() == 0.0
    _feed(pp, _records(0, 2))
    assert pp.pending_bytes() > 0 and not pp.needs_flush()
    time.sleep(pp.max_lag_s + 0.01)
    assert pp.needs_flush()  # the lag deadline
    pp.flush()
    assert not pp.needs_flush() and pp.pending_bytes() == 0
    _feed(pp, _records(2, 12))
    assert pp.needs_flush()  # the byte threshold
    pp.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_rotation_and_prune_without_a_broker(tmp_path, monkeypatch, pkg):
    """Generations rotate at the size bound at a flush; prune removes the
    generations wholly below the floor; the rest recovers dense. Both
    packages keep the same generations and records."""
    monkeypatch.setenv("SEAWEED_EC_STREAM_ROTATE_MB", "1")
    sp = PKGS[pkg]
    pp = sp.PartitionParity(str(tmp_path), "ns", "t", 0)
    payload = b"p" * 4096
    recs = [(i, i, b"k%d" % i, payload) for i in range(700)]
    for part in (recs[:350], recs[350:]):
        _feed(pp, part)
        pp.flush()
    d = tmp_path / "ns" / "t" / "0000"
    assert _gen_numbers(d) == [0, 1]
    j1 = load_stream_journal(str(d / "gen-00000001"))
    assert j1.meta == 350  # wave 1 crossed the bound: it rotated at its flush
    assert pp.prune(j1.meta - 1) == 0  # gen 0 still holds records at the floor
    assert pp.prune(j1.meta) == 1
    assert _gen_numbers(d) == [1]
    pp.close()
    got = sp.PartitionParity(str(tmp_path), "ns", "t", 0).recover()
    assert got == recs[j1.meta:]


def test_rotation_matches_jax_generation_boundaries(tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEED_EC_STREAM_ROTATE_MB", "1")
    metas = {}
    for pkg, sp in PKGS.items():
        pp = sp.PartitionParity(str(tmp_path / pkg), "ns", "t", 0)
        _feed(pp, [(i, i, b"k%d" % i, b"p" * 3000) for i in range(1200)], flush_every=40)
        pp.close()
        d = tmp_path / pkg / "ns" / "t" / "0000"
        metas[pkg] = [load_stream_journal(str(d / f"gen-{g:08d}")).meta for g in _gen_numbers(d)]
    assert metas["port"] == metas["jax"] and len(metas["port"]) >= 3


def test_non_dense_feed_cuts_a_generation(tmp_path):
    got = {}
    for pkg, sp in PKGS.items():
        pp = sp.PartitionParity(str(tmp_path / pkg), "ns", "t", 0)
        _feed(pp, _records(0, 10) + _records(20, 30))
        pp.flush()
        pp.close()
        assert _gen_numbers(tmp_path / pkg / "ns" / "t" / "0000") == [0, 1]
        got[pkg] = sp.PartitionParity(str(tmp_path / pkg), "ns", "t", 0).recover()
    # the hole at offset 10 ends the replay in both packages
    assert got["port"] == got["jax"] == _records(0, 10)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_generations_recovered_by_the_other_package(tmp_path, monkeypatch, writer, reader):
    """Rotated generations (one left open, its tail never flushed) are
    recovered by the other package to the writer's own records and
    files."""
    monkeypatch.setenv("SEAWEED_EC_STREAM_ROTATE_MB", "1")
    d = tmp_path / "w"
    pp = PKGS[writer].PartitionParity(str(d), "ns", "t", 0)
    _feed(pp, _records(0, 2500), flush_every=64)
    pp.flush()
    _feed(pp, _records(2500, 2530))  # appended, never flushed: a "crash"
    assert pp.pending_bytes() > 0
    shutil.copytree(d, tmp_path / "own")
    own = PKGS[writer].PartitionParity(str(tmp_path / "own"), "ns", "t", 0).recover()
    theirs = PKGS[reader].PartitionParity(str(d), "ns", "t", 0).recover()
    assert theirs == own and theirs[:2500] == _records(0, 2500) and len(_gen_numbers(d / "ns" / "t" / "0000")) >= 3
    assert _files(d) == _files(tmp_path / "own")
    pp.close()


def test_flush_from_a_second_thread(tmp_path):
    """Records appended on one thread while another flushes every few
    milliseconds, as the broker's flusher does: all of them recover."""
    pp = port_sp.PartitionParity(str(tmp_path), "ns", "t", 0)
    done = threading.Event()
    errors = []

    def flusher():
        try:
            while not done.wait(0.002):
                if pp.needs_flush():
                    pp.flush()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=flusher)
    t.start()
    for n, r in enumerate(_records(0, 400)):
        pp.append_record(*r)
        if n % 16 == 15:
            time.sleep(0.001)
    done.set()
    t.join(timeout=60)
    pp.close()
    assert not errors
    assert port_sp.PartitionParity(str(tmp_path), "ns", "t", 0).recover() == _records(0, 400)


# -------------------------------------------------------------- crashes

_CRASH_CHILD = r"""
import importlib, sys
pkg, root, point, nth, n = sys.argv[1:6]
faults = importlib.import_module(pkg + ".faults")
sp = importlib.import_module(pkg + ".mq.stream_parity")
faults.inject(point, faults.hard_exit(137), when=faults.nth_call(int(nth)))
pp = sp.PartitionParity(root, "default", "t", 0)
for i in range(int(n)):
    key, value = b"k%06d" % i, b"value-%06d-" % i + b"x" * (900 + i % 191)
    pp.append_record(i, 1_000_000 + i, key, value)
    pp.flush()
    print("flushed", i + 1, flush=True)
sys.exit(3)  # the armed point never fired
"""

# point -> the arrival it kills at: the second seal (one 64 KiB stripe
# sealed and flushed before it), the fiftieth flush.
CRASH_POINTS = {"ec.stream.seal": 2, "ec.stream.before_fsync": 50, "ec.stream.before_journal": 50}


@pytest.mark.parametrize("point", list(CRASH_POINTS))
def test_partition_killed_at_each_window_recovers_dense(tmp_path, point):
    """The port's partition is killed in a child at the point; the port
    and the JAX package (on a copy) recover the same dense, byte-exact
    prefix, reaching the last flush the child completed; a second pass
    rewrites no parity; appends continue dense after the tail."""
    root = tmp_path / "parity"
    proc = subprocess.run(
        [sys.executable, "-c", _CRASH_CHILD, "seaweedfs_tpu_torch", str(root), point,
         str(CRASH_POINTS[point]), "300"],
        cwd=str(REPO), capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
    )
    assert proc.returncode == 137, proc.stdout + proc.stderr
    flushed = [int(line.split()[1]) for line in proc.stdout.splitlines() if line.startswith("flushed")]
    assert flushed, proc.stdout
    shutil.copytree(root, tmp_path / "copy")
    recs = port_sp.PartitionParity(str(root), "default", "t", 0).recover()
    assert recs == jax_sp.PartitionParity(str(tmp_path / "copy"), "default", "t", 0).recover()
    assert recs == _records(0, len(recs)) and len(recs) >= flushed[-1]
    d = root / "default" / "t" / "0000"
    ctx, be = ECContext(4, 2), TorchBackend(ECContext(4, 2), device="cpu")
    for g in _gen_numbers(d):
        base = str(d / f"gen-{g:08d}")
        j = load_stream_journal(base)
        again = recover_stream(base, ctx, be, frame_scan=port_sp.dense_frame_scan(j.meta))
        assert again.parity_rewritten == 0
    pp = port_sp.PartitionParity(str(root), "default", "t", 0)
    assert pp.recover() == recs
    pp.append_record(len(recs), 7, b"post", b"crash")
    pp.flush()
    pp.close()
    after = port_sp.PartitionParity(str(root), "default", "t", 0).recover()
    assert after == recs + [(len(recs), 7, b"post", b"crash")]


# ------------------------------------------------------------- refusals


@pytest.mark.parametrize("env,value", [
    ("SEAWEED_EC_STREAM_REMOTE_ROOTS", "far=/mnt/far"),
    ("SEAWEED_EC_STREAM_REMOTE_ROOTS", "peer=net:host:18080"),
    ("SEAWEED_EC_STREAM_BACKEND", "gpu"),
    ("SEAWEED_EC_STREAM_BACKEND", "tpu"),
])
def test_refused_knobs_raise(tmp_path, monkeypatch, env, value):
    """Backend names the port does not know raise before anything is
    made. Remote roots, refused until the port had remote placement, are
    now taken and parsed as the JAX package parses them."""
    monkeypatch.setenv(env, value)
    if env == "SEAWEED_EC_STREAM_REMOTE_ROOTS":
        pp = port_sp.PartitionParity(str(tmp_path), "ns", "t", 0)
        assert pp.remote_roots == jax_sp.remote_roots() == dict([value.split("=", 1)])
        pp.close()
        return
    with pytest.raises(ECError, match="unknown EC backend"):
        port_sp.PartitionParity(str(tmp_path), "ns", "t", 0)
    assert not (tmp_path / "ns").exists()


def test_no_backend_and_no_card_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("SEAWEED_EC_STREAM_BACKEND")  # the default: cuda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the backend is resolved at the first generation or recovery, as in
    # the JAX package: a partition that never takes a record runs
    idle = port_sp.PartitionParity(str(tmp_path), "ns", "t", 0)
    idle.flush()
    assert idle.pending_bytes() == 0 and idle.backend is None
    idle.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sp.PartitionParity(str(tmp_path), "ns", "t", 0).append_record(0, 0, b"k", b"v")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sp.PartitionParity(str(tmp_path), "ns", "t", 0).recover()
    # an explicit CPU backend is the caller's choice, and works
    be = TorchBackend(ECContext(4, 2), device="cpu")
    pp = port_sp.PartitionParity(str(tmp_path), "ns", "t", 0, backend=be)
    _feed(pp, _records(0, 3))
    pp.flush()
    pp.close()
    assert port_sp.PartitionParity(str(tmp_path), "ns", "t", 0, backend=be).recover() == _records(0, 3)


def test_delete_removes_every_generation(tmp_path):
    pp = port_sp.PartitionParity(str(tmp_path), "ns", "t", 0)
    _feed(pp, _records(0, 30))
    pp.flush()
    pp.delete()
    assert not (tmp_path / "ns" / "t" / "0000").exists()
    pp.append_record(30, 0, b"k", b"v")  # closed: ignored
    assert not (tmp_path / "ns" / "t" / "0000").exists()
