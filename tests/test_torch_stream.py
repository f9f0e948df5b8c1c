"""PyTorch port: streaming EC (ec/stream_encode.py) held against the JAX
package on the CPU.

The port runs `TorchBackend(ctx, device="cpu")` (the kernel's plain
version), the JAX package its `CpuBackend`; the same seeded bytes go
through both. Every comparison is exact:

- identity: appends of arbitrary sizes through the port's
  `EcStreamEncoder` give shard files and sidecar CRCs byte-identical to
  one JAX `write_ec_files` over the concatenation (10+4 and 4+2; ragged
  tails, exact stripe multiples, small-block-only and empty streams),
  and to the JAX stream fed the same appends;
- the stripe-cursor journal: the same bytes with the same uuid, each
  package loads the other's, both call the same journals torn, and it
  advances only on flush;
- crash windows: a stream killed in a child process of one package at
  each `ec.stream.*` point is recovered by the other to the
  `StreamRecovery` and the files the crashing package's own recovery
  gives on a copy;
- threads: appends and flushes racing on two threads still give the
  batch encode's bytes;
- no backend and no card: the encoder and `recover_stream` raise.
"""

import dataclasses
import os
import pathlib
import random
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec import EcStreamEncoder as JaxStreamEncoder
from seaweedfs_tpu.ec import load_stream_journal as jax_load_journal
from seaweedfs_tpu.ec import recover_stream as jax_recover_stream
from seaweedfs_tpu.ec import write_ec_files as jax_write_ec_files
from seaweedfs_tpu.ec.backend import CpuBackend
from seaweedfs_tpu.ec.stream_encode import StreamJournal as JaxStreamJournal
from seaweedfs_tpu.ec.stream_encode import stream_summary as jax_stream_summary
from seaweedfs_tpu_torch import faults as port_faults
from seaweedfs_tpu_torch.ec import (
    BitrotProtection,
    ECContext,
    ECError,
    EcStreamEncoder,
    StreamJournal,
    TorchBackend,
    load_stream_journal,
    read_stream_data,
    recover_stream,
    stream_summary,
)
from seaweedfs_tpu_torch.ec import stream_encode as port_stream
from seaweedfs_tpu_torch.utils.fs import atomic_write

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 60
# (k, m, block, small): the JAX stream tests' two geometries
GEOMETRIES = {"10+4": (10, 4, 64 * 1024, 4 * 1024), "4+2": (4, 2, 8192, 1024)}


@pytest.fixture(autouse=True)
def _clear_port_registry():
    port_faults.clear()
    yield
    port_faults.clear()


def _payload(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _backends(k, m):
    return TorchBackend(ECContext(k, m), device="cpu"), CpuBackend(JaxECContext(k, m))


def _appends(payload: bytes, seed: int, max_piece: int):
    """The seeded append sequence: (piece, flush after it?)."""
    rng = random.Random(seed)
    pos = 0
    while pos < len(payload):
        n = rng.randrange(1, max_piece)
        yield payload[pos : pos + n], rng.random() < 0.3
        pos += n


def _stream(cls, base, ctx, backend, payload, block, small, seed=1, finalize=True):
    enc = cls(base, ctx, backend=backend, block_size=block, small_block_size=small)
    for piece, flush in _appends(payload, seed, max(block * 3 // 4, 2)):
        enc.append(piece)
        if flush:
            enc.flush()
    return enc.close(finalize=finalize)


def _jax_batch(base, payload, k, m, block, small):
    with open(base + ".dat", "wb") as f:
        f.write(payload)
    ctx = JaxECContext(k, m)
    return jax_write_ec_files(
        base, ctx, CpuBackend(ctx), large_block_size=block, small_block_size=small
    )


def _assert_identical(b1, b2, total, prot1, prot2):
    for i in range(total):
        ext = f".ec{i:02d}"
        a = pathlib.Path(b1 + ext).read_bytes()
        b = pathlib.Path(b2 + ext).read_bytes()
        assert a == b, f"shard {i} differs ({len(a)} vs {len(b)} bytes)"
    assert prot1.shard_sizes == prot2.shard_sizes
    assert prot1.shard_crcs == prot2.shard_crcs
    assert prot1.shard_leaf_crcs == prot2.shard_leaf_crcs


def _stream_totals(block, small, k):
    stripe = block * k
    return {
        "ragged": 3 * stripe + 12345,
        "exact_stripes": 2 * stripe,
        "small_only": 3 * k * small,
        "sub_small_row": 100,
        "stripes_small_ragged": 2 * stripe + 4 * k * small + 7,
        "empty": 0,
    }


# ------------------------------------------------------------- identity


@pytest.mark.parametrize("shape", list(_stream_totals(1, 1, 1)))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_port_stream_matches_jax_batch_encode(tmp_path, geometry, shape):
    k, m, block, small = GEOMETRIES[geometry]
    payload = _payload(_stream_totals(block, small, k)[shape], seed=len(shape))
    port_be, _ = _backends(k, m)
    p1 = _stream(EcStreamEncoder, str(tmp_path / "s"), ECContext(k, m), port_be,
                 payload, block, small)
    p2 = _jax_batch(str(tmp_path / "b"), payload, k, m, block, small)
    _assert_identical(str(tmp_path / "s"), str(tmp_path / "b"), k + m, p1, p2)
    # finalize retires the journal: the artifact is a sealed EC layout
    assert load_stream_journal(str(tmp_path / "s")) is None
    assert os.path.exists(str(tmp_path / "s") + ".ecsum")


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_port_stream_matches_jax_stream(tmp_path, geometry):
    """The same appends and flushes through both packages' encoders:
    shards identical, and the `.ecsum` files equal but for their uuid."""
    k, m, block, small = GEOMETRIES[geometry]
    port_be, jax_be = _backends(k, m)
    payload = _payload(2 * block * k + 3 * small + 11, seed=5)
    p1 = _stream(EcStreamEncoder, str(tmp_path / "port"), ECContext(k, m), port_be,
                 payload, block, small, seed=7)
    p2 = _stream(JaxStreamEncoder, str(tmp_path / "jax"), JaxECContext(k, m), jax_be,
                 payload, block, small, seed=7)
    _assert_identical(str(tmp_path / "port"), str(tmp_path / "jax"), k + m, p1, p2)
    a = BitrotProtection.load(str(tmp_path / "port") + ".ecsum")
    b = BitrotProtection.load(str(tmp_path / "jax") + ".ecsum")
    a.uuid = b.uuid
    assert a.to_bytes() == b.to_bytes()


def test_append_and_flush_race_on_two_threads(tmp_path):
    """A publisher thread appends while a flusher thread flushes in a
    loop; the closed stream still equals the batch encode."""
    k, m, block, small = GEOMETRIES["4+2"]
    port_be, _ = _backends(k, m)
    payload = _payload(9 * block * k + 777, seed=21)
    enc = EcStreamEncoder(str(tmp_path / "s"), ECContext(k, m), backend=port_be,
                          block_size=block, small_block_size=small)
    done = threading.Event()
    errors = []
    flushes = [0]

    def publisher():
        try:
            for n, (piece, _) in enumerate(_appends(payload, 3, 3000)):
                enc.append(piece)
                if n % 8 == 7:
                    time.sleep(0.001)  # let the flusher in between appends
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            done.set()

    def flusher():
        try:
            while not done.is_set():
                enc.flush()
                flushes[0] += 1
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=flusher), threading.Thread(target=publisher)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: more interleavings
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and flushes[0] > 1
    p1 = enc.close()
    p2 = _jax_batch(str(tmp_path / "b"), payload, k, m, block, small)
    _assert_identical(str(tmp_path / "s"), str(tmp_path / "b"), k + m, p1, p2)


# -------------------------------------------------------------- journal


def _journal_fields(j):
    return dataclasses.astuple(j)


def test_journal_bytes_identical_with_a_fixed_uuid(tmp_path):
    k, m, block, small = GEOMETRIES["4+2"]
    port_be, jax_be = _backends(k, m)
    fields = dict(uuid=b"u" * 16, meta=77, durable=1234, sealed=2, head=2222,
                  block_size=block, small_block_size=small, data_shards=k, parity_shards=m)
    assert StreamJournal(**fields).to_bytes() == JaxStreamJournal(**fields).to_bytes()
    # the encoders' journals, flush by flush
    encs = {
        "port": EcStreamEncoder(str(tmp_path / "port"), ECContext(k, m), backend=port_be,
                                block_size=block, small_block_size=small, meta=5),
        "jax": JaxStreamEncoder(str(tmp_path / "jax"), JaxECContext(k, m), backend=jax_be,
                                block_size=block, small_block_size=small, meta=5),
    }
    payload = _payload(3 * block * k + 99, seed=2)
    for enc in encs.values():
        enc.uuid = b"F" * 16
    for piece, flush in _appends(payload, 4, 5000):
        for enc in encs.values():
            enc.append(piece)
            if flush:
                enc.flush()
        if flush:
            assert (tmp_path / "port.stream").read_bytes() == (tmp_path / "jax.stream").read_bytes()
    for enc in encs.values():
        enc.close(finalize=False)
    assert (tmp_path / "port.stream").read_bytes() == (tmp_path / "jax.stream").read_bytes()
    assert load_stream_journal(str(tmp_path / "port")).durable == len(payload)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_loads_in_the_other_package(tmp_path, writer):
    fields = dict(uuid=bytes(range(16)), meta=2**40 + 3, durable=10**9, sealed=95,
                  head=10**9 + 17, block_size=1 << 20, small_block_size=64 << 10,
                  data_shards=10, parity_shards=4)
    cls, load = (
        (StreamJournal, jax_load_journal) if writer == "port" else (JaxStreamJournal, load_stream_journal)
    )
    base = str(tmp_path / "j")
    atomic_write(base + ".stream", cls(**fields).to_bytes())
    assert dataclasses.asdict(load(base)) == fields


@pytest.mark.parametrize("tear", ["flipped_byte", "short", "absent", "bad_magic"])
def test_torn_journal_is_none_in_both(tmp_path, tear):
    base = str(tmp_path / "j")
    raw = bytearray(StreamJournal(uuid=b"u" * 16, meta=1, durable=2, sealed=0, head=3,
                                  block_size=8192, small_block_size=1024,
                                  data_shards=4, parity_shards=2).to_bytes())
    if tear == "flipped_byte":
        raw[7] ^= 0xFF
    elif tear == "short":
        raw = raw[:10]
    elif tear == "bad_magic":
        raw[0] ^= 0x01
        from seaweedfs_tpu_torch.utils.crc import crc32c

        raw[-4:] = crc32c(bytes(raw[:-4])).to_bytes(4, "little")
    if tear != "absent":
        (tmp_path / "j.stream").write_bytes(bytes(raw))
    assert load_stream_journal(base) is None
    assert jax_load_journal(base) is None


def test_journal_advances_only_on_flush(tmp_path):
    base = str(tmp_path / "s")
    port_be, _ = _backends(4, 2)
    enc = EcStreamEncoder(base, ECContext(4, 2), backend=port_be,
                          block_size=8192, small_block_size=1024)
    enc.append(b"x" * 5000)
    assert load_stream_journal(base).durable == 0  # appended, not durable
    assert enc.pending_bytes == 5000
    enc.flush()
    j = load_stream_journal(base)
    assert (j.durable, j.head, j.meta) == (5000, 5000, 0)
    assert jax_load_journal(base).durable == 5000
    enc.close(finalize=False)
    # a non-finalized close keeps the journal (broker rotation)
    assert load_stream_journal(base) is not None


# ------------------------------------------------------------- recovery


def _recovery_fields(rec):
    return (dataclasses.astuple(rec.journal), rec.head, rec.data, rec.parity_rewritten,
            rec.rolled_back)


def _files(d: pathlib.Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _recover(pkg, base, k, m, frame_scan=None):
    port_be, jax_be = _backends(k, m)
    if pkg == "port":
        return recover_stream(base, ECContext(k, m), port_be, frame_scan=frame_scan)
    return jax_recover_stream(base, JaxECContext(k, m), jax_be, frame_scan=frame_scan)


def test_recovery_rewrites_unflushed_parity_like_jax(tmp_path):
    """Data processed but never flushed (parity only in memory) is
    recovered from the data, its parity re-derived: both packages give
    the same recovery and leave the same files."""
    payload = _payload(100_000, seed=9)
    for pkg, cls in (("port", EcStreamEncoder), ("jax", JaxStreamEncoder)):
        d = tmp_path / pkg
        d.mkdir()
        port_be, jax_be = _backends(4, 2)
        ctx = ECContext(4, 2) if pkg == "port" else JaxECContext(4, 2)
        enc = cls(str(d / "s"), ctx, backend=port_be if pkg == "port" else jax_be,
                  block_size=8192, small_block_size=1024)
        enc.uuid = b"R" * 16
        enc.append(payload[:60_000])
        enc.flush()
        enc.append(payload[60_000:])
        enc.process()  # data pwritten, parity in memory only; then "crash"
        for fd in enc._fds:
            os.close(fd)
        enc._fds = []
        enc.closed = True
    for pkg in ("port", "jax"):
        shutil.copytree(tmp_path / pkg, tmp_path / f"{pkg}-by-other")
    recs = {
        "port": _recover("port", str(tmp_path / "port" / "s"), 4, 2),
        "port-by-other": _recover("jax", str(tmp_path / "port-by-other" / "s"), 4, 2),
        "jax": _recover("jax", str(tmp_path / "jax" / "s"), 4, 2),
        "jax-by-other": _recover("port", str(tmp_path / "jax-by-other" / "s"), 4, 2),
    }
    want = _recovery_fields(recs["jax"])
    assert recs["port"].head >= 60_000 and recs["port"].parity_rewritten >= 1
    assert recs["port"].data == payload[: recs["port"].head]
    for name, rec in recs.items():
        assert _recovery_fields(rec) == want, name
        assert _files(tmp_path / name) == _files(tmp_path / "jax"), name
    # idempotent: a second pass verifies clean
    rec2 = _recover("port", str(tmp_path / "port" / "s"), 4, 2)
    assert rec2.head == recs["port"].head and rec2.parity_rewritten == 0
    assert read_stream_data(str(tmp_path / "port" / "s"), ECContext(4, 2), 8192, 0,
                            rec2.head) == rec2.data


def test_recovery_rolls_back_past_frame_scan_like_jax(tmp_path):
    payload = _payload(50_000, seed=11)
    port_be, _ = _backends(4, 2)
    base = str(tmp_path / "port" / "s")
    os.makedirs(os.path.dirname(base))
    enc = EcStreamEncoder(base, ECContext(4, 2), backend=port_be,
                          block_size=8192, small_block_size=1024)
    enc.append(payload)
    enc.flush()
    enc.close(finalize=False)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    cut = 30_000
    scan = lambda raw: min(len(raw), cut)  # noqa: E731
    a = _recover("port", base, 4, 2, frame_scan=scan)
    b = _recover("jax", str(tmp_path / "jax" / "s"), 4, 2, frame_scan=scan)
    assert _recovery_fields(a) == _recovery_fields(b)
    assert (a.head, a.data, a.rolled_back) == (cut, payload[:cut], 50_000 - cut)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    rec2 = _recover("port", base, 4, 2)
    assert rec2.head == cut and rec2.parity_rewritten == 0


def test_recovery_without_journal_recovers_nothing(tmp_path):
    base = str(tmp_path / "s")
    port_be, _ = _backends(4, 2)
    enc = EcStreamEncoder(base, ECContext(4, 2), backend=port_be,
                          block_size=8192, small_block_size=1024)
    enc.append(b"y" * 10_000)
    enc.flush()
    enc.close(finalize=False)
    os.unlink(base + ".stream")
    before = stream_summary()["recovered"].get("no_journal", 0)
    assert recover_stream(base, ECContext(4, 2), port_be) is None
    assert stream_summary()["recovered"]["no_journal"] == before + 1


# A stream killed at an `ec.stream.*` point in a child of either package:
# 4+2, 8 KiB blocks, 1 KiB small blocks, one flush per append.
_CRASH_CHILD = r"""
import importlib, sys
import numpy as np
pkg, base, point, nth = sys.argv[1:5]
faults = importlib.import_module(pkg + ".faults")
se = importlib.import_module(pkg + ".ec.stream_encode")
ctx = importlib.import_module(pkg + ".ec.context").ECContext(4, 2)
if pkg == "seaweedfs_tpu":
    from seaweedfs_tpu.ec.backend import CpuBackend
    backend = CpuBackend(ctx)
else:
    from seaweedfs_tpu_torch.ec.backend import TorchBackend
    backend = TorchBackend(ctx, device="cpu")
faults.inject(point, faults.hard_exit(137), when=faults.nth_call(int(nth)))
enc = se.EcStreamEncoder(base, ctx, backend=backend, block_size=8192, small_block_size=1024)
enc.uuid = b"C" * 16
payload = np.random.default_rng(31).integers(0, 256, 100_000, dtype=np.uint8).tobytes()
for pos in range(0, len(payload), 7000):
    enc.append(payload[pos : pos + 7000])
    enc.flush()
enc.close()
sys.exit(3)  # the armed point never fired
"""

# point -> the arrival it kills at: the second seal (one stripe sealed
# and flushed before it), the third flush, the finalize.
CRASH_POINTS = {
    "ec.stream.seal": 2,
    "ec.stream.before_fsync": 3,
    "ec.stream.before_journal": 3,
    "ec.stream.before_seal_publish": 1,
}
PKG_NAMES = {"port": "seaweedfs_tpu_torch", "jax": "seaweedfs_tpu"}


@pytest.mark.parametrize("crasher,other", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("point", list(CRASH_POINTS))
def test_crash_window_recovered_by_the_other_package(tmp_path, point, crasher, other):
    crashed = tmp_path / "crashed"
    crashed.mkdir()
    proc = subprocess.run(
        [sys.executable, "-c", _CRASH_CHILD, PKG_NAMES[crasher], str(crashed / "s"), point,
         str(CRASH_POINTS[point])],
        cwd=str(REPO), capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
    )
    assert proc.returncode == 137, proc.stdout + proc.stderr
    assert load_stream_journal(str(crashed / "s")) is not None
    shutil.copytree(crashed, tmp_path / "own")
    own = _recover(crasher, str(tmp_path / "own" / "s"), 4, 2)
    theirs = _recover(other, str(crashed / "s"), 4, 2)
    assert own is not None and _recovery_fields(theirs) == _recovery_fields(own)
    assert _files(crashed) == _files(tmp_path / "own")
    if point != "ec.stream.before_seal_publish":
        # the large layout's bytes come back: a prefix of what was written
        payload = _payload_31()
        assert theirs.data == payload[: theirs.head] and theirs.head >= theirs.journal.durable
    again = _recover(other, str(crashed / "s"), 4, 2)
    assert again.parity_rewritten == 0 and again.head == theirs.head


def _payload_31() -> bytes:
    return np.random.default_rng(31).integers(0, 256, 100_000, dtype=np.uint8).tobytes()


# ---------------------------------------------------- lag + observability


def test_stream_summary_has_the_jax_keys(tmp_path):
    port_be, jax_be = _backends(4, 2)
    a = EcStreamEncoder(str(tmp_path / "p"), ECContext(4, 2), backend=port_be,
                        block_size=8192, small_block_size=1024)
    b = JaxStreamEncoder(str(tmp_path / "j"), JaxECContext(4, 2), backend=jax_be,
                         block_size=8192, small_block_size=1024)
    for enc in (a, b):
        enc.append(b"z" * 20_000)
        enc.flush()
    ours, theirs = stream_summary(), jax_stream_summary()
    assert set(ours) == set(theirs)
    mine = next(s for s in ours["streams"] if s["base"] == "p")
    other = next(s for s in theirs["streams"] if s["base"] == "j")
    assert set(mine) == set(other)
    assert (mine["head_bytes"], mine["durable_bytes"], mine["sealed_stripes"]) == (20_000, 20_000, 0)
    # a backend that is no pool chip has no chip label in either package;
    # a pool's chip names itself
    assert mine["chip"] == other["chip"] == ""
    a.close()
    b.close()
    from seaweedfs_tpu_torch.ec.chip_pool import ChipBackend

    c = EcStreamEncoder(str(tmp_path / "c"), ECContext(4, 2), backend=ChipBackend(ECContext(4, 2), "cpu"),
                        block_size=8192, small_block_size=1024)
    assert next(s for s in stream_summary()["streams"] if s["base"] == "c")["chip"] == "cpu"
    c.close()
    assert all(s["base"] != "p" for s in stream_summary()["streams"])


def test_parity_lag_and_counters(tmp_path):
    port_be, _ = _backends(4, 2)
    enc = EcStreamEncoder(str(tmp_path / "s"), ECContext(4, 2), backend=port_be,
                          block_size=8192, small_block_size=1024)
    assert enc.parity_lag_s() == 0.0
    def lag_count():  # observations in the registry's sw_ec_stream_parity_lag_seconds
        return sum(t for _c, t, _s in port_stream.parity_lag.snapshot().values())

    before = lag_count()
    summary0 = stream_summary()
    enc.append(b"z" * 1000)
    enc.append(b"z" * 40_000)
    assert enc.parity_lag_s() > 0.0  # the oldest un-durable append ages
    enc.flush()
    assert enc.parity_lag_s() == 0.0
    assert lag_count() == before + 2  # two appends
    summary1 = stream_summary()
    assert summary1["appended_bytes"] - summary0["appended_bytes"] == 41_000
    assert summary1["stripes_sealed"] - summary0["stripes_sealed"] == 1  # 32 KiB stripes
    assert enc.stage_seconds["parity_update"] > 0 and set(enc.stage_seconds) == set(port_stream.STAGES)
    enc.close()


def test_append_after_close_refused(tmp_path):
    port_be, _ = _backends(4, 2)
    enc = EcStreamEncoder(str(tmp_path / "s"), ECContext(4, 2), backend=port_be,
                          block_size=8192, small_block_size=1024)
    enc.append(b"a")
    enc.close()
    with pytest.raises(ECError):
        enc.append(b"b")
    assert enc.close() is None  # idempotent


def test_small_block_larger_than_block_refused(tmp_path):
    port_be, _ = _backends(4, 2)
    with pytest.raises(ECError):
        EcStreamEncoder(str(tmp_path / "s"), ECContext(4, 2), backend=port_be,
                        block_size=1024, small_block_size=8192)


def test_no_backend_and_no_card_raises(tmp_path, monkeypatch):
    """With no backend the encoder and recovery take the card, and raise
    where there is none; nothing falls back to the CPU."""
    base = str(tmp_path / "s")
    port_be, _ = _backends(4, 2)
    enc = EcStreamEncoder(base, ECContext(4, 2), backend=port_be,
                          block_size=8192, small_block_size=1024)
    enc.append(b"q" * 9000)
    enc.flush()
    enc.close(finalize=False)
    before = _files(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EcStreamEncoder(str(tmp_path / "other"), ECContext(4, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recover_stream(base, ECContext(4, 2))
    assert _files(tmp_path) == before  # nothing created, nothing touched
