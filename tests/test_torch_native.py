"""PyTorch port: the native host byte plane (csrc/seaweed_native.cpp,
utils/native.py, ec/native_io.py, FusedShardSink), held against the JAX
package on the CPU.

The port's host library builds with g++ here as on the card. Each test
runs the same seeded numpy data through the port and the JAX package:
encode through the port's native plane must give the same 14 shards and
the same block and leaf CRC lists as the JAX package's native and Python
planes and the port's own Python plane (SEAWEED_EC_NATIVE=0); rebuild,
decode and degraded reads likewise, with a rotten or short source
excluded exactly as the JAX package excludes it. The sink, the batched
read and the pool are held against their Python twins (ShardChecksumBuilder,
_BlockCrcRoller) and the JAX package's native ones. Tolerance 0
throughout. A failure to build or load the library must raise, never
turn the plane off.
"""

import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import CpuBackend
from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec import EcVolume as JaxEcVolume
from seaweedfs_tpu.ec import native_io as jax_native_io
from seaweedfs_tpu.ec import rebuild_ec_files as jax_rebuild_ec_files
from seaweedfs_tpu.ec.context import ECError as JaxECError
from seaweedfs_tpu.ec import write_ec_files as jax_write_ec_files
from seaweedfs_tpu.ec.decoder import ec_decode_volume as jax_ec_decode_volume
from seaweedfs_tpu.ec.pipeline import FusedShardSink as JaxFusedShardSink
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu.utils import crc as jax_crc
from seaweedfs_tpu.utils import native as jax_native
import seaweedfs_tpu_torch.ec.rebuild as port_rebuild
from seaweedfs_tpu_torch import faults as port_faults
from seaweedfs_tpu_torch.ec import (
    ECContext,
    ECError,
    EcVolume,
    FusedShardSink,
    PyShardSink,
    TorchBackend,
    ec_decode_volume,
    ec_encode_volume,
    make_shard_sink,
    native_io,
    rebuild_ec_files,
    write_ec_files,
)
from seaweedfs_tpu_torch.ec.bitrot import ShardChecksumBuilder
from seaweedfs_tpu_torch.ec.decoder import record_actual_size
from seaweedfs_tpu_torch.ec.encoder import batch_plan
from seaweedfs_tpu_torch.ec.locate import locate_data
from seaweedfs_tpu_torch.ec.rebuild import _BlockCrcRoller
from seaweedfs_tpu_torch.storage.types import actual_offset
from seaweedfs_tpu_torch.ops import _build
from seaweedfs_tpu_torch.utils import crc as port_crc
from seaweedfs_tpu_torch.utils import native as port_native

# One intra-op thread: the products here are small, and the suite runs in
# several worker processes at once.
torch.set_num_threads(1)

CTX = ECContext(10, 4)
JCTX = JaxECContext(10, 4)
SIZES = dict(large_block_size=65536, small_block_size=4096)
ROW = 10 * 65536  # one large row of the test layout


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
    """Native plane on, the port's fault registry disarmed, counts at 0."""
    monkeypatch.delenv("SEAWEED_EC_NATIVE", raising=False)
    port_faults.clear()
    native_io.reset_counts()
    yield
    port_faults.clear()


def _dat(d, nbytes: int, seed: int = 7) -> str:
    os.makedirs(str(d), exist_ok=True)
    base = os.path.join(str(d), "1")
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())
    return base


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _shards(base: str) -> list[bytes]:
    return [_read(base + CTX.to_ext(i)) for i in range(CTX.total)]


def _prot_lists(prot) -> tuple:
    return prot.shard_sizes, prot.shard_crcs, prot.leaf_size, prot.shard_leaf_crcs


def _port_cpu() -> TorchBackend:
    return TorchBackend(CTX, device="cpu")


# ------------------------------------------------------------- host library


def test_crc32c_and_combine_match_jax_and_python():
    rng = np.random.default_rng(1)
    buf = rng.integers(0, 256, 70_000, dtype=np.uint8)
    for lo, hi in ((0, 0), (0, 1), (3, 11), (5, 65536 + 9), (1, 70_000)):
        part = buf[lo:hi]  # unaligned starts take the byte-wise head
        assert port_native.crc32c(part) == jax_native.crc32c(part.tobytes())
        assert port_crc.crc32c(part, 0xDEADBEEF) == jax_crc.crc32c(part.tobytes(), 0xDEADBEEF)
    for n in (1, 7, 4096, 65536, 1 << 20):
        a, b = int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32))
        want = port_crc.crc32c_combine(a, b, n)
        assert port_native.crc32c_combine(a, b, n) == want == jax_native.crc32c_combine(a, b, n)
    assert port_native.crc32c_combine(5, 9, 0) == 5


@pytest.mark.parametrize("fault", ["build", "load"])
def test_host_library_failure_raises_and_does_not_fall_back(tmp_path, monkeypatch, fault):
    """A source that does not compile, or a library that does not load,
    raises at the first call that needs it: crc32c, the sink and encode
    all fail, and the plane stays enabled (no quiet Python fallback)."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_loaded", {})
    src = csrc / "seaweed_native.cpp"
    if fault == "build":
        src.write_text("#error this source does not compile\n")
        expect = RuntimeError
    else:
        src.write_text((_build.PKG_DIR / "csrc" / "seaweed_native.cpp").read_text())
        _build._command("seaweed_native")[1].write_bytes(b"not a shared library")
        expect = OSError
    with pytest.raises(expect):
        port_crc.crc32c(b"123456789")
    with open(tmp_path / "s0", "wb", buffering=0) as f:
        with pytest.raises(expect):
            make_shard_sink([f])
    base = _dat(tmp_path / "v", 3000)
    with pytest.raises(expect):
        write_ec_files(base, CTX, _port_cpu(), **SIZES)
    assert native_io.enabled()


# ------------------------------------------------------------------- encode


# (volume bytes, batch size): two large rows, small rows and a ragged
# tail, cut into batches that end mid-leaf; large rows only; the
# small-block phase only with a tail mid-row; one byte.
ENCODE_CASES = {
    "large_small_ragged": (2 * ROW + 3 * 40960 + 12345, 20000),
    "large_only": (2 * ROW, 1 << 20),
    "small_only_ragged": (2 * 40960 + 5, 3000),
    "one_byte": (1, 1 << 20),
}


@pytest.mark.parametrize("leaf_size", [0, 65536, 1024])
@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_native_matches_jax_native_and_both_python_planes(tmp_path, monkeypatch, case, leaf_size):
    assert jax_native_io.enabled()
    nbytes, batch = ENCODE_CASES[case]
    runs = {}
    for who in ("port_native", "port_python", "jax_native", "jax_python"):
        base = _dat(tmp_path / who, nbytes)
        monkeypatch.setenv("SEAWEED_EC_NATIVE", "0" if who.endswith("python") else "1")
        native_io.reset_counts()
        if who.startswith("port"):
            prot = write_ec_files(base, CTX, _port_cpu(), batch_size=batch, leaf_size=leaf_size, **SIZES)
        else:
            prot = jax_write_ec_files(
                base, JCTX, CpuBackend(JCTX), batch_size=batch, leaf_size=leaf_size, **SIZES
            )
        runs[who] = (_shards(base), _prot_lists(prot), dict(native_io.COUNTS))
    batches = len(list(batch_plan(nbytes, 10, batch, SIZES["large_block_size"], SIZES["small_block_size"])))
    assert runs["port_native"][2]["read_batch"] == runs["port_native"][2]["sink_append"] == batches
    assert not any(runs["port_python"][2].values())
    want = runs["jax_python"][:2]
    for who in ("port_native", "port_python", "jax_native"):
        assert runs[who][:2] == want, who
    assert want[1][2] == leaf_size


def test_encode_output_does_not_depend_on_the_pool_or_file_positions(tmp_path):
    """A second encode in the same process (pooled matrices recycled
    across batches of equal width) gives the same shards and CRCs, and
    the shard files are whole although the sink never moved their file
    positions."""
    nbytes, batch = ENCODE_CASES["large_small_ragged"]
    plan = batch_plan(nbytes, 10, batch, SIZES["large_block_size"], SIZES["small_block_size"])
    widths = {w for *_, w in plan}
    out = []
    for who in ("a", "b"):
        base = _dat(tmp_path / who, nbytes)
        prot = write_ec_files(base, CTX, _port_cpu(), batch_size=batch, **SIZES)
        out.append((_shards(base), _prot_lists(prot)))
        assert [len(s) for s in out[-1][0]] == prot.shard_sizes
    assert out[0] == out[1]
    # each run's pool holds at most the pipeline's in-flight cap (2 queues
    # of 2, one batch per stage) per width
    assert 0 < native_io.COUNTS["pool_alloc"] <= 2 * 7 * len(widths)


# ------------------------------------------------------------------ rebuild


@pytest.fixture(scope="module")
def encoded_dir(tmp_path_factory):
    """A 10+4 volume of seeded bytes (two large rows, small rows, a ragged
    tail) encoded by the port with a v2 sidecar."""
    d = tmp_path_factory.mktemp("enc")
    base = _dat(d, 2 * ROW + 3 * 40960 + 777, seed=11)
    prot = write_ec_files(base, CTX, _port_cpu(), **SIZES)
    prot.save(base + ".ecsum")
    return str(d)


def _copy_dir(src: str, dst) -> str:
    shutil.copytree(src, str(dst))
    return os.path.join(str(dst), "1")


@pytest.mark.parametrize("lost", [(1,), (3, 11), (0, 12, 13)])
def test_rebuild_native_matches_python_and_jax(encoded_dir, tmp_path, monkeypatch, lost):
    originals = _shards(os.path.join(encoded_dir, "1"))
    for who in ("port_native", "port_python", "jax_native", "jax_python"):
        base = _copy_dir(encoded_dir, tmp_path / who)
        for i in lost:
            os.unlink(base + CTX.to_ext(i))
        monkeypatch.setenv("SEAWEED_EC_NATIVE", "0" if who.endswith("python") else "1")
        native_io.reset_counts()
        if who.startswith("port"):
            got = rebuild_ec_files(base, CTX, backend=_port_cpu(), batch_size=50_000)
        else:
            got = jax_rebuild_ec_files(base, JCTX, backend=CpuBackend(JCTX), batch_size=50_000)
        assert sorted(got) == sorted(lost), who
        assert _shards(base) == originals, who
        batches = -(-len(originals[0]) // 50_000)
        if who == "port_native":
            assert native_io.COUNTS["read_batch"] == native_io.COUNTS["sink_append"] == batches
        if who == "port_python":
            assert not any(native_io.COUNTS.values())
        assert not [n for n in os.listdir(os.path.dirname(base)) if n.endswith(".rebuilding")]


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("rotten", [0, 9])
def test_rotten_source_excluded_by_inline_crc_as_jax(encoded_dir, tmp_path, monkeypatch, native, rotten):
    """A bit-flipped source is caught by the CRC rolled inside the read
    (native) or by the Python roller, confirmed from disk, excluded and
    rebuilt with the lost shard: the same ids and bytes as the JAX
    package on the same damage."""
    originals = _shards(os.path.join(encoded_dir, "1"))
    monkeypatch.setenv("SEAWEED_EC_NATIVE", native)
    results = []
    for who in ("port", "jax"):
        base = _copy_dir(encoded_dir, tmp_path / who)
        with open(base + CTX.to_ext(rotten), "r+b") as f:
            f.seek(4321)
            f.write(b"\xba\xad")
        os.unlink(base + CTX.to_ext(12))
        if who == "port":
            got = rebuild_ec_files(base, CTX, backend=_port_cpu(), batch_size=50_000)
        else:
            got = jax_rebuild_ec_files(base, JCTX, backend=CpuBackend(JCTX), batch_size=50_000)
        results.append(sorted(got))
        assert _shards(base) == originals
    assert results[0] == results[1] == sorted({rotten, 12})


@pytest.mark.parametrize("sidecar", [True, False])
def test_short_source_read_names_the_right_shard(encoded_dir, tmp_path, monkeypatch, sidecar):
    """A source cut short after the size check fails the batched read on
    its own row: with a sidecar the shard is excluded and rebuilt (the
    same outcome as the JAX package's native plane); without one the
    error names it."""
    originals = _shards(os.path.join(encoded_dir, "1"))
    outcomes = []
    for who, mod in (("port", native_io), ("jax", jax_native_io)):
        base = _copy_dir(encoded_dir, tmp_path / who)
        if not sidecar:
            os.unlink(base + ".ecsum")
        os.unlink(base + CTX.to_ext(12))
        real = mod.read_batch

        def cutting(*args, _real=real, _base=base, **kw):
            os.truncate(_base + CTX.to_ext(2), 100)
            return _real(*args, **kw)

        monkeypatch.setattr(mod, "read_batch", cutting)
        attempts = []
        if who == "port":
            real_attempt = port_rebuild._attempt_rebuild
            monkeypatch.setattr(
                port_rebuild, "_attempt_rebuild",
                lambda *a, **kw: attempts.append(real_attempt(*a, **kw)) or attempts[-1],
            )
            run = lambda: rebuild_ec_files(base, CTX, backend=_port_cpu(), batch_size=50_000)  # noqa: E731
        else:
            run = lambda: jax_rebuild_ec_files(base, JCTX, backend=CpuBackend(JCTX), batch_size=50_000)  # noqa: E731
        if sidecar:
            outcomes.append(sorted(run()))
            assert _shards(base) == originals
            if who == "port":
                assert attempts == [[2], []]
        else:
            with pytest.raises((ECError, JaxECError), match=r"source shards \[2\] unreadable"):
                run()
            outcomes.append("refused")
            assert not os.path.exists(base + CTX.to_ext(12))
        assert not [n for n in os.listdir(os.path.dirname(base)) if n.endswith(".rebuilding")]
    assert outcomes[0] == outcomes[1]


def test_rebuild_fails_closed_on_a_failed_shard_write(encoded_dir, tmp_path, monkeypatch):
    """The second rebuilt shard's file turns into /dev/full mid-stream:
    rebuild raises, publishes neither shard and leaves no .rebuilding
    file; the next rebuild converges to the original bytes."""
    originals = _shards(os.path.join(encoded_dir, "1"))
    base = _copy_dir(encoded_dir, tmp_path / "v")
    for i in (3, 11):
        os.unlink(base + CTX.to_ext(i))
    real = FusedShardSink.append_rows
    calls = []

    def failing(self, rows):
        calls.append(1)
        if len(calls) == 2:
            full = os.open("/dev/full", os.O_WRONLY)
            os.dup2(full, self.fds[1])
            os.close(full)
        return real(self, rows)

    monkeypatch.setattr(FusedShardSink, "append_rows", failing)
    with pytest.raises(OSError, match="sn_sink_append failed on shard 1"):
        rebuild_ec_files(base, CTX, backend=_port_cpu(), batch_size=50_000)
    names = os.listdir(str(tmp_path / "v"))
    assert "1.ec03" not in names and "1.ec11" not in names
    assert not [n for n in names if n.endswith(".rebuilding")]
    monkeypatch.setattr(FusedShardSink, "append_rows", real)
    assert rebuild_ec_files(base, CTX, backend=_port_cpu()) == [3, 11]
    assert _shards(base) == originals


# -------------------------------------------------------------- fault seams


@pytest.mark.parametrize("point", ["ec.rebuild.before_fsync", "ec.rebuild.before_rename",
                                   "ec.rebuild.after_rename"])
def test_armed_registry_routes_the_python_plane_and_seams_fire(encoded_dir, tmp_path, point):
    """With the registry armed, encode and rebuild read and write through
    the Python plane (no native read, no fused append), give the native
    plane's bytes, and the rebuild's publish-seam points fire."""
    originals = _shards(os.path.join(encoded_dir, "1"))
    base = _copy_dir(encoded_dir, tmp_path / "v")
    os.unlink(base + CTX.to_ext(4))
    with port_faults.injected(point, port_faults.crash()) as h:
        with open(os.devnull, "wb") as f:
            assert isinstance(make_shard_sink([f]), PyShardSink)
        with pytest.raises(port_faults.InjectedCrash):
            rebuild_ec_files(base, CTX, backend=_port_cpu(), batch_size=50_000)
        enc = _dat(tmp_path / "enc", 2 * ROW + 3 * 40960 + 777, seed=11)
        write_ec_files(enc, CTX, _port_cpu(), **SIZES)
    assert h.fired == 1
    assert not any(native_io.COUNTS.values())
    assert _shards(enc) == originals
    published = os.path.exists(base + CTX.to_ext(4))
    assert published == (point == "ec.rebuild.after_rename")
    if published:
        assert _read(base + CTX.to_ext(4)) == originals[4]
    else:
        temp = os.path.exists(base + CTX.to_ext(4) + ".rebuilding")
        assert temp == (point == "ec.rebuild.before_rename")
        assert rebuild_ec_files(base, CTX, backend=_port_cpu()) == [4]
        assert native_io.COUNTS["read_batch"] > 0
    assert _shards(base) == originals


@pytest.mark.parametrize("prefer_fused,env,armed,want", [
    (True, "1", False, FusedShardSink),
    (False, "1", False, PyShardSink),
    (True, "0", False, PyShardSink),
    (True, "1", True, PyShardSink),
])
def test_make_shard_sink_takes_python_only_when_asked(tmp_path, monkeypatch, prefer_fused, env, armed, want):
    monkeypatch.setenv("SEAWEED_EC_NATIVE", env)
    if armed:
        port_faults.inject("ec.rebuild.before_fsync", lambda ctx: None)
    with open(tmp_path / "s0", "wb", buffering=0) as f:
        assert type(make_shard_sink([f], prefer_fused=prefer_fused)) is want


# -------------------------------------------------------- sink and reader


# (block, leaf, widths): ends mid-leaf and mid-block; a v1 sidecar
# ending mid-block; whole blocks then one byte then a leaf-aligned tail.
SINK_CASES = [
    (8192, 2048, [8192, 3000, 2048, 57]),
    (4096, 0, [5000, 5000, 1]),
    (16384, 4096, [16384, 1, 12287]),
    (65536, 65536, [70_000, 3]),
]


@pytest.mark.parametrize("block,leaf,widths", SINK_CASES)
def test_sink_crcs_and_bytes_match_builder_and_jax(tmp_path, block, leaf, widths):
    rng = np.random.default_rng(block + leaf)
    batches = [rng.integers(0, 256, (3, w), dtype=np.uint8) for w in widths]
    files = [open(tmp_path / f"p{i}", "wb", buffering=0) for i in range(3)]
    jfiles = [open(tmp_path / f"j{i}", "wb", buffering=0) for i in range(3)]
    try:
        sink = FusedShardSink(files, block_size=block, leaf_size=leaf)
        jsink = JaxFusedShardSink(jfiles, block_size=block, leaf_size=leaf)
        builders = [ShardChecksumBuilder(block, leaf) for _ in range(3)]
        for b in batches:
            sink.append_rows(list(b))
            jsink.append_rows(list(b))
            for i in range(3):
                builders[i].write(b[i].tobytes())
        assert [f.tell() for f in files] == [0, 0, 0]  # pwrite never moves them
        assert sink.sizes == [sum(widths)] * 3
        assert sink.block_crcs() == jsink.block_crcs() == [bl.finish() for bl in builders]
        want_leaves = [bl.finish_leaves() for bl in builders] if leaf else []
        assert sink.leaf_crcs() == jsink.leaf_crcs() == want_leaves
        assert not sink.direct_flags().any()
    finally:
        for f in files + jfiles:
            f.close()
    for i in range(3):
        want = b"".join(b[i].tobytes() for b in batches)
        assert _read(tmp_path / f"p{i}") == want == _read(tmp_path / f"j{i}")


def test_sink_early_writeback_and_direct_give_the_same_bytes(tmp_path):
    """The sink's two write options (SEAWEED_EC_EARLY_WB, SEAWEED_EC_ODIRECT)
    change how the bytes reach the disk, never which: 4096-aligned rows
    (pool matrices) and then a ragged tail, against PyShardSink."""
    rng = np.random.default_rng(33)
    batches = []
    for w in (8192, 4096, 3000):
        m = native_io.aligned_matrix(2, w)
        m[:] = rng.integers(0, 256, m.shape, dtype=np.uint8)
        batches.append(m)
    out = {}
    for name in ("py", "fused"):
        files = [open(tmp_path / f"{name}{i}", "wb", buffering=0) for i in range(2)]
        try:
            if name == "py":
                sink = PyShardSink(files, block_size=8192, leaf_size=4096)
            else:
                sink = FusedShardSink(files, block_size=8192, leaf_size=4096,
                                      early_writeback=True, direct=True)
            for m in batches:
                sink.append_rows(list(m))
            out[name] = (sink.block_crcs(), sink.leaf_crcs(),
                         [_read(tmp_path / f"{name}{i}") for i in range(2)])
            if name == "fused":
                assert not sink.direct_flags().any()  # the ragged tail ended direct writes
        finally:
            for f in files:
                f.close()
    assert out["py"] == out["fused"]
    assert out["fused"][2][0] == b"".join(m[0].tobytes() for m in batches)


def test_sink_write_failure_fails_closed(tmp_path):
    """A dead fd mid-stream raises, and no CRC is minted for the failed
    batch; bad rows are refused before any byte is written."""
    f = open(tmp_path / "s0", "wb", buffering=0)
    sink = FusedShardSink([f], block_size=4096)
    row = np.zeros(4096, np.uint8)
    sink.append_rows([row])
    f.close()
    with pytest.raises(OSError, match="sn_sink_append failed on shard 0"):
        sink.append_rows([row])
    assert sink.sizes == [4096] and sink.crcs == [[port_crc.crc32c(row)]]
    with pytest.raises(ECError):
        sink.append_rows([row[::2]])  # not contiguous
    with open(os.devnull, "wb") as null, pytest.raises(ECError):
        FusedShardSink([null], block_size=4096, leaf_size=3000)


@pytest.mark.parametrize("block,batch", [(65536, 50_000), (4096, 4096), (1000, 333)])
def test_batch_pread_fused_crc_matches_rollers_and_jax(tmp_path, block, batch):
    rng = np.random.default_rng(block)
    n = (1 << 18) + 333
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}"
        p.write_bytes(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        paths.append(p)
    fds = [os.open(p, os.O_RDONLY) for p in paths]
    try:
        states = {who: (np.zeros(3, np.uint32), np.zeros(3, np.uint64)) for who in ("port", "jax")}
        lists = {who: [[] for _ in range(3)] for who in ("port", "jax")}
        rollers = [_BlockCrcRoller(block) for _ in range(3)]
        out = np.empty((3, batch // block + 2), np.uint32)
        counts = np.empty(3, np.int32)
        for off in range(0, n, batch):
            width = min(batch, n - off)
            for who, read in (("port", native_io.read_batch), ("jax", jax_native_io.read_batch)):
                buf = np.empty((3, width), np.uint8)
                read(fds, [off] * 3, buf, pad_eof=False, granule=block,
                     crc_state=states[who][0], filled_state=states[who][1],
                     out_crcs=out, out_counts=counts)
                for r in range(3):
                    lists[who][r].extend(int(x) for x in out[r, : counts[r]])
            for r in range(3):
                rollers[r].update(buf[r])
        for who in ("port", "jax"):
            for r in range(3):
                if states[who][1][r]:
                    lists[who][r].append(int(states[who][0][r]))
        assert lists["port"] == lists["jax"] == [r.finish() for r in rollers]
    finally:
        for fd in fds:
            os.close(fd)


def test_batch_pread_pads_or_fails_and_names_the_row(tmp_path):
    lens = [5000, 3000, 5000]
    rng = np.random.default_rng(4)
    blobs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    fds = []
    for i, b in enumerate(blobs):
        (tmp_path / f"f{i}").write_bytes(b)
        fds.append(os.open(tmp_path / f"f{i}", os.O_RDONLY))
    try:
        dst = native_io.aligned_matrix(3, 4100)
        dst[:] = 0xEE
        native_io.read_batch(fds, [500] * 3, dst, width=4096, pad_eof=True)
        for i, b in enumerate(blobs):
            want = b[500:4596].ljust(4096, b"\0")
            assert dst[i, :4096].tobytes() == want
            assert (dst[i, 4096:] == 0xEE).all()  # beyond `width`: untouched
        with pytest.raises(OSError) as e:
            native_io.read_batch(fds, [500] * 3, dst, width=4096, pad_eof=False)
        assert e.value.sn_row == 1
        with pytest.raises(ValueError):
            native_io.read_batch(fds, [0] * 3, dst[:, ::2], pad_eof=True)
        native_io.prefetch(fds[0], 0, 5000)  # a hint: nothing to see
    finally:
        for fd in fds:
            os.close(fd)


def test_worker_pool_under_concurrent_callers(tmp_path):
    """16 Python threads at once (more than the cores), each reading its
    own file with CRCs rolled and writing it through its own sink: every
    row and every CRC list comes out as one thread alone makes it, so
    the shared worker pool lost or mixed no task."""
    rng = np.random.default_rng(31)
    n, width = 16, 3 * 4096 + 5
    blobs = [rng.integers(0, 256, (3, width), dtype=np.uint8) for _ in range(n)]
    for t, b in enumerate(blobs):
        (tmp_path / f"in{t}").write_bytes(b.tobytes())
    errors = []

    def worker(t):
        try:
            fd = os.open(tmp_path / f"in{t}", os.O_RDONLY)
            files = [open(tmp_path / f"out{t}.{i}", "wb", buffering=0) for i in range(3)]
            try:
                sink = FusedShardSink(files, block_size=8192, leaf_size=4096)
                state, filled = np.zeros(3, np.uint32), np.zeros(3, np.uint64)
                out, counts = np.empty((3, 4), np.uint32), np.empty(3, np.int32)
                crcs = [[] for _ in range(3)]
                for _ in range(20):
                    buf = np.empty((3, width), np.uint8)
                    native_io.read_batch(
                        [fd] * 3, [i * width for i in range(3)], buf, pad_eof=False,
                        granule=4096, crc_state=state, filled_state=filled,
                        out_crcs=out, out_counts=counts,
                    )
                    for r in range(3):
                        crcs[r].extend(int(x) for x in out[r, : counts[r]])
                    assert np.array_equal(buf, blobs[t])
                    sink.append_rows(list(buf))
                want = [ShardChecksumBuilder(4096, 4096) for _ in range(3)]
                for r in range(3):
                    want[r].write(blobs[t][r].tobytes() * 20)
                    assert crcs[r] + ([int(state[r])] if filled[r] else []) == want[r].finish()
                assert sink.leaf_crcs() == [w.finish_leaves() for w in want]
            finally:
                os.close(fd)
                for f in files:
                    f.close()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]
    for t in range(n):
        for i in range(3):
            assert _read(tmp_path / f"out{t}.{i}") == blobs[t][i].tobytes() * 20


@pytest.mark.filterwarnings("ignore:This process .* is multi-threaded:DeprecationWarning")
def test_forked_child_reads_and_writes_without_the_pool(tmp_path):
    """A child forked after the worker pool started runs its jobs on its
    own thread (the pool's threads are not in the child) and gets the
    same bytes."""
    blob = np.random.default_rng(32).integers(0, 256, (4, 5000), dtype=np.uint8)
    (tmp_path / "in").write_bytes(blob.tobytes())
    fd = os.open(tmp_path / "in", os.O_RDONLY)
    try:
        buf = np.empty((4, 5000), np.uint8)
        native_io.read_batch([fd] * 4, [i * 5000 for i in range(4)], buf)  # the pool is up
        pid = os.fork()
        if pid == 0:  # the child: exit status says whether it matched
            ok = False
            try:
                got = np.empty((4, 5000), np.uint8)
                native_io.read_batch([fd] * 4, [i * 5000 for i in range(4)], got)
                with open(tmp_path / "child", "wb", buffering=0) as f:
                    sink = FusedShardSink([f], block_size=4096)
                    sink.append_rows([got.reshape(-1)])
                    want = ShardChecksumBuilder(4096)
                    want.write(blob.tobytes())
                    ok = np.array_equal(got, blob) and sink.block_crcs() == [want.finish()]
            finally:
                os._exit(0 if ok else 1)
        _, status = os.waitpid(pid, 0)
    finally:
        os.close(fd)
    assert os.waitstatus_to_exitcode(status) == 0
    assert _read(tmp_path / "child") == blob.tobytes()


@pytest.mark.parametrize("native", ["1", "0"])
def test_read_exact_into_fills_or_raises_on_both_planes(tmp_path, monkeypatch, native):
    monkeypatch.setenv("SEAWEED_EC_NATIVE", native)
    blob = np.random.default_rng(5).integers(0, 256, 9000, dtype=np.uint8).tobytes()
    (tmp_path / "f").write_bytes(blob)
    fd = os.open(tmp_path / "f", os.O_RDONLY)
    try:
        buf = np.empty(4000, np.uint8)
        native_io.read_exact_into(fd, buf, 4000)
        assert buf.tobytes() == blob[4000:8000]
        with pytest.raises(OSError):
            native_io.read_exact_into(fd, buf, 6000)
    finally:
        os.close(fd)
    assert native_io.COUNTS["read_exact"] == (1 if native == "1" else 0)


def test_buffer_pool_reuses_by_width():
    pool = native_io.BufferPool(rows=4)
    assert not pool.pinned
    a = pool.get(1024)
    addr = a.ctypes.data
    assert addr % 4096 == 0 and a.shape == (4, 1024) and a.flags.c_contiguous
    pool.put(a)
    assert pool.get(1024).ctypes.data == addr  # the same matrix back
    c = pool.get(2048)
    assert c.shape == (4, 2048) and c.ctypes.data % 4096 == 0
    assert native_io.COUNTS["pool_alloc"] == 2 and native_io.COUNTS["pool_bytes"] == 4 * 3072
    assert not native_io.BufferPool(4, device="cpu").pinned


# ------------------------------------------------------ decode and reads


@pytest.fixture(scope="module")
def sealed(tmp_path_factory):
    """A sealed volume of real needles (written by the JAX package's
    storage engine) encoded by the port at the default layout with a v2
    sidecar; returns (directory, payloads). Data lies on shards 0-3."""
    d = tmp_path_factory.mktemp("sealed")
    rng = np.random.default_rng(0)
    v = Volume(str(d), 1)
    payloads = {}
    for i in range(1, 121):
        data = rng.integers(0, 256, int(rng.integers(1, 60_000)), dtype=np.uint8).tobytes()
        v.write_needle(JaxNeedle(cookie=0x1000 + i, needle_id=i, data=data))
        payloads[i] = data
    v.close()
    ec_encode_volume(os.path.join(str(d), "1"), CTX, backend=_port_cpu())
    return str(d), payloads


@pytest.mark.parametrize("native", ["1", "0"])
def test_degraded_reads_match_jax_ecvolume(sealed, tmp_path, monkeypatch, native):
    src, payloads = sealed
    d = os.path.dirname(_copy_dir(src, tmp_path / "v"))
    monkeypatch.setenv("SEAWEED_EC_NATIVE", native)
    port = EcVolume(d, 1, backend="cpu", impl="cuda_planes")
    jax = JaxEcVolume(d, 1, backend_name="cpu")
    try:
        port.unmount_shards([0, 2])
        jax.unmount_shards([0, 2])
        for nid, data in payloads.items():
            got = port.read_needle(nid, cookie=0x1000 + nid)
            assert got.data == data == jax.read_needle(nid, cookie=0x1000 + nid).data
        assert port.bytes_reconstructed > 0
    finally:
        port.close()
        jax.close()
    if native == "1":
        assert native_io.COUNTS["read_exact"] >= 10 * port.interval_cache.loads > 0
    else:
        assert native_io.COUNTS["read_exact"] == 0


@pytest.mark.parametrize("native", ["1", "0"])
def test_decode_matches_jax(sealed, tmp_path, monkeypatch, native):
    src, _ = sealed
    monkeypatch.setenv("SEAWEED_EC_NATIVE", native)
    out = []
    for who in ("port", "jax"):
        base = _copy_dir(src, tmp_path / who)
        original = _read(base + ".dat")
        for ext in (".dat", ".idx", CTX.to_ext(2)):
            os.unlink(base + ext)
        native_io.reset_counts()
        if who == "port":
            assert ec_decode_volume(base, CTX, backend=TorchBackend(CTX, device="cpu", impl="cuda_planes"))
            counts = dict(native_io.COUNTS)
        else:
            assert jax_ec_decode_volume(base, JCTX, backend=CpuBackend(JCTX))
        out.append((_read(base + ".dat"), _read(base + ".idx"), _read(base + CTX.to_ext(2))))
    assert out[0] == out[1]
    assert original.startswith(out[0][0])
    if native == "1":
        assert counts["read_batch"] == 1 and counts["read_exact"] > 0
    else:
        assert not any(counts.values())


def test_remote_siblings_fetched_in_parallel_past_a_hung_peer(sealed, tmp_path):
    """Shards 5-13 live on peers and the peer of shard 6 hangs: a read of
    a needle on unmounted shard 0 takes the first 6 remote siblings that
    answer (at most 8 fetches at once) and returns, bit-exact and equal
    to the JAX EcVolume's, long before the hung fetch would."""
    src, payloads = sealed
    d = os.path.dirname(_copy_dir(src, tmp_path / "v"))
    peer = tmp_path / "peer"
    peer.mkdir()
    for i in range(5, 14):
        shutil.move(os.path.join(d, f"1.ec{i:02d}"), peer / f"1.ec{i:02d}")
    release = threading.Event()
    served = []

    def remote(sid, off, size, gen):
        served.append(sid)
        if sid == 6:
            release.wait(60)
        if sid < 5 or sid == 6:
            return None
        with open(peer / f"1.ec{sid:02d}", "rb") as f:
            f.seek(off)
            return f.read(size)

    port = EcVolume(d, 1, backend="cpu", impl="cuda_planes", remote_reader=remote)
    jax = JaxEcVolume(d, 1, backend_name="cpu", remote_reader=remote)
    try:
        port.unmount_shards([0])
        jax.unmount_shards([0])
        on0 = [nid for nid in payloads if {0} >= _shards_of(port, nid)][:6]
        assert on0
        t0 = time.perf_counter()
        for nid in on0:
            got = port.read_needle(nid, cookie=0x1000 + nid).data
            assert got == payloads[nid] == jax.read_needle(nid, cookie=0x1000 + nid).data
        assert time.perf_counter() - t0 < 30
        assert 6 in served and port.stage_seconds["sibling_read"] < time.perf_counter() - t0
    finally:
        release.set()
        port.close()
        jax.close()


def _shards_of(ev, nid) -> set[int]:
    nv = ev.find_needle(nid)
    return {
        iv.to_shard_and_offset(10)[0]
        for iv in locate_data(actual_offset(nv.offset), record_actual_size(nv.size, ev.version),
                              ev._locate_shard_size, 10)
    }
