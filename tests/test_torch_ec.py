"""PyTorch port: encode and rebuild of a volume, held against the JAX
package on the CPU, and the guards that keep the port apart from JAX.

The volume is written with real needles through the JAX package's
storage engine (this test file is the only place where both packages
meet). Encode compares the port's `write_ec_files` with the JAX
package's Pallas path in interpret mode: shard bytes, .ecx bytes and the
.ecsum block and leaf CRCs must be identical (tolerance 0); the sidecar
uuid and generation may differ. Rebuild runs across the packages in both
directions.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import CpuBackend, JaxBackend
from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec import ec_encode_volume as jax_ec_encode_volume
from seaweedfs_tpu.ec import rebuild_ec_files as jax_rebuild_ec_files
from seaweedfs_tpu.ec import write_ec_files as jax_write_ec_files
from seaweedfs_tpu.ec.bitrot import BitrotProtection as JaxBitrotProtection
from seaweedfs_tpu.ec.encoder import write_sorted_file_from_idx as jax_sort_idx
from seaweedfs_tpu.ec.volume_info import VolumeInfo as JaxVolumeInfo
from seaweedfs_tpu.storage.needle import Needle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu.utils.crc import crc32c as jax_crc32c
from seaweedfs_tpu_torch.ec import CpuBackend as PortCpuBackend
from seaweedfs_tpu_torch.ec import (
    BitrotProtection,
    ECContext,
    ECError,
    TorchBackend,
    VolumeInfo,
    ec_encode_volume,
    get_backend,
    rebuild_ec_files,
    write_ec_files,
    write_sorted_file_from_idx,
)
from seaweedfs_tpu_torch.utils.crc import crc32c, crc32c_combine

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "seaweedfs_tpu_torch"
CTX = ECContext(10, 4)
JCTX = JaxECContext(10, 4)
SIZES = dict(large_block_size=65536, small_block_size=4096)


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """One sealed volume (.dat + .idx) of real needles, about 1.1 MB:
    two large rows of 10 x 64 KiB, then 4 KiB small rows."""
    d = tmp_path_factory.mktemp("vol")
    rng = np.random.default_rng(0)
    v = Volume(str(d), 1)
    for i in range(1, 41):
        size = int(rng.integers(1, 60_000))
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        v.write_needle(Needle(cookie=0x1000 + i, needle_id=i, data=data))
    for i in (5, 17):
        v.delete_needle(i)
    v.close()
    return Volume.base_file_name(str(d), "", 1)


def _copy_volume(src_base: str, dst_dir) -> str:
    dst = os.path.join(str(dst_dir), "1")
    for ext in (".dat", ".idx"):
        shutil.copy(src_base + ext, dst + ext)
    return dst


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _shards(base: str, total: int = 14) -> list[bytes]:
    return [_read(base + f".ec{i:02d}") for i in range(total)]


# ------------------------------------------------------------- (c) encode


def test_encode_matches_jax_pallas_interpret(volume, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jbase = _copy_volume(volume, tmp_path / "jax")
    pbase = _copy_volume(volume, tmp_path / "port")

    jprot = jax_write_ec_files(
        jbase, JCTX,
        backend=JaxBackend(JCTX, impl="pallas", interpret=True, n_devices=1),
        **SIZES,
    )
    backend = TorchBackend(CTX, device="cpu")
    pprot = write_ec_files(pbase, CTX, backend=backend, **SIZES)

    assert _shards(pbase) == _shards(jbase)
    assert pprot.shard_sizes == jprot.shard_sizes
    assert pprot.shard_crcs == jprot.shard_crcs
    assert pprot.leaf_size == jprot.leaf_size > 0
    assert pprot.shard_leaf_crcs == jprot.shard_leaf_crcs
    assert pprot.block_size == jprot.block_size

    jax_sort_idx(jbase)
    write_sorted_file_from_idx(pbase)
    assert _read(pbase + ".ecx") == _read(jbase + ".ecx")

    # every stage of the run was recorded
    s = backend.stage_seconds
    assert s["disk_read"] > 0 and s["kernel"] > 0 and s["write"] > 0


@pytest.mark.parametrize("leaf_size", [0, 4096])
def test_encode_sidecar_variants_match_cpu_backend(volume, tmp_path, leaf_size):
    """v1 (no leaves) and v2 sidecars, a batch split inside the rows."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jbase = _copy_volume(volume, tmp_path / "jax")
    pbase = _copy_volume(volume, tmp_path / "port")
    jprot = jax_write_ec_files(
        jbase, JCTX, backend=CpuBackend(JCTX), batch_size=10_000,
        leaf_size=leaf_size, **SIZES,
    )
    pprot = write_ec_files(
        pbase, CTX, backend=TorchBackend(CTX, device="cpu"), batch_size=10_000,
        leaf_size=leaf_size, **SIZES,
    )
    assert _shards(pbase) == _shards(jbase)
    assert pprot.to_bytes()[:6] == jprot.to_bytes()[:6]  # magic + version
    assert pprot.shard_crcs == jprot.shard_crcs
    assert pprot.shard_leaf_crcs == jprot.shard_leaf_crcs


def test_full_volume_encode_files_are_readable_by_jax_package(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    vi = ec_encode_volume(base, CTX, backend=TorchBackend(CTX, device="cpu"))
    jvi = JaxVolumeInfo.load(base + ".vif")
    assert (jvi.ec_ctx.data_shards, jvi.ec_ctx.parity_shards) == (10, 4)
    assert jvi.dat_file_size == vi.dat_file_size == os.path.getsize(base + ".dat")
    jprot = JaxBitrotProtection.load(base + ".ecsum")
    prot = BitrotProtection.load(base + ".ecsum")
    assert prot.generation == jprot.generation == vi.encode_ts_ns
    for i in range(14):
        assert jprot.verify_shard_file(base + f".ec{i:02d}", i) == []
        assert prot.verify_shard_file(base + f".ec{i:02d}", i) == []
    assert VolumeInfo.load(base + ".vif").ec_ctx == CTX


# ------------------------------------------------------------ (d) rebuild


def _drop(base: str, ids) -> dict[int, bytes]:
    kept = {}
    for i in ids:
        kept[i] = _read(base + f".ec{i:02d}")
        os.unlink(base + f".ec{i:02d}")
    return kept


def test_port_rebuilds_jax_encoded_volume(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    jax_ec_encode_volume(base, JCTX, backend=CpuBackend(JCTX))
    originals = _drop(base, (3, 11))
    got = rebuild_ec_files(base, backend=TorchBackend(CTX, device="cpu"))
    assert got == [3, 11]
    for i, raw in originals.items():
        assert _read(base + f".ec{i:02d}") == raw
    assert not any(p.endswith(".rebuilding") for p in os.listdir(tmp_path))


def test_jax_pallas_rebuilds_port_encoded_volume(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    prot = write_ec_files(base, CTX, backend=TorchBackend(CTX, device="cpu"), **SIZES)
    prot.save(base + ".ecsum")
    VolumeInfo(ec_ctx=CTX, dat_file_size=os.path.getsize(base + ".dat")).save(
        base + ".vif"
    )
    originals = _drop(base, (0, 12))
    got = jax_rebuild_ec_files(
        base, backend=JaxBackend(JCTX, impl="pallas", interpret=True, n_devices=1)
    )
    assert got == [0, 12]
    for i, raw in originals.items():
        assert _read(base + f".ec{i:02d}") == raw


def test_rebuild_excludes_corrupt_present_shard(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    ec_encode_volume(base, CTX, backend=TorchBackend(CTX, device="cpu"))
    originals = {i: _read(base + f".ec{i:02d}") for i in range(14)}
    os.unlink(base + ".ec02")
    with open(base + ".ec04", "r+b") as f:  # a source shard rots
        f.seek(12345)
        b = f.read(1)
        f.seek(12345)
        f.write(bytes([b[0] ^ 0x01]))
    got = rebuild_ec_files(base, backend=TorchBackend(CTX, device="cpu"))
    assert got == [2, 4]
    assert _shards(base) == [originals[i] for i in range(14)]


def test_rebuild_fails_closed(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    ec_encode_volume(base, CTX, backend=TorchBackend(CTX, device="cpu"))
    be = TorchBackend(CTX, device="cpu")
    raw = bytearray(_read(base + ".ecsum"))
    raw[-1] ^= 0xFF
    with open(base + ".ecsum", "wb") as f:
        f.write(bytes(raw))
    os.unlink(base + ".ec01")
    with pytest.raises(ECError):
        rebuild_ec_files(base, backend=be)
    for i in range(2, 7):
        os.unlink(base + f".ec{i:02d}")
    with pytest.raises(ECError):
        rebuild_ec_files(base, backend=be, unsafe_ignore_sidecar=True)


def test_rebuild_only_shards_and_noop(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    ec_encode_volume(base, CTX, backend=TorchBackend(CTX, device="cpu"))
    be = TorchBackend(CTX, device="cpu")
    assert rebuild_ec_files(base, backend=be) == []
    originals = _drop(base, (1, 9))
    assert rebuild_ec_files(base, backend=be, only_shards=[9]) == [9]
    assert not os.path.exists(base + ".ec01")
    assert _read(base + ".ec09") == originals[9]


def test_backend_surface_matches_cpu_backend():
    rng = np.random.default_rng(21)
    data = rng.integers(0, 256, (10, 777), dtype=np.uint8)
    port, ref = TorchBackend(CTX, device="cpu"), CpuBackend(JCTX)
    parity = port.encode(data)
    assert np.array_equal(parity, ref.encode(data))
    full = np.concatenate([data, parity])
    assert port.verify(full)
    present = {i: full[i] for i in range(14) if i not in (4, 13)}
    got = port.reconstruct(present, want=[4])
    assert list(got) == [4] and np.array_equal(got[4], full[4])
    coeffs = rng.integers(0, 256, (3, 10), dtype=np.uint8)
    assert np.array_equal(port.apply(coeffs, data), ref.apply(coeffs, data))
    staged = port.apply_staged(coeffs, port.to_device(data))
    assert np.array_equal(port.to_host(staged), ref.apply(coeffs, data))


@pytest.mark.parametrize("impl", ["cuda", "cuda_planes"])
def test_backend_impls_match_cpu_backend(impl):
    rng = np.random.default_rng(22)
    data = rng.integers(0, 256, (10, 999), dtype=np.uint8)
    port, ref = TorchBackend(CTX, device="cpu", impl=impl), CpuBackend(JCTX)
    assert port.impl == impl
    parity = port.encode(data)
    assert np.array_equal(parity, ref.encode(data))
    full = np.concatenate([data, parity])
    present = {i: full[i] for i in range(14) if i not in (0, 5, 12)}
    got = port.reconstruct(present)
    assert sorted(got) == [0, 5, 12]
    for i in got:
        assert np.array_equal(got[i], full[i])
    assert isinstance(get_backend("cpu", 10, 4), PortCpuBackend)
    assert get_backend("cpu", 10, 4) is get_backend("cpu", 10, 4)
    with pytest.raises(ECError, match="no kernel impl"):
        get_backend("cpu", 10, 4, impl="cuda_planes")  # any but the default
    with pytest.raises(ECError):
        TorchBackend(CTX, device="cpu", impl="pallas")


# -------------------------------------------------------- CRC32C and build


def test_encode_pipeline_error_propagates(volume, tmp_path):
    """A failing device stage raises out of write_ec_files; the pipeline
    threads are joined, never left running."""

    class Boom(TorchBackend):
        def encode_staged(self, staged):
            raise RuntimeError("device lost")

    base = _copy_volume(volume, tmp_path)
    with pytest.raises(RuntimeError, match="device lost"):
        write_ec_files(base, CTX, backend=Boom(CTX, device="cpu"), **SIZES)


@pytest.mark.parametrize("leaf_size,block_size", [(4096, 16384), (1000, 3000)])
def test_fold_leaf_crcs_matches_rolled_blocks_and_jax(leaf_size, block_size):
    from seaweedfs_tpu.ec.bitrot import fold_leaf_crcs as jax_fold
    from seaweedfs_tpu_torch.ec.bitrot import ShardChecksumBuilder, fold_leaf_crcs

    data = np.random.default_rng(leaf_size).integers(0, 256, 50_001, dtype=np.uint8)
    b = ShardChecksumBuilder(block_size, leaf_size)
    b.write(data[:7777])
    b.write(data[7777:])
    blocks, leaves = b.finish(), b.finish_leaves()
    assert fold_leaf_crcs(leaves, len(data), leaf_size, block_size) == blocks
    assert jax_fold(leaves, len(data), leaf_size, block_size) == blocks


def test_crc32c_matches_jax_package():
    assert crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(9)
    for n in (0, 1, 7, 8, 1000, 65536 + 3):
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        assert crc32c(buf) == jax_crc32c(buf.tobytes())
        assert crc32c(memoryview(buf.tobytes()), 0x1234) == jax_crc32c(buf.tobytes(), 0x1234)
    a, b = b"hello ", b"world"
    assert crc32c_combine(crc32c(a), crc32c(b), len(b)) == crc32c(a + b)


# ------------------------------------------------------------- (e) guards


def _python_files():
    built = PORT / "build"  # build outputs, not sources
    return sorted(
        p for p in PORT.rglob("*.py") if built not in p.parents
    ) + [REPO / "chip_smoke.py", REPO / "chip_kernels.py", REPO / "chip_host_io.py",
         REPO / "chip_sched_ab.py"]


@pytest.mark.parametrize(
    "path", _python_files(), ids=lambda p: str(p.relative_to(REPO))
)
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "seaweedfs_tpu"), (path, name)
    text = path.read_text()
    assert "libseaweed" not in text and "native/" not in text


_SUBPROCESS_ENCODE = r"""
import os, shutil, sys, tempfile
import numpy as np
import seaweedfs_tpu_torch
from seaweedfs_tpu_torch.ec import (
    CpuBackend, ECContext, EcVolume, TorchBackend, ec_decode_volume, ec_encode_volume,
)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.super_block import SuperBlock
from seaweedfs_tpu_torch.storage.types import NeedleValue, to_stored_offset

d = tempfile.mkdtemp()
base = os.path.join(d, "7")
rng = np.random.default_rng(3)
ctx = ECContext(10, 4)
bodies = {}
with open(base + ".dat", "wb") as dat, open(base + ".idx", "wb") as idx:
    dat.write(SuperBlock().to_bytes())
    for nid in range(1, 40):
        bodies[nid] = rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
        n = Needle(cookie=nid, needle_id=nid, data=bodies[nid])
        off = dat.tell()
        dat.write(n.to_bytes())
        idx.write(NeedleValue(nid, to_stored_offset(off), len(n._body())).to_bytes())
ec_encode_volume(base, ctx, backend=TorchBackend(ctx, device="cpu"))
plain = {i: open(base + ctx.to_ext(i), "rb").read() for i in range(14)}
cpu = CpuBackend(ctx)  # builds the host library's GF(2^8) apply
ec_encode_volume(base, ctx, backend=cpu)
assert cpu.stage_seconds["kernel"] > 0
assert all(open(base + ctx.to_ext(i), "rb").read() == plain[i] for i in range(14))
for backend in (TorchBackend(ctx, device="cpu", impl="cuda_planes"), "cpu"):
    ev = EcVolume(d, 7, backend=backend)
    ev.unmount_shards([0])
    for nid in bodies:
        assert ev.read_needle(nid, cookie=nid).data == bodies[nid]
    assert ev.bytes_reconstructed > 0
    ev.close()
original = open(base + ".dat", "rb").read()
os.unlink(base + ".dat")
os.unlink(base + ".ec00")
assert ec_decode_volume(base, backend=TorchBackend(ctx, device="cpu", impl="cuda_planes"))
assert open(base + ".dat", "rb").read() == original
from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity
pp = PartitionParity(d, "ns", "t", 0, backend=TorchBackend(ECContext(4, 2), device="cpu"),
                     block_size=8192, small_block_size=1024)
for off in range(20):
    pp.append_record(off, off, b"k", bytes(900))
pp.flush()
pp.close()
assert len(PartitionParity(d, "ns", "t", 0, backend=pp.backend).recover()) == 20
# the scheduler, placement, the fallback and the probe
from seaweedfs_tpu_torch.ec import FallbackBackend, QueueScope, get_backend, rebuild_ec_files
from seaweedfs_tpu_torch.ec import backend as port_backend, chip_pool, device_queue
from seaweedfs_tpu_torch.utils import devices, metrics
assert isinstance(get_backend("auto", 10, 4), CpuBackend) and port_backend.AUTO_CPU["no_card"] == 1
assert devices.probe_accelerators() == 0
shard5 = open(base + ".ec05", "rb").read()
os.unlink(base + ".ec05")
fb = FallbackBackend(TorchBackend(ctx, device="cpu"), CpuBackend(ctx))
scope = QueueScope(window=2)
assert rebuild_ec_files(base, ctx, backend=fb, scheduler=scope) == [5]
assert open(base + ".ec05", "rb").read() == shard5 and fb.fallback_batches == 0
assert scope.stats_snapshot()[0]["classes"]["recovery"]["admitted"] >= 1
assert chip_pool.pool_for(fb) is None and "residency" in metrics.gateway_summary()
assert device_queue.residency_snapshot()["budget"] == device_queue.DEFAULT_RESIDENCY_BUDGET
# peer-fetch rebuild over the shard net plane
from seaweedfs_tpu_torch.ec import net_plane, rebuild_from_peers
peer = os.path.join(d, "peer")
os.makedirs(peer)
for i in range(14):
    shutil.copy(base + ctx.to_ext(i), os.path.join(peer, "7" + ctx.to_ext(i)))
for i in range(4, 14):
    os.unlink(base + ctx.to_ext(i))
fds = {}

def resolve(vid, sid, gen):
    if sid not in fds:
        fds[sid] = os.open(os.path.join(peer, "7" + ctx.to_ext(sid)), os.O_RDONLY)
    return fds[sid], os.fstat(fds[sid]).st_size

plane = net_plane.ShardNetPlane("127.0.0.1", 0, resolve)
plane.start()
client = net_plane.NetPlaneClient(timeout=5.0)
addr = ("127.0.0.1", plane.port)
rep = rebuild_from_peers(
    base, {i: ["p"] for i in range(4, 14)},
    lambda p, sid, off, size: client.read_bytes(addr, 7, sid, 0, off, size),
    targets=[4], backend=TorchBackend(ctx, device="cpu"),
    fetch_into=net_plane.make_fetch_into(client, 7, 0, addr_of=lambda p: addr),
)
assert rep.rebuilt == [4] and set(rep.fetched_plane.values()) == {"native"}
assert open(base + ".ec04", "rb").read() == open(os.path.join(peer, "7.ec04"), "rb").read()
client.close()
plane.stop()
# the Store: write, encode, degraded read
from seaweedfs_tpu_torch.storage.store import Store
sdir = os.path.join(d, "store")
store = Store([sdir], ec_backend="cpu")
vol = store.allocate_volume(9)
for nid, body in bodies.items():
    store.write_needle(9, Needle(cookie=nid, needle_id=nid, data=body))
vol.set_read_only(True)
ec_encode_volume(vol.dat_path[:-4], ctx, backend=TorchBackend(ctx, device="cpu"))
store.unmount_volume(9)
store.mount_ec_volume(9)
store.unmount_ec_shards(9, [0, 1])
for nid, body in bodies.items():
    assert store.read_needle(9, nid, cookie=nid).data == body
assert store.find_ec_volume(9).bytes_reconstructed > 0
store.close()
# a partition with a mounted and a net-plane remote root
blobs = os.path.join(d, "blobs")

def resolve_blob(path, op, md):
    full = os.path.join(blobs, path)
    if op == "unlink":
        if os.path.exists(full):
            os.unlink(full)
        return None
    os.makedirs(os.path.dirname(full), exist_ok=True)
    return os.open(full, os.O_CREAT | os.O_RDWR, 0o644)

bplane = net_plane.ShardNetPlane("127.0.0.1", 0, resolve, resolve_blob=resolve_blob)
bplane.start()
gport = bplane.port - net_plane.NET_PLANE_PORT_OFFSET
os.environ["SEAWEED_EC_STREAM_REMOTE_ROOTS"] = (
    f"far={os.path.join(d, 'far')},peer=net:127.0.0.1:{gport}")
rp = PartitionParity(d, "ns", "remote", 0, backend=TorchBackend(ECContext(4, 2), device="cpu"),
                     block_size=8192, small_block_size=1024)
for off in range(30):
    rp.append_record(off, off, b"k", bytes(900))
rp.flush()
rp.close()
assert any(os.path.islink(os.path.join(rp.dir, n)) for n in os.listdir(rp.dir))
assert os.listdir(os.path.join(blobs, "ns", "remote", "0000"))
assert len(PartitionParity(d, "ns", "remote", 0, backend=rp.backend).recover()) == 30
PartitionParity(d, "ns", "remote", 0, backend=rp.backend).delete()
assert not os.listdir(os.path.join(blobs, "ns", "remote", "0000"))
del os.environ["SEAWEED_EC_STREAM_REMOTE_ROOTS"]
bplane.stop()
shutil.rmtree(d)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu"))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_import_and_encode_leave_jax_out_of_sys_modules():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS_ENCODE],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_default_backend_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(CTX)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend("cuda", 7, 3)  # a geometry no other test caches
    # "auto" is reached only by name, and without a card it is the
    # native CPU backend, counted (tests/test_torch_fallback.py)
    from seaweedfs_tpu_torch.ec import backend as port_backend

    before = port_backend.AUTO_CPU["no_card"]
    assert isinstance(get_backend("auto", 6, 3), PortCpuBackend)
    assert port_backend.AUTO_CPU["no_card"] == before + 1
    # the native CPU backend needs no card, and only its name reaches it
    be = get_backend("cpu", 7, 3)
    assert isinstance(be, PortCpuBackend) and not hasattr(be, "device")
    data = np.random.default_rng(5).integers(0, 256, (7, 333), dtype=np.uint8)
    assert np.array_equal(be.encode(data), CpuBackend(JaxECContext(7, 3)).encode(data))
    with pytest.raises(ECError):
        TorchBackend(CTX, device="meta")


def test_the_two_packages_schedulers_share_no_state():
    """Both packages' schedulers in one process: pools, ledgers, the
    default scope, the fallback registry and the metric families are
    each package's own, and driving one moves nothing of the other."""
    from seaweedfs_tpu.ec import backend as jax_backend
    from seaweedfs_tpu.ec import chip_pool as jax_pool
    from seaweedfs_tpu.ec import device_queue as jax_dq
    from seaweedfs_tpu.utils import metrics as jax_metrics
    from seaweedfs_tpu_torch.ec import backend, chip_pool, device_queue
    from seaweedfs_tpu_torch.utils import metrics

    assert device_queue.default_scope() is not jax_dq.default_scope()
    assert device_queue.default_residency() is not jax_dq.default_residency()
    assert chip_pool._pools is not jax_pool._pools and chip_pool._ledgers is not jax_pool._ledgers
    assert backend._FALLBACKS is not jax_backend._FALLBACKS
    assert metrics.REGISTRY is not jax_metrics.REGISTRY
    assert device_queue._queue_admitted is not jax_dq._queue_admitted
    assert not isinstance(device_queue.default_scope(), jax_dq.QueueScope)
    jax_before = {s["chip"] for s in jax_dq.default_scope().stats_snapshot()}
    jax_res = set(jax_dq.residency_snapshot().get("chips", {}))
    be = PortCpuBackend(CTX)
    q = device_queue.for_backend(be)
    t = q._admit("foreground", 123)
    assert any(s["chip"] == q.label for s in device_queue.stats_snapshot())
    # (a JAX queue may drop out of its weak registry meanwhile; none is added)
    assert {s["chip"] for s in jax_dq.default_scope().stats_snapshot()} <= jax_before
    assert q.label not in jax_before and q.label not in jax_res
    assert set(jax_dq.residency_snapshot().get("chips", {})) <= jax_res
    q._release(t)
    # a scope of one package refuses to serve the other's backend as a chip
    # of its own pool: neither package builds a pool from the other's backend
    assert chip_pool.pool_for(CpuBackend(JCTX)) is None
    assert jax_pool.pool_for(be) is None
    # the gateway summary reads each package's own ledger
    assert metrics.gateway_summary()["residency"] == device_queue.residency_snapshot()
