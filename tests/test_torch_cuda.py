"""PyTorch port on the card: the CUDA kernel's two entry points (and the
three bodies behind them) against their plain versions and the numpy
oracle, the backend's staged path, degraded reads through EcVolume, leaf
repair (reconstruction on the card, a repair killed in a child process
and healed at mount), and the native byte plane's page-locked landing
matrices (copied to the card as they lie, recycled as soon as a batch's
result is back).

Every test here needs an NVIDIA card and skips without one. This file
imports no JAX, so it runs where JAX is not installed; on the card run it
without the JAX-based conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

All comparisons are exact (tolerance 0: integer GF arithmetic).
"""

import collections
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import seaweedfs_tpu_torch.ec.ec_volume as ecv
from seaweedfs_tpu_torch.ec import (
    ECContext,
    EcVolume,
    TorchBackend,
    VolumeInfo,
    ec_encode_volume,
    native_io,
    reconstruct_leaves,
)
from seaweedfs_tpu_torch.ec.backend import _decode_coeffs
from seaweedfs_tpu_torch.ec.bitrot import BitrotProtection, ShardChecksumBuilder
from seaweedfs_tpu_torch.ec.encoder import write_ec_files
from seaweedfs_tpu_torch.ops import gf256, rs_kernels, rs_torch
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.super_block import SuperBlock
from seaweedfs_tpu_torch.storage.types import NeedleValue, to_stored_offset

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _apply(coeffs, data_np, device):
    b = rs_torch.bits_from_numpy(rs_torch.bit_matrix_bitmajor(coeffs), device)
    data = torch.from_numpy(data_np).to(device)
    return b, data, rs_kernels.gf2_apply(b, data, m=coeffs.shape[0])


def _coeffs(kind, k, m, rng):
    """Random (m, k) coefficients, the encode rows of RS(k, m), or the two
    rows that rebuild data shard 3 and parity shard 1 of RS(k, 4) from the
    first k shards that remain (the smoke's rebuild)."""
    if kind == "random":
        return rng.integers(0, 256, (m, k), dtype=np.uint8)
    if kind == "encode":
        return gf256.parity_rows(k, m)
    assert m == 2
    lost = (3, k + 1)
    src = tuple(i for i in range(k + 4) if i not in lost)[:k]
    return _decode_coeffs(gf256.build_matrix(k, k + 4), lost, src)


# The ring bodies' tile is 4096 columns; 132 x 4096 is one wave of
# one-tile blocks on an H100. 132 * 4096 + 3 is not a multiple of 16.
PLANES_EDGES = [4080, 4096, 4112, 132 * 4096 - 16, 132 * 4096, 132 * 4096 + 16, 132 * 4096 + 3]


# (24, 8): two-word table entries at k = 24; m = 9 and 12 take two row
# groups; "encode" and "rebuild" are the main paths' coefficient sets.
@pytest.mark.parametrize("width", [1, 7, 16, 127, 1000, 4099, 1 << 20] + PLANES_EDGES)
@pytest.mark.parametrize("k,m,kind", [
    (10, 4, "random"), (10, 2, "random"), (10, 1, "random"), (6, 3, "random"),
    (20, 12, "random"), (28, 4, "random"), (24, 8, "random"), (10, 9, "random"),
    (10, 12, "random"), (10, 4, "encode"), (10, 2, "rebuild"),
])
def test_kernel_matches_plain_and_oracle(cuda, width, k, m, kind):
    rng = np.random.default_rng(width * 31 + k * 7 + m)
    coeffs = _coeffs(kind, k, m, rng)
    data_np = rng.integers(0, 256, (k, width), dtype=np.uint8)
    b, data, got = _apply(coeffs, data_np, cuda)
    assert torch.equal(got, rs_kernels.gf2_apply_plain(b, data, m))
    w = min(width, 4096)
    assert np.array_equal(
        got[:, :w].cpu().numpy(), gf256.matrix_apply(coeffs, data_np[:, :w])
    )


def test_kernel_counts_launches_and_rejects_pw4(cuda):
    coeffs = gf256.parity_rows(10, 4)
    data_np = np.zeros((10, 64), np.uint8)
    before = rs_kernels.LAUNCHES["gf2_apply"]
    b, data, _ = _apply(coeffs, data_np, cuda)
    assert rs_kernels.LAUNCHES["gf2_apply"] == before + 1
    with pytest.raises(NotImplementedError):
        rs_kernels.gf2_apply(b, data, m=4, pack_width=4)
    two = rs_kernels.gf2_apply(b, data, m=4, pack_width=2)
    assert torch.equal(two, rs_kernels.gf2_apply(b, data, m=4))


def test_plain_version_exact_with_tf32_forced_on(cuda):
    rng = np.random.default_rng(4)
    coeffs = gf256.parity_rows(10, 4)
    data_np = rng.integers(0, 256, (10, 1 << 16), dtype=np.uint8)
    b, data, got = _apply(coeffs, data_np, cuda)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        plain = rs_kernels.gf2_apply_plain(b, data, 4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert torch.equal(got, plain)


def test_backend_staged_path_on_card(cuda):
    ctx = ECContext(10, 4)
    be = TorchBackend(ctx)
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (10, 3 << 20), dtype=np.uint8)
    parity = be.encode(data)
    assert np.array_equal(parity[:, :4096], gf256.matrix_apply(gf256.parity_rows(10, 4), data[:, :4096]))
    cpu = TorchBackend(ctx, device="cpu")
    full = np.concatenate([data[:, :5000], parity[:, :5000]])
    present = {i: full[i] for i in range(14) if i not in (3, 11)}
    got, want = be.reconstruct(present), cpu.reconstruct(present)
    assert sorted(got) == [3, 11]
    for i in (3, 11):
        assert np.array_equal(got[i], want[i]) and np.array_equal(got[i], full[i])
    s = be.stage_seconds
    assert s["h2d"] > 0 and s["kernel"] > 0 and s["d2h"] > 0


def test_volume_encode_on_card_matches_cpu(cuda, tmp_path):
    rng = np.random.default_rng(12)
    dat = rng.integers(0, 256, 3_000_000, dtype=np.uint8)
    for d in ("gpu", "cpu"):
        (tmp_path / d).mkdir()
        dat.tofile(tmp_path / d / "1.dat")
        (tmp_path / d / "1.idx").write_bytes(b"")
    ctx = ECContext(10, 4)
    ec_encode_volume(str(tmp_path / "gpu" / "1"), ctx, backend=TorchBackend(ctx))
    write_ec_files(
        str(tmp_path / "cpu" / "1"), ctx, backend=TorchBackend(ctx, device="cpu")
    )
    for i in range(14):
        ext = f"1.ec{i:02d}"
        assert (tmp_path / "gpu" / ext).read_bytes() == (tmp_path / "cpu" / ext).read_bytes()


@pytest.mark.parametrize("width", [1, 4096, 1 << 20, (1 << 20) + 3, 16 << 20])
def test_pinned_pool_matrices_are_page_locked_and_aligned(cuda, width):
    pool = native_io.BufferPool(10, device=cuda)
    assert pool.pinned
    native_io.reset_counts()
    mats = [pool.get(width) for _ in range(3)]
    for m in mats:
        assert m.shape == (10, width) and m.dtype == np.uint8 and m.flags.c_contiguous
        assert m.ctypes.data % 4096 == 0
        assert torch.from_numpy(m).is_pinned() and torch.from_numpy(m[7]).is_pinned()
    assert len({m.ctypes.data for m in mats}) == 3 and native_io.COUNTS["pool_alloc"] == 3
    pool.put(mats[1])
    assert pool.get(width) is mats[1] and native_io.COUNTS["pool_alloc"] == 3


def test_to_device_skips_the_pin_copy_for_pooled_batches(cuda):
    ctx = ECContext(10, 4)
    be = TorchBackend(ctx)
    pool = native_io.BufferPool(10, device=cuda)
    landed = pool.get(1 << 20)
    landed[:] = np.random.default_rng(21).integers(0, 256, landed.shape, dtype=np.uint8)
    plain = np.array(landed)  # pageable memory
    from_pool = be.to_host(be.encode_staged(be.to_device(landed))).copy()
    assert be.pin_skips == 1 and be.stage_seconds["pin"] == 0
    from_copy = be.to_host(be.encode_staged(be.to_device(plain))).copy()
    assert be.pin_skips == 1 and be.stage_seconds["pin"] > 0
    assert np.array_equal(from_pool, from_copy)
    want = gf256.matrix_apply(gf256.parity_rows(10, 4), plain[:, :65536])
    assert np.array_equal(from_pool[:, :65536], want)
    be.reset_stages()
    assert be.pin_skips == 0


def test_pooled_matrix_recycled_right_after_to_host(cuda):
    """100 batches through two in flight, each pooled matrix put back and
    refilled as soon as its batch's parity is on the host: every parity
    equals that of a private copy of the batch, so no refill reached a
    matrix whose copy to the card was still running."""
    ctx = ECContext(10, 4)
    be, ref = TorchBackend(ctx), TorchBackend(ctx)
    pool = native_io.BufferPool(10, device=cuda)
    native_io.reset_counts()
    rng = np.random.default_rng(22)
    width = 1 << 20
    pending = collections.deque()
    for i in range(100 + 2):
        if i < 100:
            m = pool.get(width)
            m[:] = rng.integers(0, 256, m.shape, dtype=np.uint8)
            pending.append((np.array(m), m, be.encode_staged(be.to_device(m))))
        if len(pending) == 2 or (i >= 100 and pending):
            copy, m, handle = pending.popleft()
            got = be.to_host(handle).copy()
            pool.put(m)  # refilled by the next get, at once
            assert np.array_equal(got, ref.encode(copy)), i
    assert be.pin_skips == 100 and native_io.COUNTS["pool_alloc"] <= 3


def test_encode_on_card_native_plane_matches_python_plane(cuda, tmp_path, monkeypatch):
    rng = np.random.default_rng(23)
    dat = rng.integers(0, 256, 3 * 655360 + 40960 * 2 + 999, dtype=np.uint8)
    sizes = dict(large_block_size=65536, small_block_size=4096, batch_size=20000)
    ctx = ECContext(10, 4)
    out = {}
    for plane in ("1", "0"):
        monkeypatch.setenv("SEAWEED_EC_NATIVE", plane)
        (tmp_path / plane).mkdir()
        dat.tofile(tmp_path / plane / "1.dat")
        be = TorchBackend(ctx)
        native_io.reset_counts()
        prot = write_ec_files(str(tmp_path / plane / "1"), ctx, backend=be, leaf_size=4096, **sizes)
        shards = [(tmp_path / plane / f"1.ec{i:02d}").read_bytes() for i in range(14)]
        out[plane] = (shards, prot.shard_sizes, prot.shard_crcs, prot.shard_leaf_crcs)
        if plane == "1":
            batches = native_io.COUNTS["read_batch"]
            assert batches == native_io.COUNTS["sink_append"] == be.pin_skips > 0
        else:
            assert not any(native_io.COUNTS.values()) and be.pin_skips == 0
    assert out["1"] == out["0"]


@pytest.mark.parametrize("width", [1, 7, 16, 127, 1000, 4099, 1 << 20] + PLANES_EDGES)
@pytest.mark.parametrize("k,m", [(10, 4), (10, 2), (10, 1), (6, 3), (20, 12), (28, 4)])
@pytest.mark.parametrize("pack_width", [1, 2])  # m_pad 32 and 16
def test_planes_kernel_matches_plain_and_oracle(cuda, width, k, m, pack_width):
    rng = np.random.default_rng(width * 37 + k * 7 + m + pack_width)
    coeffs = rng.integers(0, 256, (m, k), dtype=np.uint8)
    data_np = rng.integers(0, 256, (k, width), dtype=np.uint8)
    p = rs_torch.planes_from_numpy(rs_torch.bit_matrix_planes(coeffs, pack_width), cuda)
    data = torch.from_numpy(data_np).to(cuda)
    before = rs_kernels.LAUNCHES["gf2_apply_planes"]
    got = rs_kernels.gf2_apply_planes(p, data, m=m, pack_width=pack_width)
    assert rs_kernels.LAUNCHES["gf2_apply_planes"] == before + 1
    assert torch.equal(got, rs_kernels.gf2_apply_planes_plain(p, data, m))
    w = min(width, 4096)
    assert np.array_equal(
        got[:, :w].cpu().numpy(), gf256.matrix_apply(coeffs, data_np[:, :w])
    )


@pytest.mark.parametrize("m_pad,pack_width", [(32, 1), (16, 2)])
def test_planes_kernel_every_m_up_to_m_pad(cuda, m_pad, pack_width):
    rng = np.random.default_rng(m_pad)
    data_np = rng.integers(0, 256, (10, 4099), dtype=np.uint8)
    data = torch.from_numpy(data_np).to(cuda)
    for m in range(1, m_pad + 1):
        coeffs = rng.integers(0, 256, (m, 10), dtype=np.uint8)
        p = rs_torch.planes_from_numpy(rs_torch.bit_matrix_planes(coeffs, pack_width), cuda)
        got = rs_kernels.gf2_apply_planes(p, data, m=m, pack_width=pack_width)
        assert np.array_equal(got.cpu().numpy(), gf256.matrix_apply(coeffs, data_np)), m


@pytest.mark.parametrize("width", [4096, 1 << 20, 4099])
@pytest.mark.parametrize("entry,m,kind", [
    ("gf2_apply_planes", 2, "random"), ("gf2_apply", 4, "encode"), ("gf2_apply", 2, "rebuild"),
])
def test_planes_kernel_on_misaligned_data(cuda, width, entry, m, kind):
    rng = np.random.default_rng(width)
    coeffs = _coeffs(kind, 10, m, rng)
    data_np = rng.integers(0, 256, (10, width), dtype=np.uint8)
    # a contiguous view 1 byte into a larger buffer
    data = torch.empty(10 * width + 1, dtype=torch.uint8, device=cuda)[1:].view(10, width)
    data.copy_(torch.from_numpy(data_np))
    assert data.data_ptr() % 16 != 0
    if entry == "gf2_apply_planes":
        p = rs_torch.planes_from_numpy(rs_torch.bit_matrix_planes(coeffs, 1), cuda)
        got = rs_kernels.gf2_apply_planes(p, data, m=m)
        assert torch.equal(got, rs_kernels.gf2_apply_planes_plain(p, data, m))
    else:
        b = rs_torch.bits_from_numpy(rs_torch.bit_matrix_bitmajor(coeffs), cuda)
        got = rs_kernels.gf2_apply(b, data, m=m)
        assert torch.equal(got, rs_kernels.gf2_apply_plain(b, data, m))
    w = min(width, 4096)
    assert np.array_equal(got[:, -w:].cpu().numpy(), gf256.matrix_apply(coeffs, data_np[:, -w:]))


@pytest.mark.parametrize("width", [70000 * 16] + PLANES_EDGES)
@pytest.mark.parametrize("m", [1, 2, 9, 32])  # 9: two row groups; 32: all of m_pad
def test_planes_and_bitmajor_kernels_give_identical_bytes(cuda, m, width):
    rng = np.random.default_rng(100 + m)
    coeffs = rng.integers(0, 256, (m, 10), dtype=np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, (10, width), dtype=np.uint8)).to(cuda)
    b = rs_torch.bits_from_numpy(rs_torch.bit_matrix_bitmajor(coeffs), cuda)
    p = rs_torch.planes_from_numpy(rs_torch.bit_matrix_planes(coeffs, 1), cuda)
    assert torch.equal(rs_kernels.gf2_apply(b, data, m=m), rs_kernels.gf2_apply_planes(p, data, m=m))


def test_planes_kernel_back_to_back_on_two_streams(cuda):
    rng = np.random.default_rng(31)
    ops = []
    for m, width in ((1, 1 << 20), (3, 3 << 16)):
        coeffs = rng.integers(0, 256, (m, 10), dtype=np.uint8)
        p = rs_torch.planes_from_numpy(rs_torch.bit_matrix_planes(coeffs, 1), cuda)
        data = torch.from_numpy(rng.integers(0, 256, (10, width), dtype=np.uint8)).to(cuda)
        ops.append((p, data, m))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for stream, (p, data, m) in zip(streams, ops):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs.append(rs_kernels.gf2_apply_planes(p, data, m=m))
    torch.cuda.synchronize()
    for out, (p, data, m) in zip(outs, ops):
        assert torch.equal(out, rs_kernels.gf2_apply_planes_plain(p, data, m))


def _needle_volume(d, n_needles=60, body=200_000, seed=5):
    """A sealed volume of real needles, EC-encoded on the card with the
    plane-stack kernel; returns the payloads."""
    rng = np.random.default_rng(seed)
    base = os.path.join(str(d), "1")
    bodies = {}
    with open(base + ".dat", "wb") as dat, open(base + ".idx", "wb") as idx:
        dat.write(SuperBlock().to_bytes())
        for nid in range(1, n_needles + 1):
            bodies[nid] = rng.integers(0, 256, body, dtype=np.uint8).tobytes()
            n = Needle(cookie=nid, needle_id=nid, data=bodies[nid])
            off = dat.tell()
            dat.write(n.to_bytes())
            idx.write(NeedleValue(nid, to_stored_offset(off), len(n._body())).to_bytes())
    ctx = ECContext(10, 4)
    ec_encode_volume(base, ctx, backend=TorchBackend(ctx, impl="cuda_planes"))
    return bodies


def test_concurrent_degraded_readers_on_one_backend(cuda, tmp_path):
    bodies = _needle_volume(tmp_path)
    be = TorchBackend(ECContext(10, 4), impl="cuda_planes")
    ev = EcVolume(str(tmp_path), 1, backend=be)
    try:
        ev.unmount_shards([0])
        ids = list(bodies)
        errors = []
        before = rs_kernels.LAUNCHES["gf2_apply_planes"]

        def reader(t):
            try:
                for nid in ids[t::12] + ids[:4]:
                    assert ev.read_needle(nid, cookie=nid).data == bodies[nid]
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=reader, args=(t,)) for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors
        assert rs_kernels.LAUNCHES["gf2_apply_planes"] - before == ev.interval_cache.loads > 0
        assert be.stage_seconds["kernel"] > 0
    finally:
        ev.close()


def test_staged_degraded_reads_on_card(cuda, tmp_path, monkeypatch):
    bodies = _needle_volume(tmp_path, n_needles=30)
    monkeypatch.setattr(ecv, "STAGED_RECOVERY_BATCH", 16384)
    be = TorchBackend(ECContext(10, 4), impl="cuda_planes")
    calls = []
    real = be.apply_staged
    be.apply_staged = lambda c, s: calls.append(1) or real(c, s)
    ev = EcVolume(str(tmp_path), 1, backend=be, interval_cache_bytes=0)
    try:
        ev.unmount_shards([0, 12])
        for nid, body in bodies.items():
            assert ev.read_needle(nid, cookie=nid).data == body
        assert len(calls) > 10
    finally:
        ev.close()


# ------------------------------------------------------------ leaf repair

LEAF = 64 << 10
LEAF_SHARD = 2 * (1 << 20) + 57  # 32 leaves and a 57-byte tail leaf


def _leaf_volume(d, seed=40):
    """RS 10+4 shard files of LEAF_SHARD bytes with a v2 sidecar (1 MiB
    blocks, 64 KiB leaves), a .vif and an empty .ecx; returns the shard
    bytes."""
    ctx = ECContext(10, 4)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (10, LEAF_SHARD), dtype=np.uint8)
    shards = np.concatenate([data, gf256.matrix_apply(gf256.parity_rows(10, 4), data)])
    base = os.path.join(str(d), "1")
    builders = [ShardChecksumBuilder(1 << 20, leaf_size=LEAF) for _ in range(14)]
    for i in range(14):
        builders[i].write(shards[i].tobytes())
        with open(base + ctx.to_ext(i), "wb") as f:
            f.write(shards[i].tobytes())
    BitrotProtection.from_builders(ctx, builders, generation=9).save(base + ".ecsum")
    VolumeInfo(ec_ctx=ctx).save(base + ".vif")
    open(base + ".ecx", "wb").close()
    return {i: shards[i].tobytes() for i in range(14)}


def _rot_leaves(base, sid, leaves):
    with open(base + f".ec{sid:02d}", "r+b") as f:
        for li in leaves:
            f.seek(li * LEAF + 5)
            b = f.read(1)
            f.seek(li * LEAF + 5)
            f.write(bytes([b[0] ^ 0x3C]))


def _local_reader(base):
    def read_range(sid, lo, size):
        with open(base + f".ec{sid:02d}", "rb") as f:
            f.seek(lo)
            return f.read(size)

    return read_range


# runs of 1, 2 and 16 leaves, and the partial tail leaf (57 bytes: the
# masked byte path)
@pytest.mark.parametrize("sid", [3, 12])
def test_reconstruct_leaves_on_card_matches_plain_and_oracle(cuda, tmp_path, sid):
    blobs = _leaf_volume(tmp_path)
    base = str(tmp_path / "1")
    leaves = [0, 3, 4] + list(range(8, 24)) + [32]
    _rot_leaves(base, sid, leaves)
    ctx = ECContext(10, 4)
    prot = BitrotProtection.load(base + ".ecsum")
    candidates = [i for i in range(14) if i != sid]
    before = rs_kernels.LAUNCHES["gf2_apply"]
    stages = {}
    got = reconstruct_leaves(
        prot, ctx, sid, leaves, _local_reader(base), candidates,
        backend=TorchBackend(ctx), stages=stages,
    )
    assert rs_kernels.LAUNCHES["gf2_apply"] - before == 4  # one per leaf range
    plain = reconstruct_leaves(
        prot, ctx, sid, leaves, _local_reader(base), candidates,
        backend=TorchBackend(ctx, device="cpu"),
    )
    assert got == plain
    assert [p.leaf for p in got] == leaves
    for p in got:  # the oracle: the shard as encoded by numpy
        assert p.data == blobs[sid][p.offset : p.offset + len(p.data)]
    assert len(got[-1].data) == 57
    assert stages["reconstruct"] > 0 and stages["crc_verify"] > 0


_CRASH_CHILD = r"""
import sys
from seaweedfs_tpu_torch import faults
from seaweedfs_tpu_torch.ec import ECContext, TorchBackend, reconstruct_leaves
from seaweedfs_tpu_torch.ec.bitrot import BitrotProtection
from seaweedfs_tpu_torch.ec.repair_journal import apply_leaf_repair, leaf_verdict
from seaweedfs_tpu_torch.ops import rs_kernels

base, sid = sys.argv[1], int(sys.argv[2])
ctx = ECContext(10, 4)
faults.inject("ec.repair.patch_write", faults.hard_exit(137))
faults.inject("ec.repair.patch_bytes", faults.truncate(0.5))
prot = BitrotProtection.load(base + ".ecsum")
path = base + ctx.to_ext(sid)


def read_range(s, lo, size):
    with open(base + ctx.to_ext(s), "rb") as f:
        f.seek(lo)
        return f.read(size)


patches = reconstruct_leaves(
    prot, ctx, sid, leaf_verdict(path, sid, prot), read_range,
    [i for i in range(ctx.total) if i != sid], backend=TorchBackend(ctx),
)
print("launches", rs_kernels.LAUNCHES["gf2_apply"], flush=True)
apply_leaf_repair(path, sid, prot, patches)
sys.exit(3)  # the armed point never fired
"""


def test_repair_killed_on_card_heals_at_mount(cuda, tmp_path):
    """A child reconstructs two leaves on the card, tears their patch and
    dies; the next mount replays the journal before any fd opens."""
    blobs = _leaf_volume(tmp_path, seed=41)
    base = str(tmp_path / "1")
    _rot_leaves(base, 5, [7, 30])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-c", _CRASH_CHILD, base, "5"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 137, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["launches", "2"]
    assert os.path.exists(base + ".ec05.repair")
    ev = EcVolume(str(tmp_path), 1)
    try:
        assert ev.journal_recovery == {"replayed": {5: [7, 30]}, "rolled_back": [], "kept": []}
        assert not os.path.exists(base + ".ec05.repair")
        assert os.pread(ev.shard_fds[5], LEAF_SHARD, 0) == blobs[5]
    finally:
        ev.close()
