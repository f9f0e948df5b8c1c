"""PyTorch port on the card: the CUDA kernel's two entry points (and the
three bodies behind them) against their plain versions, the numpy
oracle and the native CPU backend, the backend's staged path, degraded reads through EcVolume, leaf
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
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import seaweedfs_tpu_torch.ec.ec_volume as ecv
from seaweedfs_tpu_torch.ec import (
    CpuBackend,
    ECContext,
    EcVolume,
    TorchBackend,
    VolumeInfo,
    ec_encode_volume,
    get_backend,
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


def test_armed_encode_on_card_counts_device_stages_per_batch(cuda, tmp_path):
    """With the flight recorder armed, an encode on the card records one
    admission_wait, h2d_dispatch and device_drain per batch, and writes
    the shards the disarmed encode wrote. A pool's chip labels its device
    stages cuda:<index>; a `TorchBackend` (no chip label, as a
    single-device JaxBackend) labels the scheduled dispatch with its
    queue's label and the drain with ""."""
    from seaweedfs_tpu_torch.ec import device_queue
    from seaweedfs_tpu_torch.ec.chip_pool import ChipBackend
    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.utils import trace

    _needle_volume(tmp_path, n_needles=80)
    base = os.path.join(str(tmp_path), "1")
    ctx = ECContext(10, 4)
    disarmed = [open(base + ctx.to_ext(i), "rb").read() for i in range(14)]
    batches = len(list(batch_plan(os.path.getsize(base + ".dat"), 10, DEFAULT_BATCH,
                                  LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)))
    for be in (ChipBackend(ctx, "cuda:0"), TorchBackend(ctx)):
        trace.configure(enabled=True)
        trace.reset()
        try:
            ec_encode_volume(base, ctx, backend=be)
            (root,) = trace.traces()
        finally:
            trace.configure(enabled=False)
            trace.reset()
        (enc,) = root["children"]
        assert enc["op"] == "ec.encode" and str(be.device).startswith("cuda:")
        label = device_queue.for_backend(be).label
        want = {"admission_wait": label, "h2d_dispatch": label, "device_drain": be.chip_label}
        assert label == (be.chip_label or label) and (be.chip_label in ("", "cuda:0"))
        for s, chip in want.items():
            assert (enc["stages"][s]["count"], enc["stages"][s]["chip"]) == (batches, chip)
        assert [open(base + ctx.to_ext(i), "rb").read() for i in range(14)] == disarmed


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


# -- streaming EC and the MQ durable-parity partition on the card ----------------

STREAM_COLUMN_WIDTHS = [1, 5, 15, 16, 17, 1062, 4099, (8 << 10) + 5, 256 << 10, (1 << 20) - 3]


@pytest.mark.parametrize("width", STREAM_COLUMN_WIDTHS)
@pytest.mark.parametrize("k,m", [(10, 4), (4, 2)])
def test_stream_delta_column_matches_plain_and_oracle(cuda, width, k, m):
    """The stream's parity delta: one generator column (k = 1) over a
    chunk of any width, on the table body or the masked byte path."""
    coeffs = gf256.parity_rows(k, m)[:, 1:2]
    data_np = np.random.default_rng(width).integers(0, 256, (1, width), dtype=np.uint8)
    rs_kernels.reset_launches()
    b, data, out = _apply(coeffs, data_np, cuda)
    assert rs_kernels.LAUNCHES["gf2_apply"] == 1
    assert rs_kernels.MASKED["gf2_apply"] == (1 if width % 16 else 0)
    assert torch.equal(out, rs_kernels.gf2_apply_plain(b, data, m))
    assert np.array_equal(out.cpu().numpy(), gf256.matrix_apply(coeffs, data_np))


def _stream_run(base, ctx, backend, payload, block=1 << 20, small=64 << 10, flush_at=256 << 10):
    from seaweedfs_tpu_torch.ec import EcStreamEncoder

    enc = EcStreamEncoder(base, ctx, backend=backend, block_size=block, small_block_size=small)
    for pos in range(0, len(payload), 8192):
        enc.append(payload[pos : pos + 8192])
        if enc.pending_bytes >= flush_at:
            enc.flush()
    return enc.close()


def test_stream_on_card_matches_cpu(cuda, tmp_path):
    """16 MiB (and a ragged tail) appended in 8 KiB pieces, flushed at
    256 KiB: the card's shards are sha256-identical to the plain CPU
    run's, and it launched once per chunk and once per tail stripe."""
    ctx = ECContext(10, 4)
    payload = np.random.default_rng(77).bytes((16 << 20) + 12345)
    rs_kernels.reset_launches()
    on_card = _stream_run(str(tmp_path / "card"), ctx, TorchBackend(ctx), payload)
    launches = rs_kernels.LAUNCHES["gf2_apply"]
    on_cpu = _stream_run(str(tmp_path / "cpu"), ctx, TorchBackend(ctx, device="cpu"), payload)
    for i in range(ctx.total):
        ext = ctx.to_ext(i)
        assert (tmp_path / f"card{ext}").read_bytes() == (tmp_path / f"cpu{ext}").read_bytes(), i
    assert (on_card.shard_crcs, on_card.shard_leaf_crcs) == (on_cpu.shard_crcs, on_cpu.shard_leaf_crcs)
    chunks = (16 << 20) // (256 << 10) + 1  # every flush one chunk, then the tail flush's
    tail = len(payload) % (10 << 20)
    assert launches == chunks + -(-tail // (10 * (64 << 10)))


def test_recover_stream_on_card_matches_cpu(cuda, tmp_path):
    """A stream whose last appends were processed but never flushed,
    recovered on the card and on the CPU (a copy): the same recovery,
    the same files."""
    import shutil

    from seaweedfs_tpu_torch.ec import EcStreamEncoder, recover_stream

    ctx = ECContext(4, 2)
    payload = np.random.default_rng(5).bytes(700_000)
    d = tmp_path / "card"
    d.mkdir()
    enc = EcStreamEncoder(str(d / "s"), ctx, backend=TorchBackend(ctx, device="cpu"),
                          block_size=64 << 10, small_block_size=4096)
    enc.append(payload[:400_000])
    enc.flush()
    enc.append(payload[400_000:])
    enc.process()
    for fd in enc._fds:
        os.close(fd)
    enc._fds, enc.closed = [], True
    shutil.copytree(d, tmp_path / "cpu")
    rs_kernels.reset_launches()
    a = recover_stream(str(d / "s"), ctx, TorchBackend(ctx))
    assert rs_kernels.LAUNCHES["gf2_apply"] == -(-a.head // (4 * (64 << 10)))
    b = recover_stream(str(tmp_path / "cpu" / "s"), ctx, TorchBackend(ctx, device="cpu"))
    assert (a.head, a.data, a.parity_rewritten, a.rolled_back) == (b.head, b.data, b.parity_rewritten, b.rolled_back)
    assert a.data == payload[: a.head] and a.parity_rewritten >= 1
    for p in sorted(d.iterdir()):
        assert p.read_bytes() == (tmp_path / "cpu" / p.name).read_bytes(), p.name


def test_partition_on_card_takes_masked_path_and_recovers(cuda, tmp_path, monkeypatch):
    """1 KB records through a partition on the card, flushed by the test
    itself every 37 records (37 x 1,062 bytes, not a multiple of 16, so
    the flush widths are ragged and take the masked byte path), and
    recovery on the card equals the CPU's. The flushes are called at
    fixed record counts, not raced by a flusher thread, so the ragged
    widths do not depend on thread timing."""
    import shutil

    from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity

    monkeypatch.delenv("SEAWEED_EC_STREAM_BACKEND", raising=False)
    rng = np.random.default_rng(9)
    recs = [(i, 1000 + i, rng.bytes(16), rng.bytes(1024)) for i in range(3000)]
    pp = PartitionParity(str(tmp_path / "card"), "ns", "t", 0, block_size=256 << 10,
                         small_block_size=16 << 10, flush_bytes=16 << 10)
    assert pp.backend is None  # resolved at the first generation
    card = get_backend("cuda", 4, 2)  # the partition takes it from the cache
    rs_kernels.reset_launches()
    flushes = 0
    for n, r in enumerate(recs, 1):
        pp.append_record(*r)
        if n % 37 == 0:
            pp.flush()
            flushes += 1
    pp.close()
    assert flushes == len(recs) // 37
    assert pp.backend is card and card.device.type == "cuda"
    assert rs_kernels.MASKED["gf2_apply"] > 0
    shutil.copytree(tmp_path / "card", tmp_path / "cpu")
    got = PartitionParity(str(tmp_path / "card"), "ns", "t", 0).recover()
    cpu = PartitionParity(str(tmp_path / "cpu"), "ns", "t", 0,
                          backend=TorchBackend(ECContext(4, 2), device="cpu")).recover()
    assert got == cpu == recs


# -- the native CPU backend beside the card -----------------------------------

# phases 2 and 2b of chip_smoke.py: (k, width) and the coefficient kind
SMOKE_SHAPES = [
    (10, 1 << 20, "encode", 4), (10, 1 << 20, "decode", 2), (10, 16 << 20, "encode", 4),
    (10, 16 << 20, "decode", 2), (10, 64 << 10, "random", 1), (1, 256 << 10, "random", 4),
    (1, (8 << 10) + 5, "random", 4), (1, 256 << 10, "random", 2), (1, (8 << 10) + 5, "random", 2),
    (10, 256 << 10, "random", 1), (10, 16 << 20, "random", 1),
]


@pytest.mark.parametrize("k,width,kind,m", SMOKE_SHAPES)
def test_cpu_backend_matches_both_entry_points(cuda, k, width, kind, m):
    rng = np.random.default_rng(width % 1000 + m)
    coeffs = _coeffs(kind, k, m, rng)
    data_np = rng.integers(0, 256, (k, width), dtype=np.uint8)
    cpu = CpuBackend(ECContext(10, 4)).apply(coeffs, data_np)
    _, _, out = _apply(coeffs, data_np, cuda)
    assert np.array_equal(out.cpu().numpy(), cpu)
    planes = rs_torch.planes_from_numpy(rs_torch.bit_matrix_planes(coeffs, 1), cuda)
    data = torch.from_numpy(data_np).to(cuda)
    got = rs_kernels.gf2_apply_planes(planes, data, m=m, pack_width=1)
    assert np.array_equal(got.cpu().numpy(), cpu)


def test_cpu_encode_beside_card_encode_on_another_thread(cuda, tmp_path):
    """A CpuBackend encode (its column windows on the host library's
    pool) runs while a TorchBackend encode of the same bytes runs on
    another thread (its reads and shard sink on the same pool): both
    exact, and only the card's launched the kernel."""
    rng = np.random.default_rng(31)
    dat = rng.integers(0, 256, 40 << 20, dtype=np.uint8)
    ctx = ECContext(10, 4)
    for d in ("card", "cpu", "plain"):
        (tmp_path / d).mkdir()
        dat.tofile(tmp_path / d / "1.dat")
        (tmp_path / d / "1.idx").write_bytes(b"")
    write_ec_files(str(tmp_path / "plain" / "1"), ctx, backend=TorchBackend(ctx, device="cpu"))
    rs_kernels.reset_launches()
    errors = []

    def card():
        try:
            ec_encode_volume(str(tmp_path / "card" / "1"), ctx, backend=TorchBackend(ctx))
        except Exception as e:  # reported below, on the test's thread
            errors.append(e)

    t = threading.Thread(target=card)
    t.start()
    cpu = CpuBackend(ctx)
    ec_encode_volume(str(tmp_path / "cpu" / "1"), ctx, backend=cpu)
    t.join()
    assert not errors
    batches = rs_kernels.LAUNCHES["gf2_apply"]
    assert batches >= 1 and cpu.stage_seconds["kernel"] > 0
    for i in range(14):
        ext = f"1.ec{i:02d}"
        want = (tmp_path / "plain" / ext).read_bytes()
        assert (tmp_path / "card" / ext).read_bytes() == want
        assert (tmp_path / "cpu" / ext).read_bytes() == want


# -- the scheduler and the CPU failover on the card (chip_smoke.py phase 10) ---


def _batches(base: str) -> int:
    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan

    return len(list(batch_plan(os.path.getsize(base + ".dat"), 10, DEFAULT_BATCH,
                               LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)))


def _shards(base: str) -> list:
    return [open(base + f".ec{i:02d}", "rb").read() for i in range(14)]


def test_auto_backend_is_the_card_behind_a_fallback(cuda, monkeypatch):
    """10a: the bounded probe sees the card, and `auto` is a
    FallbackBackend whose primary is a TorchBackend on cuda:0; no CPU
    resolution is counted."""
    from seaweedfs_tpu_torch.ec import FallbackBackend, backend
    from seaweedfs_tpu_torch.utils import devices

    monkeypatch.setattr(devices, "_cached", None)
    before = dict(backend.AUTO_CPU)
    be = get_backend("auto", 5, 3)
    assert devices.probe_accelerators() == torch.cuda.device_count() >= 1
    assert isinstance(be, FallbackBackend) and type(be.primary) is TorchBackend
    assert str(be.primary.device) == "cuda:0" and be.device == be.primary.device
    assert backend.AUTO_CPU == before and be.fallback_batches == 0


def test_fallback_encode_on_card_serves_every_batch_on_the_card(cuda, tmp_path):
    """10b: unarmed, the FallbackBackend's encode is the card's: the same
    shards, no batch on the CPU, one launch and one foreground admission
    per batch, the breaker gauge at 0."""
    from seaweedfs_tpu_torch.ec import FallbackBackend, QueueScope, backend

    _needle_volume(tmp_path, n_needles=60)
    base = os.path.join(str(tmp_path), "1")
    ctx = ECContext(10, 4)
    want, n = _shards(base), _batches(base)
    fb = FallbackBackend(TorchBackend(ctx), CpuBackend(ctx))
    scope = QueueScope()
    rs_kernels.reset_launches()
    ec_encode_volume(base, ctx, backend=fb, scheduler=scope)
    assert _shards(base) == want and fb.fallback_batches == 0 and fb.breaker.state == "closed"
    assert rs_kernels.LAUNCHES["gf2_apply"] == n
    (q,) = scope.stats_snapshot()
    assert q["classes"]["foreground"]["admitted"] == n and q["breaker"] == "closed"
    label = f"TorchBackend@{fb._seq}"
    assert dict((lab["chip"], v) for lab, v in backend._breaker_samples())[label] == 0.0


def test_fallback_fails_over_on_card_and_closes_by_probe(cuda, tmp_path):
    """10c: every to_host fails: each batch is recomputed on the CPU from
    its host copy (the same shards), launches equal the batches that
    reached the card (the to_host point's hits), the gauge reads 1; after
    the reset timeout an unarmed encode closes the breaker through its
    half-open probe, with no further fallback; a rebuild through the
    staged-apply driver on a card that loses two batches at dispatch and
    one at drain (OSErrors, the class the fallback takes for a lost
    device) is exact, with those three on the CPU, the breaker closed
    and the launches equal to the batches that reached the card."""
    import time

    from seaweedfs_tpu_torch import faults
    from seaweedfs_tpu_torch.ec import FallbackBackend, backend, rebuild_ec_files
    from seaweedfs_tpu_torch.utils.retry import CircuitBreaker

    _needle_volume(tmp_path, n_needles=150)  # 3 batches of 1 MiB rows
    base = os.path.join(str(tmp_path), "1")
    ctx = ECContext(10, 4)
    want, n = _shards(base), _batches(base)
    assert n >= 2
    fb = FallbackBackend(TorchBackend(ctx), CpuBackend(ctx),
                         breaker=CircuitBreaker(failure_threshold=2, reset_timeout=2.0))
    label = f"TorchBackend@{fb._seq}"
    rs_kernels.reset_launches()
    try:
        with faults.injected("ec.backend.device.to_host", faults.io_error()) as h:
            ec_encode_volume(base, ctx, backend=fb)
        assert _shards(base) == want and fb.fallback_batches == n
        assert rs_kernels.LAUNCHES["gf2_apply"] == h.hits >= 2
        assert fb.breaker.state == "open"
        assert dict((lab["chip"], v) for lab, v in backend._breaker_samples())[label] == 1.0
        time.sleep(2.1)
        rs_kernels.reset_launches()
        ec_encode_volume(base, ctx, backend=fb)
        # the first batch is the half-open probe; batches dispatched while
        # it is in flight go to the CPU; the rest run on the card
        during_probe = fb.fallback_batches - n
        assert _shards(base) == want and fb.breaker.state == "closed"
        assert rs_kernels.LAUNCHES["gf2_apply"] + during_probe == n and during_probe < n
        for i in (3, 11):
            os.unlink(base + ctx.to_ext(i))

        class LosingCard(TorchBackend):
            dispatched = drained = 0

            def apply_staged(self, coeffs, staged):
                self.dispatched += 1
                if self.dispatched in (1, 2):
                    raise OSError("the card was lost at dispatch")
                return super().apply_staged(coeffs, staged)

            def to_host(self, result):
                self.drained += 1
                if self.drained == 2:
                    raise OSError("the card was lost at drain")
                return super().to_host(result)

        lossy = LosingCard(ctx)
        fr = FallbackBackend(lossy, CpuBackend(ctx),
                             breaker=CircuitBreaker(failure_threshold=3, reset_timeout=2.0))
        rs_kernels.reset_launches()
        assert rebuild_ec_files(base, ctx, backend=fr, batch_size=64 << 10) == [3, 11]
        assert _shards(base) == want and lossy.dispatched >= 4
        assert (fr.fallback_batches, fr.breaker.state) == (3, "closed")
        assert rs_kernels.LAUNCHES["gf2_apply"] == lossy.dispatched - 2
    finally:
        faults.clear()


def test_fallback_does_not_hide_a_failed_launch_on_card(cuda, monkeypatch):
    """A kernel launch that fails on the card re-raises from the
    FallbackBackend, synchronous and staged, with no batch on the CPU
    and the breaker untouched: the CPU never stands in for the kernel."""
    from seaweedfs_tpu_torch.ec import FallbackBackend

    class FailingLaunch:
        def gf2_apply(self, *args):
            return 700  # cudaErrorIllegalAddress

        gf2_apply_planes = gf2_apply

    monkeypatch.setattr(rs_kernels, "_kernel_lib", FailingLaunch)
    ctx = ECContext(10, 4)
    fb = FallbackBackend(TorchBackend(ctx), CpuBackend(ctx))
    data = np.zeros((10, 4096), dtype=np.uint8)
    rs_kernels.reset_launches()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        fb.encode(data)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        fb.to_host(fb.encode_staged(fb.to_device(data)))
    assert (fb.fallback_batches, fb.breaker.state, fb.breaker._failures) == (0, "closed", 0)
    assert rs_kernels.LAUNCHES["gf2_apply"] == 0


def test_recovery_rebuild_beside_foreground_encode_on_one_backend(cuda, tmp_path):
    """10d: a foreground encode and a recovery rebuild on one backend
    under one QueueScope, concurrently: both outputs exact, each class
    admitted once per batch."""
    import shutil

    from seaweedfs_tpu_torch.ec import FallbackBackend, QueueScope, rebuild_ec_files

    (tmp_path / "enc").mkdir()
    _needle_volume(tmp_path / "enc", n_needles=60)
    enc = os.path.join(str(tmp_path / "enc"), "1")
    shutil.copytree(tmp_path / "enc", tmp_path / "reb")
    reb = os.path.join(str(tmp_path / "reb"), "1")
    ctx = ECContext(10, 4)
    want = _shards(enc)
    for i in (3, 11):
        os.unlink(reb + ctx.to_ext(i))
    fb = FallbackBackend(TorchBackend(ctx), CpuBackend(ctx))
    scope = QueueScope()
    errors = []

    def rebuild():
        try:
            assert rebuild_ec_files(reb, ctx, backend=fb, batch_size=1 << 18,
                                    priority="recovery", scheduler=scope) == [3, 11]
        except BaseException as e:  # reported on the test's thread
            errors.append(e)

    t = threading.Thread(target=rebuild)
    t.start()
    ec_encode_volume(enc, ctx, backend=fb, scheduler=scope)
    t.join()
    assert not errors and _shards(enc) == want and _shards(reb) == want
    (q,) = scope.stats_snapshot()
    shard = os.path.getsize(enc + ".ec00")
    assert q["classes"]["foreground"]["admitted"] == _batches(enc)
    assert q["classes"]["recovery"]["admitted"] == -(-shard // (1 << 18))
    assert fb.fallback_batches == 0 and q["load"] == 0


def test_stream_and_auto_partition_on_card(cuda, tmp_path, monkeypatch):
    """10e: a stream on the card admits one foreground batch per launch;
    an MQ partition with SEAWEED_EC_STREAM_BACKEND=auto runs on the card
    behind a FallbackBackend and replays byte-exact with no fallback."""
    from seaweedfs_tpu_torch.ec import EcStreamEncoder, FallbackBackend, QueueScope
    from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity

    ctx = ECContext(4, 2)
    scope = QueueScope()
    payload = np.random.default_rng(21).bytes(1_000_003)
    rs_kernels.reset_launches()
    enc = EcStreamEncoder(str(tmp_path / "s"), ctx, backend=TorchBackend(ctx), block_size=64 << 10,
                          small_block_size=4096, scheduler=scope)
    for off in range(0, len(payload), 8192):
        enc.append(payload[off : off + 8192])
        if off % (64 << 10) == 0:
            enc.flush()
    enc.close()
    (q,) = scope.stats_snapshot()
    assert q["classes"]["foreground"]["admitted"] == rs_kernels.LAUNCHES["gf2_apply"] > 10
    monkeypatch.setenv("SEAWEED_EC_STREAM_BACKEND", "auto")
    monkeypatch.delenv("SEAWEED_EC_STREAM_REMOTE_ROOTS", raising=False)
    rng = np.random.default_rng(22)
    recs = [(i, 5 + i, rng.bytes(16), rng.bytes(1024)) for i in range(1500)]
    pp = PartitionParity(str(tmp_path / "mq"), "ns", "t", 0, block_size=256 << 10,
                         small_block_size=16 << 10, flush_bytes=16 << 10)
    for n, r in enumerate(recs, 1):
        pp.append_record(*r)
        if n % 200 == 0:
            pp.flush()
    pp.close()
    assert isinstance(pp.backend, FallbackBackend) and pp.backend.device.type == "cuda"
    assert pp.backend.fallback_batches == 0
    assert PartitionParity(str(tmp_path / "mq"), "ns", "t", 0).recover() == recs



# -------------------------------------------- peer-fetch rebuild on the card


def _peer_local(tmp_path, name, blobs, rotten):
    """A local holder of shards 0, 1, 2 and 4 of the _leaf_volume in
    tmp_path/peer, shard 4 with `rotten` leaves."""
    d = tmp_path / name
    d.mkdir()
    base = str(d / "1")
    for ext in (".ecsum", ".vif"):
        with open(str(tmp_path / "peer" / "1") + ext, "rb") as f, open(base + ext, "wb") as g:
            g.write(f.read())
    for i in (0, 1, 2, 4):
        with open(base + f".ec{i:02d}", "wb") as f:
            f.write(blobs[i])
    _rot_leaves(base, 4, rotten)
    return base


def test_peer_rebuild_on_card_matches_cpu(cuda, tmp_path):
    """Shards 3 and 11 rebuilt on the card from shards fetched over the
    shard net plane (native landing), with shard 4's two rotten leaves
    repaired from ranged fetches first: one gf2_apply launch per rebuild
    batch and per leaf range, and every output bit-identical to the same
    rebuild on TorchBackend(device="cpu") and to the shards as encoded."""
    from seaweedfs_tpu_torch.ec import net_plane, rebuild_from_peers
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH
    from seaweedfs_tpu_torch.ec.peer_rebuild import PeerFetchTransient

    (tmp_path / "peer").mkdir()
    blobs = _leaf_volume(tmp_path / "peer")
    ctx = ECContext(10, 4)
    fds = {}

    def resolve(vid, sid, gen):
        if sid not in fds:
            fds[sid] = os.open(str(tmp_path / "peer" / "1") + f".ec{sid:02d}", os.O_RDONLY)
        return fds[sid], os.fstat(fds[sid]).st_size

    plane = net_plane.ShardNetPlane("127.0.0.1", 0, resolve)
    plane.start()
    client = net_plane.NetPlaneClient(timeout=10.0)
    addr = ("127.0.0.1", plane.port)

    def fetch(peer, sid, off, size):
        try:
            return client.read_bytes(addr, 1, sid, 9, off, size)
        except net_plane.NetPlaneError as e:
            raise PeerFetchTransient(str(e)) from e

    holders = {i: ["p"] for i in range(5, 14) if i != 11}
    out = {}
    try:
        for device in ("cuda", "cpu"):
            base = _peer_local(tmp_path, device, blobs, [2, 6])
            rs_kernels.reset_launches()
            rep = rebuild_from_peers(
                base, holders, fetch, ctx=ctx, targets=[3, 11],
                backend=TorchBackend(ctx, device=device),
                fetch_into=net_plane.make_fetch_into(client, 1, 9, addr_of=lambda p: addr),
            )
            assert rep.leaf_repaired == {4: [2, 6]} and rep.rebuilt == [3, 11]
            assert set(rep.fetched_plane.values()) == {"native"} and sorted(rep.fetched) == list(range(5, 11))
            if device == "cuda":
                batches = -(-len(blobs[0]) // DEFAULT_BATCH)
                assert rs_kernels.LAUNCHES["gf2_apply"] == batches + 2
            out[device] = {i: open(base + f".ec{i:02d}", "rb").read() for i in (3, 4, 11)}
    finally:
        client.close()
        plane.stop()
        for fd in fds.values():
            os.close(fd)
    assert out["cuda"] == out["cpu"] == {i: blobs[i] for i in (3, 4, 11)}


def test_ranged_peer_repair_launches_gf2_apply_per_range(cuda, tmp_path):
    """Leaf repair through rebuild_from_peers alone (nothing to rebuild):
    each rotten leaf range is reconstructed by one gf2_apply launch on
    the card from k range-verified sources, 3 local and 7 fetched."""
    from seaweedfs_tpu_torch.ec import rebuild_from_peers

    (tmp_path / "peer").mkdir()
    blobs = _leaf_volume(tmp_path / "peer")
    ctx = ECContext(10, 4)
    base = _peer_local(tmp_path, "local", blobs, [1, 2, 9])  # two ranges

    def fetch(peer, sid, off, size):
        return blobs[sid][off : off + size]

    rs_kernels.reset_launches()
    rep = rebuild_from_peers(base, {i: ["p"] for i in range(5, 14)}, fetch, ctx=ctx, targets=[],
                             backend=TorchBackend(ctx))
    assert rep.leaf_repaired == {4: [1, 2, 9]} and rep.rebuilt == []
    assert rs_kernels.LAUNCHES["gf2_apply"] == 2 and not rs_kernels.LAUNCHES["gf2_apply_planes"]
    assert rep.repair_wire_bytes == 7 * (2 * LEAF + LEAF)
    assert open(base + ".ec04", "rb").read() == blobs[4]


def test_recv_into_overlap_modes_agree_over_loopback(cuda, monkeypatch):
    """4 MiB over loopback TCP with the fused 64 KiB granule CRC: the
    overlapped core forced on and forced off land the same bytes and the
    same CRCs (the card's host takes the overlapped core by default)."""
    from seaweedfs_tpu_torch.utils import native
    from seaweedfs_tpu_torch.utils.crc import crc32c

    payload = np.random.default_rng(23).integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
    got = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("SEAWEED_EC_NET_OVERLAP", mode)
        assert native.recv_overlap_active(len(payload)) is (mode == "1")
        srv = socket.create_server(("127.0.0.1", 0))
        a = socket.create_connection(srv.getsockname())
        b, _ = srv.accept()
        try:
            t = threading.Thread(target=a.sendall, args=(payload,))
            t.start()
            dst = np.zeros(len(payload), np.uint8)
            crcs, counts = np.zeros(len(payload) // 65536 + 2, np.uint32), np.zeros(1, np.int32)
            n = native.recv_into(b.fileno(), dst, len(payload), timeout_ms=20000, granule=65536,
                                 crc_state=np.zeros(1, np.uint32), filled_state=np.zeros(1, np.uint64),
                                 out_crcs=crcs, out_counts=counts)
            t.join()
        finally:
            for s in (a, b, srv):
                s.close()
        assert n == len(payload) and dst.tobytes() == payload
        got[mode] = crcs[: int(counts[0])].tolist()
    assert got["0"] == got["1"] == [crc32c(payload[i : i + 65536]) for i in range(0, len(payload), 65536)]


# ------------------------------------- the Store and remote stream shards


def test_store_degraded_read_on_card_matches_cpu_store(cuda, tmp_path):
    """A Store on the card (ec_backend="cuda", the default) and one on the
    native CPU backend over copies of one encoded volume, shard 3
    unmounted in both: every needle reads bit-identically, the card's
    reconstructions each one gf2_apply_planes launch (one per interval
    cache miss), nothing launched by the CPU store."""
    import shutil

    from seaweedfs_tpu_torch.storage.store import Store

    ctx = ECContext(10, 4)
    rng = np.random.default_rng(31)
    card_dir, cpu_dir = tmp_path / "card", tmp_path / "cpu"
    store = Store([str(card_dir)])
    v = store.allocate_volume(3)
    bodies = {}
    for nid in range(1, 60):
        bodies[nid] = rng.bytes(int(rng.integers(1000, 200_000)))
        store.write_needle(3, Needle(cookie=nid, needle_id=nid, data=bodies[nid]))
    v.set_read_only(True)
    ec_encode_volume(v.dat_path[:-4], ctx, backend=TorchBackend(ctx))
    store.unmount_volume(3)
    shutil.copytree(card_dir, cpu_dir)
    got = {}
    try:
        for name, st in (("card", store), ("cpu", Store([str(cpu_dir)], ec_backend="cpu"))):
            if st.find_volume(3) is not None:  # the fresh store mounted the sealed .dat too
                st.unmount_volume(3)
            ev = st.mount_ec_volume(3)
            st.unmount_ec_shards(3, [3])
            rs_kernels.reset_launches()
            loads = ev.interval_cache.loads
            got[name] = {nid: st.read_needle(3, nid, cookie=nid).data for nid in bodies}
            if name == "card":
                assert ev.backend.device.type == "cuda" and ev.backend.impl == "cuda_planes"
                assert rs_kernels.LAUNCHES["gf2_apply_planes"] == ev.interval_cache.loads - loads > 0
                assert rs_kernels.LAUNCHES["gf2_apply"] == 0
            else:
                assert isinstance(ev.backend, CpuBackend) and sum(rs_kernels.LAUNCHES.values()) == 0
                st.close()
    finally:
        store.close()
    assert got["card"] == got["cpu"] == bodies


def test_remote_root_partition_flush_on_card(cuda, tmp_path, monkeypatch):
    """A partition with a mounted and a net-plane remote root flushes its
    parity deltas on the card (one gf2_apply launch per delta) and pushes
    its net-planned shards over the native plane; at close every remote
    data shard equals its local file (a parity shard has its length: each
    extent is pushed once, as in the JAX package) and recovery gives back
    every record."""
    from seaweedfs_tpu_torch.ec import net_plane
    from seaweedfs_tpu_torch.ec.stream_encode import EcStreamEncoder
    from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity

    blobs = tmp_path / "blobs"

    def resolve_blob(path, op, md):
        full = blobs / path
        if op == "unlink":
            full.unlink(missing_ok=True)
            return None
        full.parent.mkdir(parents=True, exist_ok=True)
        return os.open(str(full), os.O_CREAT | os.O_RDWR, 0o644)

    def refuse(vid, sid, gen):
        raise net_plane.NetPlaneError("no shards here")

    srv = net_plane.ShardNetPlane("127.0.0.1", 0, refuse, resolve_blob=resolve_blob)
    srv.start()
    gport = srv.port - net_plane.NET_PLANE_PORT_OFFSET
    monkeypatch.setenv("SEAWEED_EC_STREAM_BACKEND", "cuda")
    monkeypatch.setenv("SEAWEED_EC_STREAM_REMOTE_ROOTS",
                       f"far={tmp_path / 'far'},peer=net:127.0.0.1:{gport}/sub")
    deltas = [0]
    apply = EcStreamEncoder._dispatch_apply

    def counted(self, coeffs, data):
        deltas[0] += 1
        return apply(self, coeffs, data)

    monkeypatch.setattr(EcStreamEncoder, "_dispatch_apply", counted)
    rng = np.random.default_rng(23)
    recs = [(i, 9 + i, rng.bytes(16), rng.bytes(1024)) for i in range(1200)]
    try:
        rs_kernels.reset_launches()
        pp = PartitionParity(str(tmp_path / "mq"), "ns", "t", 0, block_size=64 << 10,
                             small_block_size=8 << 10, rotate_bytes=512 << 10)
        for n, r in enumerate(recs, 1):
            pp.append_record(*r)
            if n % 150 == 0:
                pp.flush()
        plans = {p: rp for plan in pp._net_shards.values() for p, (_a, rp) in plan.items()}
        pp.close()
        assert pp.backend.device.type == "cuda" and rs_kernels.LAUNCHES["gf2_apply"] == deltas[0] > 0
        assert plans and srv.status()["write_native_bytes"] > 0 and srv.status()["write_python_bytes"] == 0
        parity = tuple(pp.ctx.to_ext(s) for s in range(pp.ctx.data_shards, pp.ctx.total))
        for path, rpath in plans.items():
            with open(path, "rb") as f:
                local = f.read()
            remote = (blobs / rpath).read_bytes() if (blobs / rpath).exists() else b""
            if path.endswith(parity):
                assert len(remote) == len(local), rpath
            else:
                assert remote == local, rpath
        assert any(os.path.islink(os.path.join(pp.dir, n)) for n in os.listdir(pp.dir))
        assert PartitionParity(str(tmp_path / "mq"), "ns", "t", 0).recover() == recs
    finally:
        srv.stop()


def test_recv_file_over_loopback_at_4mib(cuda, tmp_path):
    """sn_recv_file lands 4 MiB from a loopback TCP socket at an offset of
    a file: the bytes and the CRC32C equal the written file's."""
    from seaweedfs_tpu_torch.utils import native
    from seaweedfs_tpu_torch.utils.crc import crc32c

    payload = np.random.default_rng(24).bytes(4 << 20)
    lst = socket.create_server(("127.0.0.1", 0))
    try:
        out = socket.create_connection(lst.getsockname())
        conn, _ = lst.accept()
    finally:
        lst.close()
    conn.settimeout(10.0)  # O_NONBLOCK: the landing polls
    path = tmp_path / "blob"
    fd = os.open(str(path), os.O_CREAT | os.O_RDWR, 0o644)
    try:
        t = threading.Thread(target=out.sendall, args=(payload,))
        t.start()
        got, crc = native.recv_file(conn.fileno(), fd, 4096, len(payload), timeout_ms=10000)
        t.join()
    finally:
        os.close(fd)
        out.close()
        conn.close()
    assert got == len(payload) and crc == crc32c(payload)
    assert path.read_bytes() == bytes(4096) + payload
