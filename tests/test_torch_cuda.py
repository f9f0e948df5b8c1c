"""PyTorch port on the card: the CUDA kernel's two entry points (and the
three bodies behind them) against their plain versions and the numpy
oracle, the backend's staged path, and degraded reads through EcVolume.

Every test here needs an NVIDIA card and skips without one. This file
imports no JAX, so it runs where JAX is not installed; on the card run it
without the JAX-based conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

All comparisons are exact (tolerance 0: integer GF arithmetic).
"""

import os
import threading

import numpy as np
import pytest
import torch

import seaweedfs_tpu_torch.ec.ec_volume as ecv
from seaweedfs_tpu_torch.ec import ECContext, EcVolume, TorchBackend, ec_encode_volume
from seaweedfs_tpu_torch.ec.backend import _decode_coeffs
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
