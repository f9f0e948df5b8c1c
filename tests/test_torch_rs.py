"""PyTorch port: the GF(2) apply kernel's plain version and RSTorch, held
against the JAX package's Pallas kernel (interpret mode, CPU) and the
numpy oracle.

All comparisons are exact (tolerance 0): GF(256) arithmetic is integer
arithmetic. Inputs are made with numpy from fixed seeds and handed to
both packages. The CUDA kernel itself runs only on a card: see
tests/test_torch_cuda.py and chip_smoke.py.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jgf256
from seaweedfs_tpu.ops import rs_jax, rs_pallas
from seaweedfs_tpu_torch.ops import gf256, rs_kernels, rs_torch

WIDTHS = [1, 7, 127, 600, 1000]


def _pallas(coeffs, data, pack_width=1):
    m, k = coeffs.shape
    b = jnp.asarray(rs_jax.bit_matrix_bitmajor(coeffs), jnp.float32)
    return np.asarray(
        rs_pallas.apply_bitmajor_pallas(
            b, jnp.asarray(data), k=k, m=m, tile_n=128,
            pack_width=pack_width, interpret=True,
        )
    )


def _port(coeffs, data, pack_width=1):
    b = rs_torch.bits_from_numpy(rs_torch.bit_matrix_bitmajor(coeffs), "cpu")
    out = rs_kernels.gf2_apply(
        b, torch.from_numpy(data), m=coeffs.shape[0], pack_width=pack_width
    )
    return out.numpy()


# ------------------------------------------------------------ (a) the kernel


@pytest.mark.parametrize("pack_width", [1, 2])
@pytest.mark.parametrize("width", WIDTHS)
def test_plain_matches_pallas_and_oracle(pack_width, width):
    rng = np.random.default_rng(1000 + width)
    coeffs = gf256.parity_rows(10, 4)
    data = rng.integers(0, 256, size=(10, width), dtype=np.uint8)
    got = _port(coeffs, data, pack_width)
    assert got.shape == (4, width) and got.dtype == np.uint8
    assert np.array_equal(got, _pallas(coeffs, data, pack_width))
    assert np.array_equal(got, gf256.matrix_apply(coeffs, data))


def test_all_byte_values():
    """Every byte value in every shard row, against every coefficient."""
    rng = np.random.default_rng(7)
    data = np.stack([np.roll(np.arange(256, dtype=np.uint8), 17 * i) for i in range(10)])
    coeffs = np.concatenate(
        [gf256.parity_rows(10, 4), rng.integers(0, 256, (4, 10), dtype=np.uint8)]
    )
    coeffs[0, :] = np.arange(0, 250, 25, dtype=np.uint8)  # includes 0 and 1
    got = _port(coeffs, data)
    assert np.array_equal(got, gf256.matrix_apply(coeffs, data))
    assert np.array_equal(got, _pallas(coeffs, data))


@pytest.mark.parametrize("k,m", [(6, 3), (12, 4), (4, 2)])
def test_custom_ratios(k, m):
    rng = np.random.default_rng(k * 100 + m)
    coeffs = gf256.parity_rows(k, m)
    data = rng.integers(0, 256, size=(k, 513), dtype=np.uint8)
    got = _port(coeffs, data)
    assert np.array_equal(got, _pallas(coeffs, data, pack_width=2))
    assert np.array_equal(got, jgf256.ReedSolomon(k, m).encode(data))


def test_pack_width_4_rejected():
    coeffs = gf256.parity_rows(10, 4)
    data = np.zeros((10, 512), np.uint8)
    with pytest.raises(NotImplementedError):
        _port(coeffs, data, pack_width=4)
    with pytest.raises(NotImplementedError):
        _pallas(coeffs, data, pack_width=4)
    with pytest.raises(ValueError):
        _port(coeffs, data, pack_width=3)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    b = rs_torch.bits_from_numpy(
        rs_torch.bit_matrix_bitmajor(gf256.parity_rows(10, 4)), "cpu"
    )
    data = torch.zeros((10, 64), dtype=torch.uint8)
    with pytest.raises(TypeError):
        rs_kernels.gf2_apply(b, data.to(torch.int32), m=4)
    with pytest.raises(ValueError):
        rs_kernels.gf2_apply(b, data[:9], m=4)  # k mismatch
    with pytest.raises(ValueError):
        rs_kernels.gf2_apply(b, data, m=3)  # m mismatch
    with pytest.raises(ValueError):
        rs_kernels.gf2_apply(b, torch.zeros((64, 10), dtype=torch.uint8).t(), m=4)
    with pytest.raises(ValueError):
        rs_torch.bits_from_numpy(np.full((32, 80), 2.0), "cpu")


def test_cpu_tensor_runs_plain_version_without_counting_a_launch():
    before = rs_kernels.LAUNCHES["gf2_apply"]
    coeffs = gf256.parity_rows(10, 4)
    data = np.random.default_rng(3).integers(0, 256, (10, 100), dtype=np.uint8)
    b = rs_torch.bits_from_numpy(rs_torch.bit_matrix_bitmajor(coeffs), "cpu")
    got = rs_kernels.gf2_apply(b, torch.from_numpy(data), m=4)
    assert torch.equal(got, rs_kernels.gf2_apply_plain(b, torch.from_numpy(data), 4))
    assert rs_kernels.LAUNCHES["gf2_apply"] == before


def test_bits_from_jax_parity_bits_match_port_expansion():
    jx = rs_jax.RSJax(10, 4, impl="pallas", interpret=True, tile_n=128)
    theirs = rs_torch.bits_from_numpy(jx._parity_bits, "cpu")
    ours = rs_torch.RSTorch(10, 4, device="cpu")._parity_bits
    assert torch.equal(theirs, ours)
    data = np.random.default_rng(5).integers(0, 256, (10, 300), dtype=np.uint8)
    got = rs_kernels.gf2_apply(theirs, torch.from_numpy(data), m=4).numpy()
    assert np.array_equal(got, np.asarray(jx.encode(data)))


def test_gf_tables_and_matrix_match_the_jax_package():
    assert np.array_equal(gf256.EXP_TABLE, jgf256.EXP_TABLE)
    assert np.array_equal(gf256.LOG_TABLE, jgf256.LOG_TABLE)
    for k, m in [(10, 4), (6, 3), (12, 4)]:
        assert np.array_equal(gf256.build_matrix(k, k + m), jgf256.build_matrix(k, k + m))
        coeffs = gf256.parity_rows(k, m)
        assert np.array_equal(
            rs_torch.bit_matrix_bitmajor(coeffs), rs_jax.bit_matrix_bitmajor(coeffs)
        )


# ----------------------------------------------------------- (b) the codec


@pytest.fixture(scope="module")
def codecs():
    jx = rs_jax.RSJax(10, 4, impl="pallas", interpret=True, tile_n=128)
    port = rs_torch.RSTorch(10, 4, impl="cuda", device="cpu")
    plain = rs_torch.RSTorch(10, 4, impl="torch", device="cpu")
    data = np.random.default_rng(11).integers(0, 256, (10, 300), dtype=np.uint8)
    full = np.concatenate([data, np.asarray(jx.encode(data))])
    return jx, port, plain, full


def test_rstorch_encode(codecs):
    jx, port, plain, full = codecs
    assert np.array_equal(port.encode(full[:10]).numpy(), full[10:])
    assert np.array_equal(plain.encode(torch.from_numpy(full[:10])).numpy(), full[10:])
    assert port.verify(full)
    bad = full.copy()
    bad[12, 5] ^= 1
    assert not port.verify(bad)
    with pytest.raises(ValueError):
        port.encode(full[:9])


LOSSES = [c for r in (1, 2) for c in itertools.combinations(range(14), r)]


@pytest.mark.parametrize("lost", LOSSES, ids=lambda t: "-".join(map(str, t)))
def test_rstorch_reconstruct_matches_rsjax(codecs, lost):
    jx, port, _, full = codecs
    present = {i: full[i] for i in range(14) if i not in lost}
    want = jx.reconstruct(present)
    got = port.reconstruct(present)
    assert sorted(got) == sorted(want) == list(lost)
    for i in lost:
        assert np.array_equal(got[i].numpy(), np.asarray(want[i]))
        assert np.array_equal(got[i].numpy(), full[i])


def test_rstorch_reconstruct_data_only_and_want(codecs):
    jx, port, plain, full = codecs
    present = {i: full[i] for i in range(14) if i not in (2, 7, 11, 13)}
    got = port.reconstruct(present, data_only=True)
    want = jx.reconstruct(present, data_only=True)
    assert sorted(got) == sorted(want) == [2, 7]
    for i in (2, 7):
        assert np.array_equal(got[i].numpy(), full[i])
    got = plain.reconstruct(present, want=[11])
    assert sorted(got) == [11]
    assert np.array_equal(got[11].numpy(), np.asarray(jx.reconstruct(present, want=[11])[11]))
    assert port.reconstruct({i: full[i] for i in range(14)}) == {}
    with pytest.raises(ValueError):
        port.reconstruct({i: full[i] for i in range(9)})


def test_rstorch_apply_and_caches(codecs):
    jx, port, _, full = codecs
    rng = np.random.default_rng(13)
    for rows in (1, 2, 5):
        coeffs = rng.integers(0, 256, (rows, 10), dtype=np.uint8)
        got = port.apply(coeffs, full[:10]).numpy()
        assert np.array_equal(got, np.asarray(jx.apply(coeffs, full[:10])))
        assert port.coeff_bits(coeffs) is port.coeff_bits(coeffs)
    with pytest.raises(ValueError):
        port.apply(np.zeros((2, 9), np.uint8), full[:10])
    assert port._rows_bits((0,), tuple(range(1, 11))) is port._rows_bits(
        (0,), tuple(range(1, 11))
    )
    for i in range(70):  # bounded LRU
        port.coeff_bits(np.full((1, 10), i, np.uint8))
    assert len(port._coeff_bits_cache) == 64


# ------------------------------------------- (c) the plane-stack entry point


def _pallas_planes(coeffs, data, pack_width=1):
    m, k = coeffs.shape
    p = jnp.asarray(rs_pallas.bit_matrix_planes(coeffs, pack_width=pack_width))
    return np.asarray(
        rs_pallas.apply_planes_pallas(
            p, jnp.asarray(data), k=k, m=m, tile_n=128,
            pack_width=pack_width, interpret=True,
        )
    )


def _port_planes(coeffs, data, pack_width=1):
    p = rs_torch.planes_from_numpy(rs_torch.bit_matrix_planes(coeffs, pack_width), "cpu")
    out = rs_kernels.gf2_apply_planes(
        p, torch.from_numpy(data), m=coeffs.shape[0], pack_width=pack_width
    )
    return out.numpy()


@pytest.mark.parametrize("km", [(10, 1), (10, 2), (10, 3), (10, 4), (20, 12)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("pack_width", [1, 2])
@pytest.mark.parametrize("width", WIDTHS)
def test_planes_plain_matches_pallas_aligned_and_oracle(km, pack_width, width):
    k, m = km
    rng = np.random.default_rng(width * 100 + k * 10 + m + pack_width)
    coeffs = rng.integers(0, 256, (m, k), dtype=np.uint8)
    data = rng.integers(0, 256, size=(k, width), dtype=np.uint8)
    got = _port_planes(coeffs, data, pack_width)
    assert got.shape == (m, width) and got.dtype == np.uint8
    assert np.array_equal(got, _pallas_planes(coeffs, data, pack_width))
    assert np.array_equal(got, gf256.matrix_apply(coeffs, data))


@pytest.mark.parametrize("m_pad,pack_width", [(32, 1), (16, 2)])
def test_planes_every_m_up_to_m_pad(m_pad, pack_width):
    """The fold's m_pad stride where m != m_pad: every m from 1 to m_pad,
    across the 8-row launch groups."""
    rng = np.random.default_rng(m_pad)
    data = rng.integers(0, 256, size=(10, 77), dtype=np.uint8)
    for m in range(1, m_pad + 1):
        coeffs = rng.integers(0, 256, (m, 10), dtype=np.uint8)
        p = rs_torch.bit_matrix_planes(coeffs, pack_width)
        assert p.shape == (8, 10, 8 * m_pad)
        assert np.array_equal(
            _port_planes(coeffs, data, pack_width), gf256.matrix_apply(coeffs, data)
        )


def test_planes_errors_in_the_tpu_wrappers_order():
    """apply_planes_pallas's checks, in order: pack_width, sublane
    legality of m_pad, m <= m_pad, then the kernel's pw=4 refusal
    (tests/test_rs_pallas.py:151-161 for the JAX side)."""
    coeffs = gf256.parity_rows(10, 4)
    data = np.zeros((10, 256), np.uint8)
    tdata = torch.from_numpy(data)
    pw2 = rs_torch.bit_matrix_planes(coeffs, pack_width=2)  # m_pad 16
    pw1 = rs_torch.bit_matrix_planes(coeffs, pack_width=1)  # m_pad 32

    def both(planes, m, pw):
        outcomes = []
        for fn in (
            lambda: rs_kernels.gf2_apply_planes(
                torch.from_numpy(planes), tdata, m=m, pack_width=pw
            ),
            lambda: rs_pallas.apply_planes_pallas(
                jnp.asarray(planes, jnp.float32), jnp.asarray(data), k=10, m=m,
                tile_n=128, pack_width=pw, interpret=True,
            ),
        ):
            with pytest.raises(Exception) as info:
                fn()
            outcomes.append((type(info.value), str(info.value)))
        assert outcomes[0][0] is outcomes[1][0]
        if outcomes[0][0] is ValueError:  # the wrapper's own messages
            assert outcomes[0][1] == outcomes[1][1]
        return outcomes[0]

    # 1. pack_width outside {1, 2, 4} wins over a bad m_pad and m
    assert both(pw2, 99, 3)[0] is ValueError
    # 2. m_pad 16 is not sublane-legal for pw=1 (wins over m > m_pad)
    err = both(pw2, 99, 1)
    assert err[0] is ValueError and "sublane-legal" in err[1]
    # 3. m > m_pad
    err = both(pw1, 33, 1)
    assert err[0] is ValueError and "exceeds" in err[1]
    err = both(pw1, 33, 4)
    assert err[0] is ValueError and "exceeds" in err[1]
    # 4. pw=4 on a legal stack
    assert both(pw2, 4, 4)[0] is NotImplementedError
    # pack_width 1 and 2 give identical bytes
    rng = np.random.default_rng(3)
    d = rng.integers(0, 256, (10, 300), dtype=np.uint8)
    assert np.array_equal(_port_planes(coeffs, d, 1), _port_planes(coeffs, d, 2))


def test_planes_wrapper_rejects_what_the_kernel_does_not_take():
    p = torch.from_numpy(rs_torch.bit_matrix_planes(gf256.parity_rows(10, 4)))
    data = torch.zeros((10, 64), dtype=torch.uint8)
    with pytest.raises(TypeError):
        rs_kernels.gf2_apply_planes(p.to(torch.int32), data, m=4)
    with pytest.raises(TypeError):
        rs_kernels.gf2_apply_planes(p, data.to(torch.int32), m=4)
    with pytest.raises(ValueError):
        rs_kernels.gf2_apply_planes(p, data[:9], m=4)  # k mismatch
    with pytest.raises(ValueError):
        rs_kernels.gf2_apply_planes(p, torch.zeros((64, 10), dtype=torch.uint8).t(), m=4)
    with pytest.raises(ValueError):
        rs_torch.planes_from_numpy(np.full((8, 10, 256), 2.0), "cpu")
    with pytest.raises(ValueError):
        rs_torch.planes_from_numpy(np.zeros((80, 256)), "cpu")
    before = rs_kernels.LAUNCHES["gf2_apply_planes"]
    rs_kernels.gf2_apply_planes(p, data, m=4)
    assert rs_kernels.LAUNCHES["gf2_apply_planes"] == before  # CPU: plain version


@pytest.mark.parametrize("pack_width", [1, 2])
@pytest.mark.parametrize("km", [(10, 4), (6, 3), (20, 12), (17, 5)], ids=str)
def test_planes_from_jax_stack_match_port_expansion(km, pack_width):
    k, m = km
    coeffs = gf256.parity_rows(k, m)
    theirs = rs_torch.planes_from_numpy(rs_pallas.bit_matrix_planes(coeffs, pack_width), "cpu")
    ours = rs_torch.bit_matrix_planes(coeffs, pack_width)
    assert ours.dtype == np.uint8
    assert torch.equal(theirs, torch.from_numpy(ours))


@pytest.fixture(scope="module")
def planes_codecs():
    jx = rs_jax.RSJax(10, 4, impl="pallas_aligned", interpret=True, tile_n=128)
    port = rs_torch.RSTorch(10, 4, impl="cuda_planes", device="cpu")
    data = np.random.default_rng(17).integers(0, 256, (10, 300), dtype=np.uint8)
    full = np.concatenate([data, np.asarray(jx.encode(data))])
    return jx, port, full


def test_rstorch_planes_encode(planes_codecs):
    jx, port, full = planes_codecs
    assert torch.equal(port._parity_bits, rs_torch.planes_from_numpy(jx._parity_bits, "cpu"))
    assert np.array_equal(port.encode(full[:10]).numpy(), full[10:])
    assert port.verify(full)
    with pytest.raises(ValueError):
        rs_torch.RSTorch(10, 4, impl="pallas_aligned", device="cpu")


@pytest.mark.parametrize("lost", LOSSES, ids=lambda t: "-".join(map(str, t)))
def test_rstorch_planes_reconstruct_matches_rsjax(planes_codecs, lost):
    jx, port, full = planes_codecs
    present = {i: full[i] for i in range(14) if i not in lost}
    want = jx.reconstruct(present)
    got = port.reconstruct(present)
    assert sorted(got) == sorted(want) == list(lost)
    for i in lost:
        assert np.array_equal(got[i].numpy(), np.asarray(want[i]))
        assert np.array_equal(got[i].numpy(), full[i])
    # the decode cache holds the plane-stack layout
    assert port._decode_bits_cache[(tuple(lost), tuple(sorted(present))[:10])].ndim == 3


def test_rstorch_planes_want_and_apply(planes_codecs):
    jx, port, full = planes_codecs
    present = {i: full[i] for i in range(14) if i not in (2, 7, 11)}
    got = port.reconstruct(present, want=[11])
    assert sorted(got) == [11]
    assert np.array_equal(got[11].numpy(), np.asarray(jx.reconstruct(present, want=[11])[11]))
    got = port.reconstruct(present, data_only=True)
    assert sorted(got) == [2, 7]
    rng = np.random.default_rng(19)
    for rows in (1, 2, 5):
        coeffs = rng.integers(0, 256, (rows, 10), dtype=np.uint8)
        out = port.apply(coeffs, full[:10]).numpy()
        assert np.array_equal(out, np.asarray(jx.apply(coeffs, full[:10])))
        assert port.coeff_bits(coeffs).shape == (8, 10, 8 * 32)
