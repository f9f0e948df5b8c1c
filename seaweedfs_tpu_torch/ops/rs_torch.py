"""Reed-Solomon GF(2^8) encode and reconstruct on torch tensors.

Port of seaweedfs_tpu/ops/rs_jax.py. GF(256) multiplication by a constant
is a linear map over GF(2)^8, so an (m x k) coefficient matrix expands to
an (8m x 8k) 0/1 matrix B and parity is (B @ data_bits) mod 2. The device
sees only B, in the bit-major layout (`bit_matrix_bitmajor`) or the
plane-stack layout (`bit_matrix_planes`), and a kernel in
ops/rs_kernels.py applies it; all GF(256) matrix work (inverse, products,
expansion) stays on the host in numpy (ops/gf256.py).

`RSTorch` has RSJax's surface: encode, reconstruct(want=, data_only=),
apply, coeff_bits, _rows_bits, verify, and two locked 64-entry LRU caches
of expanded matrices, each in the layout its impl applies. `impl="cuda"`
applies the bit-major matrix through `gf2_apply` (RSJax impl="pallas");
`impl="cuda_planes"` applies the plane stack through `gf2_apply_planes`
(RSJax impl="pallas_aligned"); both wrappers run their plain version for
a CPU tensor. `impl="torch"` always runs the plain bit-major version.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from . import gf256, rs_kernels


def bit_matrix(coeffs: np.ndarray) -> np.ndarray:
    """(m x k) GF(256) coeffs -> (8m x 8k) GF(2) matrix (byte-major)."""
    return gf256.expand_bit_matrix(np.asarray(coeffs, dtype=np.uint8))


def bit_matrix_bitmajor(coeffs: np.ndarray) -> np.ndarray:
    """Bit-major permutation of `bit_matrix`, the kernel's operand.

    Row (i*m + r) is output-bit i of byte-row r; column (j*k + c) is
    input-bit j of byte-column c (rs_jax.bit_matrix_bitmajor's layout)."""
    m, k = np.asarray(coeffs).shape
    b = bit_matrix(coeffs)
    return (
        b.reshape(m, 8, k, 8).transpose(1, 0, 3, 2).reshape(8 * m, 8 * k).copy()
    )


def bit_matrix_planes(coeffs: np.ndarray, pack_width: int = 1) -> np.ndarray:
    """(m x k) GF(256) coeffs -> the (8, k, 8*m_pad) uint8 plane stack
    (rs_pallas.bit_matrix_planes, as uint8 instead of float32).

    p[j, c, i*m_pad + r] is bit i of gf_mul(coeffs[r, c], 1 << j); rows
    r >= m are zero. m_pad = rs_kernels.aligned_m_pad(m, pack_width)."""
    coeffs = np.asarray(coeffs, dtype=np.uint8)
    m, k = coeffs.shape
    m_pad = rs_kernels.aligned_m_pad(m, pack_width)
    b = gf256.expand_bit_matrix(coeffs).reshape(m, 8, k, 8)  # [r, i, c, j]
    out = np.zeros((8, k, 8, m_pad), dtype=np.uint8)
    out[:, :, :, :m] = b.transpose(3, 2, 1, 0)  # [j, c, i, r]
    return out.reshape(8, k, 8 * m_pad)


def _zero_one_uint8(a: np.ndarray) -> np.ndarray:
    u = a.astype(np.uint8)
    if not np.array_equal(u, a) or u.max(initial=0) > 1:
        raise ValueError("bit matrix entries must be 0 or 1")
    return np.ascontiguousarray(u)


def planes_from_numpy(p: np.ndarray, device) -> torch.Tensor:
    """An (8, k, 8*m_pad) 0/1 plane stack as numpy (any numeric dtype,
    e.g. the float32 `rs_pallas.bit_matrix_planes`) -> the
    `gf2_apply_planes` operand: a contiguous uint8 tensor on `device`."""
    p = np.asarray(p)
    if p.ndim != 3 or p.shape[0] != 8 or p.shape[2] % 8:
        raise ValueError(f"plane stack must be (8, k, 8*m_pad), got {p.shape}")
    return torch.from_numpy(_zero_one_uint8(p)).to(device)


def bits_from_numpy(b: np.ndarray, device) -> torch.Tensor:
    """A bit-major (8m, 8k) 0/1 matrix as numpy (any numeric dtype, e.g.
    the float32 `RSJax(..., impl="pallas")._parity_bits`) -> the kernel
    operand: a contiguous uint8 tensor on `device`."""
    b = np.asarray(b)
    if b.ndim != 2 or b.shape[0] % 8 or b.shape[1] % 8:
        raise ValueError(f"bit matrix must be (8m, 8k), got {b.shape}")
    return torch.from_numpy(_zero_one_uint8(b)).to(device)


# impl -> (expansion of an (m x k) coefficient matrix, its device operand)
_IMPLS = {
    "cuda": (bit_matrix_bitmajor, bits_from_numpy),
    "torch": (bit_matrix_bitmajor, bits_from_numpy),
    "cuda_planes": (bit_matrix_planes, planes_from_numpy),
}


class RSTorch:
    """RS codec over torch tensors on one device. All GF matrix work is
    host-side numpy; the device only applies 0/1 bit matrices."""

    _CACHE_LIMIT = 64

    def __init__(
        self,
        data_shards: int,
        parity_shards: int,
        impl: str = "cuda",
        device="cuda",
    ):
        if impl not in _IMPLS:
            raise ValueError(f"unknown impl {impl!r}")
        self.k = data_shards
        self.m = parity_shards
        self.n = data_shards + parity_shards
        self.impl = impl
        self.device = torch.device(device)
        # The expansion this impl's kernel takes; both LRU caches hold it.
        self._expand, self._from_numpy = _IMPLS[impl]
        self._ref = gf256.ReedSolomon(data_shards, parity_shards)
        self.matrix = self._ref.matrix
        self._parity_bits = self._to_bits(self._ref.parity)
        # Bounded: shard-loss patterns are diverse in a long-lived server;
        # each entry pins an (8m x 8k) bit matrix on the device.
        self._decode_bits_cache: "collections.OrderedDict[tuple, torch.Tensor]" = (
            collections.OrderedDict()
        )
        # Raw-coefficient apply cache: rebuild computes its decode
        # coefficients once per loss set and applies them to every batch.
        self._coeff_bits_cache: "collections.OrderedDict[bytes, torch.Tensor]" = (
            collections.OrderedDict()
        )
        # Several pipeline threads may share one codec; the OrderedDict
        # move_to_end/popitem sequences are not atomic.
        self._cache_lock = threading.Lock()

    def _to_bits(self, coeffs: np.ndarray) -> torch.Tensor:
        return self._from_numpy(self._expand(coeffs), self.device)

    def _cached(self, cache, key, make) -> torch.Tensor:
        with self._cache_lock:
            cached = cache.get(key)
            if cached is not None:
                cache.move_to_end(key)
                return cached
        bits = make()
        with self._cache_lock:
            cache[key] = bits
            if len(cache) > self._CACHE_LIMIT:
                cache.popitem(last=False)
        return bits

    def _tensor(self, data) -> torch.Tensor:
        if isinstance(data, torch.Tensor):
            return data.to(self.device, torch.uint8).contiguous()
        arr = np.ascontiguousarray(data, dtype=np.uint8)
        return torch.from_numpy(arr).to(self.device)

    def _apply(self, bits: torch.Tensor, data: torch.Tensor, m_out: int) -> torch.Tensor:
        if self.impl == "cuda":
            return rs_kernels.gf2_apply(bits, data, m=m_out)
        if self.impl == "cuda_planes":
            return rs_kernels.gf2_apply_planes(bits, data, m=m_out)
        return rs_kernels.gf2_apply_plain(bits, data, m_out)

    # -- encode ------------------------------------------------------------

    def encode(self, data) -> torch.Tensor:
        """(k, n) uint8 data shards -> (m, n) uint8 parity shards."""
        data = self._tensor(data)
        if data.shape[0] != self.k:
            raise ValueError(f"expected {self.k} data rows, got {data.shape[0]}")
        return self._apply(self._parity_bits, data, self.m)

    # -- reconstruct -------------------------------------------------------

    def _rows_bits(
        self, out_rows: tuple[int, ...], src_rows: tuple[int, ...]
    ) -> torch.Tensor:
        """Bit matrix mapping shards[src_rows] -> shards[out_rows]."""

        def make():
            inv = gf256.invert(self.matrix[list(src_rows), :])
            return self._to_bits(gf256.matmul(self.matrix[list(out_rows), :], inv))

        return self._cached(self._decode_bits_cache, (out_rows, src_rows), make)

    def reconstruct(
        self,
        shards: dict,
        data_only: bool = False,
        want: list[int] | None = None,
    ) -> dict[int, torch.Tensor]:
        """Recover missing shards from any >= k present ones.

        `want` restricts the output to specific shard ids; by default every
        missing shard (every missing data shard with `data_only`) is
        regenerated."""
        present = tuple(sorted(shards))
        if len(present) < self.k:
            raise ValueError(f"need {self.k} shards, have {len(present)}")
        if want is not None:
            targets = want
        else:
            targets = range(self.k if data_only else self.n)
        missing = tuple(i for i in targets if i not in shards)
        if not missing:
            return {}
        src = present[: self.k]
        bits = self._rows_bits(missing, src)
        data = torch.stack([self._tensor(shards[i]) for i in src])
        out = self._apply(bits, data, len(missing))
        return {idx: out[i] for i, idx in enumerate(missing)}

    # -- general apply -----------------------------------------------------

    def coeff_bits(self, coeffs: np.ndarray) -> torch.Tensor:
        """Expanded bit matrix of an arbitrary (m_out x k) GF(256)
        coefficient matrix, on the device, cached by content."""
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        key = coeffs.shape[0].to_bytes(4, "little") + coeffs.tobytes()
        return self._cached(
            self._coeff_bits_cache, key, lambda: self._to_bits(coeffs)
        )

    def apply(self, coeffs: np.ndarray, data) -> torch.Tensor:
        """out[r] = sum_j coeffs[r,j] * data[j] over GF(256). On CUDA the
        kernel is queued on the current stream and not waited for."""
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        if coeffs.ndim != 2 or coeffs.shape[1] != len(data):
            raise ValueError(
                f"coeffs {coeffs.shape} do not match {len(data)} data rows"
            )
        return self._apply(self.coeff_bits(coeffs), self._tensor(data), coeffs.shape[0])

    def verify(self, shards) -> bool:
        shards = self._tensor(shards)
        return bool(torch.equal(self.encode(shards[: self.k]), shards[self.k :]))
