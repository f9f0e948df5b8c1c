"""CRC32C (Castagnoli): the .ecsum bitrot sidecar and inline source checks.

Port of seaweedfs_tpu/utils/crc.py. `crc32c` is the port's host library's
(`sn_crc32c` in csrc/seaweed_native.cpp, bound in utils/native.py: SSE4.2
crc32 instructions, slice-by-8 tables on other CPUs), built with g++ at
first use; a shard stream of a 1 GiB volume is 1.4 GiB, far too much for
a Python loop. `crc32c_combine` is plain Python: it touches no bytes.
"""

from __future__ import annotations

import functools

from .native import crc32c

__all__ = ["CASTAGNOLI_POLY", "crc32c", "crc32c_combine"]

CASTAGNOLI_POLY = 0x82F63B78  # reflected


# ---------------------------------------------------------------- combine
#
# crc32c(A || B) from crc32c(A), crc32c(B), len(B) without touching the
# bytes (zlib's crc32_combine GF(2) matrix method, Castagnoli polynomial).
# Lets the .ecsum v2 sidecar derive block-level CRCs from its per-leaf
# CRCs.


def _gf2_matrix_times(mat: list[int], vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_matrix_square(mat: list[int]) -> list[int]:
    return [_gf2_matrix_times(mat, mat[n]) for n in range(32)]


def _gf2_matrix_mul(a: list[int], b: list[int]) -> list[int]:
    """Operator composition: (a∘b)[n] = a * b[n] (columns are uint32)."""
    return [_gf2_matrix_times(a, b[n]) for n in range(32)]


@functools.lru_cache(maxsize=64)
def _zero_operator(nbytes: int) -> tuple[int, ...]:
    """32x32 GF(2) matrix advancing a finalized CRC32C over `nbytes`
    zero bytes, cached per length (.ecsum leaves are uniform-size)."""
    odd = [0] * 32
    odd[0] = CASTAGNOLI_POLY  # one zero BIT, reflected form
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    even = _gf2_matrix_square(odd)  # 2 bits
    odd = _gf2_matrix_square(even)  # 4 bits
    mat = odd
    op: list[int] | None = None
    n = nbytes
    while n:
        mat = _gf2_matrix_square(mat)  # 8 bits = 1 byte, then doubling
        if n & 1:
            op = list(mat) if op is None else _gf2_matrix_mul(mat, op)
        n >>= 1
    if op is None:
        raise ValueError("zero operator needs nbytes > 0")
    return tuple(op)


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32c of the concatenation of two streams whose individual
    (finalized) CRCs are crc1 and crc2, where the second stream is
    `len2` bytes long."""
    if len2 <= 0:
        return crc1
    return _gf2_matrix_times(list(_zero_operator(len2)), crc1) ^ crc2
