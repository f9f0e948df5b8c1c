"""The GF(2) bit-matrix apply kernels: wrappers, launch counts, plain versions.

Port of seaweedfs_tpu/ops/rs_pallas.py:55-339: `_rs_kernel` through
`apply_bitmajor_pallas`, and `_rs_kernel_aligned` through
`apply_planes_pallas`. Both are entry points of one CUDA library,
csrc/gf2_apply.cu (CUDA C++ for sm_90a), with three bodies. Both ring
bodies keep 4 source rows per thread in flight through shared memory
and fold their operand while the first ones land. `gf2_apply` (encode,
rebuild) runs the table body on 16-byte aligned rows: two 16-entry
tables per source row hold the packed products of the m output rows,
so a column costs two conflict-free shared loads per source byte
whatever m is; its work per byte no longer grows with m, and at
(10, 16 MiB) the memory stream sets its pace. `gf2_apply_planes`
(degraded reads, decode) runs the planes body: a PRMT byte mask per bit
and one LOP3 per bit and output row, held by its ALU work past m = 1.
Rows that are not 16-byte aligned go through the masked byte path. The
source says what bounds each body at m = 1, 2 and 4 and what was
measured.

`gf2_apply(b, data, m=...)` computes out[r] = XOR_c gf_mul(coeff[r, c],
data[c]) from the bit-major (8m, 8k) GF(2) expansion `b` of the
coefficients (rs_torch.bit_matrix_bitmajor). `gf2_apply_planes(p, data,
m=...)` computes the same from the (8, k, 8*m_pad) plane stack `p`
(rs_torch.bit_matrix_planes). On a CUDA tensor each launches its kernel
on the current stream, or raises; on a CPU tensor each runs its plain
torch version, which unpacks the bit-planes, multiplies, keeps the low
bit and packs.
"""

from __future__ import annotations

import torch

from . import _build

# Launches of each kernel, counted by its wrapper where it launches
# (never by the plain version). chip_smoke.py zeroes and reads these
# around the main path to show that the path went through the kernel.
LAUNCHES = {"gf2_apply": 0, "gf2_apply_planes": 0}
# Of those, the launches that took the masked byte path (a row not
# 16-byte aligned, or n not a multiple of 16), counted the same way.
MASKED = {"gf2_apply": 0, "gf2_apply_planes": 0}

_PACK_WIDTHS = (1, 2, 4)

# Mosaic's minimum sublane count per output word width
# (rs_pallas._MIN_SUBLANES): the plane stack pads m to it.
_MIN_SUBLANES = {1: 32, 2: 16, 4: 8}


def aligned_m_pad(m: int, pack_width: int) -> int:
    """Rows of the plane stack for m output rows (rs_pallas._aligned_m_pad):
    a multiple of 16 and of the word width's minimum sublane count."""
    gran = max(16, _MIN_SUBLANES[pack_width])
    return ((m + gran - 1) // gran) * gran


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        MASKED[name] = 0


def _masked(data: torch.Tensor, n: int, out: torch.Tensor) -> bool:
    """Whether the library takes the masked byte path (csrc/gf2_apply.cu
    `aligned16`)."""
    return bool(n % 16 or data.data_ptr() % 16 or out.data_ptr() % 16)


def _check_pw4(pack_width: int) -> None:
    if pack_width == 4:
        # Parity with the TPU kernels, which refuse pw=4 (their packed
        # sums need >24-bit exact accumulation). Here the byte lanes
        # never carry, so pw only selects the word width; 1 and 2 give
        # the same bytes.
        raise NotImplementedError(
            "pack_width=4 is rejected, as the TPU kernel rejects it"
        )


def _check(b: torch.Tensor, data: torch.Tensor, m: int, pack_width: int) -> None:
    if pack_width not in _PACK_WIDTHS:
        raise ValueError(f"pack_width must be 1, 2 or 4, got {pack_width}")
    _check_pw4(pack_width)
    if b.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise TypeError(
            f"gf2_apply takes uint8 operands, got {b.dtype} and {data.dtype}"
        )
    if data.ndim != 2 or b.ndim != 2:
        raise ValueError("gf2_apply takes a 2-D bit matrix and 2-D data")
    k = data.shape[0]
    if tuple(b.shape) != (8 * m, 8 * k):
        raise ValueError(
            f"bit matrix {tuple(b.shape)} does not match m={m}, k={k} "
            f"(want {(8 * m, 8 * k)})"
        )
    if not (b.is_contiguous() and data.is_contiguous()):
        raise ValueError("gf2_apply takes contiguous operands")
    if b.device != data.device:
        raise ValueError(f"bit matrix on {b.device}, data on {data.device}")


def gf2_apply_plain(b: torch.Tensor, data: torch.Tensor, m: int) -> torch.Tensor:
    """Plain torch version of the kernel: unpack, matmul, `& 1`, pack.

    Plane row j*k + c holds bit j of shard c (the bit-major column order
    of `b`); accumulator row i*m + r holds output bit i of row r."""
    return _plain_product(b, data, m)


def _plain_product(b: torch.Tensor, data: torch.Tensor, m: int) -> torch.Tensor:
    """(8m, 8k) 0/1 bit-major matrix times the (8k, n) bit-planes of
    `data`, mod 2, packed to (m, n) bytes. The product runs in float32 on
    0/1 operands: exact, because every sum is an integer of at most
    8k <= 256 (exact under TF32 too: 0/1 inputs lose nothing and the
    accumulator is float32). Never int8 (torch's CPU int8 product
    returns int8, and sums reach 8k), never bf16 or fp16 accumulation."""
    k, n = data.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device).view(8, 1, 1)
    planes = ((data.unsqueeze(0) >> shifts) & 1).reshape(8 * k, n)
    acc = (b.to(torch.float32) @ planes.to(torch.float32)).to(torch.int32)
    bits = (acc & 1).reshape(8, m, n)
    # distinct bit positions: the sum is the OR
    out = (bits << shifts.to(torch.int32)).sum(dim=0)
    return out.to(torch.uint8)


def _kernel_lib():
    """The kernel library, built on first use. A failed build or load
    raises a RuntimeError, never an OSError (a missing compiler, an
    unloadable library): the EC backend's CPU failover takes OSErrors
    for a lost device, and a kernel that does not build must show."""
    try:
        return _build.load("gf2_apply")
    except OSError as e:
        raise RuntimeError(f"the gf2_apply kernels did not build or load: {e}") from e


def gf2_apply(
    b: torch.Tensor, data: torch.Tensor, *, m: int, pack_width: int = 1
) -> torch.Tensor:
    """(8m, 8k) bit-major GF(2) matrix applied to (k, n) uint8 -> (m, n).

    `pack_width` is kept for parity with apply_bitmajor_pallas: 1 and 2
    give identical output, 4 raises NotImplementedError."""
    _check(b, data, m, pack_width)
    if data.device.type == "cpu":
        return gf2_apply_plain(b, data, m)
    if data.device.type != "cuda":
        raise ValueError(f"gf2_apply runs on cuda or cpu, not {data.device}")
    lib = _kernel_lib()
    k, n = data.shape
    out = torch.empty((m, n), dtype=torch.uint8, device=data.device)
    stream = torch.cuda.current_stream(data.device)
    err = lib.gf2_apply(
        b.data_ptr(), k, m, data.data_ptr(), n, out.data_ptr(),
        data.device.index, stream.cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gf2_apply kernel launch failed: CUDA error {err}")
    LAUNCHES["gf2_apply"] += 1
    MASKED["gf2_apply"] += _masked(data, n, out)
    return out


def _check_planes(p: torch.Tensor, data: torch.Tensor, m: int, pack_width: int) -> int:
    """apply_planes_pallas's checks in its order (pack_width, sublane
    legality of m_pad, m <= m_pad, then the kernel body's pw=4 refusal),
    then what this kernel does not take. Returns m_pad."""
    if pack_width not in _PACK_WIDTHS:
        raise ValueError(f"pack_width must be 1, 2 or 4, got {pack_width}")
    m_pad = p.shape[-1] // 8
    if m_pad % aligned_m_pad(1, pack_width):
        raise ValueError(
            f"b_planes m_pad={m_pad} is not sublane-legal for "
            f"pack_width={pack_width}; build it with "
            f"bit_matrix_planes(coeffs, pack_width={pack_width})"
        )
    if m > m_pad:
        raise ValueError(f"m={m} exceeds the {m_pad} rows b_planes encodes")
    _check_pw4(pack_width)
    if p.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise TypeError(
            f"gf2_apply_planes takes uint8 operands, got {p.dtype} and {data.dtype}"
        )
    if data.ndim != 2:
        raise ValueError("gf2_apply_planes takes 2-D (k, n) data")
    k = data.shape[0]
    if tuple(p.shape) != (8, k, 8 * m_pad):
        raise ValueError(
            f"plane stack {tuple(p.shape)} does not match k={k} "
            f"(want {(8, k, 8 * m_pad)})"
        )
    if m < 1:
        raise ValueError(f"m must be at least 1, got {m}")
    if not (p.is_contiguous() and data.is_contiguous()):
        raise ValueError("gf2_apply_planes takes contiguous operands")
    if p.device != data.device:
        raise ValueError(f"plane stack on {p.device}, data on {data.device}")
    return m_pad


def gf2_apply_planes_plain(p: torch.Tensor, data: torch.Tensor, m: int) -> torch.Tensor:
    """Plain torch version of the plane-stack kernel: the (8, k, 8*m_pad)
    stack reshaped to (8k, 8*m_pad) and transposed is the bit-major
    matrix of m_pad rows (row i*m_pad + r); its m real rows of each
    output bit i are multiplied with the (8k, n) bit-planes of the data
    (`_rs_kernel_aligned` multiplies all m_pad and slices afterwards:
    the padded rows are zero), then `& 1` and pack."""
    k = data.shape[0]
    m_pad = p.shape[2] // 8
    bt = p.reshape(8 * k, 8, m_pad).permute(1, 2, 0)[:, :m]  # [i, r, j*k + c]
    return _plain_product(bt.reshape(8 * m, 8 * k), data, m)


def gf2_apply_planes(
    p: torch.Tensor, data: torch.Tensor, *, m: int, pack_width: int = 1
) -> torch.Tensor:
    """(8, k, 8*m_pad) plane stack applied to (k, n) uint8 -> (m, n).

    Raises apply_planes_pallas's errors in its order; `pack_width` 1 and
    2 give identical output. The kernel writes only the m real rows."""
    m_pad = _check_planes(p, data, m, pack_width)
    if data.device.type == "cpu":
        return gf2_apply_planes_plain(p, data, m)
    if data.device.type != "cuda":
        raise ValueError(f"gf2_apply_planes runs on cuda or cpu, not {data.device}")
    lib = _kernel_lib()
    k, n = data.shape
    out = torch.empty((m, n), dtype=torch.uint8, device=data.device)
    stream = torch.cuda.current_stream(data.device)
    err = lib.gf2_apply_planes(
        p.data_ptr(), k, m_pad, m, data.data_ptr(), n, out.data_ptr(),
        data.device.index, stream.cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gf2_apply_planes kernel launch failed: CUDA error {err}")
    LAUNCHES["gf2_apply_planes"] += 1
    MASKED["gf2_apply_planes"] += _masked(data, n, out)
    return out
