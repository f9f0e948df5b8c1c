// gf2_apply: GF(2^8) matrix apply for Reed-Solomon encode and rebuild,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rs_kernel` in seaweedfs_tpu/ops/rs_pallas.py
// (reached through apply_bitmajor_pallas -> _pallas_apply -> pl.pallas_call).
// Same function, same operand, byte for byte:
//
//   out[r] = XOR_c gf_mul(coeff[r, c], data[c])   data (k, n) u8 -> out (m, n) u8
//
// where the coefficients arrive as their bit-major (8m, 8k) GF(2) expansion
// B (rs_torch.bit_matrix_bitmajor): B[i*m + r, j*k + c] is bit i of
// gf_mul(coeff[r, c], 1 << j).
//
// Design. The TPU kernel unpacks 8 bit-planes and runs one int8 MXU product
// with contraction 8k. No matrix unit is used here: the work is exact
// integer XOR, and the MXU block structure is not carried over.
//   1. Each block folds B into column masks in shared memory,
//        col[c][j][r] = sum_i B[i*m + r, j*k + c] << i = gf_mul(coeff[r,c], 1<<j),
//      replicated into the 4 byte lanes of a 32-bit word (k*8*M words,
//      320 bytes of distinct values for 10+4).
//   2. Each thread takes 16 byte columns: one coalesced 16-byte load per
//      shard row. For each input bit j it turns bit j of every byte into a
//      0x00/0xFF lane mask, lanes = ((w >> j) & 0x01010101) * 0xFF, and
//      accumulates out_r ^= lanes & col[c][j][r] (one LOP3). The 0/1 lanes
//      cannot carry into a neighbour, so each byte lane receives exactly its
//      own product.
//   3. It writes M output rows of 16 bytes. A ragged tail (n not a multiple
//      of 16, or a row not 16-byte aligned) goes through byte loads and
//      stores, masked at n.
// Output rows are launched in groups of at most 8 (a template parameter, so
// the accumulators stay in registers); rebuild of 2 shards is one launch,
// 10+4 encode is one launch.
//
// Second entry point, gf2_apply_planes: replaces `_rs_kernel_aligned` in
// seaweedfs_tpu/ops/rs_pallas.py (reached through apply_planes_pallas ->
// _pallas_apply -> pl.pallas_call). Same function, but the coefficients
// arrive as the plane stack of rs_torch.bit_matrix_planes, (8, k, 8*m_pad):
// P[j, c, i*m_pad + r] is bit i of gf_mul(coeff[r, c], 1 << j), rows r >= m
// zero. m_pad (32 for pack_width 1, 16 for 2) exists only for Mosaic's
// (sublane, 128) tiling; Hopper has no such rule, so only the fold differs:
//   col[c][j][r] = sum_i P[j][c][i*m_pad + r0 + r] << i
// and the streaming loop below is shared (the fold is a template parameter
// of gf2_apply_kernel). Only the m real rows are computed and written: the
// TPU kernel's (m_pad, TN) output block, sliced afterwards, never reaches
// HBM here.
//   - Bound: (k+m)*n bytes plus the 8*k*8*m_pad operand over 3.35 TB/s.
//   - Degraded-read shape (m = 1, n from 64 KiB to about 1.1 MiB, one
//     needle's leaf-aligned extent of one lost shard): about 11 MiB per
//     launch at n = 1 MiB, so about 3.4 us. The per-block fold is a fixed
//     cost (8*k*8 bytes of operand per block); at small n it weighs as it
//     does for gf2_apply, which reached 23 % of its bound at (10, 1 MiB).
//   - Decode-rebuild shape: (10, 16 MiB), m = 1, 176 MiB, about 55 us.
//
// Bounds on an H100 SXM (3.35 TB/s HBM3):
//   - Memory: the kernel must move (k+m)*n bytes. At n = 1 MiB (10+4 encode
//     of a volume under 10 GiB, one small-block row per batch) that is
//     14.7 MB, about 4.4 us; at n = 16 MiB (rebuild batches) with m = 2,
//     201 MB, about 60 us.
//   - Operations: per 16 columns the loop issues k*8*(12 + 5*M) integer
//     instructions, 2560 for 10+4, i.e. about 1.2 ms per GiB of data on the
//     INT32 pipes. So this simple design sits above the memory bound; int8
//     mma/wgmma on the bit-planes (what the MXU did) is the way below it.
//   - End to end, each 10 MiB host-to-device copy over PCIe costs hundreds
//     of microseconds, so the copy, not this kernel, sets the pace.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 32;           // ECContext caps the total shard count at 32
constexpr int kRowsPerLaunch = 8;   // output rows per launch (register accumulators)
constexpr int kThreads = 256;

// Operand layouts: the bit-major (8m, 8k) matrix of gf2_apply, or the
// (8, k, 8*m_pad) plane stack of gf2_apply_planes.
enum class Layout { kBitMajor, kPlanes };

// Bit i of gf_mul(coeff[row, c], 1 << j); `m_stride` is m for the bit-major
// matrix and m_pad for the plane stack.
template <Layout L>
__device__ __forceinline__ uint32_t operand_bit(const uint8_t* __restrict__ b, int k,
                                                int m_stride, int row, int c, int j,
                                                int i) {
    if (L == Layout::kBitMajor)
        return b[(int64_t)(i * m_stride + row) * (8 * k) + j * k + c] & 1u;
    return b[(int64_t)(j * k + c) * (8 * m_stride) + i * m_stride + row] & 1u;
}

template <int M, Layout L>
__global__ void __launch_bounds__(kThreads)
gf2_apply_kernel(const uint8_t* __restrict__ bits, int k, int m_stride, int r0,
                 const uint8_t* __restrict__ data, int64_t n,
                 uint8_t* __restrict__ out, bool vec_ok) {
    __shared__ uint32_t s_col[kMaxK * 8 * M];
    const int n_col = k * 8 * M;
    for (int e = threadIdx.x; e < n_col; e += blockDim.x) {
        const int r = e % M;
        const int cj = e / M;  // c * 8 + j
        const int c = cj >> 3;
        const int j = cj & 7;
        uint32_t v = 0;
        for (int i = 0; i < 8; ++i)
            v |= operand_bit<L>(bits, k, m_stride, r0 + r, c, j, i) << i;
        s_col[e] = v * 0x01010101u;
    }
    __syncthreads();

    const int64_t n_chunks = (n + 15) / 16;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n_chunks;
         t += stride) {
        const int64_t col0 = t * 16;
        const bool full = vec_ok && col0 + 16 <= n;
        uint32_t acc[M][4];
#pragma unroll
        for (int r = 0; r < M; ++r) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = 0u;
        }
        for (int c = 0; c < k; ++c) {
            const uint8_t* src = data + (int64_t)c * n + col0;
            uint32_t w[4];
            if (full) {
                const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
                w[0] = v.x;
                w[1] = v.y;
                w[2] = v.z;
                w[3] = v.w;
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    uint32_t x = 0u;
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        const int64_t idx = col0 + q * 4 + b;
                        if (idx < n) x |= (uint32_t)src[q * 4 + b] << (8 * b);
                    }
                    w[q] = x;
                }
            }
            const uint32_t* col = s_col + c * 8 * M;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                uint32_t lanes[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) lanes[q] = ((w[q] >> j) & 0x01010101u) * 0xFFu;
#pragma unroll
                for (int r = 0; r < M; ++r) {
                    const uint32_t cm = col[j * M + r];
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[r][q] ^= lanes[q] & cm;
                }
            }
        }
#pragma unroll
        for (int r = 0; r < M; ++r) {
            uint8_t* dst = out + (int64_t)(r0 + r) * n + col0;
            if (full) {
                *reinterpret_cast<uint4*>(dst) =
                    make_uint4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        const int64_t idx = col0 + q * 4 + b;
                        if (idx < n) dst[q * 4 + b] = (uint8_t)(acc[r][q] >> (8 * b));
                    }
                }
            }
        }
    }
}

template <int M, Layout L>
void launch(const uint8_t* bits, int k, int m_stride, int r0, const uint8_t* data,
            int64_t n, uint8_t* out, bool vec_ok, int blocks, cudaStream_t stream) {
    gf2_apply_kernel<M, L><<<blocks, kThreads, 0, stream>>>(bits, k, m_stride, r0, data, n,
                                                            out, vec_ok);
}

// Launches the m output rows in groups of at most kRowsPerLaunch.
template <Layout L>
int run(const uint8_t* bits, int k, int m, int m_stride, const uint8_t* data, int64_t n,
        uint8_t* out, int device, void* stream) {
    if (n == 0) return 0;
    int sms = 0;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const bool vec_ok = n % 16 == 0 && (uintptr_t)data % 16 == 0 && (uintptr_t)out % 16 == 0;
    const int64_t n_chunks = (n + 15) / 16;
    int64_t blocks = (n_chunks + kThreads - 1) / kThreads;
    const int64_t max_blocks = (int64_t)sms * 8;
    if (blocks > max_blocks) blocks = max_blocks;
    const int g = (int)blocks;
    cudaStream_t s = (cudaStream_t)stream;
    for (int r0 = 0; r0 < m; r0 += kRowsPerLaunch) {
        const int rows = m - r0 < kRowsPerLaunch ? m - r0 : kRowsPerLaunch;
        switch (rows) {
            case 1: launch<1, L>(bits, k, m_stride, r0, data, n, out, vec_ok, g, s); break;
            case 2: launch<2, L>(bits, k, m_stride, r0, data, n, out, vec_ok, g, s); break;
            case 3: launch<3, L>(bits, k, m_stride, r0, data, n, out, vec_ok, g, s); break;
            case 4: launch<4, L>(bits, k, m_stride, r0, data, n, out, vec_ok, g, s); break;
            case 5: launch<5, L>(bits, k, m_stride, r0, data, n, out, vec_ok, g, s); break;
            case 6: launch<6, L>(bits, k, m_stride, r0, data, n, out, vec_ok, g, s); break;
            case 7: launch<7, L>(bits, k, m_stride, r0, data, n, out, vec_ok, g, s); break;
            default: launch<8, L>(bits, k, m_stride, r0, data, n, out, vec_ok, g, s); break;
        }
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace

// bits: (8m, 8k) u8 0/1, bit-major; data: (k, n) u8; out: (m, n) u8 -- all
// contiguous memory on device `device`. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success). The device is
// set explicitly: this library links its own CUDA runtime, whose current
// device is not PyTorch's.
extern "C" int gf2_apply(const uint8_t* bits, int k, int m, const uint8_t* data,
                         int64_t n, uint8_t* out, int device, void* stream) {
    if (k < 1 || k > kMaxK || m < 1 || n < 0) return (int)cudaErrorInvalidValue;
    return run<Layout::kBitMajor>(bits, k, m, m, data, n, out, device, stream);
}

// planes: (8, k, 8*m_pad) u8 0/1 plane stack; data: (k, n) u8; out: (m, n)
// u8, m <= m_pad: only the m real rows are written. Otherwise as gf2_apply.
extern "C" int gf2_apply_planes(const uint8_t* planes, int k, int m_pad, int m,
                                const uint8_t* data, int64_t n, uint8_t* out, int device,
                                void* stream) {
    if (k < 1 || k > kMaxK || m < 1 || m > m_pad || n < 0) return (int)cudaErrorInvalidValue;
    return run<Layout::kPlanes>(planes, k, m, m_pad, data, n, out, device, stream);
}
