// gf2_apply: GF(2^8) matrix apply for Reed-Solomon encode, rebuild, degraded
// reads and decode, written by hand for Hopper (sm_90a). Two entry points
// compute the same function, exact, byte for byte:
//
//   out[r] = XOR_c gf_mul(coeff[r, c], data[c])   data (k, n) u8 -> out (m, n) u8
//
// and differ in the operand that carries the coefficients. Output rows are
// launched in groups of at most 8 (a template parameter M, so the
// accumulators stay in registers). Three bodies:
//
// gf2_table_kernel<M>, gf2_apply's body for 16-byte aligned rows, replaces
// `_rs_kernel` in seaweedfs_tpu/ops/rs_pallas.py (reached through
// apply_bitmajor_pallas -> _pallas_apply -> pl.pallas_call). gf2_apply serves
// encode ((10, 1 MiB), m = 4) and rebuild ((10, 16 MiB), m = 2). Its operand
// is the bit-major (8m, 8k) GF(2) expansion B (rs_torch.bit_matrix_bitmajor):
// B[i*m + r, j*k + c] is bit i of gf_mul(coeff[r, c], 1 << j).
//   1. Fold off the critical path. A block first issues its first source
//      rows' copies (step 3), then folds B while they are in flight: lane l
//      of a warp loads bit (l & 7) of row 4h + (l >> 3), and one ballot is
//      the packed mask of (c, j): gf_mul(coeff[r, c], 1 << j) in byte r of a
//      word (rows 4-7 in a second word when M > 4).
//   2. Tables. Multiplication by a constant is linear over GF(2), so the M
//      products of a source byte x are T_lo[c][x & 15] ^ T_hi[c][x >> 4],
//      where each 16-entry table holds the packed products of one nibble.
//      Each thread builds a few of the k*32 entries. Sixteen 4-byte entries
//      lie in 16 distinct banks (8-byte entries fill the 32 once), so a
//      warp's lookups into a table never conflict, whatever the bytes; a
//      256-entry byte table conflicts about 3 ways on random bytes.
//   3. Streaming. Each thread takes 16 columns of a tile and streams their k
//      rows through 4 slots of its own in shared memory with cp.async, as
//      gf2_planes_kernel does, and consumes two landed rows at a time. Each
//      row's tables sit in a 256-byte-aligned slot, so one PRMT forms a
//      lookup's shared address (the nibble's offset in byte 0 under the
//      slot's address), and one XOR3 folds two lookups into a column's
//      packed accumulator. Per 16 bytes of a source row, for any M <= 4:
//      32 shared loads, 32 PRMT, 8 shift-and-mask pairs and 16 XOR3 (32
//      XOR3 on two-word entries).
//   4. Once per tile, 4x4 byte transposes (8 PRMT each) turn the 16 packed
//      column accumulators into M row words, stored 16 bytes a row.
//   What bounds it, at M = 1, 2 and 4 alike (chip_kernels.py, NVIDIA H100
//   80GB HBM3, 700.00 W, medians, L2 flushed by a 64 MiB write): the memory
//   stream. The loop issues about 128 instructions per 16 bytes of a row
//   at M <= 4 (76.5 on the ALU pipe, 10 FMA, 33 shared loads; 92.5 ALU at
//   M = 5 to 8; chip_kernels.py --sass),
//   about 50 us of ALU and shared-memory issue at (10, 16 MiB) against byte
//   bounds of 55, 60 and 70 us. At (10, 16 MiB) it takes 82.6, 87.2 and
//   95.9 us where one device copy of the same bytes takes 67.2, 72.5 and
//   83.7 us under the same method. At (10, 1 MiB): 13.6, 13.9 and 13.8 us
//   against copies of 10.1, 10.4 and 11.2 us: the launch, the fold and each
//   thread's wait for its first rows.
//
// gf2_planes_kernel<M>, gf2_apply_planes's body for 16-byte aligned rows,
// replaces `_rs_kernel_aligned` in rs_pallas.py (reached through
// apply_planes_pallas -> _pallas_apply -> pl.pallas_call). Its operand is the
// plane stack of rs_torch.bit_matrix_planes, (8, k, 8*m_pad):
// P[j, c, i*m_pad + r] is bit i of gf_mul(coeff[r, c], 1 << j), rows r >= m
// zero. m_pad (32 for pack_width 1, 16 for 2) exists only for Mosaic's
// (sublane, 128) tiling; only the m real rows are computed and written. It
// serves degraded reads (m = 1, n from 64 KiB to about 1.1 MiB) and decode
// ((10, 16 MiB), m = 1). It folds P into byte masks behind the first copies,
// streams rows through the same ring, and for each input bit j spreads bit j
// of every byte over its byte (x = w << (7 - j), then PRMT in sign mode,
// selector 0xBA98) and accumulates out_r ^= lanes & mask[c][j][r] (LOP3):
// 76 + 32(M - 1) ALU-pipe instructions per 16 bytes of a row.
//   What bounds it (same runs): the memory stream at M = 1 (82.9 us at
//   (10, 16 MiB), 12.6 us at (10, 1 MiB)), the ALU pipe past it: 108 and
//   172 ALU-pipe instructions per 16 bytes of a row at M = 2 and 4 give
//   93.6 and 137.2 us at (10, 16 MiB), 14.3 and 20.1 us at (10, 1 MiB).
//
// gf2_apply_kernel<M, L>, the masked byte path of both entry points, takes
// rows that are not 16-byte aligned, or n not a multiple of 16. Each block
// folds the operand (layout L) into byte masks replicated over a word, and
// each thread takes 16 columns (a grid-stride loop), loading each source
// row's bytes one at a time, masked at n, and accumulating
// out_r ^= ((w >> j) & 0x01010101) * 0xFF & mask[c][j][r] for each bit j.
//   What bounds it (same runs, gf2_apply on data 1 byte off alignment):
//   ALU issue, three instructions per bit and word for the masks besides
//   the byte loads and shifts: 18.4, 20.1 and 26.1 us at (10, 1 MiB) for
//   M = 1, 2 and 4, and 140, 169 and 233 us at (10, 16 MiB).

#include <atomic>
#include <cstdint>
#include <type_traits>
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

// ---- gf2_apply_kernel: the masked byte path ----

template <int M, Layout L>
__global__ void __launch_bounds__(kThreads)
gf2_apply_kernel(const uint8_t* __restrict__ bits, int k, int m_stride, int r0,
                 const uint8_t* __restrict__ data, int64_t n, uint8_t* __restrict__ out) {
    __shared__ uint32_t s_col[kMaxK * 8 * M];
    const int n_col = k * 8 * M;
    for (int e = threadIdx.x; e < n_col; e += blockDim.x) {
        const int r = e % M;
        const int cj = e / M;  // c * 8 + j
        uint32_t v = 0;
        for (int i = 0; i < 8; ++i)
            v |= operand_bit<L>(bits, k, m_stride, r0 + r, cj >> 3, cj & 7, i) << i;
        s_col[e] = v * 0x01010101u;
    }
    __syncthreads();

    const int64_t n_chunks = (n + 15) / 16;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n_chunks;
         t += stride) {
        const int64_t col0 = t * 16;
        uint32_t acc[M][4];
#pragma unroll
        for (int r = 0; r < M; ++r) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = 0u;
        }
        for (int c = 0; c < k; ++c) {
            const uint8_t* src = data + (int64_t)c * n + col0;
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                uint32_t x = 0u;
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    if (col0 + q * 4 + b < n) x |= (uint32_t)src[q * 4 + b] << (8 * b);
                w[q] = x;
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
#pragma unroll
            for (int q = 0; q < 4; ++q) {
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    if (col0 + q * 4 + b < n) dst[q * 4 + b] = (uint8_t)(acc[r][q] >> (8 * b));
            }
        }
    }
}

template <int M, Layout L>
void launch_masked(const uint8_t* bits, int k, int m_stride, int r0, const uint8_t* data,
                   int64_t n, uint8_t* out, int blocks, cudaStream_t stream) {
    gf2_apply_kernel<M, L><<<blocks, kThreads, 0, stream>>>(bits, k, m_stride, r0, data, n, out);
}

// The masked byte path over m output rows, in groups of at most kRowsPerLaunch.
template <Layout L>
int run_masked(const uint8_t* bits, int k, int m, int m_stride, const uint8_t* data, int64_t n,
               uint8_t* out, int device, void* stream) {
    if (n == 0) return 0;
    int sms = 0;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int64_t n_chunks = (n + 15) / 16;
    int64_t blocks = (n_chunks + kThreads - 1) / kThreads;
    const int64_t max_blocks = (int64_t)sms * 8;
    if (blocks > max_blocks) blocks = max_blocks;
    const int g = (int)blocks;
    cudaStream_t s = (cudaStream_t)stream;
    for (int r0 = 0; r0 < m; r0 += kRowsPerLaunch) {
        const int rows = m - r0 < kRowsPerLaunch ? m - r0 : kRowsPerLaunch;
        switch (rows) {
            case 1: launch_masked<1, L>(bits, k, m_stride, r0, data, n, out, g, s); break;
            case 2: launch_masked<2, L>(bits, k, m_stride, r0, data, n, out, g, s); break;
            case 3: launch_masked<3, L>(bits, k, m_stride, r0, data, n, out, g, s); break;
            case 4: launch_masked<4, L>(bits, k, m_stride, r0, data, n, out, g, s); break;
            case 5: launch_masked<5, L>(bits, k, m_stride, r0, data, n, out, g, s); break;
            case 6: launch_masked<6, L>(bits, k, m_stride, r0, data, n, out, g, s); break;
            case 7: launch_masked<7, L>(bits, k, m_stride, r0, data, n, out, g, s); break;
            default: launch_masked<8, L>(bits, k, m_stride, r0, data, n, out, g, s); break;
        }
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// ---- gf2_planes_kernel: gf2_apply_planes's body for 16-byte aligned rows ----

constexpr int kTile = 4096;  // columns per tile: 256 threads x 16 bytes
constexpr int kRing = 4;     // source rows in flight per thread
static_assert((kRing & (kRing - 1)) == 0, "kRing must be a power of 2");
constexpr int kMaxDevices = 64;  // devices whose launch shape is cached

// Bytes of the folded masks at the head of dynamic shared memory (16-aligned,
// so the ring after them is too).
__host__ __device__ constexpr int col_bytes(int k, int rows) {
    return (k * 8 * rows * 4 + 15) & ~15;
}

__device__ __forceinline__ void cp_async16(uint8_t* smem, const uint8_t* gmem) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 0xFF in each byte lane whose top bit is set, 0x00 in the others: PRMT with
// every selector nibble's sign bit set replicates the selected byte's sign.
__device__ __forceinline__ uint32_t sign_lanes(uint32_t x) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, 0xBA98;" : "=r"(d) : "r"(x), "r"(0u));
    return d;
}

// s_col[(c*8 + j)*M + r] = gf_mul(coeff[r0 + r, c], 1 << j) in all 4 byte
// lanes. Mask e takes lanes 8*(e & 3) .. +7 of one warp, lane l loading bit
// (l & 7), so a mask's 8 bytes (m_pad apart) are loaded at once; kUnroll
// rounds of loads are issued before the first ballot packs them.
template <int M>
__device__ __forceinline__ void fold_planes(const uint8_t* __restrict__ planes, int k,
                                            int m_pad, int r0, uint32_t* s_col) {
    constexpr int kUnroll = 8;
    const int n_col = k * 8 * M;
    const int lane = threadIdx.x & 31;
    const int round = (blockDim.x >> 5) * 4;  // masks per round of the block
    for (int e0 = (threadIdx.x >> 5) * 4; e0 < n_col; e0 += round * kUnroll) {
        uint32_t bit[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int e = e0 + u * round + (lane >> 3);
            const int cj = e / M;  // c * 8 + j
            bit[u] = e < n_col ? operand_bit<Layout::kPlanes>(planes, k, m_pad, r0 + e % M,
                                                              cj >> 3, cj & 7, lane & 7)
                               : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int e = e0 + u * round + (lane >> 3);
            const uint32_t v = __ballot_sync(0xffffffffu, bit[u]);
            if ((lane & 7) == 0 && e < n_col) s_col[e] = ((v >> lane) & 0xFFu) * 0x01010101u;
        }
    }
}

// data, out and n 16-byte aligned. Block b owns columns [b*span, b*span + span)
// and walks them a tile at a time: thread x takes 16 columns of each tile and
// streams their k rows through its own kRing slots of shared memory (slot s
// at ring + s*kTile), kRing rows ahead of the one it computes. It reads back
// only what it copied, so the loop needs no barrier.
template <int M>
__global__ void __launch_bounds__(kTile / 16)
gf2_planes_kernel(const uint8_t* __restrict__ planes, int k, int m_pad, int r0,
                  const uint8_t* __restrict__ data, int64_t n, uint8_t* __restrict__ out,
                  int64_t span) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint32_t* s_col = reinterpret_cast<uint32_t*>(smem);
    uint8_t* ring = smem + col_bytes(k, M) + threadIdx.x * 16;
    const int64_t lo = (int64_t)blockIdx.x * span + threadIdx.x * 16;
    const int64_t hi = (int64_t)(blockIdx.x + 1) * span < n ? (int64_t)(blockIdx.x + 1) * span : n;

    // The next row to copy: row `row` of this thread's 16 columns at `at`.
    // Past the end it copies nothing but still commits (an empty group), so
    // the wait below always counts kRing groups.
    int row = 0;
    int64_t at = lo;
    auto issue = [&](int slot) {
        if (at < hi) cp_async16(ring + slot * kTile, data + row * n + at);
        cp_async_commit();
        if (++row == k) {
            row = 0;
            at += kTile;
        }
    };
    for (int slot = 0; slot < kRing; ++slot) issue(slot);
    fold_planes<M>(planes, k, m_pad, r0, s_col);
    __syncthreads();

    int slot = 0;
    for (int64_t col = lo; col < hi; col += kTile) {
        uint32_t acc[M][4];
#pragma unroll
        for (int r = 0; r < M; ++r) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = 0u;
        }
        for (int c = 0; c < k; ++c) {
            cp_async_wait<kRing - 1>();
            const uint4 v = *reinterpret_cast<const uint4*>(ring + slot * kTile);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
            issue(slot);  // the slot just read takes the row kRing ahead
            slot = (slot + 1) & (kRing - 1);
            const uint32_t* cm = s_col + c * 8 * M;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                uint32_t lanes[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) lanes[q] = sign_lanes(w[q] << (7 - j));
#pragma unroll
                for (int r = 0; r < M; ++r) {
                    const uint32_t mask = cm[j * M + r];
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[r][q] ^= lanes[q] & mask;
                }
            }
        }
#pragma unroll
        for (int r = 0; r < M; ++r)
            *reinterpret_cast<uint4*>(out + (int64_t)(r0 + r) * n + col) =
                make_uint4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
}

// ---- gf2_table_kernel: gf2_apply's body for 16-byte aligned rows ----

// A table entry packs the M rows' products, row r in byte r: one word for
// M <= 4, two for M <= 8 (rows 4-7 in .y).
template <int M>
struct Packed {
    static constexpr int kWords = M <= 4 ? 1 : 2;
    using type = typename std::conditional<(M <= 4), uint32_t, uint2>::type;
};

// Source row c's two tables take a 256-byte slot: the low-nibble table at +0,
// the high-nibble table at +16 entries (+64 bytes for one word, +128 for two).
constexpr int kSlot = 256;

// Bytes of the packed masks, (c*8 + j)*W + h.
__host__ __device__ constexpr int mask_bytes(int k, int words) { return k * 8 * 4 * words; }

// Dynamic shared memory before the ring: room to align the slots to 256
// bytes, the k slots, the masks.
__host__ __device__ constexpr int table_smem(int k, int words) {
    return kSlot + k * kSlot + mask_bytes(k, words);
}
static_assert(table_smem(kMaxK, 2) + kRing * kTile <= 48 << 10,
              "a table launch needs no more than the default dynamic shared memory");

// s_mask[(c*8 + j)*W + h] packs gf_mul(coeff[r0 + 4h + g, c], 1 << j) for
// g = 0..3 into byte g (rows at or past M are 0). Word w takes one warp: lane
// l loads bit (l & 7) of row 4h + (l >> 3), and the ballot is the word. All
// the loads of a round are issued before its first ballot; k <= 16 takes one
// round at M <= 4.
template <int M>
__device__ __forceinline__ void fold_packed(const uint8_t* __restrict__ b, int k, int m,
                                            int r0, uint32_t* s_mask) {
    constexpr int W = Packed<M>::kWords;
    constexpr int kUnroll = 16;
    const int n_words = k * 8 * W;
    const int lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    for (int w0 = threadIdx.x >> 5; w0 < n_words; w0 += warps * kUnroll) {
        uint32_t bit[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int w = w0 + u * warps;
            const int cj = w / W;  // c * 8 + j
            const int row = (w % W) * 4 + (lane >> 3);
            bit[u] = w < n_words && row < M
                         ? operand_bit<Layout::kBitMajor>(b, k, m, r0 + row, cj >> 3, cj & 7,
                                                          lane & 7)
                         : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int w = w0 + u * warps;
            const uint32_t v = __ballot_sync(0xffffffffu, bit[u]);
            if (lane == 0 && w < n_words) s_mask[w] = v;
        }
    }
}

// Table entry e (row c = e / 32, nibble table h = (e / 16) & 1, nibble v =
// e & 15): the XOR of row c's packed masks of the set bits of v << 4h.
template <int M>
__device__ __forceinline__ void build_tables(int k, const uint32_t* s_mask, uint8_t* slots) {
    constexpr int W = Packed<M>::kWords;
    for (int e = threadIdx.x; e < k * 32; e += blockDim.x) {
        const int c = e >> 5, h = (e >> 4) & 1, v = e & 15;
        uint32_t* dst = reinterpret_cast<uint32_t*>(slots + c * kSlot + (h * 16 + v) * 4 * W);
#pragma unroll
        for (int w = 0; w < W; ++w) {
            uint32_t x = 0u;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if ((v >> i) & 1) x ^= s_mask[(c * 8 + 4 * h + i) * W + w];
            dst[w] = x;
        }
    }
}

// Byte lane b of each result: the shared-memory offset in a slot of the low
// (lo_offsets) or high (hi_offsets) nibble of w's byte b, nibble * entry size,
// the high table's past the low one's.
template <int W>
__device__ __forceinline__ uint32_t lo_offsets(uint32_t w) {
    return W == 1 ? (w << 2) & 0x3C3C3C3Cu : (w << 3) & 0x78787878u;
}
template <int W>
__device__ __forceinline__ uint32_t hi_offsets(uint32_t w) {
    return W == 1 ? ((w >> 2) & 0x3C3C3C3Cu) | 0x40404040u
                  : ((w >> 1) & 0x78787878u) | 0x80808080u;
}

// The shared address of byte lane b's entry: byte b of `offs` under bytes
// 1-3 of the slot's address, whose byte 0 is zero. One PRMT.
__device__ __forceinline__ uint32_t entry_addr(uint32_t offs, uint32_t slot, int b) {
    return __byte_perm(offs, slot, 0x7650u | (uint32_t)b);
}

template <int W>
__device__ __forceinline__ typename std::conditional<(W == 1), uint32_t, uint2>::type
lds_entry(uint32_t addr) {
    if constexpr (W == 1) {
        uint32_t v;
        asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
        return v;
    } else {
        uint2 v;
        asm("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(addr));
        return v;
    }
}

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) { return a ^ b ^ c; }
__device__ __forceinline__ uint2 xor3(uint2 a, uint2 b, uint2 c) {
    return make_uint2(a.x ^ b.x ^ c.x, a.y ^ b.y ^ c.y);
}

// acc[4q + b] ^= the products of byte b of w[q], for the row whose slot is at
// shared address `slot`.
template <int W, typename Entry>
__device__ __forceinline__ void lookup_row(Entry acc[16], const uint32_t w[4], uint32_t slot) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint32_t lo = lo_offsets<W>(w[q]), hi = hi_offsets<W>(w[q]);
#pragma unroll
        for (int b = 0; b < 4; ++b)
            acc[4 * q + b] = xor3(acc[4 * q + b], lds_entry<W>(entry_addr(lo, slot, b)),
                                  lds_entry<W>(entry_addr(hi, slot, b)));
    }
}

// Rows 0-3 of four packed column words a[0..3] (byte r of a[i] is row r of
// column i): row r's word holds a[0..3]'s byte r. Eight PRMT.
__device__ __forceinline__ void transpose4(const uint32_t a[4], uint32_t row[4]) {
    const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140u);  // a0.0 a1.0 a0.1 a1.1
    const uint32_t t1 = __byte_perm(a[0], a[1], 0x7362u);  // a0.2 a1.2 a0.3 a1.3
    const uint32_t t2 = __byte_perm(a[2], a[3], 0x5140u);
    const uint32_t t3 = __byte_perm(a[2], a[3], 0x7362u);
    row[0] = __byte_perm(t0, t2, 0x5410u);
    row[1] = __byte_perm(t0, t2, 0x7632u);
    row[2] = __byte_perm(t1, t3, 0x5410u);
    row[3] = __byte_perm(t1, t3, 0x7632u);
}

__device__ __forceinline__ uint32_t word_of(uint32_t e, int) { return e; }
__device__ __forceinline__ uint32_t word_of(uint2 e, int h) { return h ? e.y : e.x; }

// data, out and n 16-byte aligned; blocks, spans and tiles as in
// gf2_planes_kernel. Shared memory: the slots (from the first 256-aligned
// address), the packed masks, then the ring.
template <int M>
__global__ void __launch_bounds__(kTile / 16)
gf2_table_kernel(const uint8_t* __restrict__ b, int k, int m, int r0,
                 const uint8_t* __restrict__ data, int64_t n, uint8_t* __restrict__ out,
                 int64_t span) {
    using Entry = typename Packed<M>::type;
    constexpr int W = Packed<M>::kWords;
    extern __shared__ __align__(16) uint8_t smem[];
    const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
    const uint32_t pad = (kSlot - (s0 & (kSlot - 1))) & (kSlot - 1);
    const uint32_t slots = s0 + pad;  // shared address of row 0's slot
    uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem + kSlot + k * kSlot);
    uint8_t* ring = smem + table_smem(k, W) + threadIdx.x * 16;
    const int64_t lo = (int64_t)blockIdx.x * span + threadIdx.x * 16;
    const int64_t hi = (int64_t)(blockIdx.x + 1) * span < n ? (int64_t)(blockIdx.x + 1) * span : n;

    // The next row to copy, as in gf2_planes_kernel.
    int row = 0;
    int64_t at = lo;
    auto issue = [&](int slot) {
        if (at < hi) cp_async16(ring + slot * kTile, data + row * n + at);
        cp_async_commit();
        if (++row == k) {
            row = 0;
            at += kTile;
        }
    };
    for (int slot = 0; slot < kRing; ++slot) issue(slot);
    fold_packed<M>(b, k, m, r0, s_mask);
    __syncthreads();
    build_tables<M>(k, s_mask, smem + pad);
    __syncthreads();

    int slot = 0;
    for (int64_t col = lo; col < hi; col += kTile) {
        Entry acc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = Entry{};
        int c = 0;
        for (; c + 1 < k; c += 2) {  // two landed rows at a time
            cp_async_wait<kRing - 2>();
            const int next = (slot + 1) & (kRing - 1);
            const uint4 v0 = *reinterpret_cast<const uint4*>(ring + slot * kTile);
            const uint4 v1 = *reinterpret_cast<const uint4*>(ring + next * kTile);
            issue(slot);  // the slots just read take the rows kRing ahead
            issue(next);
            slot = (slot + 2) & (kRing - 1);
            const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w};
            const uint32_t w1[4] = {v1.x, v1.y, v1.z, v1.w};
            lookup_row<W>(acc, w0, slots + c * kSlot);
            lookup_row<W>(acc, w1, slots + (c + 1) * kSlot);
        }
        if (c < k) {  // k odd: the last row alone
            cp_async_wait<kRing - 1>();
            const uint4 v = *reinterpret_cast<const uint4*>(ring + slot * kTile);
            issue(slot);
            slot = (slot + 1) & (kRing - 1);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
            lookup_row<W>(acc, w, slots + c * kSlot);
        }
        uint32_t rows[8][4];
#pragma unroll
        for (int h = 0; h < W; ++h) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const uint32_t a[4] = {word_of(acc[4 * q], h), word_of(acc[4 * q + 1], h),
                                       word_of(acc[4 * q + 2], h), word_of(acc[4 * q + 3], h)};
                uint32_t r4[4];
                transpose4(a, r4);
#pragma unroll
                for (int r = 0; r < 4; ++r) rows[4 * h + r][q] = r4[r];
            }
        }
#pragma unroll
        for (int r = 0; r < M; ++r)
            *reinterpret_cast<uint4*>(out + (int64_t)(r0 + r) * n + col) =
                make_uint4(rows[r][0], rows[r][1], rows[r][2], rows[r][3]);
    }
}

// The SM count of `device`, read once per device: like the blocks per SM
// below, it is host work before every launch, which a degraded read waits on.
cudaError_t sm_count(int device, int* sms) {
    static std::atomic<int> cached[kMaxDevices];
    const bool keep = device >= 0 && device < kMaxDevices;
    if (keep && (*sms = cached[device].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
    const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess && keep) cached[device].store(*sms, std::memory_order_relaxed);
    return err;
}

// The grid of one launch of a ring body: as many blocks per SM as fit, but no
// more than give each block a tile of work, each over an equal span of
// columns. Blocks per SM depend on the device and, through the shared memory,
// on k: read once for each into `cache` (one per kernel instantiation).
template <typename Kernel>
cudaError_t ring_grid(Kernel kernel, int smem, std::atomic<int> (*cache)[kMaxK + 1], int k,
                      int device, int64_t n, int* blocks, int64_t* span) {
    constexpr int threads = kTile / 16;
    int sms = 0;
    cudaError_t err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    const bool keep = device >= 0 && device < kMaxDevices;
    int per_sm = keep ? cache[device][k].load(std::memory_order_relaxed) : 0;
    if (per_sm == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        if (keep) cache[device][k].store(per_sm, std::memory_order_relaxed);
    }
    const int64_t chunks = n / 16;
    const int64_t waves = (chunks + (int64_t)threads * sms - 1) / ((int64_t)threads * sms);
    int64_t g = (int64_t)sms * (waves < per_sm ? waves : per_sm);
    if (g > chunks) g = chunks;
    *blocks = (int)g;
    *span = (chunks + g - 1) / g * 16;
    return cudaSuccess;
}

// One launch of gf2_planes_kernel<M> for rows r0 .. r0+M-1.
template <int M>
cudaError_t launch_planes(const uint8_t* planes, int k, int m_pad, int r0,
                          const uint8_t* data, int64_t n, uint8_t* out, int device,
                          cudaStream_t stream) {
    static std::atomic<int> cached[kMaxDevices][kMaxK + 1];
    const int smem = col_bytes(k, M) + kRing * kTile;
    int blocks = 0;
    int64_t span = 0;
    const cudaError_t err =
        ring_grid(gf2_planes_kernel<M>, smem, cached, k, device, n, &blocks, &span);
    if (err != cudaSuccess) return err;
    gf2_planes_kernel<M><<<blocks, kTile / 16, smem, stream>>>(planes, k, m_pad, r0, data, n,
                                                               out, span);
    return cudaGetLastError();
}

// One launch of gf2_table_kernel<M> for rows r0 .. r0+M-1 of the bit-major
// operand of m rows.
template <int M>
cudaError_t launch_table(const uint8_t* bits, int k, int m, int r0, const uint8_t* data,
                         int64_t n, uint8_t* out, int device, cudaStream_t stream) {
    static std::atomic<int> cached[kMaxDevices][kMaxK + 1];
    const int smem = table_smem(k, Packed<M>::kWords) + kRing * kTile;
    int blocks = 0;
    int64_t span = 0;
    const cudaError_t err =
        ring_grid(gf2_table_kernel<M>, smem, cached, k, device, n, &blocks, &span);
    if (err != cudaSuccess) return err;
    gf2_table_kernel<M><<<blocks, kTile / 16, smem, stream>>>(bits, k, m, r0, data, n, out,
                                                              span);
    return cudaGetLastError();
}

bool aligned16(const uint8_t* data, int64_t n, const uint8_t* out) {
    return n % 16 == 0 && (uintptr_t)data % 16 == 0 && (uintptr_t)out % 16 == 0;
}

int run_planes(const uint8_t* planes, int k, int m, int m_pad, const uint8_t* data, int64_t n,
               uint8_t* out, int device, void* stream) {
    if (n == 0 || !aligned16(data, n, out))
        return run_masked<Layout::kPlanes>(planes, k, m, m_pad, data, n, out, device, stream);
    cudaError_t err = cudaSetDevice(device);
    cudaStream_t s = (cudaStream_t)stream;
    for (int r0 = 0; r0 < m && err == cudaSuccess; r0 += kRowsPerLaunch) {
        const int rows = m - r0 < kRowsPerLaunch ? m - r0 : kRowsPerLaunch;
        switch (rows) {
            case 1: err = launch_planes<1>(planes, k, m_pad, r0, data, n, out, device, s); break;
            case 2: err = launch_planes<2>(planes, k, m_pad, r0, data, n, out, device, s); break;
            case 3: err = launch_planes<3>(planes, k, m_pad, r0, data, n, out, device, s); break;
            case 4: err = launch_planes<4>(planes, k, m_pad, r0, data, n, out, device, s); break;
            case 5: err = launch_planes<5>(planes, k, m_pad, r0, data, n, out, device, s); break;
            case 6: err = launch_planes<6>(planes, k, m_pad, r0, data, n, out, device, s); break;
            case 7: err = launch_planes<7>(planes, k, m_pad, r0, data, n, out, device, s); break;
            default: err = launch_planes<8>(planes, k, m_pad, r0, data, n, out, device, s); break;
        }
    }
    return (int)err;
}

int run_table(const uint8_t* bits, int k, int m, const uint8_t* data, int64_t n, uint8_t* out,
              int device, void* stream) {
    if (n == 0 || !aligned16(data, n, out))
        return run_masked<Layout::kBitMajor>(bits, k, m, m, data, n, out, device, stream);
    cudaError_t err = cudaSetDevice(device);
    cudaStream_t s = (cudaStream_t)stream;
    for (int r0 = 0; r0 < m && err == cudaSuccess; r0 += kRowsPerLaunch) {
        const int rows = m - r0 < kRowsPerLaunch ? m - r0 : kRowsPerLaunch;
        switch (rows) {
            case 1: err = launch_table<1>(bits, k, m, r0, data, n, out, device, s); break;
            case 2: err = launch_table<2>(bits, k, m, r0, data, n, out, device, s); break;
            case 3: err = launch_table<3>(bits, k, m, r0, data, n, out, device, s); break;
            case 4: err = launch_table<4>(bits, k, m, r0, data, n, out, device, s); break;
            case 5: err = launch_table<5>(bits, k, m, r0, data, n, out, device, s); break;
            case 6: err = launch_table<6>(bits, k, m, r0, data, n, out, device, s); break;
            case 7: err = launch_table<7>(bits, k, m, r0, data, n, out, device, s); break;
            default: err = launch_table<8>(bits, k, m, r0, data, n, out, device, s); break;
        }
    }
    return (int)err;
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
    return run_table(bits, k, m, data, n, out, device, stream);
}

// planes: (8, k, 8*m_pad) u8 0/1 plane stack; data: (k, n) u8; out: (m, n)
// u8, m <= m_pad: only the m real rows are written. Otherwise as gf2_apply.
extern "C" int gf2_apply_planes(const uint8_t* planes, int k, int m_pad, int m,
                                const uint8_t* data, int64_t n, uint8_t* out, int device,
                                void* stream) {
    if (k < 1 || k > kMaxK || m < 1 || m > m_pad || n < 0) return (int)cudaErrorInvalidValue;
    return run_planes(planes, k, m, m_pad, data, n, out, device, stream);
}
