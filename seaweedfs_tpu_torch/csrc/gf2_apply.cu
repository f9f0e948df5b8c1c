// gf2_apply: GF(2^8) matrix apply for Reed-Solomon encode, rebuild, degraded
// reads and decode, written by hand for Hopper (sm_90a). Two entry points
// compute the same function, exact, byte for byte:
//
//   out[r] = XOR_c gf_mul(coeff[r, c], data[c])   data (k, n) u8 -> out (m, n) u8
//
// and differ in the operand that carries the coefficients and in the body.
// Output rows are launched in groups of at most 8 (a template parameter M,
// so the accumulators stay in registers).
//
// gf2_apply replaces `_rs_kernel` in seaweedfs_tpu/ops/rs_pallas.py (reached
// through apply_bitmajor_pallas -> _pallas_apply -> pl.pallas_call). Its
// operand is the bit-major (8m, 8k) GF(2) expansion B
// (rs_torch.bit_matrix_bitmajor): B[i*m + r, j*k + c] is bit i of
// gf_mul(coeff[r, c], 1 << j). Body, gf2_apply_kernel:
//   1. Each block folds B into column masks in shared memory,
//        col[c][j][r] = sum_i B[i*m + r, j*k + c] << i = gf_mul(coeff[r,c], 1<<j),
//      replicated into the 4 byte lanes of a 32-bit word (k*8*M words).
//   2. Each thread takes 16 byte columns (a grid-stride loop): one 16-byte
//      load per shard row, consumed before the next row's load. For each
//      input bit j it turns bit j of every byte into a 0x00/0xFF lane mask,
//      lanes = ((w >> j) & 0x01010101) * 0xFF, and accumulates
//      out_r ^= lanes & col[c][j][r] (one LOP3). The 0/1 lanes cannot carry
//      into a neighbour, so each byte lane receives exactly its own product.
//   3. It writes M output rows of 16 bytes. A ragged tail (n not a multiple
//      of 16, or a row not 16-byte aligned) goes through byte loads and
//      stores, masked at n.
//   What bounds it, measured on an NVIDIA H100 80GB HBM3 at 700 W
//   (chip_smoke.py, cold L2): 18.3 us at (10, 1 MiB), m = 4, 24 % of the
//   4.4 us byte bound; 110 us at (10, 16 MiB), m = 2, 55 %. The fold sits
//   before the first load in every block, each thread's k row loads follow
//   one another, and the mask takes 3 integer instructions per bit and word.
//
// gf2_apply_planes replaces `_rs_kernel_aligned` in rs_pallas.py (reached
// through apply_planes_pallas -> _pallas_apply -> pl.pallas_call). Its
// operand is the plane stack of rs_torch.bit_matrix_planes, (8, k, 8*m_pad):
// P[j, c, i*m_pad + r] is bit i of gf_mul(coeff[r, c], 1 << j), rows r >= m
// zero. m_pad (32 for pack_width 1, 16 for 2) exists only for Mosaic's
// (sublane, 128) tiling; only the m real rows are computed and written. It
// serves degraded reads (m = 1, n from 64 KiB to about 1.1 MiB) and decode
// ((10, 16 MiB), m = 1), where the byte bound, (k+m)*n over 3.35 TB/s, is
// 3.4 us at n = 1 MiB and 55 us at 16 MiB. Body, gf2_planes_kernel, against
// the three causes above:
//   1. Fold off the critical path. A block first issues its first source
//      rows' copies (step 2), then folds the k*8*M masks while they are in
//      flight: lane l of a warp loads bit (l & 7) of one of four masks, so a
//      mask's 8 strided bytes are loaded at once, and one ballot packs them.
//   2. Rows in flight, consumed as they land. Block b owns an equal span of
//      columns (as many blocks per SM as fit, no more than give each a tile
//      of 256 x 16 columns) and walks it a tile at a time. Each thread
//      streams the k rows of its 16 columns through kRing = 4 slots of its
//      own in shared memory with cp.async.cg, waiting for one row at a time
//      and refilling the slot it just read with the row 4 ahead, across tile
//      ends. It reads back only what it copied: no barrier in the loop.
//   3. Fewer integer instructions per bit. x = w << (7 - j) moves bit j of
//      every byte to its top bit without leaking between bytes (no bit moves
//      past 7), and PRMT in sign mode (selector 0xBA98) spreads each byte's
//      top bit over its byte: IMAD.SHL, PRMT and LOP3 per bit and word at
//      M = 1, where gf2_apply's body needs SHF, LOP, IMAD and LOP3.
//   Rows that are not 16-byte aligned, or n not a multiple of 16, go through
//   gf2_apply_kernel's masked byte path with the plane-stack fold.
//   Measured (chip_smoke.py and chip_kernels.py, NVIDIA H100 80GB HBM3 at
//   700 W, L2 flushed by a 64 MiB write, medians): 12.3-12.5 us at
//   (10, 1 MiB), m = 1, and 83-86 us at (10, 16 MiB), against 14.9 us and
//   91 us for gf2_apply's body on the same coefficients in the same runs.
//   What still bounds it at 1 MiB: the ALU work (64 PRMT and LOP3 per 16
//   bytes of a row) is close to the byte bound and shows wherever the
//   stream and the compute do not overlap, and each thread waits one row's
//   latency before it computes anything. A ring of 2 or 8 slots, whole
//   tiles in 2 stages, and an L2 evict-first cache hint on cp.async (an
//   illegal instruction on this card) were tried and lost. The launch
//   shape (SM count, blocks per SM) is read once per device and k: the
//   host set-up of a launch is on a degraded read's path.

#include <atomic>
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

// ---- gf2_planes_kernel: the plane-stack body for 16-byte aligned rows ----

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

// One launch of gf2_planes_kernel<M> for rows r0 .. r0+M-1: as many blocks
// per SM as fit, but no more than give each block a tile of work, each over
// an equal span of columns. Blocks per SM depend on the device and, through
// the masks' shared memory, on k: queried once for each.
template <int M>
cudaError_t launch_planes(const uint8_t* planes, int k, int m_pad, int r0,
                          const uint8_t* data, int64_t n, uint8_t* out, int device,
                          cudaStream_t stream) {
    static std::atomic<int> cached[kMaxDevices][kMaxK + 1];
    constexpr int threads = kTile / 16;
    const int smem = col_bytes(k, M) + kRing * kTile;
    int sms = 0;
    cudaError_t err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    const bool keep = device >= 0 && device < kMaxDevices;
    int per_sm = keep ? cached[device][k].load(std::memory_order_relaxed) : 0;
    if (per_sm == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, gf2_planes_kernel<M>, threads, smem);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        if (keep) cached[device][k].store(per_sm, std::memory_order_relaxed);
    }
    const int64_t chunks = n / 16;
    const int64_t waves = (chunks + (int64_t)threads * sms - 1) / ((int64_t)threads * sms);
    int64_t blocks = (int64_t)sms * (waves < per_sm ? waves : per_sm);
    if (blocks > chunks) blocks = chunks;
    const int64_t span = (chunks + blocks - 1) / blocks * 16;
    gf2_planes_kernel<M><<<(int)blocks, threads, smem, stream>>>(planes, k, m_pad, r0, data, n,
                                                                 out, span);
    return cudaGetLastError();
}

int run_planes(const uint8_t* planes, int k, int m, int m_pad, const uint8_t* data, int64_t n,
               uint8_t* out, int device, void* stream) {
    const bool vec_ok = n % 16 == 0 && (uintptr_t)data % 16 == 0 && (uintptr_t)out % 16 == 0;
    if (n == 0 || !vec_ok)
        return run<Layout::kPlanes>(planes, k, m, m_pad, data, n, out, device, stream);
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
    return run_planes(planes, k, m, m_pad, data, n, out, device, stream);
}
