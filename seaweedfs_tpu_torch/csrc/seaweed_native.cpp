// The PyTorch port's host library: the host byte plane (CRC32C, batched
// positioned reads with an inline rolling CRC, a readahead hint, and the
// stateful shard sink that writes N shard streams and rolls their
// sidecar CRCs in the same cache-hot pass) and the GF(2^8) Reed-Solomon
// matrix apply of the native CPU backend (ec/backend.py CpuBackend:
// PSHUFB nibble tables, AVX2 or SSSE3 where the CPU has them). Host
// code, built with g++ (-pthread) at first use and loaded with ctypes
// (seaweedfs_tpu_torch/ops/_build.py, seaweedfs_tpu_torch/utils/native.py).
//
// The port's own copy of the parts of the JAX package's C++ core that
// encode, rebuild, decode, degraded reads, the CPU backend and the shard
// net plane's read opcode (sn_send_file, sn_sendv, sn_recv_into,
// sn_recv_overlap_active; socket helpers in sn_net.h) call; same
// functions, same output bit for bit, with the .dat scanner (sn_scan_dat)
// of the volume server's ScrubVolume. The one-shot shard append is not
// here: no path of the port calls it.
//
// Departures from that core:
// - the reader's and the sink's per-row work, and the column windows of
//   sn_rs_apply_mt, run on a persistent pool of worker threads, where
//   the core starts and joins fresh threads on every call. Where starting
//   a thread costs about as much as reading or CRC-ing a 1 MiB row
//   (chip_host_io.py times both on the card's host), per-call threads
//   made the native plane slower than the Python loops it replaces;
// - the GF(2^8) tables are built once under std::call_once, where the
//   core sets a plain flag: the pool's threads and several Python threads
//   may reach the first apply at once;
// - sn_rs_apply_body runs one named multiply body (scalar, SSSE3 or
//   AVX2) so that tests reach all three on any host; no path calls it.

#include <algorithm>
#include <cerrno>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

#include "sn_net.h"

#if defined(__x86_64__)
#include <immintrin.h>
#endif

// ---------------------------------------------------------------------------
// Worker pool: parallel_for(n, fn) runs fn(0..n-1) on the pool's threads
// and the calling thread, and returns when all n have run. Several
// callers may run at once (encode's reader and writer do); their jobs
// queue in order. The threads start at the first call and live as long
// as the process. A child forked from a process that has them runs
// every job on its calling thread.
// ---------------------------------------------------------------------------

namespace {

struct Job {
    const std::function<void(int)>* fn;
    int n;
    int next = 0;  // the next index to hand out; all fields under Pool::mu
    int done = 0;
    std::condition_variable finished;
};

class Pool {
  public:
    static Pool& get() {
        static Pool* pool = new Pool();  // never destroyed: its threads outlive main
        return *pool;
    }

    // Threads that run a job's indices: the workers and the caller.
    int threads() const { return forked_ ? 1 : (int)threads_ + 1; }

    void parallel_for(int n, const std::function<void(int)>& fn) {
        if (n <= 1 || threads_ == 0 || forked_) {
            for (int i = 0; i < n; i++) fn(i);
            return;
        }
        Job job;
        job.fn = &fn;
        job.n = n;
        std::unique_lock<std::mutex> l(mu_);
        jobs_.push_back(&job);
        work_.notify_all();
        while (job.next < n) {  // the caller works too
            int i = take(&job);
            l.unlock();
            fn(i);
            l.lock();
            job.done++;
        }
        job.finished.wait(l, [&] { return job.done == n; });
    }

  private:
    Pool() {
        unsigned hw = std::thread::hardware_concurrency();
        threads_ = hw > 1 ? hw - 1 : 0;  // the caller is the last worker
        for (unsigned t = 0; t < threads_; t++) std::thread([this] { worker(); }).detach();
        pthread_atfork(nullptr, nullptr, [] { forked_ = true; });
    }

    // Hand out the job's next index; the job leaves the queue with its last.
    int take(Job* j) {
        int i = j->next++;
        if (j->next == j->n) jobs_.erase(std::find(jobs_.begin(), jobs_.end(), j));
        return i;
    }

    void worker() {
        std::unique_lock<std::mutex> l(mu_);
        for (;;) {
            work_.wait(l, [&] { return !jobs_.empty(); });
            Job* j = jobs_.front();
            int i = take(j);
            l.unlock();
            (*j->fn)(i);
            l.lock();
            // the job's owner returns only after done == n, under mu_
            if (++j->done == j->n) j->finished.notify_all();
        }
    }

    std::mutex mu_;
    std::condition_variable work_;
    std::deque<Job*> jobs_;
    unsigned threads_ = 0;
    static bool forked_;
};

bool Pool::forked_ = false;

void parallel_for(int n, const std::function<void(int)>& fn) { Pool::get().parallel_for(n, fn); }

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli): SSE4.2 crc32 instructions where the CPU has them,
// slice-by-8 tables otherwise.
// ---------------------------------------------------------------------------

static uint32_t crc32c_table[8][256];
static std::once_flag crc32c_table_once;

static void crc32c_table_build() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t crc = i;
        for (int j = 0; j < 8; j++) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
        crc32c_table[0][i] = crc;
    }
    for (int k = 1; k < 8; k++)
        for (uint32_t i = 0; i < 256; i++)
            crc32c_table[k][i] =
                (crc32c_table[k - 1][i] >> 8) ^ crc32c_table[0][crc32c_table[k - 1][i] & 0xFF];
}

// Thread-safe: the sink's and the reader's workers may race to the
// first software CRC.
static void crc32c_table_init() { std::call_once(crc32c_table_once, crc32c_table_build); }

static uint32_t crc32c_sw(uint32_t crc, const uint8_t* p, size_t len) {
    crc32c_table_init();
    crc = ~crc;
    while (len && ((uintptr_t)p & 7)) {
        crc = (crc >> 8) ^ crc32c_table[0][(crc ^ *p++) & 0xFF];
        len--;
    }
    while (len >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        w ^= crc;
        crc = crc32c_table[7][w & 0xFF] ^ crc32c_table[6][(w >> 8) & 0xFF] ^
              crc32c_table[5][(w >> 16) & 0xFF] ^ crc32c_table[4][(w >> 24) & 0xFF] ^
              crc32c_table[3][(w >> 32) & 0xFF] ^ crc32c_table[2][(w >> 40) & 0xFF] ^
              crc32c_table[1][(w >> 48) & 0xFF] ^ crc32c_table[0][(w >> 56) & 0xFF];
        p += 8;
        len -= 8;
    }
    while (len--) crc = (crc >> 8) ^ crc32c_table[0][(crc ^ *p++) & 0xFF];
    return ~crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(uint32_t crc, const uint8_t* p, size_t len) {
    crc = ~crc;
    while (len && ((uintptr_t)p & 7)) {
        crc = _mm_crc32_u8(crc, *p++);
        len--;
    }
    while (len >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        crc = (uint32_t)_mm_crc32_u64(crc, w);
        p += 8;
        len -= 8;
    }
    while (len--) crc = _mm_crc32_u8(crc, *p++);
    return ~crc;
}
#endif

uint32_t sn_crc32c(uint32_t crc, const uint8_t* data, size_t len) {
#if defined(__x86_64__)
    if (__builtin_cpu_supports("sse4.2")) return crc32c_hw(crc, data, len);
#endif
    return crc32c_sw(crc, data, len);
}

// crc(A ++ B) = shift(crc(A), len(B)) ^ crc(B), with the shift operator
// a 32x32 GF(2) matrix raised to the byte length (zlib's crc32_combine,
// Castagnoli polynomial). Lets the sink fold leaf CRCs into block CRCs
// without a second pass over the bytes.

static uint32_t gf2_matrix_times(const uint32_t* mat, uint32_t vec) {
    uint32_t sum = 0;
    while (vec) {
        if (vec & 1) sum ^= *mat;
        vec >>= 1;
        mat++;
    }
    return sum;
}

static void gf2_matrix_square(uint32_t* square, const uint32_t* mat) {
    for (int n = 0; n < 32; n++) square[n] = gf2_matrix_times(mat, mat[n]);
}

// Fill `op` (32 words) with the matrix that advances a CRC over len2
// zero bytes: square-and-multiply over the shift-by-one-byte operator.
static void crc32c_shift_op(uint32_t* op, uint64_t len2) {
    uint32_t even[32], odd[32];
    odd[0] = 0x82F63B78u;  // one zero bit, reflected polynomial
    uint32_t row = 1;
    for (int n = 1; n < 32; n++) {
        odd[n] = row;
        row <<= 1;
    }
    gf2_matrix_square(even, odd);  // 2 bits
    gf2_matrix_square(odd, even);  // 4 bits
    uint32_t cur[32], nxt[32];
    gf2_matrix_square(cur, odd);   // 8 bits: one byte
    bool have = false;
    uint32_t acc[32];
    while (len2) {
        if (len2 & 1) {
            if (!have) {
                memcpy(acc, cur, sizeof(acc));
                have = true;
            } else {
                // powers of one matrix commute
                for (int n = 0; n < 32; n++) nxt[n] = gf2_matrix_times(cur, acc[n]);
                memcpy(acc, nxt, sizeof(acc));
            }
        }
        len2 >>= 1;
        if (len2) {
            gf2_matrix_square(nxt, cur);
            memcpy(cur, nxt, sizeof(cur));
        }
    }
    if (!have)
        for (int n = 0; n < 32; n++) acc[n] = 1u << n;  // len2 == 0: identity
    memcpy(op, acc, sizeof(acc));
}

uint32_t sn_crc32c_combine(uint32_t crc1, uint32_t crc2, uint64_t len2) {
    if (len2 == 0) return crc1;
    uint32_t op[32];
    crc32c_shift_op(op, len2);
    return gf2_matrix_times(op, crc1) ^ crc2;
}

// Advance one stream's rolling granule CRC over `len` bytes; completed
// granule CRCs append to out (capacity max_out). Returns the count added,
// -1 on overflow.
static int roll_crc_blocks(uint32_t* crc, uint64_t* filled, uint32_t block_size,
                           const uint8_t* p, size_t len, uint32_t* out, int32_t max_out) {
    int added = 0;
    while (len) {
        size_t room = (size_t)block_size - (size_t)*filled;
        size_t take = len < room ? len : room;
        *crc = sn_crc32c(*crc, p, take);
        *filled += take;
        p += take;
        len -= take;
        if (*filled == block_size) {
            if (added >= max_out) return -1;
            out[added++] = *crc;
            *crc = 0;
            *filled = 0;
        }
    }
    return added;
}

// ---------------------------------------------------------------------------
// Read source: batched positioned reads into caller-owned rows, a row per
// pool task, with an optional fused rolling granule CRC32C. One call per
// batch, with the GIL released by ctypes, in place of k Python preadv
// loops (and, on the rebuild path, k Python CRC rollers).
// ---------------------------------------------------------------------------

// Read `width` bytes from fds[i] at offsets[i] into dst + i*stride.
// pad_eof != 0 zero-fills past EOF (the encoder's ragged tail); pad_eof
// == 0 makes a short read that row's failure (the rebuild contract).
// With granule > 0, each row's rolling CRC (crc_state/filled_state,
// persisting across calls) advances over the bytes read (not the
// padding); completed granule CRCs land at out_crcs[i*max_out..], counts
// in out_counts[i] (-1: out_crcs overflowed). Returns 0, or -(i+1) for
// the first failed row.
int sn_batch_pread(const int* fds, const uint64_t* offsets, int nrows, uint8_t* dst,
                   size_t width, size_t stride, int pad_eof, uint32_t granule,
                   uint32_t* crc_state, uint64_t* filled_state, uint32_t* out_crcs,
                   int32_t* out_counts, int32_t max_out) {
    std::vector<int> status((size_t)nrows, 0);
    auto work = [&](int i) {
        uint8_t* p = dst + (size_t)i * stride;
        size_t filled = 0;
        while (filled < width) {
            ssize_t got = pread(fds[i], p + filled, width - filled, (off_t)(offsets[i] + filled));
            if (got < 0) {
                if (errno == EINTR) continue;
                status[i] = -1;
                return;
            }
            if (got == 0) break;  // EOF
            filled += (size_t)got;
        }
        if (filled < width) {
            if (!pad_eof) {
                status[i] = -1;
                return;
            }
            memset(p + filled, 0, width - filled);
        }
        if (granule > 0) {
            int added = roll_crc_blocks(&crc_state[i], &filled_state[i], granule, p, filled,
                                        out_crcs + (size_t)i * (size_t)max_out, max_out);
            if (added < 0) {
                out_counts[i] = -1;
                status[i] = -1;
                return;
            }
            out_counts[i] = added;
        } else if (out_counts) {
            out_counts[i] = 0;
        }
    };
    parallel_for(nrows, work);
    for (int i = 0; i < nrows; i++)
        if (status[i] != 0) return -(i + 1);
    return 0;
}

// Best-effort readahead hint for the next batch's extent, issued before
// the current batch is read.
int sn_fadvise_willneed(int fd, uint64_t off, uint64_t len) {
#if defined(POSIX_FADV_WILLNEED)
    return posix_fadvise(fd, (off_t)off, (off_t)len, POSIX_FADV_WILLNEED);
#else
    (void)fd;
    (void)off;
    (void)len;
    return 0;
#endif
}

// ---------------------------------------------------------------------------
// Stateful shard sink: one call per batch appends `width` bytes to every
// shard stream, a pool task per shard, pwrite(2) at offsets the sink
// tracks itself (the callers' file positions never move), straight from
// the source rows. Each worker rolls its shard's sidecar CRCs first,
// while the bytes are cache-hot: with a leaf level, one byte pass rolls
// the leaves and the block level is folded from completed leaf CRCs.
//
// SN_SINK_EARLY_WB starts background writeback of each appended extent
// (sync_file_range), so the publish-time fsync drains a range already in
// flight. SN_SINK_DIRECT writes O_DIRECT while every append stays
// 4096-aligned (pointer, width, file offset); a misaligned append (the
// ragged tail) or a write the filesystem rejects drops that shard back
// to buffered writes, with the same bytes at the same offsets.
// ---------------------------------------------------------------------------

#define SN_SINK_EARLY_WB 1u
#define SN_SINK_DIRECT 2u
#define SN_DIRECT_ALIGN 4096u

static int set_fd_direct(int fd, bool on) {
#if defined(O_DIRECT)
    int fl = fcntl(fd, F_GETFL);
    if (fl < 0) return -1;
    int nfl = on ? (fl | O_DIRECT) : (fl & ~O_DIRECT);
    if (fl == nfl) return 0;
    return fcntl(fd, F_SETFL, nfl) == 0 ? 0 : -1;
#else
    (void)fd;
    (void)on;
    return -1;
#endif
}

struct SnSink {
    std::vector<int> fds;
    std::vector<char> direct;   // shard still writing O_DIRECT
    std::vector<uint64_t> off;  // next pwrite offset per shard
    uint32_t block_size;
    uint32_t leaf_size;  // 0: block level only (v1 sidecar)
    uint32_t flags;
    // leaf_size == 0: the block CRC is byte-rolled (bcrc/bfill).
    // leaf_size > 0: the block CRC is folded from completed leaf CRCs
    // through leaf_op, and bfill counts completed leaves.
    std::vector<uint32_t> bcrc;
    std::vector<uint64_t> bfill;
    std::vector<uint32_t> lcrc;  // rolling leaf CRC
    std::vector<uint64_t> lfill;
    uint32_t leaf_op[32];  // CRC shift operator over leaf_size bytes
};

void* sn_sink_create(const int* fds, int n, uint32_t block_size, uint32_t leaf_size,
                     uint32_t flags) {
    if (n <= 0 || block_size == 0) return nullptr;
    if (leaf_size != 0 && block_size % leaf_size != 0) return nullptr;
    SnSink* s = new SnSink();
    s->fds.assign(fds, fds + n);
    s->direct.assign((size_t)n, 0);
    if (flags & SN_SINK_DIRECT)
        for (int i = 0; i < n; i++) s->direct[(size_t)i] = set_fd_direct(fds[i], true) == 0 ? 1 : 0;
    s->off.assign((size_t)n, 0);
    s->block_size = block_size;
    s->leaf_size = leaf_size;
    s->flags = flags;
    s->bcrc.assign((size_t)n, 0);
    s->bfill.assign((size_t)n, 0);
    s->lcrc.assign((size_t)n, 0);
    s->lfill.assign((size_t)n, 0);
    if (leaf_size) crc32c_shift_op(s->leaf_op, leaf_size);
    return s;
}

static int sink_pwrite(SnSink* s, int i, const uint8_t* p, size_t len, uint64_t off) {
    if (s->direct[(size_t)i]) {
        bool aligned = ((uintptr_t)p % SN_DIRECT_ALIGN == 0) && (len % SN_DIRECT_ALIGN == 0) &&
                       (off % SN_DIRECT_ALIGN == 0);
        if (!aligned) {
            set_fd_direct(s->fds[(size_t)i], false);
            s->direct[(size_t)i] = 0;
        }
    }
    while (len) {
        ssize_t w = pwrite(s->fds[(size_t)i], p, len, (off_t)off);
        if (w < 0) {
            if (errno == EINTR) continue;
            if (errno == EINVAL && s->direct[(size_t)i]) {
                set_fd_direct(s->fds[(size_t)i], false);
                s->direct[(size_t)i] = 0;
                continue;  // retry buffered
            }
            return -1;
        }
        p += w;
        off += (uint64_t)w;
        len -= (size_t)w;
    }
    return 0;
}

// Append `width` bytes from rows[i] to shard i, for every shard.
// Completed block CRCs land at out_block_crcs[i*max_out..] (counts in
// out_block_counts[i]); with a leaf level, completed leaf CRCs likewise
// in out_leaf_*. A count of -1 reports an overflow of the out arrays.
// Returns 0, or -(i+1) for the first failed shard.
int sn_sink_append(void* handle, const uint8_t* const* rows, size_t width,
                   uint32_t* out_block_crcs, int32_t* out_block_counts, uint32_t* out_leaf_crcs,
                   int32_t* out_leaf_counts, int32_t max_out) {
    SnSink* s = (SnSink*)handle;
    int n = (int)s->fds.size();
    uint32_t leaves_per_block = s->leaf_size ? s->block_size / s->leaf_size : 0;
    std::vector<int> status((size_t)n, 0);
    auto work = [&](int i) {
        if (s->leaf_size) {
            uint32_t* leaf_out = out_leaf_crcs + (size_t)i * (size_t)max_out;
            int added = roll_crc_blocks(&s->lcrc[i], &s->lfill[i], s->leaf_size, rows[i], width,
                                        leaf_out, max_out);
            if (added < 0) {
                out_leaf_counts[i] = -1;
                status[i] = -1;
                return;
            }
            out_leaf_counts[i] = added;
            uint32_t* block_out = out_block_crcs + (size_t)i * (size_t)max_out;
            int nblocks = 0;
            for (int l = 0; l < added; l++) {
                s->bcrc[i] = gf2_matrix_times(s->leaf_op, s->bcrc[i]) ^ leaf_out[l];
                if (++s->bfill[i] == leaves_per_block) {
                    if (nblocks >= max_out) {
                        out_block_counts[i] = -1;
                        status[i] = -1;
                        return;
                    }
                    block_out[nblocks++] = s->bcrc[i];
                    s->bcrc[i] = 0;
                    s->bfill[i] = 0;
                }
            }
            out_block_counts[i] = nblocks;
        } else {
            int added = roll_crc_blocks(&s->bcrc[i], &s->bfill[i], s->block_size, rows[i], width,
                                        out_block_crcs + (size_t)i * (size_t)max_out, max_out);
            if (added < 0) {
                out_block_counts[i] = -1;
                status[i] = -1;
                return;
            }
            out_block_counts[i] = added;
            if (out_leaf_counts) out_leaf_counts[i] = 0;
        }
        uint64_t at = s->off[i];
        if (sink_pwrite(s, i, rows[i], width, at) != 0) {
            status[i] = -1;
            return;
        }
        s->off[i] = at + width;
#if defined(__linux__) && defined(SYNC_FILE_RANGE_WRITE)
        if (s->flags & SN_SINK_EARLY_WB)
            // best effort: a filesystem that rejects it leaves the
            // writeback to the caller's fsync
            (void)sync_file_range(s->fds[i], (off_t)at, (off_t)width, SYNC_FILE_RANGE_WRITE);
#endif
    };
    parallel_for(n, work);
    for (int i = 0; i < n; i++)
        if (status[i] != 0) return -(i + 1);
    return 0;
}

// Flush each level's partial-tail CRC (a valid flag per shard) and
// report the bytes appended per shard. Only destroy may follow.
int sn_sink_finish(void* handle, uint32_t* tail_block_crc, uint8_t* tail_block_valid,
                   uint32_t* tail_leaf_crc, uint8_t* tail_leaf_valid, uint64_t* sizes) {
    SnSink* s = (SnSink*)handle;
    int n = (int)s->fds.size();
    for (int i = 0; i < n; i++) {
        if (s->leaf_size) {
            // partial block = the folded completed leaves + the partial leaf
            tail_block_valid[i] = (s->bfill[i] || s->lfill[i]) ? 1 : 0;
            tail_block_crc[i] = sn_crc32c_combine(s->bcrc[i], s->lcrc[i], s->lfill[i]);
        } else {
            tail_block_valid[i] = s->bfill[i] ? 1 : 0;
            tail_block_crc[i] = s->bcrc[i];
        }
        if (tail_leaf_valid) {
            tail_leaf_valid[i] = (s->leaf_size && s->lfill[i]) ? 1 : 0;
            tail_leaf_crc[i] = s->lcrc[i];
        }
        sizes[i] = s->off[i];
        s->bfill[i] = 0;
        s->bcrc[i] = 0;
        s->lfill[i] = 0;
        s->lcrc[i] = 0;
    }
    return 0;
}

// Per-shard O_DIRECT state (1: still writing O_DIRECT).
int sn_sink_direct_flags(void* handle, uint8_t* out) {
    SnSink* s = (SnSink*)handle;
    for (size_t i = 0; i < s->fds.size(); i++) out[i] = (uint8_t)s->direct[i];
    return (int)s->fds.size();
}

void sn_sink_destroy(void* handle) { delete (SnSink*)handle; }

// ---------------------------------------------------------------------------
// Network byte plane (ec/net_plane.py):
//
//   sn_send_file  - sendfile(2) a shard fd range straight into a socket
//                   (kernel to kernel; a pread+write fallback where the
//                   kernel path is unsupported);
//   sn_sendv      - scatter-gather writev from caller buffers without a
//                   Python-side join or per-chunk GIL round trips;
//   sn_recv_into  - land a socket stream DIRECTLY in a caller-owned
//                   buffer (a pooled landing row), rolling the fused
//                   granule CRC32C during the copy-in so the sidecar
//                   verify costs no extra byte pass;
//   sn_recv_file  - land a socket stream in a file at an offset with one
//                   CRC32C rolled over it (the write opcode's blobs).
//
// ctypes releases the GIL for each whole call; timeouts follow the
// sn_net.h convention (Python settimeout sockets are O_NONBLOCK, so
// EAGAIN polls instead of failing).
// ---------------------------------------------------------------------------

int64_t sn_send_file(int out_fd, int in_fd, uint64_t offset, uint64_t len, int timeout_ms) {
    return sn_net::send_file(out_fd, in_fd, offset, len, timeout_ms);
}

// Scatter-gather send of n buffers. Returns total bytes sent (== sum of
// lens on success) or -errno; a peer that dies mid-stream surfaces as
// -EPIPE/-ECONNRESET, a stalled peer as -ETIMEDOUT.
int64_t sn_sendv(int fd, const uint8_t* const* bufs, const uint64_t* lens, int n,
                 int timeout_ms) {
    int64_t total = 0;
    int i = 0;
    uint64_t off = 0;  // progress within bufs[i]
    for (;;) {
        while (i < n && off >= lens[i]) {
            i++;
            off = 0;
        }
        if (i >= n) return total;
        struct iovec iov[64];
        int cnt = 0;
        for (int j = i; j < n && cnt < 64; j++) {
            uint64_t skip = (j == i) ? off : 0;
            if (lens[j] <= skip) continue;
            iov[cnt].iov_base = const_cast<uint8_t*>(bufs[j]) + skip;
            iov[cnt].iov_len = (size_t)(lens[j] - skip);
            cnt++;
        }
        ssize_t w = writev(fd, iov, cnt);
        if (w < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                int rc = sn_net::wait_fd(fd, POLLOUT, timeout_ms);
                if (rc != 0) return (int64_t)rc;
                continue;
            }
            return -(int64_t)errno;
        }
        total += w;
        uint64_t adv = (uint64_t)w;
        while (i < n && adv) {
            uint64_t rem = lens[i] - off;
            if (adv >= rem) {
                adv -= rem;
                off = 0;
                i++;
            } else {
                off += adv;
                adv = 0;
            }
        }
    }
}

// Receive up to `len` bytes from fd; `progress` (when given) publishes
// the bytes landed so far. Short = the peer closed.
static int64_t recv_plain(int fd, uint8_t* dst, uint64_t len, int timeout_ms,
                          uint64_t* progress) {
    uint64_t got = 0;
    while (got < len) {
        ssize_t r = read(fd, dst + got, (size_t)(len - got));
        if (r < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                int rc = sn_net::wait_fd(fd, POLLIN, timeout_ms);
                if (rc != 0) return (int64_t)rc;
                continue;
            }
            return -(int64_t)errno;
        }
        if (r == 0) break;  // peer closed
        got += (uint64_t)r;
        if (progress) __atomic_store_n(progress, got, __ATOMIC_RELEASE);
    }
    return (int64_t)got;
}

// Transfers below this run the serial recv+CRC loop: a thread start
// costs more than it buys on small ranges (leaf repairs, tails). The
// overlap also needs spare cores: with fewer than 4 hardware threads the
// CRC helper only steals CPU from the socket copy (and, on loopback,
// from the peer's sendfile). SEAWEED_EC_NET_OVERLAP overrides the core
// gate ("1" on, "0" serial, anything else the auto rule); the size floor
// always applies. The hot path takes the mode as a PARAMETER, read
// Python-side under the GIL: a getenv here would race a concurrent
// setenv from Python's os.environ, which is undefined behavior in glibc.
#define SN_RECV_OVERLAP_MIN (256u * 1024u)
#define SN_RECV_OVERLAP_MIN_CORES 4u

// mode: 0 = force serial, 1 = force overlapped, anything else = auto.
static bool recv_overlap_wanted(uint64_t len, int32_t mode) {
    if (len < SN_RECV_OVERLAP_MIN) return false;
    if (mode == 0) return false;
    if (mode == 1) return true;
    return std::thread::hardware_concurrency() >= SN_RECV_OVERLAP_MIN_CORES;
}

// Whether a fused recv of `len` bytes would take the overlapped core
// under the current env and host. Cold path only: callers probe it
// sequentially, so the getenv here does not race.
int sn_recv_overlap_active(uint64_t len) {
    const char* env = getenv("SEAWEED_EC_NET_OVERLAP");
    int32_t mode = -1;
    // env[0] before env[1]: an empty value is a 1-byte string
    if (env && (env[0] == '0' || env[0] == '1') && env[1] == 0) mode = env[0] - '0';
    return recv_overlap_wanted(len, mode) ? 1 : 0;
}

// Receive up to `len` bytes from fd straight into dst. With granule > 0
// the rolling granule CRC32C (crc_state/filled_state, persisting across
// calls if the caller keeps them) advances over the bytes while they are
// cache-hot from the copy-in; completed granule CRCs append to out_crcs
// (*out_count in all, -1 on overflow of max_out). For large fused
// transfers the socket reads run on a helper thread with the CRC chasing
// the landed bytes from the calling thread, so the verify overlaps the
// wire instead of serializing behind it. Returns bytes received (short
// means the peer closed mid-stream: the caller's torn-stream contract)
// or -errno.
int64_t sn_recv_into(int fd, uint8_t* dst, uint64_t len, int timeout_ms, uint32_t granule,
                     uint32_t* crc_state, uint64_t* filled_state, uint32_t* out_crcs,
                     int32_t* out_count, int32_t max_out, int32_t overlap_mode) {
    crc32c_table_init();
    if (out_count) *out_count = 0;
    if (granule == 0) return recv_plain(fd, dst, len, timeout_ms, nullptr);
    if (!recv_overlap_wanted(len, overlap_mode)) {
        // serial: recv then CRC the fresh bytes, chunk by chunk
        uint64_t got = 0;
        while (got < len) {
            uint64_t before = got;
            ssize_t r = read(fd, dst + got, (size_t)(len - got));
            if (r < 0) {
                if (errno == EINTR) continue;
                if (errno == EAGAIN || errno == EWOULDBLOCK) {
                    int rc = sn_net::wait_fd(fd, POLLIN, timeout_ms);
                    if (rc != 0) return (int64_t)rc;
                    continue;
                }
                return -(int64_t)errno;
            }
            if (r == 0) break;
            got += (uint64_t)r;
            int added = roll_crc_blocks(crc_state, filled_state, granule, dst + before,
                                        (size_t)r, out_crcs + *out_count, max_out - *out_count);
            if (added < 0) {
                *out_count = -1;
                return -EOVERFLOW;
            }
            *out_count += added;
        }
        return (int64_t)got;
    }
    // Overlapped: a helper thread fills dst, this thread CRCs behind it.
    uint64_t progress = 0;
    int64_t recv_rc = 0;
    bool done = false;
    std::thread reader([&]() {
        recv_rc = recv_plain(fd, dst, len, timeout_ms, &progress);
        __atomic_store_n(&done, true, __ATOMIC_RELEASE);
    });
    uint64_t crc_done = 0;
    bool overflow = false;
    for (;;) {
        uint64_t avail = __atomic_load_n(&progress, __ATOMIC_ACQUIRE);
        bool finished = __atomic_load_n(&done, __ATOMIC_ACQUIRE);
        if (avail > crc_done) {
            int added = roll_crc_blocks(crc_state, filled_state, granule, dst + crc_done,
                                        (size_t)(avail - crc_done), out_crcs + *out_count,
                                        max_out - *out_count);
            if (added < 0) {
                overflow = true;
                break;
            }
            *out_count += added;
            crc_done = avail;
        } else if (finished) {
            break;
        } else {
            std::this_thread::yield();
        }
    }
    reader.join();
    if (overflow) {
        *out_count = -1;
        return -EOVERFLOW;
    }
    if (recv_rc < 0) return recv_rc;
    // CRC whatever landed after the last loop pass
    uint64_t got = (uint64_t)recv_rc;
    if (got > crc_done) {
        int added = roll_crc_blocks(crc_state, filled_state, granule, dst + crc_done,
                                    (size_t)(got - crc_done), out_crcs + *out_count,
                                    max_out - *out_count);
        if (added < 0) {
            *out_count = -1;
            return -EOVERFLOW;
        }
        *out_count += added;
    }
    return recv_rc;
}

static int pwrite_full(int fd, const uint8_t* p, size_t len, uint64_t off) {
    while (len) {
        ssize_t w = pwrite(fd, p, len, (off_t)off);
        if (w < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        p += w;
        len -= (size_t)w;
        off += (uint64_t)w;
    }
    return 0;
}

// Land `len` socket bytes straight into file out_fd at `offset`
// (socket -> 256 KiB bounce buffer -> pwrite(2)), rolling one CRC32C
// over the whole payload while each chunk is cache-hot: the blob-write
// landing of the net plane's write opcode, the payload never crossing
// into Python. Returns bytes landed (short means the peer closed
// mid-stream: the partial extent is on disk, but the caller never ACKs
// it) or -errno from the socket or the pwrite. *crc_out holds the CRC
// of the landed prefix on any non-negative return.
int64_t sn_recv_file(int fd, int out_fd, uint64_t offset, uint64_t len, int timeout_ms,
                     uint32_t* crc_out) {
    crc32c_table_init();
    const size_t CHUNK = 256u * 1024u;
    std::vector<uint8_t> buf((size_t)(len < CHUNK ? len : CHUNK));
    uint32_t crc = 0;
    uint64_t got = 0;
    while (got < len) {
        size_t want = (size_t)(len - got < (uint64_t)buf.size() ? len - got : (uint64_t)buf.size());
        ssize_t r = read(fd, buf.data(), want);
        if (r < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                int rc = sn_net::wait_fd(fd, POLLIN, timeout_ms);
                if (rc != 0) return (int64_t)rc;
                continue;
            }
            return -(int64_t)errno;
        }
        if (r == 0) break;  // peer closed
        crc = sn_crc32c(crc, buf.data(), (size_t)r);
        if (pwrite_full(out_fd, buf.data(), (size_t)r, offset + got) != 0) return -(int64_t)errno;
        got += (uint64_t)r;
    }
    if (crc_out) *crc_out = crc;
    return (int64_t)got;
}

// ---------------------------------------------------------------------------
// GF(2^8) Reed-Solomon matrix apply (polynomial 0x11D, klauspost's field):
// out[r] = XOR_j coeffs[r*in_rows+j] * data[j] over rows of n bytes.
// ---------------------------------------------------------------------------

static uint8_t gf_mul_table[256][256];
static uint8_t gf_nib_lo[256][16];  // low-nibble products per constant
static uint8_t gf_nib_hi[256][16];  // high-nibble products per constant
static std::once_flag gf_once;

static uint8_t gf_mul_slow(uint8_t a, uint8_t b) {
    uint16_t r = 0;
    uint16_t aa = a;
    for (int i = 0; i < 8; i++) {
        if (b & (1 << i)) r ^= (uint16_t)(aa << i);
    }
    // reduce mod x^8+x^4+x^3+x^2+1 (0x11D)
    for (int i = 15; i >= 8; i--) {
        if (r & (1 << i)) r ^= (0x11D << (i - 8));
    }
    return (uint8_t)r;
}

static void gf_build() {
    for (int a = 0; a < 256; a++)
        for (int b = 0; b < 256; b++)
            gf_mul_table[a][b] = gf_mul_slow((uint8_t)a, (uint8_t)b);
    for (int c = 0; c < 256; c++) {
        for (int n = 0; n < 16; n++) {
            gf_nib_lo[c][n] = gf_mul_table[c][n];
            gf_nib_hi[c][n] = gf_mul_table[c][n << 4];
        }
    }
}

static void gf_init() { std::call_once(gf_once, gf_build); }

typedef void (*gf_mul_xor_fn)(uint8_t c, const uint8_t* in, uint8_t* out, size_t n);

// Portable scalar multiply-accumulate: out ^= c * in
static void gf_mul_xor_scalar(uint8_t c, const uint8_t* in, uint8_t* out, size_t n) {
    const uint8_t* t = gf_mul_table[c];
    for (size_t i = 0; i < n; i++) out[i] ^= t[in[i]];
}

#if defined(__x86_64__)
__attribute__((target("avx2")))
static void gf_mul_xor_avx2(uint8_t c, const uint8_t* in, uint8_t* out, size_t n) {
    __m256i lo = _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)gf_nib_lo[c]));
    __m256i hi = _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)gf_nib_hi[c]));
    __m256i mask = _mm256_set1_epi8(0x0F);
    size_t i = 0;
    for (; i + 32 <= n; i += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(in + i));
        __m256i vlo = _mm256_and_si256(v, mask);
        __m256i vhi = _mm256_and_si256(_mm256_srli_epi64(v, 4), mask);
        __m256i p = _mm256_xor_si256(_mm256_shuffle_epi8(lo, vlo), _mm256_shuffle_epi8(hi, vhi));
        __m256i o = _mm256_loadu_si256((const __m256i*)(out + i));
        _mm256_storeu_si256((__m256i*)(out + i), _mm256_xor_si256(o, p));
    }
    if (i < n) gf_mul_xor_scalar(c, in + i, out + i, n - i);
}

__attribute__((target("ssse3")))
static void gf_mul_xor_ssse3(uint8_t c, const uint8_t* in, uint8_t* out, size_t n) {
    __m128i lo = _mm_loadu_si128((const __m128i*)gf_nib_lo[c]);
    __m128i hi = _mm_loadu_si128((const __m128i*)gf_nib_hi[c]);
    __m128i mask = _mm_set1_epi8(0x0F);
    size_t i = 0;
    for (; i + 16 <= n; i += 16) {
        __m128i v = _mm_loadu_si128((const __m128i*)(in + i));
        __m128i vlo = _mm_and_si128(v, mask);
        __m128i vhi = _mm_and_si128(_mm_srli_epi64(v, 4), mask);
        __m128i p = _mm_xor_si128(_mm_shuffle_epi8(lo, vlo), _mm_shuffle_epi8(hi, vhi));
        __m128i o = _mm_loadu_si128((const __m128i*)(out + i));
        _mm_storeu_si128((__m128i*)(out + i), _mm_xor_si128(o, p));
    }
    if (i < n) gf_mul_xor_scalar(c, in + i, out + i, n - i);
}
#endif

static void gf_mul_xor(uint8_t c, const uint8_t* in, uint8_t* out, size_t n) {
#if defined(__x86_64__)
    if (__builtin_cpu_supports("avx2")) { gf_mul_xor_avx2(c, in, out, n); return; }
    if (__builtin_cpu_supports("ssse3")) { gf_mul_xor_ssse3(c, in, out, n); return; }
#endif
    gf_mul_xor_scalar(c, in, out, n);
}

static void xor_into(const uint8_t* in, uint8_t* out, size_t n) {
    size_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t a, b;
        memcpy(&a, out + i, 8);
        memcpy(&b, in + i, 8);
        a ^= b;
        memcpy(out + i, &a, 8);
    }
    for (; i < n; i++) out[i] ^= in[i];
}

// Columns [lo, lo + w) of the apply over rows of n bytes: coefficient 0
// is skipped, 1 is a plain XOR, any other goes through `mul`.
static void rs_apply_window(gf_mul_xor_fn mul, const uint8_t* coeffs, int out_rows, int in_rows,
                            const uint8_t* data, uint8_t* out, size_t n, size_t lo, size_t w) {
    for (int r = 0; r < out_rows; r++) {
        uint8_t* dst = out + (size_t)r * n + lo;
        memset(dst, 0, w);
        for (int j = 0; j < in_rows; j++) {
            uint8_t c = coeffs[r * in_rows + j];
            if (c == 0) continue;
            const uint8_t* src = data + (size_t)j * n + lo;
            if (c == 1) {
                xor_into(src, dst, w);
            } else {
                mul(c, src, dst, w);
            }
        }
    }
}

// data: in_rows contiguous rows of n bytes; out: out_rows rows of n bytes.
void sn_rs_apply(const uint8_t* coeffs, int out_rows, int in_rows,
                 const uint8_t* data, uint8_t* out, size_t n) {
    gf_init();
    rs_apply_window(gf_mul_xor, coeffs, out_rows, in_rows, data, out, n, 0, n);
}

uint8_t sn_gf_mul(uint8_t a, uint8_t b) {
    gf_init();
    return gf_mul_table[a][b];
}

// Column-parallel sn_rs_apply: the n columns split into `nthreads`
// 64-byte-aligned windows that run on the worker pool (parity is
// columnwise-independent, so any column split is bit-exact). One thread
// below 64 KiB of width. Callers via ctypes release the GIL for the
// whole call.
void sn_rs_apply_mt(const uint8_t* coeffs, int out_rows, int in_rows,
                    const uint8_t* data, uint8_t* out, size_t n,
                    int nthreads) {
    gf_init();
    if (nthreads <= 1 || n < (1u << 16)) {
        sn_rs_apply(coeffs, out_rows, in_rows, data, out, n);
        return;
    }
    size_t chunk = (n + (size_t)nthreads - 1) / (size_t)nthreads;
    chunk = (chunk + 63) & ~(size_t)63;  // cache-line align column splits
    int windows = (int)((n + chunk - 1) / chunk);
    parallel_for(windows, [&](int i) {
        size_t lo = (size_t)i * chunk;
        size_t w = lo + chunk <= n ? chunk : n - lo;
        rs_apply_window(gf_mul_xor, coeffs, out_rows, in_rows, data, out, n, lo, w);
    });
}

// Test-only: sn_rs_apply through one named body, 0 scalar, 1 SSSE3,
// 2 AVX2. Returns -1, writing nothing, when the CPU lacks that body.
int sn_rs_apply_body(int body, const uint8_t* coeffs, int out_rows, int in_rows,
                     const uint8_t* data, uint8_t* out, size_t n) {
    gf_mul_xor_fn mul = nullptr;
    if (body == 0) mul = gf_mul_xor_scalar;
#if defined(__x86_64__)
    if (body == 1 && __builtin_cpu_supports("ssse3")) mul = gf_mul_xor_ssse3;
    if (body == 2 && __builtin_cpu_supports("avx2")) mul = gf_mul_xor_avx2;
#endif
    if (mul == nullptr) return -1;
    gf_init();
    rs_apply_window(mul, coeffs, out_rows, in_rows, data, out, n, 0, n);
    return 0;
}

// ---------------------------------------------------------------------------
// sn_scan_dat: one pass over a volume's .dat (mmap), every record in append
// order: needle id, stored offset (8-byte units), body size and whether
// the data's CRC32C equals the stored one. The scan stops at a truncated
// tail. Returns the record count, -1 where the file does not open or is
// not a v2 / v3 volume, -2 where max_entries is too small.

static inline uint32_t be32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) |
           (uint32_t)p[3];
}

static inline uint64_t be64(const uint8_t* p) { return ((uint64_t)be32(p) << 32) | be32(p + 4); }

int64_t sn_scan_dat(const char* path, uint64_t* ids, uint32_t* offsets, int32_t* sizes,
                    uint8_t* crc_ok, int64_t max_entries) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 8) {
        close(fd);
        return -1;
    }
    size_t size = (size_t)st.st_size;
    const uint8_t* buf = (const uint8_t*)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (buf == MAP_FAILED) return -1;
    uint8_t version = buf[0];
    if (version != 2 && version != 3) {
        munmap((void*)buf, size);
        return -1;
    }
    size_t footer = 4 + (version == 3 ? 8 : 0);  // CRC, then v3's appendAtNs
    int64_t count = 0;
    size_t off = 8;  // the superblock
    while (off + 16 <= size) {
        uint64_t nid = be64(buf + off + 4);
        uint32_t body = be32(buf + off + 12);
        size_t rec = (16 + (size_t)body + footer + 7) & ~(size_t)7;
        if (off + rec > size) break;  // a truncated tail
        if (count >= max_entries) {
            munmap((void*)buf, size);
            return -2;
        }
        uint8_t ok = 1;
        if (body > 0) {
            // body = dataSize(4) | data | flags(1) | ...; the CRC covers data
            ok = 0;
            if (body >= 5) {
                uint32_t data_size = be32(buf + off + 16);
                if ((size_t)data_size + 5 <= body)
                    ok = sn_crc32c(0, buf + off + 20, data_size) == be32(buf + off + 16 + body);
            }
        }
        ids[count] = nid;
        offsets[count] = (uint32_t)(off / 8);
        sizes[count] = (int32_t)body;
        crc_ok[count] = ok;
        count++;
        off += rec;
    }
    munmap((void*)buf, size);
    return count;
}

int sn_has_avx2() {
#if defined(__x86_64__)
    return __builtin_cpu_supports("avx2") ? 1 : 0;
#else
    return 0;
#endif
}

// Threads that run the pool's jobs (its workers and the calling thread).
int sn_pool_threads() { return Pool::get().threads(); }

}  // extern "C"
