// The PyTorch port's host byte plane: CRC32C, batched positioned reads
// with an inline rolling CRC, a readahead hint, and the stateful shard
// sink that writes N shard streams and rolls their sidecar CRCs in the
// same cache-hot pass. Host code, built with g++ (-pthread) at first use
// and loaded with ctypes (seaweedfs_tpu_torch/ops/_build.py,
// seaweedfs_tpu_torch/utils/native.py).
//
// The port's own copy of the parts of the JAX package's C++ core that
// encode, rebuild, decode and degraded reads call; same functions, same
// output bit for bit. The network plane, the .dat scanner, the one-shot
// shard append and the GF(2^8) apply are not here: no path of the port
// calls them.
//
// One departure from that core: the reader's and the sink's per-row work
// runs on a persistent pool of worker threads, where the core starts and
// joins fresh threads on every call. Where starting a thread costs about
// as much as reading or CRC-ing a 1 MiB row (chip_host_io.py times both
// on the card's host), per-call threads made the native plane slower
// than the Python loops it replaces.

#include <algorithm>
#include <cerrno>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <pthread.h>
#include <unistd.h>

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

}  // extern "C"
