// sn_net.h: socket helpers of the port's network byte plane
// (seaweed_native.cpp: sn_send_file, sn_sendv, sn_recv_into). Payload
// bytes move kernel to kernel (sendfile) or with exactly one userspace
// hop (read and write loops). Callers reach these through ctypes, which
// releases the GIL for the whole call: Python-side socket handling holds
// the GIL per chunk, this does not.
//
// The port's copy of the JAX package's helpers of the same name: what the
// shard-read opcode and the fastread sidecar (fastread.cpp) call.
//
// Timeout convention: `timeout_ms` < 0 blocks forever; >= 0 bounds each
// individual poll() wait on a non-blocking fd (Python's settimeout puts
// sockets in O_NONBLOCK, so EAGAIN here is the NORMAL slow-peer case,
// not an error). All helpers return bytes moved (possibly short at
// EOF/peer-close) or a negative errno.

#pragma once

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <poll.h>
#include <unistd.h>

#if defined(__linux__)
#include <sys/sendfile.h>
#endif

namespace sn_net {

// Wait for fd readiness. 0 = ready, -ETIMEDOUT, or -errno.
inline int wait_fd(int fd, short events, int timeout_ms) {
    struct pollfd p;
    p.fd = fd;
    p.events = events;
    p.revents = 0;
    for (;;) {
        int r = poll(&p, 1, timeout_ms);
        if (r > 0) return 0;
        if (r == 0) return -ETIMEDOUT;
        if (errno == EINTR) continue;
        return -errno;
    }
}

// write(2) the whole buffer. 0 on success, negative errno on failure.
inline int write_full(int fd, const uint8_t* p, size_t len, int timeout_ms) {
    while (len) {
        ssize_t w = write(fd, p, len);
        if (w < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                int rc = wait_fd(fd, POLLOUT, timeout_ms);
                if (rc != 0) return rc;
                continue;
            }
            return -errno;
        }
        p += w;
        len -= (size_t)w;
    }
    return 0;
}

// read(2) exactly `len` bytes unless EOF first. Returns bytes read (short
// only at EOF) or negative errno.
inline int64_t read_full(int fd, uint8_t* p, size_t len, int timeout_ms) {
    size_t got = 0;
    while (got < len) {
        ssize_t r = read(fd, p + got, len - got);
        if (r < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                int rc = wait_fd(fd, POLLIN, timeout_ms);
                if (rc != 0) return rc;
                continue;
            }
            return -(int64_t)errno;
        }
        if (r == 0) break;
        got += (size_t)r;
    }
    return (int64_t)got;
}

// sendfile(2) `len` bytes of in_fd@offset to out_fd; transparently
// falls back to a pread+write loop when the kernel path is unsupported
// for this fd pair (FUSE/9p-backed files, non-socket out_fd on older
// kernels). Returns bytes sent (short only at in_fd EOF) or -errno.
inline int64_t send_file(int out_fd, int in_fd, uint64_t offset,
                         uint64_t len, int timeout_ms) {
    uint64_t sent = 0;
#if defined(__linux__)
    off_t off = (off_t)offset;
    bool kernel_path = true;
    while (kernel_path && sent < len) {
        ssize_t w = sendfile(out_fd, in_fd, &off, (size_t)(len - sent));
        if (w < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                int rc = wait_fd(out_fd, POLLOUT, timeout_ms);
                if (rc != 0) return (int64_t)rc;
                continue;
            }
            if (sent == 0 && (errno == EINVAL || errno == ENOSYS ||
                              errno == EOPNOTSUPP)) {
                kernel_path = false;  // fall back below
                break;
            }
            return -(int64_t)errno;
        }
        if (w == 0) return (int64_t)sent;  // EOF in the source file
        sent += (uint64_t)w;
    }
    if (sent == len) return (int64_t)sent;
#endif
    // Portable fallback: one userspace hop through a reusable buffer.
    static thread_local uint8_t* buf = nullptr;
    const size_t BUF = 1 << 20;
    if (buf == nullptr) buf = new uint8_t[BUF];
    while (sent < len) {
        size_t want = (size_t)(len - sent) < BUF ? (size_t)(len - sent) : BUF;
        ssize_t r = pread(in_fd, buf, want, (off_t)(offset + sent));
        if (r < 0) {
            if (errno == EINTR) continue;
            return -(int64_t)errno;
        }
        if (r == 0) return (int64_t)sent;  // EOF
        int rc = write_full(out_fd, buf, (size_t)r, timeout_ms);
        if (rc != 0) return (int64_t)rc;
        sent += (uint64_t)r;
    }
    return (int64_t)sent;
}

}  // namespace sn_net
