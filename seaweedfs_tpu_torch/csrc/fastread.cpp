// Bulk-read fast path: the RDMA-sidecar equivalent (SURVEY §2.10).
//
// The port's copy of the JAX package's sidecar of the same name, whole;
// ops/_build.py builds it with g++ into seaweedfs_tpu_torch/build/ at
// first use and utils/fastread.py binds it.
//
// Reference: seaweedfs-rdma-sidecar — a native data plane that bypasses
// the HTTP server for bulk reads (claimed up to 44x). Here the same
// role is filled by a Unix-domain-socket server that ships needle
// payload bytes with sendfile(2): after the client learns
// (dat_path, offset, size) from the volume server's ?locate endpoint
// (the control plane), the data plane is kernel-to-kernel — no Python,
// no HTTP framing, no userspace copies.
//
// Protocol (little-endian):
//   request:  u16 path_len | path | u64 offset | u64 size
//   response: u8 status (0 ok, 1 error) | u64 n | n bytes
// Paths are confined to the root directory given at serve time; the
// socket lives inside the served directory so reachability implies
// the same trust as reading the files directly.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>

#include <fcntl.h>
#include <limits.h>
#include <stdlib.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

// Shared byte-plane helpers (sendfile loop with portable fallback,
// exact read/write): the same header the port's host library
// (seaweed_native.cpp) uses, so both libraries move bytes alike.
#include "sn_net.h"

namespace {

bool read_exact(int fd, void* buf, size_t n) {
  return sn_net::read_full(fd, static_cast<uint8_t*>(buf), n, -1) ==
         static_cast<int64_t>(n);
}

bool write_exact(int fd, const void* buf, size_t n) {
  return sn_net::write_full(fd, static_cast<const uint8_t*>(buf), n, -1) == 0;
}

void send_error(int fd, const std::string& msg) {
  uint8_t status = 1;
  uint64_t n = msg.size();
  write_exact(fd, &status, 1);
  write_exact(fd, &n, 8);
  write_exact(fd, msg.data(), msg.size());
}

// root-confinement: the realpath of the request must live under root
bool path_allowed(const std::string& root, const std::string& req,
                  std::string* resolved) {
  char buf[PATH_MAX];
  if (realpath(req.c_str(), buf) == nullptr) return false;
  *resolved = buf;
  if (resolved->size() < root.size()) return false;
  if (resolved->compare(0, root.size(), root) != 0) return false;
  return resolved->size() == root.size() || (*resolved)[root.size()] == '/';
}

void serve_conn(int fd, std::string root) {
  for (;;) {
    uint16_t path_len = 0;
    if (!read_exact(fd, &path_len, 2)) break;
    if (path_len == 0 || path_len > 4096) break;
    std::string path(path_len, '\0');
    uint64_t offset = 0, size = 0;
    if (!read_exact(fd, path.data(), path_len)) break;
    if (!read_exact(fd, &offset, 8)) break;
    if (!read_exact(fd, &size, 8)) break;
    if (size > (1ull << 32)) {
      send_error(fd, "size too large");
      break;
    }
    std::string resolved;
    if (!path_allowed(root, path, &resolved)) {
      send_error(fd, "path outside served root");
      continue;
    }
    int file = open(resolved.c_str(), O_RDONLY);
    if (file < 0) {
      send_error(fd, std::string("open: ") + strerror(errno));
      continue;
    }
    struct stat st {};
    // overflow-safe bounds: offset+size could wrap u64
    if (fstat(file, &st) != 0 ||
        offset > static_cast<uint64_t>(st.st_size) ||
        size > static_cast<uint64_t>(st.st_size) - offset) {
      send_error(fd, "range beyond EOF");
      close(file);
      continue;
    }
    uint8_t status = 0;
    uint64_t n = size;
    if (!write_exact(fd, &status, 1) || !write_exact(fd, &n, 8)) {
      close(file);
      break;
    }
    // kernel-to-kernel, with the shared pread+write fallback (e.g.
    // FUSE-backed files refusing sendfile) and its reusable buffer
    int64_t sent = sn_net::send_file(fd, file, offset, size, -1);
    close(file);
    if (sent != static_cast<int64_t>(size)) break;  // connection is dead
  }
  close(fd);
}

}  // namespace

extern "C" {

// Blocking accept loop; call from a dedicated (Python daemon) thread.
// Returns 0 on clean shutdown (socket unlinked externally + connect),
// negative errno on setup failure.
int sn_fastread_serve(const char* socket_path, const char* root_dir) {
  char root_real[PATH_MAX];
  if (realpath(root_dir, root_real) == nullptr) return -errno;
  std::string root(root_real);

  int srv = socket(AF_UNIX, SOCK_STREAM, 0);
  if (srv < 0) return -errno;
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  if (strlen(socket_path) >= sizeof(addr.sun_path)) {
    close(srv);
    return -ENAMETOOLONG;
  }
  strncpy(addr.sun_path, socket_path, sizeof(addr.sun_path) - 1);
  unlink(socket_path);
  if (bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    int e = errno;
    close(srv);
    return -e;
  }
  if (listen(srv, 64) != 0) {
    int e = errno;
    close(srv);
    return -e;
  }
  for (;;) {
    int conn = accept(srv, nullptr, nullptr);
    if (conn < 0) {
      if (errno == EINTR) continue;
      break;
    }
    // the socket file disappearing is the shutdown signal
    struct stat st {};
    if (lstat(socket_path, &st) != 0) {
      close(conn);
      break;
    }
    std::thread(serve_conn, conn, root).detach();
  }
  close(srv);
  return 0;
}

}  // extern "C"
