// Collective-transport core: ring collectives over TCP for N local processes.
//
// The port's copy of kubeflow_tpu/transport/transport_core.cc, byte for byte
// below this header.  Role: the DDP shim of the PyTorchJob path
// (examples/resnet_ddp_worker.py, DDP_TRANSPORT=shim): every process keeps a
// full replica and the per-step gradient sync runs through this ring over
// host TCP instead of NCCL, so several processes can share one card.  Rank r
// listens on base_port+r, connects to (r+1)%world, and runs ring
// reduce-scatter / allgather / allreduce with a poll()-based full-duplex
// exchange (no deadlock at any message size, single thread).
//
// C ABI (ctypes-bound by transport.py):
//   tr_create(rank, world, host, base_port) -> handle (NULL on error)
//   tr_allreduce_f32 / tr_reduce_scatter_f32 / tr_allgather / tr_broadcast
//   tr_barrier, tr_destroy — all return 0 on success, negative errno-ish codes.
//
// Build: on first use, by kubeflow_tpu_torch/utils/native_build.py
// (build_native, g++ -pthread) into kubeflow_tpu_torch/_build/.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <string>
#include <thread>
#include <vector>

namespace {

// Generous: gang members on an oversubscribed host can be compute-starved for
// minutes (e.g. N ranks serializing XLA compiles on few cores) while a peer
// waits in a collective.
constexpr int kConnectTimeoutSec = 300;

struct Transport {
  int rank = 0;
  int world = 1;
  int send_fd = -1;  // to (rank+1) % world
  int recv_fd = -1;  // from (rank-1+world) % world
};

int set_nodelay(int fd) {
  int one = 1;
  return setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// CRITICAL: the exchange() loop assumes partial writes.  On a blocking fd,
// send() of a large chunk parks the thread in sk_stream_wait_memory until the
// WHOLE chunk is buffered — with every rank sending at once that deadlocks
// the ring.  Non-blocking fds make send/recv return what fits, which is what
// the poll loop is built around.
int set_nonblocking(int fd) {
  int flags = fcntl(fd, F_GETFL, 0);
  return flags < 0 ? -1 : fcntl(fd, F_SETFL, flags | O_NONBLOCK);
}

// Blocking-socket full-duplex exchange driven by poll(): pushes send_buf out
// and drains recv_buf in whatever order the kernel allows.  This is the piece
// that makes a blocking ring safe at any chunk size (everyone can be "in send"
// simultaneously without deadlock because reads still drain).
int exchange(Transport* t, const char* send_buf, size_t send_n, char* recv_buf,
             size_t recv_n) {
  size_t sent = 0, rcvd = 0;
  while (sent < send_n || rcvd < recv_n) {
    struct pollfd fds[2];
    int nfds = 0;
    int send_idx = -1, recv_idx = -1;
    if (sent < send_n) {
      fds[nfds] = {t->send_fd, POLLOUT, 0};
      send_idx = nfds++;
    }
    if (rcvd < recv_n) {
      fds[nfds] = {t->recv_fd, POLLIN, 0};
      recv_idx = nfds++;
    }
    int rc = poll(fds, nfds, kConnectTimeoutSec * 1000);
    if (rc == 0) return -2;  // peer stalled
    if (rc < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (send_idx >= 0 && (fds[send_idx].revents & (POLLOUT | POLLERR | POLLHUP))) {
      ssize_t n = send(t->send_fd, send_buf + sent, send_n - sent, MSG_NOSIGNAL);
      if (n < 0 && errno != EAGAIN && errno != EINTR) return -1;
      if (n > 0) sent += static_cast<size_t>(n);
    }
    if (recv_idx >= 0 && (fds[recv_idx].revents & (POLLIN | POLLERR | POLLHUP))) {
      ssize_t n = recv(t->recv_fd, recv_buf + rcvd, recv_n - rcvd, 0);
      if (n == 0) return -3;  // peer closed
      if (n < 0 && errno != EAGAIN && errno != EINTR) return -1;
      if (n > 0) rcvd += static_cast<size_t>(n);
    }
  }
  return 0;
}

// Chunk c of a length-n vector split into `world` near-equal pieces.
void chunk_bounds(int64_t n, int world, int c, int64_t* lo, int64_t* len) {
  int64_t base = n / world, rem = n % world;
  *lo = c * base + (c < rem ? c : rem);
  *len = base + (c < rem ? 1 : 0);
}

}  // namespace

extern "C" {

void* tr_create(int rank, int world, const char* host, int base_port) {
  if (rank < 0 || world <= 0 || rank >= world || base_port <= 0) return nullptr;
  auto* t = new Transport{rank, world, -1, -1};
  if (world == 1) return t;

  // Listen for the left neighbor on base_port + rank.
  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) { delete t; return nullptr; }
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(static_cast<uint16_t>(base_port + rank));
  if (bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      listen(lfd, 1) < 0) {
    close(lfd); delete t; return nullptr;
  }

  // Connect to the right neighbor (retry while it boots).
  int right = (rank + 1) % world;
  sockaddr_in raddr{};
  raddr.sin_family = AF_INET;
  raddr.sin_port = htons(static_cast<uint16_t>(base_port + right));
  if (inet_pton(AF_INET, host && *host ? host : "127.0.0.1", &raddr.sin_addr) != 1) {
    close(lfd); delete t; return nullptr;
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::seconds(kConnectTimeoutSec);
  int sfd = -1;
  while (true) {
    sfd = socket(AF_INET, SOCK_STREAM, 0);
    if (sfd >= 0 &&
        connect(sfd, reinterpret_cast<sockaddr*>(&raddr), sizeof(raddr)) == 0)
      break;
    if (sfd >= 0) close(sfd);
    sfd = -1;
    if (std::chrono::steady_clock::now() > deadline) {
      close(lfd); delete t; return nullptr;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
  }

  // Accept the left neighbor.
  struct pollfd pfd = {lfd, POLLIN, 0};
  int rc = poll(&pfd, 1, kConnectTimeoutSec * 1000);
  if (rc <= 0) { close(sfd); close(lfd); delete t; return nullptr; }
  int afd = accept(lfd, nullptr, nullptr);
  close(lfd);
  if (afd < 0) { close(sfd); delete t; return nullptr; }
  set_nodelay(sfd);
  set_nodelay(afd);
  if (set_nonblocking(sfd) < 0 || set_nonblocking(afd) < 0) {
    close(sfd); close(afd); delete t; return nullptr;
  }
  t->send_fd = sfd;
  t->recv_fd = afd;
  return t;
}

void tr_destroy(void* h) {
  auto* t = static_cast<Transport*>(h);
  if (!t) return;
  if (t->send_fd >= 0) close(t->send_fd);
  if (t->recv_fd >= 0) close(t->recv_fd);
  delete t;
}

int tr_reduce_scatter_f32(void* h, const float* in, int64_t n, float* out) {
  auto* t = static_cast<Transport*>(h);
  if (!t || n < 0) return -4;
  int w = t->world, r = t->rank;
  if (w == 1) { std::memcpy(out, in, sizeof(float) * n); return 0; }
  std::vector<float> acc(in, in + n);
  int64_t base = n / w + 1;
  std::vector<float> inbox(base);
  // w-1 steps: send chunk (r - s), receive + accumulate chunk (r - s - 1).
  for (int s = 0; s < w - 1; ++s) {
    int send_c = ((r - s) % w + w) % w;
    int recv_c = ((r - s - 1) % w + w) % w;
    int64_t slo, slen, rlo, rlen;
    chunk_bounds(n, w, send_c, &slo, &slen);
    chunk_bounds(n, w, recv_c, &rlo, &rlen);
    int rc = exchange(t, reinterpret_cast<const char*>(acc.data() + slo),
                      sizeof(float) * slen,
                      reinterpret_cast<char*>(inbox.data()), sizeof(float) * rlen);
    if (rc != 0) return rc;
    for (int64_t i = 0; i < rlen; ++i) acc[rlo + i] += inbox[i];
  }
  int64_t mlo, mlen;
  chunk_bounds(n, w, (r + 1) % w, &mlo, &mlen);
  std::memcpy(out, acc.data() + mlo, sizeof(float) * mlen);
  return 0;
}

int tr_allgather(void* h, const char* in, int64_t bytes, char* out) {
  auto* t = static_cast<Transport*>(h);
  if (!t || bytes < 0) return -4;
  int w = t->world, r = t->rank;
  std::memcpy(out + r * bytes, in, bytes);
  // w-1 steps: pass blocks around the ring.
  for (int s = 0; s < w - 1; ++s) {
    int send_b = ((r - s) % w + w) % w;
    int recv_b = ((r - s - 1) % w + w) % w;
    int rc = exchange(t, out + send_b * bytes, bytes, out + recv_b * bytes, bytes);
    if (rc != 0) return rc;
  }
  return 0;
}

int tr_allreduce_f32(void* h, float* data, int64_t n) {
  auto* t = static_cast<Transport*>(h);
  if (!t || n < 0) return -4;
  int w = t->world, r = t->rank;
  if (w == 1 || n == 0) return 0;
  // Phase 1: reduce-scatter (this rank ends owning chunk (r+1)%w, reduced).
  std::vector<float> mine(n / w + 1);
  int rc = tr_reduce_scatter_f32(h, data, n, mine.data());
  if (rc != 0) return rc;
  int own = (r + 1) % w;
  int64_t olo, olen;
  chunk_bounds(n, w, own, &olo, &olen);
  std::memcpy(data + olo, mine.data(), sizeof(float) * olen);
  // Phase 2: allgather of the reduced chunks (variable-size ring pass).
  for (int s = 0; s < w - 1; ++s) {
    int send_c = ((own - s) % w + w) % w;
    int recv_c = ((own - s - 1) % w + w) % w;
    int64_t slo, slen, rlo, rlen;
    chunk_bounds(n, w, send_c, &slo, &slen);
    chunk_bounds(n, w, recv_c, &rlo, &rlen);
    rc = exchange(t, reinterpret_cast<const char*>(data + slo), sizeof(float) * slen,
                  reinterpret_cast<char*>(data + rlo), sizeof(float) * rlen);
    if (rc != 0) return rc;
  }
  return 0;
}

int tr_broadcast(void* h, char* data, int64_t bytes, int root) {
  auto* t = static_cast<Transport*>(h);
  if (!t || bytes < 0 || root < 0 || root >= t->world) return -4;
  int w = t->world, r = t->rank;
  if (w == 1) return 0;
  // Pass along the ring root → root+1 → …; the rank just before root only
  // receives.  Distance from root determines order.
  int dist = ((r - root) % w + w) % w;
  if (dist != 0) {  // receive from left first
    int rc = exchange(t, nullptr, 0, data, bytes);
    if (rc != 0) return rc;
  }
  if (dist != w - 1) {  // forward to right
    int rc = exchange(t, data, bytes, nullptr, 0);
    if (rc != 0) return rc;
  }
  return 0;
}

int tr_barrier(void* h) {
  auto* t = static_cast<Transport*>(h);
  if (!t) return -4;
  if (t->world == 1) return 0;
  char token = 1;
  std::vector<char> all(static_cast<size_t>(t->world));
  return tr_allgather(h, &token, 1, all.data());
}

int tr_rank(void* h) { return h ? static_cast<Transport*>(h)->rank : -1; }
int tr_world(void* h) { return h ? static_cast<Transport*>(h)->world : -1; }

}  // extern "C"
