#include "coordinator.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <cerrno>
#include <chrono>
#include <cstring>
#include <thread>

#include "wire.h"

namespace hvdtpu {
namespace {

constexpr uint8_t kKindRequests = 0;
constexpr uint8_t kKindResponses = 1;
constexpr uint8_t kKindShutdown = 2;

bool WriteAll(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool ReadAll(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (r == 0) return false;  // peer closed
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void SetTimeout(int fd, double seconds) {
  if (seconds <= 0) return;
  struct timeval tv;
  tv.tv_sec = static_cast<long>(seconds);
  tv.tv_usec = static_cast<long>((seconds - tv.tv_sec) * 1e6);
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

void SetNoDelay(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

}  // namespace

Coordinator::Coordinator(int32_t rank, int32_t world_size,
                         int64_t fusion_threshold)
    : rank_(rank), world_size_(world_size) {
  if (rank == 0) {
    controller_.reset(new Controller(world_size, fusion_threshold));
  }
}

Coordinator::~Coordinator() { Shutdown(); }

std::unique_ptr<Coordinator> Coordinator::Create(
    int32_t rank, int32_t world_size, const std::string& host, int32_t port,
    int64_t fusion_threshold, double timeout_s) {
  std::unique_ptr<Coordinator> c(
      new Coordinator(rank, world_size, fusion_threshold));
  c->timeout_s_ = timeout_s;

  struct sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    return nullptr;
  }

  if (rank == 0) {
    c->listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (c->listen_fd_ < 0) return nullptr;
    int one = 1;
    ::setsockopt(c->listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    if (::bind(c->listen_fd_, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0 ||
        ::listen(c->listen_fd_, world_size) != 0) {
      return nullptr;
    }
    socklen_t alen = sizeof(addr);
    ::getsockname(c->listen_fd_, reinterpret_cast<sockaddr*>(&addr), &alen);
    c->bound_port_ = ntohs(addr.sin_port);
    SetTimeout(c->listen_fd_, timeout_s);
    c->worker_fds_.assign(world_size, -1);
    // Workers need BoundPort() before they can connect, so the accepts
    // happen on a handshake thread; Negotiate() waits for it.
    Coordinator* raw = c.get();
    c->accept_thread_ = std::thread([raw] { raw->AcceptLoop(); });
  } else {
    // Retry connect while the coordinator comes up (reference: Gloo
    // rendezvous retries against the HTTP store).
    auto deadline =
        std::chrono::steady_clock::now() + std::chrono::duration<double>(
                                               timeout_s <= 0 ? 60.0
                                                              : timeout_s);
    for (;;) {
      c->coord_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
      if (c->coord_fd_ < 0) return nullptr;
      if (::connect(c->coord_fd_, reinterpret_cast<sockaddr*>(&addr),
                    sizeof(addr)) == 0) {
        break;
      }
      ::close(c->coord_fd_);
      c->coord_fd_ = -1;
      if (std::chrono::steady_clock::now() > deadline) return nullptr;
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
    }
    SetTimeout(c->coord_fd_, timeout_s);
    SetNoDelay(c->coord_fd_);
    c->bound_port_ = port;
    if (!WriteAll(c->coord_fd_, &rank, sizeof(rank))) return nullptr;
  }
  return c;
}

void Coordinator::AcceptLoop() {
  // Accept world_size-1 workers; each sends its rank as a hello.
  bool ok = true;
  for (int32_t i = 1; i < world_size_ && ok; ++i) {
    int fd = ::accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) {
      ok = false;
      break;
    }
    SetTimeout(fd, timeout_s_);
    SetNoDelay(fd);
    int32_t peer_rank = -1;
    if (!ReadAll(fd, &peer_rank, sizeof(peer_rank)) || peer_rank < 1 ||
        peer_rank >= world_size_ || worker_fds_[peer_rank] != -1) {
      ::close(fd);
      ok = false;
      break;
    }
    worker_fds_[peer_rank] = fd;
  }
  {
    std::lock_guard<std::mutex> lk(handshake_mu_);
    handshake_done_ = true;
    handshake_ok_ = ok;
  }
  handshake_cv_.notify_all();
}

bool Coordinator::WaitHandshake() {
  if (rank_ != 0) return true;
  std::unique_lock<std::mutex> lk(handshake_mu_);
  if (!handshake_cv_.wait_for(
          lk, std::chrono::duration<double>(timeout_s_ <= 0 ? 3600.0
                                                            : timeout_s_),
          [this] { return handshake_done_; })) {
    last_error_ = "handshake timeout: not all workers connected";
    return false;
  }
  if (!handshake_ok_) {
    last_error_ = "handshake failed: worker accept/hello error";
  }
  return handshake_ok_;
}

bool Coordinator::SendFrame(int fd, uint8_t kind,
                            const std::vector<uint8_t>& payload) {
  uint32_t len = static_cast<uint32_t>(payload.size());
  return WriteAll(fd, &len, sizeof(len)) && WriteAll(fd, &kind, 1) &&
         (payload.empty() || WriteAll(fd, payload.data(), payload.size()));
}

bool Coordinator::RecvFrame(int fd, uint8_t* kind,
                            std::vector<uint8_t>* payload) {
  uint32_t len = 0;
  if (!ReadAll(fd, &len, sizeof(len)) || !ReadAll(fd, kind, 1)) return false;
  if (len > (1u << 30)) return false;  // sanity bound
  payload->resize(len);
  return len == 0 || ReadAll(fd, payload->data(), len);
}

bool Coordinator::Negotiate(const std::vector<Request>& mine,
                            std::vector<Response>* out) {
  out->clear();
  if (shut_down_) {
    last_error_ = "coordinator already shut down";
    return false;
  }
  ++cycles_;
  if (rank_ == 0) {
    if (!WaitHandshake()) return false;
    for (const Request& r : mine) {
      if (r.rank != 0) {
        last_error_ = "request '" + r.name + "' on the coordinator claims "
                      "rank " + std::to_string(r.rank) + " (expected 0)";
        return false;
      }
      if (!controller_->Submit(r)) {
        last_error_ = controller_->last_error();
        return false;
      }
    }
    for (int32_t peer = 1; peer < world_size_; ++peer) {
      uint8_t kind = 0;
      std::vector<uint8_t> payload;
      if (!RecvFrame(worker_fds_[peer], &kind, &payload) ||
          kind != kKindRequests) {
        last_error_ = "recv from worker " + std::to_string(peer) + " failed";
        return false;
      }
      std::vector<Request> reqs;
      if (!wire::DecodeRequests(payload.data(), payload.size(), &reqs)) {
        last_error_ = "malformed requests from worker " +
                      std::to_string(peer);
        return false;
      }
      for (const Request& r : reqs) {
        // The connection's hello rank is authoritative; a mismatched
        // embedded rank means a confused worker — fail loudly rather
        // than corrupt the readiness table.
        if (r.rank != peer) {
          last_error_ = "request '" + r.name + "' from worker " +
                        std::to_string(peer) + " claims rank " +
                        std::to_string(r.rank);
          return false;
        }
        if (!controller_->Submit(r)) {
          last_error_ = controller_->last_error();
          return false;
        }
      }
    }
    *out = controller_->ComputeResponseList();
    std::vector<uint8_t> enc = wire::EncodeResponses(*out);
    for (int32_t peer = 1; peer < world_size_; ++peer) {
      if (!SendFrame(worker_fds_[peer], kKindResponses, enc)) {
        last_error_ = "send to worker " + std::to_string(peer) + " failed";
        return false;
      }
    }
    return true;
  }
  // Worker path.
  std::vector<uint8_t> enc = wire::EncodeRequests(mine);
  if (!SendFrame(coord_fd_, kKindRequests, enc)) {
    last_error_ = "send to coordinator failed";
    return false;
  }
  uint8_t kind = 0;
  std::vector<uint8_t> payload;
  if (!RecvFrame(coord_fd_, &kind, &payload)) {
    last_error_ = "recv from coordinator failed";
    return false;
  }
  if (kind == kKindShutdown) {
    last_error_ = "coordinator shut down";
    return false;
  }
  if (kind != kKindResponses ||
      !wire::DecodeResponses(payload.data(), payload.size(), out)) {
    last_error_ = "malformed responses from coordinator";
    return false;
  }
  return true;
}

bool Coordinator::Barrier() {
  // One dedicated round: every rank submits the same barrier tensor;
  // the controller emits it only when all ranks have.  Negotiate()'s
  // blocking collective structure makes one round sufficient.
  Request r;
  r.rank = rank_;
  r.op = OpType::kBarrier;
  r.name = "_hvdtpu_barrier";
  r.size_bytes = 0;
  std::vector<Response> resp;
  if (!Negotiate({r}, &resp)) return false;
  for (const Response& x : resp) {
    if (x.op == OpType::kBarrier) return true;
  }
  last_error_ = "barrier round did not complete";
  return false;
}

void Coordinator::Shutdown() {
  if (shut_down_) return;
  shut_down_ = true;
  if (rank_ == 0) {
    // Unblock a still-accepting handshake thread, then join it.
    if (listen_fd_ >= 0) ::shutdown(listen_fd_, SHUT_RDWR);
    if (accept_thread_.joinable()) accept_thread_.join();
    for (int fd : worker_fds_) {
      if (fd >= 0) {
        SendFrame(fd, kKindShutdown, {});
        ::close(fd);
      }
    }
    worker_fds_.clear();
    if (listen_fd_ >= 0) ::close(listen_fd_);
    listen_fd_ = -1;
  } else if (coord_fd_ >= 0) {
    ::close(coord_fd_);
    coord_fd_ = -1;
  }
}

}  // namespace hvdtpu
