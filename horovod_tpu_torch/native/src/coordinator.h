// TCP coordination service: the rank-0 consensus loop.
//
// Reference: the MPI/Gloo controller transport underneath
// Controller::ComputeResponseList — workers send Request batches to the
// coordinator each cycle, the coordinator returns the fused
// ResponseList (horovod/common/controller.cc + gloo/http_store.cc).
//
// Transport: plain TCP between the hosts (the reference uses MPI
// point-to-points or an HTTP KV store; torch.distributed's store has no
// batched-exchange primitive either).  One fixed-size frame protocol:
//
//   frame := u32 payload_len | u8 kind | payload
//   kind  := 0 requests (worker->coord), 1 responses (coord->worker),
//            2 shutdown
//
// Every rank calls Negotiate() once per cycle (empty request lists are
// normal); the call is collective and returns the same ResponseList on
// every rank — the same contract the reference's per-cycle coordinator
// round provides.

#ifndef HVD_TPU_NATIVE_COORDINATOR_H_
#define HVD_TPU_NATIVE_COORDINATOR_H_

#include <condition_variable>
#include <cstdint>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "common.h"
#include "controller.h"

namespace hvdtpu {

class Coordinator {
 public:
  // rank 0 binds `port` (0 = ephemeral; BoundPort() reports the pick
  // immediately) and accepts the world_size-1 workers on a handshake
  // thread so Create() returns without waiting for them; others
  // connect to host:port (with retry).  Returns nullptr on socket
  // failure; a worker-side handshake timeout surfaces on the first
  // Negotiate().
  static std::unique_ptr<Coordinator> Create(int32_t rank,
                                             int32_t world_size,
                                             const std::string& host,
                                             int32_t port,
                                             int64_t fusion_threshold,
                                             double timeout_s);
  ~Coordinator();

  // Collective: exchanges this rank's pending requests for the global
  // ResponseList. Returns false on transport failure or controller
  // metadata mismatch (error text in last_error()).
  bool Negotiate(const std::vector<Request>& mine,
                 std::vector<Response>* out);

  // Collective barrier (one dedicated negotiate round).
  bool Barrier();

  void Shutdown();

  int32_t BoundPort() const { return bound_port_; }
  int64_t cycles() const { return cycles_; }
  const std::string& last_error() const { return last_error_; }
  // Rank 0 only: the underlying controller (cache stats, stall info).
  Controller* controller() { return controller_.get(); }

 private:
  Coordinator(int32_t rank, int32_t world_size, int64_t fusion_threshold);

  bool SendFrame(int fd, uint8_t kind, const std::vector<uint8_t>& payload);
  bool RecvFrame(int fd, uint8_t* kind, std::vector<uint8_t>* payload);
  void AcceptLoop();          // rank 0 handshake thread body
  bool WaitHandshake();       // blocks until all workers connected

  int32_t rank_;
  int32_t world_size_;
  int32_t bound_port_ = 0;
  int64_t cycles_ = 0;
  double timeout_s_ = 60.0;
  std::string last_error_;

  int listen_fd_ = -1;               // rank 0
  std::vector<int> worker_fds_;      // rank 0: fd per worker rank (1..n-1)
  int coord_fd_ = -1;                // workers: connection to rank 0
  std::unique_ptr<Controller> controller_;  // rank 0
  bool shut_down_ = false;

  // rank 0 handshake state
  std::thread accept_thread_;
  std::mutex handshake_mu_;
  std::condition_variable handshake_cv_;
  bool handshake_done_ = false;
  bool handshake_ok_ = false;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_NATIVE_COORDINATOR_H_
