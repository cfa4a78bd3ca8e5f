// Thread-safe pending-request queue.
//
// Reference: horovod/common/tensor_queue.cc — the handoff between
// framework threads (which enqueue ready tensors) and the background
// coordinator thread (which drains them each cycle).
//
// Here the "framework thread" is the Python eager API (torch binding /
// async collectives) and the drain side is the coordinator cycle.

#ifndef HVD_TPU_NATIVE_TENSOR_QUEUE_H_
#define HVD_TPU_NATIVE_TENSOR_QUEUE_H_

#include <chrono>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <vector>

#include "common.h"

namespace hvdtpu {

class TensorQueue {
 public:
  void Push(Request req) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      q_.push_back(std::move(req));
    }
    cv_.notify_one();
  }

  // Drains everything currently queued (non-blocking).
  std::vector<Request> DrainAll() {
    std::lock_guard<std::mutex> lk(mu_);
    std::vector<Request> out(q_.begin(), q_.end());
    q_.clear();
    return out;
  }

  // Blocks up to timeout_ms for at least one entry, then drains.
  std::vector<Request> DrainWait(int64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                 [this] { return !q_.empty(); });
    std::vector<Request> out(q_.begin(), q_.end());
    q_.clear();
    return out;
  }

  size_t Size() const {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

 private:
  mutable std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Request> q_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_NATIVE_TENSOR_QUEUE_H_
