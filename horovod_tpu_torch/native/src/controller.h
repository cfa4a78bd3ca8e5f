// Rank-0 coordination protocol: which tensors are globally ready, and
// how to fuse them.
//
// Reference: horovod/common/controller.cc::ComputeResponseList — workers
// send Requests as tensors become ready; the coordinator tracks, per
// tensor, the set of ranks that have requested it; once all ranks of
// the tensor's process set have, the tensor is "ready"; ready tensors
// are fused into buckets (same op/dtype, bytes under the fusion
// threshold, submission order preserved) and broadcast back as a
// ResponseList.
//
// In horovod_tpu_torch it runs inside rank 0's cross-process monitor
// (utils/cross_stall.py): every rank reports the names it dispatched,
// and the controller says which are ready on every rank and which ranks
// a stalled one is missing.  torch.distributed moves the bytes.

#ifndef HVD_TPU_NATIVE_CONTROLLER_H_
#define HVD_TPU_NATIVE_CONTROLLER_H_

#include <cstdint>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "common.h"
#include "group_table.h"
#include "response_cache.h"

namespace hvdtpu {

class Controller {
 public:
  Controller(int32_t world_size, int64_t fusion_threshold_bytes,
             size_t cache_capacity = 1024)
      : world_size_(world_size),
        fusion_threshold_(fusion_threshold_bytes),
        cache_(cache_capacity) {}

  // Thread-safe. Records that `req.rank` declared `req.name` ready.
  // Returns false on inconsistent metadata across ranks (shape/dtype/op
  // mismatch — the reference raises on this; see test_collectives
  // error-path parity).
  bool Submit(const Request& req);

  // Computes the ordered ResponseList of fully-ready tensors, honoring
  // group atomicity, fusing within the threshold, preserving the order
  // in which tensors *became fully ready* (the reference uses rank-0
  // submission order; ready-order is the multi-process-deterministic
  // equivalent since it is identical on every rank by construction).
  // Ready tensors are consumed; unready ones stay pending.
  std::vector<Response> ComputeResponseList();

  GroupTable& group_table() { return group_table_; }
  const ResponseCache& cache() const { return cache_; }

  // Tensors currently submitted by some-but-not-all ranks, with the set
  // of missing ranks — the stall inspector's raw material.
  std::vector<std::pair<std::string, std::vector<int32_t>>> PendingPartial()
      const;

  int32_t world_size() const { return world_size_; }
  std::string last_error() const {
    std::lock_guard<std::mutex> lk(mu_);
    return last_error_;
  }

 private:
  struct PendingTensor {
    Request meta;                      // from the first submitting rank
    std::unordered_set<int32_t> ranks; // which ranks have submitted
    int64_t ready_seq = -1;            // order of becoming fully ready
  };

  int32_t world_size_;
  int64_t fusion_threshold_;
  ResponseCache cache_;
  GroupTable group_table_;

  mutable std::mutex mu_;
  std::unordered_map<std::string, PendingTensor> pending_;
  std::vector<std::string> arrival_order_;  // first-submission order
  int64_t ready_counter_ = 0;
  std::string last_error_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_NATIVE_CONTROLLER_H_
