// Per-tensor stall tracking: submitted on some ranks but not all.
//
// Reference: horovod/common/stall_inspector.cc — rank 0 records when
// each tensor was first requested; tensors whose request set has been
// incomplete for longer than HOROVOD_STALL_CHECK_TIME are reported with
// the list of missing ranks; past a shutdown threshold the job aborts
// (Horovod's stall inspector).
//
// This native table implements the reference's *exact* semantic for the
// eager multi-process path (the coordinator feeds it per-cycle); the
// Python watchdog in utils/stall.py remains the per-process heartbeat.

#ifndef HVD_TPU_NATIVE_STALL_INSPECTOR_H_
#define HVD_TPU_NATIVE_STALL_INSPECTOR_H_

#include <cstdint>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace hvdtpu {

class StallInspector {
 public:
  StallInspector(int32_t world_size, double warn_after_s,
                 double shutdown_after_s = 0.0)
      : world_size_(world_size),
        warn_after_s_(warn_after_s),
        shutdown_after_s_(shutdown_after_s) {}

  // Rank `rank` declared `name` ready at host-time `now_s`.
  void RecordSubmit(const std::string& name, int32_t rank, double now_s) {
    std::lock_guard<std::mutex> lk(mu_);
    auto& e = table_[name];
    if (e.ranks.empty()) e.first_submit_s = now_s;
    e.ranks.insert(rank);
  }

  // The collective for `name` completed everywhere; forget it.
  void RecordComplete(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    table_.erase(name);
  }

  struct Stalled {
    std::string name;
    double age_s;
    std::vector<int32_t> missing_ranks;
  };

  // Tensors incomplete for > warn_after_s at `now_s`.
  std::vector<Stalled> Report(double now_s) const {
    std::lock_guard<std::mutex> lk(mu_);
    std::vector<Stalled> out;
    for (const auto& kv : table_) {
      const Entry& e = kv.second;
      if (static_cast<int32_t>(e.ranks.size()) >= world_size_) continue;
      double age = now_s - e.first_submit_s;
      if (age <= warn_after_s_) continue;
      Stalled s;
      s.name = kv.first;
      s.age_s = age;
      for (int32_t r = 0; r < world_size_; ++r) {
        if (!e.ranks.count(r)) s.missing_ranks.push_back(r);
      }
      out.push_back(std::move(s));
    }
    return out;
  }

  // True when any tensor exceeded the shutdown threshold.
  bool ShouldShutdown(double now_s) const {
    if (shutdown_after_s_ <= 0) return false;
    std::lock_guard<std::mutex> lk(mu_);
    for (const auto& kv : table_) {
      const Entry& e = kv.second;
      if (static_cast<int32_t>(e.ranks.size()) < world_size_ &&
          now_s - e.first_submit_s > shutdown_after_s_) {
        return true;
      }
    }
    return false;
  }

 private:
  struct Entry {
    std::unordered_set<int32_t> ranks;
    double first_submit_s = 0;
  };
  int32_t world_size_;
  double warn_after_s_;
  double shutdown_after_s_;
  mutable std::mutex mu_;
  std::unordered_map<std::string, Entry> table_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_NATIVE_STALL_INSPECTOR_H_
