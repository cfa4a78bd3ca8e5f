// Grouped-collective atomicity table.
//
// Reference: horovod/common/group_table.cc — tensors registered as one
// group must be fused and completed atomically: the coordinator may not
// emit any member until every member is ready on every rank
// (Horovod's group table).

#ifndef HVD_TPU_NATIVE_GROUP_TABLE_H_
#define HVD_TPU_NATIVE_GROUP_TABLE_H_

#include <cstdint>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace hvdtpu {

class GroupTable {
 public:
  // Registers a group; returns its id.
  int32_t RegisterGroup(const std::vector<std::string>& names) {
    int32_t id = next_id_++;
    groups_[id] = std::unordered_set<std::string>(names.begin(), names.end());
    for (const auto& n : names) member_of_[n] = id;
    return id;
  }

  bool Knows(int32_t id) const { return groups_.count(id) > 0; }

  // -1 when the tensor is ungrouped.
  int32_t GroupOf(const std::string& name) const {
    auto it = member_of_.find(name);
    return it == member_of_.end() ? -1 : it->second;
  }

  // True iff every member of `id` appears in `ready_names`.
  bool GroupComplete(int32_t id,
                     const std::unordered_set<std::string>& ready) const {
    auto it = groups_.find(id);
    if (it == groups_.end()) return false;
    for (const auto& n : it->second) {
      if (ready.find(n) == ready.end()) return false;
    }
    return true;
  }

  size_t GroupSize(int32_t id) const {
    auto it = groups_.find(id);
    return it == groups_.end() ? 0 : it->second.size();
  }

  void DeregisterGroup(int32_t id) {
    auto it = groups_.find(id);
    if (it == groups_.end()) return;
    for (const auto& n : it->second) member_of_.erase(n);
    groups_.erase(it);
  }

 private:
  int32_t next_id_ = 0;
  std::unordered_map<int32_t, std::unordered_set<std::string>> groups_;
  std::unordered_map<std::string, int32_t> member_of_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_NATIVE_GROUP_TABLE_H_
