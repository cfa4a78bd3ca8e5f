#include "controller.h"

#include <algorithm>

namespace hvdtpu {

bool Controller::Submit(const Request& req) {
  std::lock_guard<std::mutex> lk(mu_);
  if (req.rank < 0 || req.rank >= world_size_) {
    last_error_ = "Request for tensor '" + req.name + "' carries rank " +
                  std::to_string(req.rank) + " outside world size " +
                  std::to_string(world_size_);
    return false;
  }
  auto it = pending_.find(req.name);
  if (it == pending_.end()) {
    PendingTensor pt;
    pt.meta = req;
    pt.ranks.insert(req.rank);
    if (static_cast<int32_t>(pt.ranks.size()) == world_size_) {
      pt.ready_seq = ready_counter_++;
    }
    pending_.emplace(req.name, std::move(pt));
    arrival_order_.push_back(req.name);
    return true;
  }
  PendingTensor& pt = it->second;
  // Metadata must agree across ranks (reference: the controller errors
  // the whole job on mismatched dtype/shape/op for one tensor name).
  if (pt.meta.op != req.op || pt.meta.dtype != req.dtype ||
      pt.meta.size_bytes != req.size_bytes ||
      pt.meta.root_rank != req.root_rank) {
    last_error_ = "Mismatched collective for tensor '" + req.name +
                  "': ranks disagree on op/dtype/size/root";
    return false;
  }
  pt.ranks.insert(req.rank);
  if (static_cast<int32_t>(pt.ranks.size()) == world_size_ &&
      pt.ready_seq < 0) {
    pt.ready_seq = ready_counter_++;
  }
  return true;
}

std::vector<Response> Controller::ComputeResponseList() {
  std::lock_guard<std::mutex> lk(mu_);

  // 1. Collect fully-ready tensors in ready order.
  std::vector<const PendingTensor*> ready;
  std::unordered_set<std::string> ready_names;
  for (const auto& kv : pending_) {
    if (kv.second.ready_seq >= 0) {
      ready.push_back(&kv.second);
      ready_names.insert(kv.first);
    }
  }
  std::sort(ready.begin(), ready.end(),
            [](const PendingTensor* a, const PendingTensor* b) {
              return a->ready_seq < b->ready_seq;
            });

  // Effective group of a request: an unregistered group_id is treated
  // as ungrouped (otherwise the tensor could never be emitted and,
  // being "ready", would be invisible to the stall inspector — a
  // silent permanent hang).  Explicit atomicity requires registering
  // the group on the controller-owning process.
  auto resolve_gid = [this](const Request& r) -> int32_t {
    int32_t gid = r.group_id >= 0 ? r.group_id
                                  : group_table_.GroupOf(r.name);
    return (gid >= 0 && group_table_.Knows(gid)) ? gid : -1;
  };

  // 2. Group atomicity: drop members of incomplete groups.
  std::vector<const PendingTensor*> emit;
  for (const PendingTensor* pt : ready) {
    int32_t gid = resolve_gid(pt->meta);
    if (gid >= 0 && !group_table_.GroupComplete(gid, ready_names)) {
      continue;  // stays pending until the whole group is ready
    }
    emit.push_back(pt);
  }
  if (emit.empty()) return {};

  // 3. Response cache: identical ready-sets reuse prior fusion plans.
  // The signature includes each tensor's *resolved* group so that
  // register/deregister of groups invalidates prior plans.
  std::vector<Request> emit_reqs;
  emit_reqs.reserve(emit.size());
  std::vector<int32_t> emit_gids;
  emit_gids.reserve(emit.size());
  for (const PendingTensor* pt : emit) {
    emit_reqs.push_back(pt->meta);
    emit_gids.push_back(resolve_gid(pt->meta));
  }
  std::string sig = ResponseCache::Signature(emit_reqs);
  for (int32_t g : emit_gids) {
    sig += ';';
    sig += std::to_string(g);
  }
  std::vector<Response> result;
  if (const std::vector<Response>* cached = cache_.Lookup(sig)) {
    result = *cached;
  } else {
    // 4. Fuse: greedy order-preserving bin packing within each run of
    // the same fusion class (op, dtype, root) — the same contract as
    // the planner (planner.cc), extended with class boundaries.
    // Barrier/join are never fused.
    bool cur_fusable = false;  // is the open (last) response fusable?
    for (size_t ri = 0; ri < emit_reqs.size(); ++ri) {
      const Request& r = emit_reqs[ri];
      bool fusable = (r.op == OpType::kAllreduce ||
                      r.op == OpType::kAllgather ||
                      r.op == OpType::kReducescatter) &&
                     emit_gids[ri] < 0;
      if (!result.empty() && fusable && cur_fusable) {
        Response& cur = result.back();
        if (cur.op == r.op && cur.dtype == r.dtype &&
            cur.root_rank == r.root_rank &&
            cur.total_bytes + r.size_bytes <= fusion_threshold_) {
          cur.names.push_back(r.name);
          cur.total_bytes += r.size_bytes;
          continue;
        }
      }
      Response resp;
      resp.op = r.op;
      resp.dtype = r.dtype;
      resp.root_rank = r.root_rank;
      resp.total_bytes = r.size_bytes;
      resp.names.push_back(r.name);
      result.push_back(std::move(resp));
      cur_fusable = fusable;
    }
    // Grouped tensors: one response per complete group (atomic fusion
    // regardless of threshold — reference GroupTable semantics).
    // They were emitted as singletons above; merge adjacent same-group.
    std::vector<Response> merged;
    std::unordered_map<int32_t, size_t> group_slot;
    size_t emit_idx = 0;
    for (auto& resp : result) {
      int32_t gid = -1;
      if (resp.names.size() == 1) {
        gid = emit_gids[emit_idx];
      }
      emit_idx += resp.names.size();
      if (gid >= 0) {
        auto it = group_slot.find(gid);
        if (it != group_slot.end()) {
          Response& dst = merged[it->second];
          dst.total_bytes += resp.total_bytes;
          dst.names.insert(dst.names.end(), resp.names.begin(),
                           resp.names.end());
          continue;
        }
        group_slot[gid] = merged.size();
      }
      merged.push_back(std::move(resp));
    }
    result = std::move(merged);
    cache_.Insert(sig, result);
  }

  // 5. Consume emitted tensors.
  std::unordered_set<std::string> emitted;
  for (const auto& resp : result) {
    for (const auto& n : resp.names) emitted.insert(n);
  }
  for (const auto& n : emitted) pending_.erase(n);
  arrival_order_.erase(
      std::remove_if(arrival_order_.begin(), arrival_order_.end(),
                     [&](const std::string& n) { return emitted.count(n); }),
      arrival_order_.end());
  return result;
}

std::vector<std::pair<std::string, std::vector<int32_t>>>
Controller::PendingPartial() const {
  std::lock_guard<std::mutex> lk(mu_);
  std::vector<std::pair<std::string, std::vector<int32_t>>> out;
  for (const auto& name : arrival_order_) {
    auto it = pending_.find(name);
    if (it == pending_.end() || it->second.ready_seq >= 0) continue;
    std::vector<int32_t> missing;
    for (int32_t r = 0; r < world_size_; ++r) {
      if (!it->second.ranks.count(r)) missing.push_back(r);
    }
    out.emplace_back(name, std::move(missing));
  }
  return out;
}

}  // namespace hvdtpu
