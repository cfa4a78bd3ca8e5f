// Steady-state response cache.
//
// Reference: horovod/common/response_cache.cc — after the first few
// steps the set of tensors per step repeats, so the coordinator skips
// full name-list negotiation and exchanges cache-hit bit vectors
// instead.
//
// Same role here: the controller keys each computed ResponseList by the
// signature of the ready-set that produced it; a repeat signature
// returns the cached decisions without re-running fusion planning.

#ifndef HVD_TPU_NATIVE_RESPONSE_CACHE_H_
#define HVD_TPU_NATIVE_RESPONSE_CACHE_H_

#include <cstdint>
#include <list>
#include <string>
#include <unordered_map>
#include <vector>

#include "common.h"

namespace hvdtpu {

class ResponseCache {
 public:
  explicit ResponseCache(size_t capacity) : capacity_(capacity) {}

  // Signature of a ready set: order-sensitive concatenation of
  // name/op/dtype/size — the same quadruple the reference hashes.
  static std::string Signature(const std::vector<Request>& ready) {
    std::string sig;
    sig.reserve(ready.size() * 24);
    for (const auto& r : ready) {
      sig += r.name;
      sig += '\x1f';
      sig += static_cast<char>(static_cast<int8_t>(r.op) + 1);
      sig += static_cast<char>(static_cast<int8_t>(r.dtype) + 1);
      sig += std::to_string(r.size_bytes);
      sig += std::to_string(r.root_rank);
      sig += '\x1e';
    }
    return sig;
  }

  const std::vector<Response>* Lookup(const std::string& sig) {
    auto it = map_.find(sig);
    if (it == map_.end()) {
      ++misses_;
      return nullptr;
    }
    ++hits_;
    // LRU touch.
    lru_.splice(lru_.begin(), lru_, it->second.lru_it);
    return &it->second.responses;
  }

  void Insert(const std::string& sig, std::vector<Response> responses) {
    if (capacity_ == 0) return;
    auto it = map_.find(sig);
    if (it != map_.end()) {
      it->second.responses = std::move(responses);
      lru_.splice(lru_.begin(), lru_, it->second.lru_it);
      return;
    }
    if (map_.size() >= capacity_) {
      map_.erase(lru_.back());
      lru_.pop_back();
    }
    lru_.push_front(sig);
    map_[sig] = Entry{std::move(responses), lru_.begin()};
  }

  int64_t hits() const { return hits_; }
  int64_t misses() const { return misses_; }
  size_t size() const { return map_.size(); }
  void Clear() {
    map_.clear();
    lru_.clear();
  }

 private:
  struct Entry {
    std::vector<Response> responses;
    std::list<std::string>::iterator lru_it;
  };
  size_t capacity_;
  int64_t hits_ = 0;
  int64_t misses_ = 0;
  std::list<std::string> lru_;
  std::unordered_map<std::string, Entry> map_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_NATIVE_RESPONSE_CACHE_H_
