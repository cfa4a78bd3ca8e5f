// Shared types for the native runtime.
//
// Horovod's horovod/common/common.h (DataType, the op enum) and
// horovod/common/message.h (Request/Response).  The same records as
// horovod_tpu/native/src/common.h, integer for integer.
//
// The data plane (the bytes of the tensors) lives in torch tensors and
// never passes through this library.  What is native here is the
// *control plane*: the metadata records that the coordinator negotiates
// over, fuses, caches and times.

#ifndef HVD_TPU_NATIVE_COMMON_H_
#define HVD_TPU_NATIVE_COMMON_H_

#include <cstdint>
#include <string>
#include <vector>

namespace hvdtpu {

// Mirrors the reference's DataType enum (horovod/common/common.h).
enum class DataType : int8_t {
  kUInt8 = 0,
  kInt8 = 1,
  kUInt16 = 2,
  kInt16 = 3,
  kInt32 = 4,
  kInt64 = 5,
  kFloat16 = 6,
  kFloat32 = 7,
  kFloat64 = 8,
  kBool = 9,
  kBFloat16 = 10,
};

// Request types (reference: Request::RequestType — ALLREDUCE, ALLGATHER,
// BROADCAST, ALLTOALL, JOIN, ADASUM, BARRIER).
enum class OpType : int8_t {
  kAllreduce = 0,
  kAllgather = 1,
  kBroadcast = 2,
  kAlltoall = 3,
  kReducescatter = 4,
  kAdasum = 5,
  kBarrier = 6,
  kJoin = 7,
};

// A worker's declaration that one tensor is ready on one rank
// (reference: Request in message.h).
struct Request {
  int32_t rank = 0;
  OpType op = OpType::kAllreduce;
  DataType dtype = DataType::kFloat32;
  int64_t size_bytes = 0;
  int32_t root_rank = -1;    // broadcast only
  int32_t group_id = -1;     // -1 = ungrouped
  std::string name;
};

// A coordinator decision: execute these tensors as one fused collective
// (reference: Response in message.h).
struct Response {
  OpType op = OpType::kAllreduce;
  DataType dtype = DataType::kFloat32;
  int64_t total_bytes = 0;
  int32_t root_rank = -1;
  std::vector<std::string> names;
};

inline bool SameFusionClass(const Request& a, const Request& b) {
  return a.op == b.op && a.dtype == b.dtype && a.root_rank == b.root_rank;
}

}  // namespace hvdtpu

#endif  // HVD_TPU_NATIVE_COMMON_H_
