// Binary wire format for Request/Response lists.
//
// Reference: horovod/common/wire/message.fbs + message.cc — flatbuffers
// serialization of the coordinator protocol.  Here: a dependency-free
// little-endian length-prefixed encoding (the schema is small and
// version-tagged; flatbuffers would be the only third-party dependency
// in the whole native layer, for no measurable win at these sizes).
//
// Layout (all integers little-endian):
//   RequestList  := u8 version | u32 count | Request*
//   Request      := i32 rank | i8 op | i8 dtype | i64 size_bytes
//                 | i32 root_rank | i32 group_id | u16 name_len | bytes
//   ResponseList := u8 version | u32 count | Response*
//   Response     := i8 op | i8 dtype | i64 total_bytes | i32 root_rank
//                 | u32 n_names | (u16 len | bytes)*

#ifndef HVD_TPU_NATIVE_WIRE_H_
#define HVD_TPU_NATIVE_WIRE_H_

#include <cstdint>
#include <vector>

#include "common.h"

namespace hvdtpu {
namespace wire {

constexpr uint8_t kVersion = 1;

std::vector<uint8_t> EncodeRequests(const std::vector<Request>& reqs);
// Returns false on malformed input (truncation, bad version).
bool DecodeRequests(const uint8_t* data, size_t len,
                    std::vector<Request>* out);

std::vector<uint8_t> EncodeResponses(const std::vector<Response>& resps);
bool DecodeResponses(const uint8_t* data, size_t len,
                     std::vector<Response>* out);

}  // namespace wire
}  // namespace hvdtpu

#endif  // HVD_TPU_NATIVE_WIRE_H_
