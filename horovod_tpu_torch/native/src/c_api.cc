// Plain-C ABI for the native runtime (consumed via ctypes, so the
// library needs no Python or torch headers; see native/bindings.py).
//
// Reference analogue: the C API exported by horovod/common/operations.cc
// (horovod_init/horovod_rank/... + EnqueueTensorAllreduce) that the
// Python HorovodBasics façade loads.  Here the C surface exposes the
// control-plane components (controller, coordinator, stall inspector,
// timeline, planner); the data plane stays in torch.distributed.
//
// Conventions:
//   - objects are opaque void* handles with explicit _destroy
//   - functions returning int: 1 = success, 0 = failure
//   - functions filling buffers return bytes written, or -(bytes
//     needed) when the buffer is too small, so callers can retry

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "controller.h"
#include "coordinator.h"
#include "json_util.h"
#include "stall_inspector.h"
#include "timeline.h"
#include "wire.h"
#include "tensor_queue.h"

namespace {

using hvdtpu::Controller;
using hvdtpu::Coordinator;
using hvdtpu::DataType;
using hvdtpu::JsonEscape;
using hvdtpu::OpType;
using hvdtpu::Request;
using hvdtpu::Response;
using hvdtpu::StallInspector;
using hvdtpu::TimelineWriter;

int64_t FillBuffer(const std::vector<uint8_t>& data, uint8_t* out,
                   int64_t cap) {
  int64_t n = static_cast<int64_t>(data.size());
  if (n > cap) return -n;
  if (n > 0) std::memcpy(out, data.data(), n);
  return n;
}

int64_t FillString(const std::string& s, char* out, int64_t cap) {
  int64_t n = static_cast<int64_t>(s.size());
  if (n + 1 > cap) return -(n + 1);
  std::memcpy(out, s.data(), n);
  out[n] = '\0';
  return n;
}

// Fill-style calls that have a side effect (consuming controller state,
// running a collective network round) stash their encoded result so a
// too-small buffer only costs a retry of the *copy*, never a re-run of
// the side effect.
int64_t FillStashed(std::string* stash, uint8_t* out, int64_t cap) {
  int64_t n = static_cast<int64_t>(stash->size());
  if (n > cap) return -n;
  if (n > 0) std::memcpy(out, stash->data(), n);
  stash->clear();
  return n;
}

struct CtrlHandle {
  std::unique_ptr<Controller> ctrl;
  std::string stash;  // computed-but-unfetched ResponseList bytes
};

struct CoordHandle {
  std::unique_ptr<Coordinator> coord;
  std::string stash;  // negotiated-but-unfetched ResponseList bytes
};

}  // namespace

extern "C" {

// ---- version ---------------------------------------------------------------

int64_t hvd_tpu_native_abi_version() { return 3; }

// ---- controller ------------------------------------------------------------

void* hvd_ctrl_create(int32_t world_size, int64_t fusion_threshold,
                      int64_t cache_capacity) {
  if (world_size <= 0 || fusion_threshold < 0 || cache_capacity < 0) {
    return nullptr;
  }
  auto* h = new CtrlHandle;
  h->ctrl.reset(new Controller(world_size, fusion_threshold,
                               static_cast<size_t>(cache_capacity)));
  return h;
}

void hvd_ctrl_destroy(void* h) { delete static_cast<CtrlHandle*>(h); }

int hvd_ctrl_submit(void* h, int32_t rank, const char* name, int8_t op,
                    int8_t dtype, int64_t size_bytes, int32_t root_rank,
                    int32_t group_id) {
  if (!h || !name) return 0;
  Request r;
  r.rank = rank;
  r.op = static_cast<OpType>(op);
  r.dtype = static_cast<DataType>(dtype);
  r.size_bytes = size_bytes;
  r.root_rank = root_rank;
  r.group_id = group_id;
  r.name = name;
  return static_cast<CtrlHandle*>(h)->ctrl->Submit(r) ? 1 : 0;
}

int64_t hvd_ctrl_compute(void* h, uint8_t* out, int64_t cap) {
  if (!h) return -1;
  auto* ch = static_cast<CtrlHandle*>(h);
  if (ch->stash.empty()) {  // encoded lists are never 0 bytes
    auto resp = ch->ctrl->ComputeResponseList();
    auto enc = hvdtpu::wire::EncodeResponses(resp);
    ch->stash.assign(enc.begin(), enc.end());
  }
  return FillStashed(&ch->stash, out, cap);
}

int32_t hvd_ctrl_register_group(void* h, const char** names, int32_t n) {
  if (!h || n < 0) return -1;
  std::vector<std::string> v;
  v.reserve(n);
  for (int32_t i = 0; i < n; ++i) v.emplace_back(names[i]);
  return static_cast<CtrlHandle*>(h)->ctrl->group_table().RegisterGroup(v);
}

int64_t hvd_ctrl_cache_hits(void* h) {
  return h ? static_cast<CtrlHandle*>(h)->ctrl->cache().hits() : -1;
}

int64_t hvd_ctrl_cache_misses(void* h) {
  return h ? static_cast<CtrlHandle*>(h)->ctrl->cache().misses() : -1;
}

int64_t hvd_ctrl_last_error(void* h, char* out, int64_t cap) {
  if (!h) return -1;
  return FillString(static_cast<CtrlHandle*>(h)->ctrl->last_error(), out,
                    cap);
}

// JSON: [["name", [missing_rank, ...]], ...] — names are user-chosen
// and may contain any byte, so no delimiter format.
int64_t hvd_ctrl_pending_partial(void* h, char* out, int64_t cap) {
  if (!h) return -1;
  std::string s = "[";
  bool first = true;
  for (const auto& p :
       static_cast<CtrlHandle*>(h)->ctrl->PendingPartial()) {
    if (!first) s += ", ";
    first = false;
    s += "[\"" + JsonEscape(p.first) + "\", [";
    for (size_t i = 0; i < p.second.size(); ++i) {
      if (i) s += ", ";
      s += std::to_string(p.second[i]);
    }
    s += "]]";
  }
  s += "]";
  return FillString(s, out, cap);
}

// ---- wire (test hooks: verify Python codec compatibility) ------------------

int64_t hvd_wire_requests_roundtrip(const uint8_t* in, int64_t len,
                                    uint8_t* out, int64_t cap) {
  std::vector<Request> reqs;
  if (!hvdtpu::wire::DecodeRequests(in, static_cast<size_t>(len), &reqs)) {
    return -1;
  }
  return FillBuffer(hvdtpu::wire::EncodeRequests(reqs), out, cap);
}

int64_t hvd_wire_responses_roundtrip(const uint8_t* in, int64_t len,
                                     uint8_t* out, int64_t cap) {
  std::vector<Response> resps;
  if (!hvdtpu::wire::DecodeResponses(in, static_cast<size_t>(len), &resps)) {
    return -1;
  }
  return FillBuffer(hvdtpu::wire::EncodeResponses(resps), out, cap);
}

// ---- coordinator -----------------------------------------------------------

void* hvd_coord_create(int32_t rank, int32_t world_size, const char* host,
                       int32_t port, int64_t fusion_threshold,
                       double timeout_s) {
  if (!host || rank < 0 || world_size <= 0 || rank >= world_size) {
    return nullptr;
  }
  auto c = Coordinator::Create(rank, world_size, host, port,
                               fusion_threshold, timeout_s);
  if (!c) return nullptr;
  auto* h = new CoordHandle;
  h->coord = std::move(c);
  return h;
}

void hvd_coord_destroy(void* h) { delete static_cast<CoordHandle*>(h); }

int32_t hvd_coord_bound_port(void* h) {
  return h ? static_cast<CoordHandle*>(h)->coord->BoundPort() : -1;
}

// `req`/`req_len`: wire-encoded RequestList for this rank; fills `out`
// with the wire-encoded global ResponseList.  If a prior call returned
// -needed, the retry returns the already-negotiated result without
// re-running the network round (`req` is ignored on such a retry).
int64_t hvd_coord_negotiate(void* h, const uint8_t* req, int64_t req_len,
                            uint8_t* out, int64_t cap) {
  if (!h) return -1;
  auto* ch = static_cast<CoordHandle*>(h);
  if (ch->stash.empty()) {  // encoded lists are never 0 bytes
    std::vector<Request> mine;
    if (req_len > 0 &&
        !hvdtpu::wire::DecodeRequests(req, static_cast<size_t>(req_len),
                                      &mine)) {
      return -1;
    }
    std::vector<Response> responses;
    if (!ch->coord->Negotiate(mine, &responses)) return -1;
    auto enc = hvdtpu::wire::EncodeResponses(responses);
    ch->stash.assign(enc.begin(), enc.end());
  }
  return FillStashed(&ch->stash, out, cap);
}

int hvd_coord_barrier(void* h) {
  return h && static_cast<CoordHandle*>(h)->coord->Barrier() ? 1 : 0;
}

void hvd_coord_shutdown(void* h) {
  if (h) static_cast<CoordHandle*>(h)->coord->Shutdown();
}

int64_t hvd_coord_cycles(void* h) {
  return h ? static_cast<CoordHandle*>(h)->coord->cycles() : -1;
}

int64_t hvd_coord_last_error(void* h, char* out, int64_t cap) {
  if (!h) return -1;
  return FillString(static_cast<CoordHandle*>(h)->coord->last_error(), out,
                    cap);
}

int64_t hvd_coord_cache_hits(void* h) {
  if (!h) return -1;
  Controller* c = static_cast<CoordHandle*>(h)->coord->controller();
  return c ? c->cache().hits() : -1;
}

// ---- stall inspector -------------------------------------------------------

void* hvd_stall_create(int32_t world_size, double warn_after_s,
                       double shutdown_after_s) {
  if (world_size <= 0) return nullptr;
  return new StallInspector(world_size, warn_after_s, shutdown_after_s);
}

void hvd_stall_destroy(void* h) { delete static_cast<StallInspector*>(h); }

void hvd_stall_submit(void* h, const char* name, int32_t rank,
                      double now_s) {
  if (h && name) {
    static_cast<StallInspector*>(h)->RecordSubmit(name, rank, now_s);
  }
}

void hvd_stall_complete(void* h, const char* name) {
  if (h && name) static_cast<StallInspector*>(h)->RecordComplete(name);
}

// JSON: [["name", age_s, [missing_rank, ...]], ...].
int64_t hvd_stall_report(void* h, double now_s, char* out, int64_t cap) {
  if (!h) return -1;
  std::string s = "[";
  char num[32];
  bool first = true;
  for (const auto& st : static_cast<StallInspector*>(h)->Report(now_s)) {
    if (!first) s += ", ";
    first = false;
    s += "[\"" + JsonEscape(st.name) + "\"";
    std::snprintf(num, sizeof(num), ", %.3f, [", st.age_s);
    s += num;
    for (size_t i = 0; i < st.missing_ranks.size(); ++i) {
      if (i) s += ", ";
      s += std::to_string(st.missing_ranks[i]);
    }
    s += "]]";
  }
  s += "]";
  return FillString(s, out, cap);
}

int hvd_stall_should_shutdown(void* h, double now_s) {
  return h && static_cast<StallInspector*>(h)->ShouldShutdown(now_s) ? 1 : 0;
}

// ---- timeline --------------------------------------------------------------

void* hvd_tl_open(const char* path, int mark_cycles) {
  if (!path) return nullptr;
  return TimelineWriter::Open(path, mark_cycles != 0);
}

void hvd_tl_record(void* h, const char* tensor, const char* phase,
                   double ts_us, double dur_us, const char* args_json) {
  if (h && tensor && phase) {
    static_cast<TimelineWriter*>(h)->Record(
        tensor, phase, ts_us, dur_us, args_json ? args_json : "");
  }
}

void hvd_tl_mark_cycle(void* h, double ts_us) {
  if (h) static_cast<TimelineWriter*>(h)->MarkCycle(ts_us);
}

void hvd_tl_counter(void* h, const char* name, double ts_us,
                    const char* series_json) {
  if (h && name && series_json) {
    static_cast<TimelineWriter*>(h)->Counter(name, ts_us, series_json);
  }
}

void hvd_tl_flow(void* h, const char* name, const char* phase,
                 const char* id, double ts_us) {
  if (h && name && phase && id) {
    static_cast<TimelineWriter*>(h)->Flow(name, phase, id, ts_us);
  }
}

int64_t hvd_tl_events_written(void* h) {
  return h ? static_cast<TimelineWriter*>(h)->events_written() : -1;
}

void hvd_tl_close_destroy(void* h) {
  if (h) {
    auto* w = static_cast<TimelineWriter*>(h);
    w->Close();
    delete w;
  }
}

// ---- tensor queue ----------------------------------------------------------
// The reference's framework-thread -> background-thread handoff
// (horovod/common/tensor_queue.cc); here it stages collective-dispatch
// reports between the Python API threads and the cross-process monitor
// cycle (utils/cross_stall.py).

struct QueueHandle {
  hvdtpu::TensorQueue q;
  std::string stash;  // drained-but-unfetched encoded Requests
};

void* hvd_queue_create() { return new QueueHandle; }

void hvd_queue_destroy(void* h) { delete static_cast<QueueHandle*>(h); }

int hvd_queue_push(void* h, int32_t rank, const char* name, int8_t op,
                   int8_t dtype, int64_t size_bytes, int32_t root_rank,
                   int32_t group_id) {
  if (!h || !name) return 0;
  hvdtpu::Request r;
  r.rank = rank;
  r.op = static_cast<hvdtpu::OpType>(op);
  r.dtype = static_cast<hvdtpu::DataType>(dtype);
  r.size_bytes = size_bytes;
  r.root_rank = root_rank;
  r.group_id = group_id;
  r.name = name;
  static_cast<QueueHandle*>(h)->q.Push(std::move(r));
  return 1;
}

int64_t hvd_queue_size(void* h) {
  if (!h) return -1;
  return static_cast<int64_t>(static_cast<QueueHandle*>(h)->q.Size());
}

// Drains everything queued, encoded with the Request wire codec.
// Stashed: a too-small buffer retries the copy, never loses the drain.
int64_t hvd_queue_drain(void* h, uint8_t* out, int64_t cap) {
  if (!h) return -1;
  auto* qh = static_cast<QueueHandle*>(h);
  if (qh->stash.empty()) {
    auto reqs = qh->q.DrainAll();
    auto enc = hvdtpu::wire::EncodeRequests(reqs);
    qh->stash.assign(enc.begin(), enc.end());
  }
  return FillStashed(&qh->stash, out, cap);
}

}  // extern "C"
