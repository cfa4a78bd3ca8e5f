#include "wire.h"

#include <cstring>

namespace hvdtpu {
namespace wire {
namespace {

// Bounded little-endian reader/writer. The hosts are x86/ARM LE; the
// explicit byte handling keeps the format well-defined regardless.
class Writer {
 public:
  explicit Writer(std::vector<uint8_t>* buf) : buf_(buf) {}

  void U8(uint8_t v) { buf_->push_back(v); }
  void I8(int8_t v) { buf_->push_back(static_cast<uint8_t>(v)); }
  void U16(uint16_t v) { Raw(&v, 2); }
  void U32(uint32_t v) { Raw(&v, 4); }
  void I32(int32_t v) { Raw(&v, 4); }
  void I64(int64_t v) { Raw(&v, 8); }
  void Str(const std::string& s) {
    uint16_t n = static_cast<uint16_t>(s.size() > 0xffff ? 0xffff : s.size());
    U16(n);
    buf_->insert(buf_->end(), s.begin(), s.begin() + n);
  }

 private:
  void Raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    buf_->insert(buf_->end(), b, b + n);
  }
  std::vector<uint8_t>* buf_;
};

class Reader {
 public:
  Reader(const uint8_t* data, size_t len) : data_(data), len_(len) {}

  bool U8(uint8_t* v) { return Raw(v, 1); }
  bool I8(int8_t* v) { return Raw(v, 1); }
  bool U16(uint16_t* v) { return Raw(v, 2); }
  bool U32(uint32_t* v) { return Raw(v, 4); }
  bool I32(int32_t* v) { return Raw(v, 4); }
  bool I64(int64_t* v) { return Raw(v, 8); }
  bool Str(std::string* s) {
    uint16_t n = 0;
    if (!U16(&n)) return false;
    if (pos_ + n > len_) return false;
    s->assign(reinterpret_cast<const char*>(data_ + pos_), n);
    pos_ += n;
    return true;
  }
  bool AtEnd() const { return pos_ == len_; }

 private:
  bool Raw(void* p, size_t n) {
    if (pos_ + n > len_) return false;
    std::memcpy(p, data_ + pos_, n);
    pos_ += n;
    return true;
  }
  const uint8_t* data_;
  size_t len_;
  size_t pos_ = 0;
};

}  // namespace

std::vector<uint8_t> EncodeRequests(const std::vector<Request>& reqs) {
  std::vector<uint8_t> buf;
  Writer w(&buf);
  w.U8(kVersion);
  w.U32(static_cast<uint32_t>(reqs.size()));
  for (const auto& r : reqs) {
    w.I32(r.rank);
    w.I8(static_cast<int8_t>(r.op));
    w.I8(static_cast<int8_t>(r.dtype));
    w.I64(r.size_bytes);
    w.I32(r.root_rank);
    w.I32(r.group_id);
    w.Str(r.name);
  }
  return buf;
}

bool DecodeRequests(const uint8_t* data, size_t len,
                    std::vector<Request>* out) {
  Reader rd(data, len);
  uint8_t version = 0;
  uint32_t count = 0;
  if (!rd.U8(&version) || version != kVersion) return false;
  if (!rd.U32(&count)) return false;
  out->clear();
  out->reserve(count);
  for (uint32_t i = 0; i < count; ++i) {
    Request r;
    int8_t op = 0, dtype = 0;
    if (!rd.I32(&r.rank) || !rd.I8(&op) || !rd.I8(&dtype) ||
        !rd.I64(&r.size_bytes) || !rd.I32(&r.root_rank) ||
        !rd.I32(&r.group_id) || !rd.Str(&r.name)) {
      return false;
    }
    r.op = static_cast<OpType>(op);
    r.dtype = static_cast<DataType>(dtype);
    out->push_back(std::move(r));
  }
  return rd.AtEnd();
}

std::vector<uint8_t> EncodeResponses(const std::vector<Response>& resps) {
  std::vector<uint8_t> buf;
  Writer w(&buf);
  w.U8(kVersion);
  w.U32(static_cast<uint32_t>(resps.size()));
  for (const auto& r : resps) {
    w.I8(static_cast<int8_t>(r.op));
    w.I8(static_cast<int8_t>(r.dtype));
    w.I64(r.total_bytes);
    w.I32(r.root_rank);
    w.U32(static_cast<uint32_t>(r.names.size()));
    for (const auto& n : r.names) w.Str(n);
  }
  return buf;
}

bool DecodeResponses(const uint8_t* data, size_t len,
                     std::vector<Response>* out) {
  Reader rd(data, len);
  uint8_t version = 0;
  uint32_t count = 0;
  if (!rd.U8(&version) || version != kVersion) return false;
  if (!rd.U32(&count)) return false;
  out->clear();
  out->reserve(count);
  for (uint32_t i = 0; i < count; ++i) {
    Response r;
    int8_t op = 0, dtype = 0;
    uint32_t n_names = 0;
    if (!rd.I8(&op) || !rd.I8(&dtype) || !rd.I64(&r.total_bytes) ||
        !rd.I32(&r.root_rank) || !rd.U32(&n_names)) {
      return false;
    }
    r.op = static_cast<OpType>(op);
    r.dtype = static_cast<DataType>(dtype);
    r.names.reserve(n_names);
    for (uint32_t j = 0; j < n_names; ++j) {
      std::string s;
      if (!rd.Str(&s)) return false;
      r.names.push_back(std::move(s));
    }
    out->push_back(std::move(r));
  }
  return rd.AtEnd();
}

}  // namespace wire
}  // namespace hvdtpu
