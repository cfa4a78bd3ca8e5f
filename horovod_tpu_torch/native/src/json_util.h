// Minimal JSON string escaping shared by the timeline writer and the
// C-API report serializers (tensor names are user-chosen and may
// contain quotes, pipes, newlines — anything).

#ifndef HVD_TPU_NATIVE_JSON_UTIL_H_
#define HVD_TPU_NATIVE_JSON_UTIL_H_

#include <cstdio>
#include <string>

namespace hvdtpu {

inline std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      case '\r': out += "\\r"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

}  // namespace hvdtpu

#endif  // HVD_TPU_NATIVE_JSON_UTIL_H_
