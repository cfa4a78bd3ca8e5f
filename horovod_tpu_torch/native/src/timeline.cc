#include "timeline.h"

#include <unistd.h>

#include <cinttypes>
#include <cstring>

#include "json_util.h"

namespace hvdtpu {
namespace {

// Stable small tid per tensor name so each tensor gets its own trace row
// (the reference assigns per-tensor lanes the same way).
uint32_t NameTid(const std::string& name) {
  uint32_t h = 2166136261u;
  for (char c : name) {
    h ^= static_cast<unsigned char>(c);
    h *= 16777619u;
  }
  return h & 0x7fffffffu;
}

}  // namespace

TimelineWriter* TimelineWriter::Open(const std::string& path,
                                     bool mark_cycles) {
  std::FILE* f = std::fopen(path.c_str(), "w");
  if (!f) return nullptr;
  return new TimelineWriter(f, mark_cycles);
}

TimelineWriter::TimelineWriter(std::FILE* f, bool mark_cycles)
    : file_(f), mark_cycles_(mark_cycles) {
  std::fputs("[\n", file_);
  thread_ = std::thread([this] { WriterLoop(); });
}

TimelineWriter::~TimelineWriter() { Close(); }

void TimelineWriter::Enqueue(std::string line) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (closing_) return;
    queue_.push_back(std::move(line));
  }
  cv_.notify_one();
}

void TimelineWriter::Record(const std::string& tensor,
                            const std::string& phase, double ts_us,
                            double dur_us, const std::string& args_json) {
  char head[256];
  std::snprintf(head, sizeof(head),
                "{\"name\": \"%s\", \"cat\": \"collective\", \"ph\": \"X\", "
                "\"ts\": %.3f, \"dur\": %.3f, \"pid\": %d, \"tid\": %u, ",
                JsonEscape(phase).c_str(), ts_us, dur_us,
                static_cast<int>(::getpid()), NameTid(tensor));
  std::string line(head);
  line += "\"args\": {\"tensor\": \"" + JsonEscape(tensor) + "\"";
  if (!args_json.empty()) {
    line += ", ";
    line += args_json;  // caller-provided JSON body (already formed)
  }
  line += "}}";
  Enqueue(std::move(line));
}

void TimelineWriter::MarkCycle(double ts_us) {
  if (!mark_cycles_) return;
  char buf[160];
  std::snprintf(buf, sizeof(buf),
                "{\"name\": \"CYCLE\", \"cat\": \"cycle\", \"ph\": \"i\", "
                "\"ts\": %.3f, \"pid\": %d, \"tid\": 0, \"s\": \"p\"}",
                ts_us, static_cast<int>(::getpid()));
  Enqueue(std::string(buf));
}

void TimelineWriter::Counter(const std::string& name, double ts_us,
                             const std::string& series_json) {
  if (series_json.empty()) return;
  // The free-form track name stays in the unbounded std::string part
  // (same rule as Record's tensor name): a fixed buffer would truncate
  // long names mid-string and corrupt the JSON array.
  char head[160];
  std::snprintf(head, sizeof(head),
                "\", \"cat\": \"counter\", \"ph\": \"C\", "
                "\"ts\": %.3f, \"pid\": %d, \"tid\": 0, ",
                ts_us, static_cast<int>(::getpid()));
  std::string line = "{\"name\": \"" + JsonEscape(name) + head;
  line += "\"args\": {" + series_json + "}}";
  Enqueue(std::move(line));
}

void TimelineWriter::Flow(const std::string& name, const std::string& phase,
                          const std::string& id, double ts_us) {
  if (phase != "s" && phase != "f") return;
  char head[160];
  std::snprintf(head, sizeof(head),
                "\"ts\": %.3f, \"pid\": %d, \"tid\": 0",
                ts_us, static_cast<int>(::getpid()));
  std::string line = "{\"name\": \"" + JsonEscape(name) +
                     "\", \"cat\": \"flow\", \"ph\": \"" + phase +
                     "\", \"id\": \"" + JsonEscape(id) + "\", ";
  line += head;
  if (phase == "f") line += ", \"bp\": \"e\"";
  line += "}";
  Enqueue(std::move(line));
}

void TimelineWriter::WriterLoop() {
  for (;;) {
    std::deque<std::string> batch;
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_.wait(lk, [this] { return closing_ || !queue_.empty(); });
      batch.swap(queue_);
      if (batch.empty() && closing_) return;
    }
    for (const std::string& line : batch) {
      if (!first_) std::fputs(",\n", file_);
      first_ = false;
      std::fputs(line.c_str(), file_);
      ++events_written_;
    }
    std::fflush(file_);
  }
}

void TimelineWriter::Close() {
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (closing_ && !thread_.joinable()) return;
    closing_ = true;
  }
  cv_.notify_one();
  if (thread_.joinable()) thread_.join();
  if (file_) {
    std::fputs("\n]\n", file_);
    std::fclose(file_);
    file_ = nullptr;
  }
}

}  // namespace hvdtpu
