// Background-thread Chrome-trace timeline writer.
//
// Reference: horovod/common/timeline.cc — a dedicated writer thread
// receives per-tensor lifecycle events from the coordination path and
// streams chrome://tracing JSON, so tracing never blocks the hot loop
// (Horovod's timeline writer).
//
// Same design here: Record() enqueues under a mutex and returns; a
// std::thread owns the FILE* and formats/flushes. utils/timeline.py
// prefers this writer (via ctypes) and falls back to its pure-Python
// one when the native library is unavailable.

#ifndef HVD_TPU_NATIVE_TIMELINE_H_
#define HVD_TPU_NATIVE_TIMELINE_H_

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

namespace hvdtpu {

class TimelineWriter {
 public:
  // Returns nullptr if the file cannot be opened.
  static TimelineWriter* Open(const std::string& path, bool mark_cycles);
  ~TimelineWriter();

  // One complete ("X") event. `args_json` may be empty or a JSON object
  // body without braces, e.g. "\"op\": \"sum\"".
  void Record(const std::string& tensor, const std::string& phase,
              double ts_us, double dur_us, const std::string& args_json);

  // Instant ("i") event — the reference's cycle markers.
  void MarkCycle(double ts_us);

  // Counter ("C") event: one counter track per `name`; `series_json`
  // is a JSON object body without braces, e.g. "\"tokens_per_s\": 12.5"
  // (the args object IS the series map in the trace-event format).
  void Counter(const std::string& name, double ts_us,
               const std::string& series_json);

  // Flow event: `phase` is "s" (start) or "f" (finish, rendered with
  // bp:"e" so it binds to the enclosing slice); `id` is the flow key —
  // the tracing layer uses the RPC client span id, so the same id on
  // two ranks' files draws one arrow after merging.
  void Flow(const std::string& name, const std::string& phase,
            const std::string& id, double ts_us);

  void Close();  // drains queue, finalizes JSON array, joins thread

  int64_t events_written() const { return events_written_; }

 private:
  TimelineWriter(std::FILE* f, bool mark_cycles);
  void WriterLoop();
  void Enqueue(std::string line);

  std::FILE* file_;
  bool mark_cycles_;
  bool first_ = true;
  int64_t events_written_ = 0;

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::string> queue_;
  bool closing_ = false;
  std::thread thread_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_NATIVE_TIMELINE_H_
