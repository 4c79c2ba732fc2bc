// Native host-side IO runtime for the VO engine.
//
// C++ replacement for the reference's host plumbing: the bounded
// spin-wait input queues of the tracking pipeline
// (the reference's src/tracking.cc:96-102, 203-216), the generic
// ThreadPublisher worker queues (include/thread_publisher.h:13-85) and
// the dataset reader (src/dataset.cc). Provides:
//
//   * a bounded blocking queue with condition-variable backpressure,
//   * a multi-threaded, in-order image prefetcher (PGM / raw .npy u8)
//     that overlaps disk IO + decode with device compute,
//   * a buffered TUM trajectory writer.
//
// Exposed through a plain C ABI consumed from Python via ctypes
// (ur_mvo_tpu_torch/native/__init__.py) — no pybind11 dependency.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Bounded blocking queue (ThreadPublisher / input-buffer parity, but with
// condvars instead of the reference's 1ms spin loops).
// ---------------------------------------------------------------------------

class ByteQueue {
 public:
  explicit ByteQueue(size_t capacity) : capacity_(capacity) {}

  void push(std::vector<uint8_t>&& item) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_not_full_.wait(lk, [&] { return items_.size() < capacity_ || closed_; });
    if (closed_) return;
    items_.emplace_back(std::move(item));
    cv_not_empty_.notify_one();
  }

  bool pop(std::vector<uint8_t>* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_not_empty_.wait(lk, [&] { return !items_.empty() || closed_; });
    if (items_.empty()) return false;
    *out = std::move(items_.front());
    items_.erase(items_.begin());
    cv_not_full_.notify_one();
    return true;
  }

  size_t size() {
    std::lock_guard<std::mutex> lk(mu_);
    return items_.size();
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    cv_not_empty_.notify_all();
    cv_not_full_.notify_all();
  }

 private:
  size_t capacity_;
  bool closed_ = false;
  std::vector<std::vector<uint8_t>> items_;
  std::mutex mu_;
  std::condition_variable cv_not_empty_, cv_not_full_;
};

// ---------------------------------------------------------------------------
// Image decode: binary PGM (P5) and raw .npy uint8 2-D arrays.
// ---------------------------------------------------------------------------

struct DecodedImage {
  int height = 0, width = 0;
  std::vector<uint8_t> pixels;
  bool ok = false;
};

DecodedImage decode_pgm(const std::vector<uint8_t>& raw) {
  DecodedImage img;
  if (raw.size() < 10 || raw[0] != 'P' || raw[1] != '5') return img;
  size_t pos = 2;
  auto skip_ws = [&] {
    while (pos < raw.size()) {
      if (raw[pos] == '#') {
        while (pos < raw.size() && raw[pos] != '\n') pos++;
      } else if (isspace(raw[pos])) {
        pos++;
      } else {
        break;
      }
    }
  };
  auto read_int = [&]() -> long {
    skip_ws();
    long v = 0;
    while (pos < raw.size() && isdigit(raw[pos])) v = v * 10 + (raw[pos++] - '0');
    return v;
  };
  long w = read_int(), h = read_int(), maxv = read_int();
  pos++;  // single whitespace after maxval
  if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 255) return img;
  if (raw.size() - pos < static_cast<size_t>(w * h)) return img;
  img.width = static_cast<int>(w);
  img.height = static_cast<int>(h);
  img.pixels.assign(raw.begin() + pos, raw.begin() + pos + w * h);
  img.ok = true;
  return img;
}

DecodedImage decode_npy_u8(const std::vector<uint8_t>& raw) {
  DecodedImage img;
  if (raw.size() < 10 || memcmp(raw.data(), "\x93NUMPY", 6) != 0) return img;
  uint16_t header_len;
  memcpy(&header_len, raw.data() + 8, 2);
  std::string header(reinterpret_cast<const char*>(raw.data()) + 10, header_len);
  if (header.find("'descr': '|u1'") == std::string::npos &&
      header.find("'descr': '<u1'") == std::string::npos)
    return img;
  size_t sp = header.find("'shape': (");
  if (sp == std::string::npos) return img;
  long h = 0, w = 0;
  if (sscanf(header.c_str() + sp, "'shape': (%ld, %ld)", &h, &w) != 2) return img;
  size_t data_off = 10 + header_len;
  if (raw.size() - data_off < static_cast<size_t>(h * w)) return img;
  img.height = static_cast<int>(h);
  img.width = static_cast<int>(w);
  img.pixels.assign(raw.begin() + data_off, raw.begin() + data_off + h * w);
  img.ok = true;
  return img;
}

DecodedImage decode_any(const std::vector<uint8_t>& raw) {
  DecodedImage img = decode_pgm(raw);
  if (!img.ok) img = decode_npy_u8(raw);
  return img;
}

// ---------------------------------------------------------------------------
// In-order multi-threaded prefetcher.
// ---------------------------------------------------------------------------

class Prefetcher {
 public:
  Prefetcher(std::vector<std::string> paths, int n_workers, int window)
      : paths_(std::move(paths)),
        window_(window),
        slots_(paths_.size()),
        ready_(paths_.size(), 0) {
    next_fetch_.store(0);
    for (int i = 0; i < n_workers; i++) {
      workers_.emplace_back([this] { this->work(); });
    }
  }

  ~Prefetcher() { stop(); }

  void stop() {
    stopping_.store(true);
    {
      std::lock_guard<std::mutex> lk(mu_);
      cv_ready_.notify_all();
      cv_window_.notify_all();
    }
    for (auto& t : workers_)
      if (t.joinable()) t.join();
    workers_.clear();
  }

  // Blocks until image `idx` is decoded; returns false at end/error.
  bool get(size_t idx, DecodedImage* out) {
    if (idx >= paths_.size()) return false;
    std::unique_lock<std::mutex> lk(mu_);
    cv_ready_.wait(lk, [&] { return ready_[idx] != 0 || stopping_.load(); });
    if (ready_[idx] == 0) return false;
    *out = std::move(slots_[idx]);
    consumed_ = idx + 1;
    cv_window_.notify_all();
    return out->ok;
  }

  size_t size() const { return paths_.size(); }

 private:
  void work() {
    for (;;) {
      size_t idx = next_fetch_.fetch_add(1);
      if (idx >= paths_.size() || stopping_.load()) return;
      {
        // backpressure: stay within `window_` of the consumer
        std::unique_lock<std::mutex> lk(mu_);
        cv_window_.wait(lk, [&] { return idx < consumed_ + window_ || stopping_.load(); });
        if (stopping_.load()) return;
      }
      std::ifstream f(paths_[idx], std::ios::binary);
      std::vector<uint8_t> raw((std::istreambuf_iterator<char>(f)),
                               std::istreambuf_iterator<char>());
      DecodedImage img = decode_any(raw);
      {
        std::lock_guard<std::mutex> lk(mu_);
        slots_[idx] = std::move(img);
        ready_[idx] = 1;
        cv_ready_.notify_all();
      }
    }
  }

  std::vector<std::string> paths_;
  size_t window_;
  std::vector<DecodedImage> slots_;
  std::vector<uint8_t> ready_;
  size_t consumed_ = 0;
  std::atomic<size_t> next_fetch_{0};
  std::atomic<bool> stopping_{false};
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_ready_, cv_window_;
};

// ---------------------------------------------------------------------------
// Buffered TUM writer (Mapping::SaveKeyframeTrajectory parity).
// ---------------------------------------------------------------------------

class TumWriter {
 public:
  explicit TumWriter(const std::string& path) : f_(path) {}
  void write(double ts, const double* t, const double* q_wxyz) {
    char buf[256];
    snprintf(buf, sizeof(buf), "%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n", ts,
             t[0], t[1], t[2], q_wxyz[1], q_wxyz[2], q_wxyz[3], q_wxyz[0]);
    f_ << buf;
  }
  void flush() { f_.flush(); }

 private:
  std::ofstream f_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* urmvo_prefetcher_create(const char** paths, int n_paths, int n_workers, int window) {
  std::vector<std::string> v(paths, paths + n_paths);
  return new Prefetcher(std::move(v), n_workers, window);
}

// Returns 1 on success and fills height/width; the pixel buffer must be
// fetched with urmvo_prefetcher_copy before the next get().
int urmvo_prefetcher_get(void* handle, long idx, uint8_t* out, long out_capacity,
                         int* height, int* width) {
  auto* p = static_cast<Prefetcher*>(handle);
  DecodedImage img;
  if (!p->get(static_cast<size_t>(idx), &img)) return 0;
  long need = static_cast<long>(img.pixels.size());
  if (need > out_capacity) return 0;
  memcpy(out, img.pixels.data(), need);
  *height = img.height;
  *width = img.width;
  return 1;
}

void urmvo_prefetcher_destroy(void* handle) { delete static_cast<Prefetcher*>(handle); }

void* urmvo_queue_create(long capacity) { return new ByteQueue(static_cast<size_t>(capacity)); }

void urmvo_queue_push(void* handle, const uint8_t* data, long n) {
  static_cast<ByteQueue*>(handle)->push(std::vector<uint8_t>(data, data + n));
}

long urmvo_queue_pop(void* handle, uint8_t* out, long capacity) {
  std::vector<uint8_t> item;
  if (!static_cast<ByteQueue*>(handle)->pop(&item)) return -1;
  long n = static_cast<long>(item.size());
  if (n > capacity) return -2;
  memcpy(out, item.data(), n);
  return n;
}

long urmvo_queue_size(void* handle) { return static_cast<long>(static_cast<ByteQueue*>(handle)->size()); }

void urmvo_queue_close(void* handle) { static_cast<ByteQueue*>(handle)->close(); }

void urmvo_queue_destroy(void* handle) { delete static_cast<ByteQueue*>(handle); }

void* urmvo_tum_writer_create(const char* path) { return new TumWriter(path); }

void urmvo_tum_writer_write(void* handle, double ts, const double* t, const double* q_wxyz) {
  static_cast<TumWriter*>(handle)->write(ts, t, q_wxyz);
}

void urmvo_tum_writer_destroy(void* handle) {
  auto* w = static_cast<TumWriter*>(handle);
  w->flush();
  delete w;
}

}  // extern "C"
