// Async file I/O engine (thread-pool pread/pwrite with a completion queue).
//
// The JAX package's csrc/aio/ds_aio.cpp, copied for deepspeed_tpu_torch:
// a portable POSIX thread pool issuing pread/pwrite (the reference drives
// libaio against O_DIRECT NVMe) with the same asynchrony contract (submit
// returns immediately, wait() drains completions) on any filesystem,
// which the host-RAM <-> disk offload tier needs. Exposed to Python
// through ctypes (deepspeed_tpu_torch/ops/aio.py); built at first use by
// ops/op_builder.py load_host("ds_aio") with -pthread.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Request {
  int64_t id;
  bool is_read;
  std::string path;
  void* buffer;
  int64_t nbytes;
  int64_t offset;
  bool trunc;  // writes only: truncate file to offset+nbytes afterwards
};

struct Completion {
  int64_t id;
  int64_t result;  // bytes transferred or -errno
};

class AioEngine {
 public:
  AioEngine(int n_threads, int queue_depth)
      : queue_depth_(queue_depth), stop_(false), inflight_(0) {
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] { worker_loop(); });
    }
  }

  ~AioEngine() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  int64_t submit(bool is_read, const char* path, void* buffer, int64_t nbytes,
                 int64_t offset, bool trunc = false) {
    std::unique_lock<std::mutex> lk(mu_);
    if ((int)pending_.size() >= queue_depth_) return -1;
    int64_t id = next_id_++;
    pending_.push_back(Request{id, is_read, path, buffer, nbytes, offset, trunc});
    ++inflight_;
    cv_.notify_one();
    return id;
  }

  // Blocks until `count` completions are available; fills ids/results.
  int64_t wait(int64_t count, int64_t* ids, int64_t* results) {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this, count] { return (int64_t)done_.size() >= count; });
    int64_t n = 0;
    while (n < count && !done_.empty()) {
      ids[n] = done_.front().id;
      results[n] = done_.front().result;
      done_.pop_front();
      ++n;
    }
    return n;
  }

  // Non-blocking: number of completions ready.
  int64_t poll() {
    std::unique_lock<std::mutex> lk(mu_);
    return (int64_t)done_.size();
  }

  int64_t inflight() {
    std::unique_lock<std::mutex> lk(mu_);
    return inflight_;
  }

 private:
  void worker_loop() {
    for (;;) {
      Request req;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !pending_.empty(); });
        if (stop_ && pending_.empty()) return;
        req = pending_.front();
        pending_.pop_front();
      }
      int64_t result = run(req);
      {
        std::unique_lock<std::mutex> lk(mu_);
        done_.push_back(Completion{req.id, result});
        --inflight_;
      }
      done_cv_.notify_all();
    }
  }

  static int64_t run(const Request& req) {
    int flags = req.is_read ? O_RDONLY : (O_WRONLY | O_CREAT);
    int fd = ::open(req.path.c_str(), flags, 0644);
    if (fd < 0) return -errno;
    int64_t total = 0;
    char* buf = static_cast<char*>(req.buffer);
    while (total < req.nbytes) {
      ssize_t n = req.is_read
          ? ::pread(fd, buf + total, req.nbytes - total, req.offset + total)
          : ::pwrite(fd, buf + total, req.nbytes - total, req.offset + total);
      if (n < 0) {
        ::close(fd);
        return -errno;
      }
      if (n == 0) break;  // EOF
      total += n;
    }
    // caller-requested truncation: drop any stale tail beyond this write
    // (an explicit flag, not inferred from offset — inferring from offset==0
    // would race with concurrent chunk writes to other offsets of the file)
    if (!req.is_read && req.trunc) {
      if (::ftruncate(fd, req.offset + total) != 0) {
        int64_t err = -errno;
        ::close(fd);
        return err;
      }
    }
    ::close(fd);
    return total;
  }

  int queue_depth_;
  bool stop_;
  int64_t inflight_;
  int64_t next_id_ = 1;
  std::deque<Request> pending_;
  std::deque<Completion> done_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
};

}  // namespace

extern "C" {

void* ds_aio_create(int n_threads, int queue_depth) {
  return new AioEngine(n_threads, queue_depth);
}

void ds_aio_destroy(void* h) { delete static_cast<AioEngine*>(h); }

int64_t ds_aio_pread(void* h, const char* path, void* buf, int64_t nbytes,
                     int64_t offset) {
  return static_cast<AioEngine*>(h)->submit(true, path, buf, nbytes, offset);
}

int64_t ds_aio_pwrite(void* h, const char* path, void* buf, int64_t nbytes,
                      int64_t offset) {
  return static_cast<AioEngine*>(h)->submit(false, path, buf, nbytes, offset);
}

// write + truncate-to-end: for whole-file rewrites that must not leave a
// stale tail when the new contents are shorter than the old file
int64_t ds_aio_pwrite_trunc(void* h, const char* path, void* buf,
                            int64_t nbytes, int64_t offset) {
  return static_cast<AioEngine*>(h)->submit(false, path, buf, nbytes, offset,
                                            /*trunc=*/true);
}

int64_t ds_aio_wait(void* h, int64_t count, int64_t* ids, int64_t* results) {
  return static_cast<AioEngine*>(h)->wait(count, ids, results);
}

int64_t ds_aio_poll(void* h) { return static_cast<AioEngine*>(h)->poll(); }

int64_t ds_aio_inflight(void* h) {
  return static_cast<AioEngine*>(h)->inflight();
}

}  // extern "C"
