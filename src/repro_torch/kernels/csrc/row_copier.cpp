// A row copier: one native worker thread that copies clients' images into the
// serving tier's pinned rows, in the order the copies were asked for.
//
// row_copier_copy() only enqueues a copy and returns; it is called with the
// interpreter's lock held (KEEP_LOCK in _build.py), so a submitting thread
// neither spends the copy nor hands the lock over for it.  The worker clears
// nothing: the caller sets a row's flag to 0 before asking, the worker stores
// 1 (release) once the row holds the image.  row_copier_wait() spins,
// yielding, until a flag reads 1 (acquire); it is called without the
// interpreter's lock.  row_copier_free() lets the worker finish what is
// queued, then joins it.  The worker is named "row-copier".
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <pthread.h>
#include <thread>

namespace {

struct Job {
  void* dst;
  const void* src;
  size_t bytes;
  int32_t* flag;
};

struct Copier {
  std::mutex lock;
  std::condition_variable wake;
  std::deque<Job> queue;
  bool stopping = false;
  std::thread worker;

  Copier() : worker([this] { run(); }) {
    pthread_setname_np(worker.native_handle(), "row-copier");
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> held(lock);
        wake.wait(held, [this] { return stopping || !queue.empty(); });
        if (queue.empty()) return;
        job = queue.front();
        queue.pop_front();
      }
      std::memcpy(job.dst, job.src, job.bytes);
      __atomic_store_n(job.flag, 1, __ATOMIC_RELEASE);
    }
  }
};

}  // namespace

extern "C" {

void* row_copier_new() { return new Copier(); }

void row_copier_free(void* copier) {
  auto* c = static_cast<Copier*>(copier);
  {
    std::lock_guard<std::mutex> held(c->lock);
    c->stopping = true;
  }
  c->wake.notify_one();
  c->worker.join();
  delete c;
}

void row_copier_copy(void* copier, void* dst, const void* src, size_t bytes, int32_t* flag) {
  auto* c = static_cast<Copier*>(copier);
  {
    std::lock_guard<std::mutex> held(c->lock);
    c->queue.push_back(Job{dst, src, bytes, flag});
  }
  c->wake.notify_one();
}

void row_copier_wait(const int32_t* flag) {
  while (!__atomic_load_n(flag, __ATOMIC_ACQUIRE)) std::this_thread::yield();
}

}  // extern "C"
