// hyslam_rt: the host runtime of the threaded pipeline (counterpart of
// hyslam_tpu/native/hyslam_rt.cpp, the same C ABI).
//
// The reference's inter-thread runtime is a C++ ThreadSafeQueue template
// (src/util/ThreadSafeQueue.h) plus the MainThreadsStatus flag block of
// mutex-guarded stop/release/interrupt/accepting flags
// (src/main/InterThread.h:37-95). This library provides the same
// primitives as a C ABI consumed from Python via ctypes: queues carry
// opaque uint64 handles (the Python side keeps a registry mapping handles
// to frame payloads), and a blocked push or pop waits in C++ with the GIL
// released. It is host code: nothing here touches the card.
//
// Built at first use by hyslam_tpu_torch/runtime/native.py:
//   g++ -O2 -shared -fPIC -std=c++17 -o libhyslam_rt.so hyslam_rt.cpp -lpthread

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>

extern "C" {

// ---------------------------------------------------------------------------
// bounded blocking queue of uint64 handles (ThreadSafeQueue analog)
// ---------------------------------------------------------------------------

struct HQueue {
  std::mutex m;
  std::condition_variable cv_push;
  std::condition_variable cv_pop;
  std::deque<uint64_t> items;
  size_t capacity;
  bool closed = false;
};

void* hq_create(size_t capacity) {
  auto* q = new HQueue();
  q->capacity = capacity == 0 ? SIZE_MAX : capacity;
  return q;
}

// push with backpressure: blocks while full (the caller-side spin at
// System.cc:194 "while tracking_queue.size() > 2"). timeout_ms < 0 = wait
// forever. Returns 1 on success, 0 on timeout/closed.
int hq_push(void* qp, uint64_t item, long timeout_ms) {
  auto* q = static_cast<HQueue*>(qp);
  std::unique_lock<std::mutex> lk(q->m);
  auto pred = [q] { return q->closed || q->items.size() < q->capacity; };
  if (timeout_ms < 0) {
    q->cv_push.wait(lk, pred);
  } else if (!q->cv_push.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                  pred)) {
    return 0;
  }
  if (q->closed) return 0;
  q->items.push_back(item);
  q->cv_pop.notify_one();
  return 1;
}

// pop: blocks until an item or close. Returns 1 on success.
int hq_pop(void* qp, uint64_t* out, long timeout_ms) {
  auto* q = static_cast<HQueue*>(qp);
  std::unique_lock<std::mutex> lk(q->m);
  auto pred = [q] { return q->closed || !q->items.empty(); };
  if (timeout_ms < 0) {
    q->cv_pop.wait(lk, pred);
  } else if (!q->cv_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                 pred)) {
    return 0;
  }
  if (q->items.empty()) return 0;  // closed and drained
  *out = q->items.front();
  q->items.pop_front();
  q->cv_push.notify_one();
  return 1;
}

size_t hq_size(void* qp) {
  auto* q = static_cast<HQueue*>(qp);
  std::lock_guard<std::mutex> lk(q->m);
  return q->items.size();
}

// drop all queued items, returning how many were dropped (the mapping
// thread's overflow clearing, Mapping.cpp:285-304). Dropped handles are
// written to `dropped` (caller-sized >= capacity) so Python can release them.
size_t hq_clear(void* qp, uint64_t* dropped, size_t max_out) {
  auto* q = static_cast<HQueue*>(qp);
  std::lock_guard<std::mutex> lk(q->m);
  size_t n = 0;
  while (!q->items.empty() && n < max_out) {
    dropped[n++] = q->items.front();
    q->items.pop_front();
  }
  q->cv_push.notify_all();
  return n;
}

void hq_close(void* qp) {
  auto* q = static_cast<HQueue*>(qp);
  std::lock_guard<std::mutex> lk(q->m);
  q->closed = true;
  q->cv_pop.notify_all();
  q->cv_push.notify_all();
}

void hq_destroy(void* qp) { delete static_cast<HQueue*>(qp); }

// ---------------------------------------------------------------------------
// thread status flag block (InterThread.h ThreadStatus analog)
// ---------------------------------------------------------------------------

struct HStatus {
  std::atomic<int> stop_requested{0};
  std::atomic<int> stopped{0};
  std::atomic<int> release_requested{0};
  std::atomic<int> finish_requested{0};
  std::atomic<int> finished{0};
  std::atomic<int> interrupt_requested{0};
  std::atomic<int> accepting_input{1};
  std::atomic<int> queue_length{0};
};

void* hs_create() { return new HStatus(); }
void hs_destroy(void* s) { delete static_cast<HStatus*>(s); }

#define FLAG(name)                                                       \
  void hs_set_##name(void* s, int v) {                                   \
    static_cast<HStatus*>(s)->name.store(v, std::memory_order_release);  \
  }                                                                      \
  int hs_get_##name(void* s) {                                           \
    return static_cast<HStatus*>(s)->name.load(std::memory_order_acquire); \
  }

FLAG(stop_requested)
FLAG(stopped)
FLAG(release_requested)
FLAG(finish_requested)
FLAG(finished)
FLAG(interrupt_requested)
FLAG(accepting_input)
FLAG(queue_length)

#undef FLAG

}  // extern "C"
