// megatts2_tpu_torch native data loader (a copy of native/dataloader.cpp,
// the JAX package's, kept in the port so that it builds and loads its own).
//
// The reference's data path is lhotse HDF5 reads through a per-batch
// ThreadPoolExecutor (modules/datamodule.py:88-90) inside torch DataLoader
// worker processes.  This library replaces that stack with a zero-copy
// mmap'd shard reader and a multi-threaded padded-batch filler, exposed
// through a plain C ABI consumed via ctypes (see
// megatts2_tpu_torch/data/native_loader.py).
//
// Responsibilities:
//   * open/close mmap'd feature shards (float16/float32, frames x dim)
//   * fill_batch: gather N (offset, len) slices into a zero-padded
//     (N, T, dim) float32 batch, converting f16->f32, parallelized across
//     items with a persistent worker pool
//   * prefetcher: a bounded ring of batch buffers filled by a background
//     thread so the accelerator never waits on host IO
//
// Build: at first use, by megatts2_tpu_torch/data/native_loader.py
//   (g++ -O3 -std=c++17 -fPIC -shared -pthread; no external deps)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---- half -> float conversion (portable bit twiddling) ---------------------
static inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {        // subnormal: normalize
      int shift = 0;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      // value = 1.mant * 2^(-14 - shift)  →  biased exp = 127 - 14 - shift
      bits = sign | ((uint32_t)(127 - 14 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 0x1Fu) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf/nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, sizeof(f));
  return f;
}

struct Shard {
  void* base = nullptr;
  size_t bytes = 0;
  int64_t frames = 0;
  int32_t dim = 0;
  int32_t dtype = 0;  // 0 = f32, 1 = f16
};

// ---- simple worker pool ----------------------------------------------------
class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      threads_.emplace_back([this] { worker(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  void run(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      q_.push_back(std::move(f));
    }
    cv_.notify_one();
  }
  void wait_all() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return q_.empty() && active_ == 0; });
  }

 private:
  void worker() {
    for (;;) {
      std::function<void()> f;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        f = std::move(q_.front());
        q_.pop_front();
        ++active_;
      }
      f();
      {
        std::lock_guard<std::mutex> lk(mu_);
        --active_;
        if (q_.empty() && active_ == 0) done_cv_.notify_all();
      }
    }
  }
  std::vector<std::thread> threads_;
  std::deque<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  bool stop_;
  int active_ = 0;
};

Pool& pool() {
  static Pool p(std::max(2u, std::thread::hardware_concurrency()));
  return p;
}

void copy_item(const Shard* s, int64_t offset, int32_t len, int32_t T,
               float* out_item) {
  const int32_t dim = s->dim;
  if (s->dtype == 0) {
    const float* src = (const float*)s->base + (size_t)offset * dim;
    std::memcpy(out_item, src, (size_t)len * dim * sizeof(float));
  } else {
    const uint16_t* src = (const uint16_t*)s->base + (size_t)offset * dim;
    size_t n = (size_t)len * dim;
    for (size_t i = 0; i < n; ++i) out_item[i] = half_to_float(src[i]);
  }
  // zero padding tail
  if (T > len)
    std::memset(out_item + (size_t)len * dim, 0,
                (size_t)(T - len) * dim * sizeof(float));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16
void* mtl_open_shard(const char* path, int64_t frames, int32_t dim,
                     int32_t dtype) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  size_t elem = dtype == 0 ? 4 : 2;
  size_t bytes = (size_t)frames * dim * elem;
  void* base = ::mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) return nullptr;
  ::madvise(base, bytes, MADV_WILLNEED);
  Shard* s = new Shard{base, bytes, frames, dim, dtype};
  return s;
}

void mtl_close_shard(void* handle) {
  Shard* s = (Shard*)handle;
  if (!s) return;
  ::munmap(s->base, s->bytes);
  delete s;
}

// Gather n items into out (n, T, dim) float32, zero-padded, parallel.
// offsets/lens are per-item frame offsets/lengths within the shard.
int32_t mtl_fill_batch(void* handle, const int64_t* offsets,
                       const int32_t* lens, int32_t n, int32_t T,
                       float* out) {
  Shard* s = (Shard*)handle;
  if (!s) return -1;
  const int32_t dim = s->dim;
  for (int32_t b = 0; b < n; ++b) {
    if (offsets[b] + lens[b] > s->frames || lens[b] > T) return -2;
    float* dst = out + (size_t)b * T * dim;
    int64_t off = offsets[b];
    int32_t len = lens[b];
    pool().run([s, off, len, T, dst] { copy_item(s, off, len, T, dst); });
  }
  pool().wait_all();
  return 0;
}

// Concatenate k slices (offsets/lens) into out (total_T, dim) float32,
// truncated to cap frames.  Used for same-speaker timbre-mel assembly.
int32_t mtl_concat_slices(void* handle, const int64_t* offsets,
                          const int32_t* lens, int32_t k, int32_t cap,
                          float* out) {
  Shard* s = (Shard*)handle;
  if (!s) return -1;
  int32_t written = 0;
  for (int32_t i = 0; i < k && written < cap; ++i) {
    int32_t take = std::min(lens[i], cap - written);
    if (offsets[i] + take > s->frames) return -2;
    copy_item(s, offsets[i], take, take, out + (size_t)written * s->dim);
    written += take;
  }
  return written;
}

}  // extern "C"

// ---- async prefetch ring ---------------------------------------------------
//
// A bounded ring of preallocated batch buffers.  mtl_ring_submit enqueues a
// padded-batch gather (same semantics as mtl_fill_batch) that the worker
// pool fills asynchronously — the caller overlaps Python-side batch
// assembly (timbre concat, token collation) with the copy/f16-convert work,
// then blocks in mtl_ring_wait only if the fill is still in flight.
// Tickets are slot indices; a slot is reusable after mtl_ring_release.

namespace {

struct RingSlot {
  std::vector<float> buf;
  std::vector<int64_t> offsets;
  std::vector<int32_t> lens;
  std::atomic<int32_t> remaining{0};
  bool busy = false;  // guarded by Ring::mu
  int32_t rc = 0;
};

struct Ring {
  std::vector<RingSlot> slots;
  std::mutex mu;
  std::condition_variable cv;
  explicit Ring(int32_t n, size_t max_floats) : slots(n) {
    for (auto& s : slots) s.buf.resize(max_floats);
  }
};

}  // namespace

extern "C" {

void* mtl_ring_create(int32_t n_slots, int64_t max_floats) {
  if (n_slots < 1 || max_floats < 1) return nullptr;
  return new Ring(n_slots, (size_t)max_floats);
}

void mtl_ring_destroy(void* rh) {
  Ring* r = (Ring*)rh;
  if (!r) return;
  {  // drain: wait for all in-flight fills before freeing buffers
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv.wait(lk, [r] {
      for (auto& s : r->slots)
        if (s.busy && s.remaining.load() != 0) return false;
      return true;
    });
  }
  delete r;
}

// Submit an async padded-batch gather into a free slot.  Returns the slot
// ticket (>=0), or -1 if every slot is busy (caller: wait+release one), or
// -2 on validation error.
int32_t mtl_ring_submit(void* rh, void* shard_handle, const int64_t* offsets,
                        const int32_t* lens, int32_t n, int32_t T) {
  Ring* r = (Ring*)rh;
  Shard* s = (Shard*)shard_handle;
  if (!r || !s) return -2;
  const int32_t dim = s->dim;
  if ((size_t)n * T * dim > r->slots[0].buf.size()) return -2;
  for (int32_t b = 0; b < n; ++b)
    if (offsets[b] + lens[b] > s->frames || lens[b] > T) return -2;

  int32_t ticket = -1;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    for (int32_t i = 0; i < (int32_t)r->slots.size(); ++i) {
      if (!r->slots[i].busy) {
        ticket = i;
        r->slots[i].busy = true;
        break;
      }
    }
  }
  if (ticket < 0) return -1;

  RingSlot& slot = r->slots[ticket];
  slot.offsets.assign(offsets, offsets + n);  // job owns its index arrays
  slot.lens.assign(lens, lens + n);
  slot.rc = 0;
  slot.remaining.store(n, std::memory_order_release);
  for (int32_t b = 0; b < n; ++b) {
    float* dst = slot.buf.data() + (size_t)b * T * dim;
    Ring* rp = r;
    RingSlot* sp = &slot;
    int32_t bb = b;
    pool().run([s, sp, rp, bb, T, dst] {
      copy_item(s, sp->offsets[bb], sp->lens[bb], T, dst);
      if (sp->remaining.fetch_sub(1, std::memory_order_acq_rel) == 1) {
        std::lock_guard<std::mutex> lk(rp->mu);
        rp->cv.notify_all();
      }
    });
  }
  return ticket;
}

// Block until the ticket's fill completes; returns the buffer pointer
// (valid until mtl_ring_release of the same ticket), or NULL on bad ticket.
float* mtl_ring_wait(void* rh, int32_t ticket) {
  Ring* r = (Ring*)rh;
  if (!r || ticket < 0 || ticket >= (int32_t)r->slots.size()) return nullptr;
  RingSlot& slot = r->slots[ticket];
  std::unique_lock<std::mutex> lk(r->mu);
  if (!slot.busy) return nullptr;
  r->cv.wait(lk, [&slot] { return slot.remaining.load(std::memory_order_acquire) == 0; });
  return slot.buf.data();
}

void mtl_ring_release(void* rh, int32_t ticket) {
  Ring* r = (Ring*)rh;
  if (!r || ticket < 0 || ticket >= (int32_t)r->slots.size()) return;
  std::lock_guard<std::mutex> lk(r->mu);
  r->slots[ticket].busy = false;
}

int32_t mtl_version() { return 2; }
}
