// Native data loader for forward-KL (MLE) flow training.
//
// Native equivalent of the dataloader the reference left as a TODO
// (`src/objectives/loglikelihood.jl:35-43`): the host side of the input
// pipeline must keep the device fed without stealing Python-thread time from the
// dispatch loop. This library mmaps a raw float32 row-major (n_rows, dim)
// file, draws per-epoch shuffled minibatches, and materializes them into a
// ring of prefetch buffers from a background thread pool; the Python side
// (normalizingflows/jl_tpu/utils/data.py, via ctypes) hands zero-copy numpy
// views to jax.device_put.
//
// C ABI:
//   dl_open(path, n_rows, dim, batch, seed, n_prefetch) -> handle (or -1)
//   dl_next(handle) -> const float* (blocks until a batch is ready)
//   dl_release(handle, ptr)      return the buffer to the ring
//   dl_epoch(handle) -> int64    epochs completed
//   dl_close(handle)
//
// Shuffling: Fisher–Yates over a row-index permutation per epoch
// (xoshiro256** PRNG), re-shuffled by the producer thread at epoch ends.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Xoshiro {
  uint64_t s[4];
  explicit Xoshiro(uint64_t seed) {
    // splitmix64 init
    uint64_t z = seed;
    for (int i = 0; i < 4; i++) {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t t = z;
      t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
      t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
      s[i] = t ^ (t >> 31);
    }
  }
  static uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) {
    __uint128_t m = (__uint128_t)next() * n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = (-n) % n;
      while (l < t) {
        m = (__uint128_t)next() * n;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

struct Loader {
  const float* data = nullptr;  // mmapped (n_rows, dim)
  size_t map_len = 0;
  int fd = -1;
  int64_t n_rows = 0, dim = 0, batch = 0;
  std::vector<int64_t> perm;
  int64_t cursor = 0;  // next row within the permutation
  Xoshiro rng;
  std::atomic<int64_t> epoch{0};

  // prefetch ring
  std::vector<std::vector<float>> buffers;
  std::queue<float*> free_q;    // buffers ready to be filled
  std::queue<float*> ready_q;   // filled batches
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::thread producer;
  std::atomic<bool> stop{false};

  explicit Loader(uint64_t seed) : rng(seed) {}

  void shuffle() {
    for (int64_t i = n_rows - 1; i > 0; i--) {
      int64_t j = (int64_t)rng.bounded((uint64_t)(i + 1));
      std::swap(perm[i], perm[j]);
    }
  }

  void fill(float* out) {
    for (int64_t b = 0; b < batch; b++) {
      if (cursor >= n_rows) {
        cursor = 0;
        epoch.fetch_add(1);
        shuffle();
      }
      const float* src = data + perm[cursor] * dim;
      std::memcpy(out + b * dim, src, sizeof(float) * (size_t)dim);
      cursor++;
    }
  }

  void produce_loop() {
    while (!stop.load()) {
      float* buf;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_q.empty(); });
        if (stop.load()) return;
        buf = free_q.front();
        free_q.pop();
      }
      fill(buf);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready_q.push(buf);
      }
      cv_ready.notify_one();
    }
  }
};

std::mutex g_mu;
std::vector<Loader*> g_loaders;

}  // namespace

extern "C" {

int64_t dl_open(const char* path, int64_t n_rows, int64_t dim,
                int64_t batch, uint64_t seed, int64_t n_prefetch) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  size_t need = sizeof(float) * (size_t)n_rows * (size_t)dim;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < need) {
    close(fd);
    return -1;
  }
  void* p = mmap(nullptr, need, PROT_READ, MAP_PRIVATE, fd, 0);
  if (p == MAP_FAILED) {
    close(fd);
    return -1;
  }
  madvise(p, need, MADV_WILLNEED);

  auto* L = new Loader(seed);
  L->data = (const float*)p;
  L->map_len = need;
  L->fd = fd;
  L->n_rows = n_rows;
  L->dim = dim;
  L->batch = batch;
  L->perm.resize(n_rows);
  for (int64_t i = 0; i < n_rows; i++) L->perm[i] = i;
  L->shuffle();
  if (n_prefetch < 2) n_prefetch = 2;
  L->buffers.resize(n_prefetch);
  for (auto& b : L->buffers) {
    b.resize((size_t)batch * (size_t)dim);
    L->free_q.push(b.data());
  }
  L->producer = std::thread([L] { L->produce_loop(); });

  std::lock_guard<std::mutex> lk(g_mu);
  g_loaders.push_back(L);
  return (int64_t)(g_loaders.size() - 1);
}

const float* dl_next(int64_t handle) {
  Loader* L;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (handle < 0 || handle >= (int64_t)g_loaders.size()) return nullptr;
    L = g_loaders[handle];
  }
  if (!L) return nullptr;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] { return !L->ready_q.empty(); });
  float* buf = L->ready_q.front();
  L->ready_q.pop();
  return buf;
}

void dl_release(int64_t handle, const float* ptr) {
  Loader* L;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (handle < 0 || handle >= (int64_t)g_loaders.size()) return;
    L = g_loaders[handle];
  }
  if (!L) return;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_q.push(const_cast<float*>(ptr));
  }
  L->cv_free.notify_one();
}

int64_t dl_epoch(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (handle < 0 || handle >= (int64_t)g_loaders.size()) return -1;
  Loader* L = g_loaders[handle];
  return L ? L->epoch.load() : -1;
}

void dl_close(int64_t handle) {
  Loader* L;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (handle < 0 || handle >= (int64_t)g_loaders.size()) return;
    L = g_loaders[handle];
    g_loaders[handle] = nullptr;
  }
  if (!L) return;
  L->stop.store(true);
  L->cv_free.notify_all();
  L->producer.join();
  munmap((void*)L->data, L->map_len);
  close(L->fd);
  delete L;
}

}  // extern "C"
