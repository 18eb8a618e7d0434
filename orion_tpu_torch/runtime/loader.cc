// Native host-side data loader.
//
// The native layer's job is the host hot path: mmap the token-bin file,
// gather shuffled windows into a pinned int32 batch buffer with a worker-thread pool, and hand numpy a
// ready array through ctypes (which releases the GIL for the whole call).
//
// Determinism contract: window starts are splitmix64(seed ^ step*C1 ^
// row*C2) % n_windows — bit-for-bit the same stream as the Python fallback
// (training/data.py::window_starts), so checkpoints resume onto
// identical batches regardless of which loader produced them.
//
// Built with g++ by runtime/__init__.py (plain C ABI for ctypes).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kGamma = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kM1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kM2 = 0x94D049BB133111EBull;
constexpr uint64_t kStepMix = 0xD1B54A32D192ED03ull;
constexpr uint64_t kRowMix = 0x8CB92BA72F3D8DD7ull;

inline uint64_t splitmix64(uint64_t x) {
  uint64_t z = x + kGamma;
  z = (z ^ (z >> 30)) * kM1;
  z = (z ^ (z >> 27)) * kM2;
  return z ^ (z >> 31);
}

struct Loader {
  const uint8_t* data = nullptr;
  size_t file_bytes = 0;
  int64_t n_tokens = 0;
  int itemsize = 2;  // uint16 or uint32 token files
  int64_t seq_len = 0;
  int64_t n_windows = 0;
  int fd = -1;
};

template <typename T>
void gather_rows(const Loader* L, const uint64_t seed, const uint64_t step,
                 int64_t row_begin, int64_t row_end, int32_t* out) {
  const T* toks = reinterpret_cast<const T*>(L->data);
  const int64_t w = L->seq_len + 1;
  for (int64_t r = row_begin; r < row_end; ++r) {
    uint64_t x = seed ^ (step * kStepMix) ^ (static_cast<uint64_t>(r) * kRowMix);
    int64_t start =
        static_cast<int64_t>(splitmix64(x) % static_cast<uint64_t>(L->n_windows));
    int32_t* dst = out + r * w;
    const T* src = toks + start;
    for (int64_t j = 0; j < w; ++j) dst[j] = static_cast<int32_t>(src[j]);
  }
}

template <typename T>
void gather_explicit(const Loader* L, const int64_t* starts, int64_t row_begin,
                     int64_t row_end, int32_t* out) {
  const T* toks = reinterpret_cast<const T*>(L->data);
  const int64_t w = L->seq_len + 1;
  for (int64_t r = row_begin; r < row_end; ++r) {
    int32_t* dst = out + r * w;
    const T* src = toks + starts[r];
    for (int64_t j = 0; j < w; ++j) dst[j] = static_cast<int32_t>(src[j]);
  }
}

}  // namespace

extern "C" {

// Returns an opaque handle, or nullptr on failure.
void* orion_loader_open(const char* path, int64_t seq_len, int itemsize) {
  if (itemsize != 2 && itemsize != 4) return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(map, st.st_size, MADV_RANDOM);
  auto* L = new Loader;
  L->data = static_cast<const uint8_t*>(map);
  L->file_bytes = st.st_size;
  L->itemsize = itemsize;
  L->n_tokens = st.st_size / itemsize;
  L->seq_len = seq_len;
  L->n_windows = L->n_tokens - seq_len - 1;
  L->fd = fd;
  if (L->n_windows <= 0) {
    munmap(map, st.st_size);
    ::close(fd);
    delete L;
    return nullptr;
  }
  return L;
}

int64_t orion_loader_n_tokens(void* handle) {
  return static_cast<Loader*>(handle)->n_tokens;
}

// Fill out[batch, seq_len+1] (int32, row-major). Multi-threaded gather.
void orion_loader_batch(void* handle, uint64_t seed, uint64_t step,
                        int64_t batch, int32_t* out, int n_threads) {
  auto* L = static_cast<Loader*>(handle);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > batch) n_threads = static_cast<int>(batch);
  auto run = [&](int64_t lo, int64_t hi) {
    if (L->itemsize == 2) {
      gather_rows<uint16_t>(L, seed, step, lo, hi, out);
    } else {
      gather_rows<uint32_t>(L, seed, step, lo, hi, out);
    }
  };
  if (n_threads == 1) {
    run(0, batch);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(batch, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(run, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// Fill out[n_rows, seq_len+1] from caller-provided window starts (the
// sharded-dataset path: the global window -> (shard, local start) mapping
// lives in Python — training/data.py::ShardedTokenBinDataset — and each
// shard's rows arrive here as explicit local offsets).
void orion_loader_gather(void* handle, const int64_t* starts, int64_t n_rows,
                         int32_t* out, int n_threads) {
  auto* L = static_cast<Loader*>(handle);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_rows) n_threads = static_cast<int>(n_rows);
  auto run = [&](int64_t lo, int64_t hi) {
    if (L->itemsize == 2) {
      gather_explicit<uint16_t>(L, starts, lo, hi, out);
    } else {
      gather_explicit<uint32_t>(L, starts, lo, hi, out);
    }
  };
  if (n_threads <= 1) {
    run(0, n_rows);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(n_rows, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(run, lo, hi);
  }
  for (auto& t : ts) t.join();
}

void orion_loader_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  munmap(const_cast<uint8_t*>(L->data), L->file_bytes);
  ::close(L->fd);
  delete L;
}

}  // extern "C"
