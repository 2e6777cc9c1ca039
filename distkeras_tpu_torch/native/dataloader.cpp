// Native data-path kernels for distkeras_tpu_torch (a copy of the JAX
// package's distkeras_tpu/native/dataloader.cpp).
//
// The reference's per-row Python iterators (distkeras/workers.py minibatch
// loop) have no native analogue; here the host-side hot path is epoch
// batching — permutation-gather of the full feature matrix into the
// [workers, windows, window, batch, ...] layout (distkeras_tpu_torch/data.py).
// numpy's fancy indexing is single-threaded; for CIFAR-scale epochs this
// multithreaded gather is the difference between the card waiting on the host
// and not.
//
// Built as a plain shared library (no pybind11 — loaded via ctypes) at first
// use by distkeras_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 -o libdkdata.so dataloader.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Shared chunked thread pool: calls row_op(i) for every destination row i,
// work-stealing in fixed chunks over n_threads threads.
template <typename RowOp>
void parallel_rows(int64_t n_rows, int64_t chunk, int n_threads, RowOp row_op) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next{0};
  auto work = [&] {
    for (;;) {
      int64_t start = next.fetch_add(chunk);
      if (start >= n_rows) return;
      int64_t end = start + chunk < n_rows ? start + chunk : n_rows;
      for (int64_t i = start; i < end; ++i) row_op(i);
    }
  };
  if (n_threads == 1) {
    work();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
}

// Parallel row gather: dst[i] = src[idx[i]] for rows of row_bytes bytes.
void gather_rows_impl(const uint8_t* src, const int64_t* idx, uint8_t* dst,
                      int64_t n_rows, int64_t row_bytes, int n_threads) {
  parallel_rows(n_rows, 256, n_threads, [&](int64_t i) {
    std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
  });
}

// f32 -> bf16 with round-to-nearest-even, matching ml_dtypes/XLA (so the
// fused gather+cast below is bit-identical to gather-then-astype).
inline uint16_t f32_to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof(u));
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) {        // NaN: quiet, keep sign
    return static_cast<uint16_t>((u >> 16) | 0x0040u);
  }
  uint32_t rounding_bias = 0x7FFFu + ((u >> 16) & 1u);
  return static_cast<uint16_t>((u + rounding_bias) >> 16);
}

// Fused permutation-gather + f32->bf16 cast: dst[i] = bf16(src[idx[i]]).
// One pass instead of gather-f32 (write N) then astype (read N, write N/2) —
// the host half of the streaming path's compute-dtype transfer.
void gather_rows_bf16_impl(const float* src, const int64_t* idx, uint16_t* dst,
                           int64_t n_rows, int64_t row_elems, int n_threads) {
  parallel_rows(n_rows, 64, n_threads, [&](int64_t i) {
    const float* s = src + idx[i] * row_elems;
    uint16_t* d = dst + i * row_elems;
    for (int64_t j = 0; j < row_elems; ++j) d[j] = f32_to_bf16(s[j]);
  });
}

}  // namespace

extern "C" {

// Gather rows by index. src/dst are raw buffers; row_bytes = bytes per row.
void dk_gather_rows(const void* src, const int64_t* idx, void* dst,
                    int64_t n_rows, int64_t row_bytes, int n_threads) {
  gather_rows_impl(static_cast<const uint8_t*>(src), idx,
                   static_cast<uint8_t*>(dst), n_rows, row_bytes, n_threads);
}

// Fisher-Yates shuffle of an index array with SplitMix64 (deterministic for a
// given seed — keeps the framework's reproducibility guarantee native-side).
void dk_shuffle_indices(int64_t* idx, int64_t n, uint64_t seed) {
  auto splitmix = [&seed]() {
    uint64_t z = (seed += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  };
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(splitmix() % static_cast<uint64_t>(i + 1));
    int64_t tmp = idx[i];
    idx[i] = idx[j];
    idx[j] = tmp;
  }
}

// Fused gather + f32->bf16 cast; row_elems = floats per row.
void dk_gather_rows_bf16(const void* src, const int64_t* idx, void* dst,
                         int64_t n_rows, int64_t row_elems, int n_threads) {
  gather_rows_bf16_impl(static_cast<const float*>(src), idx,
                        static_cast<uint16_t*>(dst), n_rows, row_elems,
                        n_threads);
}

int dk_version() { return 2; }

}  // extern "C"
