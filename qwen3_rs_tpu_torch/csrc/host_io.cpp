// Native host-side (de)serialization helpers — C++ counterpart of the
// reference's Rust loader hot path (qwen3-inference/src/models/qwen3.rs:199-277
// reads + the mmap cursor in utils.rs:7-59).  The Python cursor handles the
// format walking; what needs native speed is the layout change from the
// stored row-major [out, in] weight codes to the in-major [in, out] compute
// layout: for an 8B checkpoint that is ~8 GB of strided int8 swizzling, which
// a single numpy thread does at well under memcpy speed.
//
// Provides cache-blocked, multi-threaded 2D transposes (int8 codes, f32
// scales) with a batch (layer) axis.  Exposed as a C ABI consumed via ctypes
// (qwen3_rs_tpu_torch/utils/native.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// One cache-blocked transpose of src[rows, cols] -> dst[cols, rows], both
// with an elem_size of ELEM bytes, restricted to row block [r0, r1).
template <typename T>
void transpose_rows(const T* src, T* dst, int64_t rows, int64_t cols,
                    int64_t r0, int64_t r1) {
  constexpr int64_t B = 128;  // fits two BxB int8 tiles in 32K L1
  for (int64_t rb = r0; rb < r1; rb += B) {
    const int64_t rend = std::min(rb + B, r1);
    for (int64_t cb = 0; cb < cols; cb += B) {
      const int64_t cend = std::min(cb + B, cols);
      for (int64_t r = rb; r < rend; ++r) {
        const T* s = src + r * cols;
        for (int64_t c = cb; c < cend; ++c) {
          dst[c * rows + r] = s[c];
        }
      }
    }
  }
}

template <typename T>
void transpose_batched(const T* src, T* dst, int64_t batch, int64_t rows,
                       int64_t cols, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  // Parallelize over (batch x row-chunks): each task transposes a slab of
  // rows from one batch element into the right offset of dst.
  const int64_t plane = rows * cols;
  const int64_t chunk = std::max<int64_t>(128, (rows + n_threads - 1) / n_threads);
  struct Task {
    int64_t b, r0, r1;
  };
  std::vector<Task> tasks;
  for (int64_t b = 0; b < batch; ++b) {
    for (int64_t r = 0; r < rows; r += chunk) {
      tasks.push_back({b, r, std::min(r + chunk, rows)});
    }
  }
  std::vector<std::thread> pool;
  std::atomic<size_t> next{0};
  auto worker = [&] {
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= tasks.size()) return;
      const Task& t = tasks[i];
      transpose_rows(src + t.b * plane, dst + t.b * plane, rows, cols, t.r0,
                     t.r1);
    }
  };
  const int n = std::min<int>(n_threads, static_cast<int>(tasks.size()));
  pool.reserve(n);
  for (int i = 1; i < n; ++i) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Transpose src[batch, rows, cols] -> dst[batch, cols, rows] for int8 weight
// codes.  n_threads <= 0 means hardware concurrency.
void transpose_i8(const int8_t* src, int8_t* dst, int64_t batch, int64_t rows,
                  int64_t cols, int32_t n_threads) {
  transpose_batched(src, dst, batch, rows, cols, n_threads);
}

// Same for f32 (per-group scales).
void transpose_f32(const float* src, float* dst, int64_t batch, int64_t rows,
                   int64_t cols, int32_t n_threads) {
  transpose_batched(src, dst, batch, rows, cols, n_threads);
}

}  // extern "C"
