// Native batch assembly: multithreaded row gather.
//
// The reference delegates per-batch sample collation to torch's C++
// DataLoader worker pool (SURVEY.md §2.2, base_data_loader.py:19). Here the
// equivalent hot operation — assembling a batch by gathering rows from a
// large contiguous array — is a parallel memcpy implemented natively and
// driven from Python via ctypes (data/native/__init__.py). At ImageNet
// shapes a batch is tens of MB; single-threaded numpy fancy indexing is
// memcpy-bound on one core, while this spreads rows across threads.
//
// Build: g++ -O3 -shared -fPIC -pthread batcher.cpp -o libbatcher.so
// (compiled on demand by data/native/__init__.py into build/native/).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// dst[i, :] = src[idx[i], :] for i in [0, n_idx); rows are row_bytes wide.
// idx values must be valid row numbers of src (caller-checked).
void gather_rows(const char* src, const int64_t* idx, int64_t n_idx,
                 int64_t row_bytes, char* dst, int32_t n_threads) {
  auto work = [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
    }
  };
  if (n_threads < 1) n_threads = 1;
  // Threading only pays off past ~1 MiB of total copy.
  if (n_threads == 1 || n_idx * row_bytes < (1 << 20)) {
    work(0, n_idx);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  const int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(n_idx, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

// Fused gather + uint8->float32 + per-channel normalize:
//   dst[i, p, c] = (src[idx[i], p, c] / 255 - mean[c]) / std[c]
// for i in [0, n_idx), p pixels, c in [0, n_chan). One pass over the
// gathered bytes instead of gather-then-cast-then-normalize (three
// full-batch traversals in numpy), enabling uint8 on-disk datasets (4x
// smaller than float32) at full pipeline speed. row_elems counts uint8
// elements per row; n_chan must divide row_elems (trailing channel dim).
void gather_rows_norm_u8(const uint8_t* src, const int64_t* idx,
                         int64_t n_idx, int64_t row_elems, int64_t n_chan,
                         const float* mean, const float* stddev, float* dst,
                         int32_t n_threads) {
  // Precompute per-channel affine: x * a[c] + b[c].
  std::vector<float> a(n_chan), b(n_chan);
  for (int64_t c = 0; c < n_chan; ++c) {
    a[c] = 1.0f / (255.0f * stddev[c]);
    b[c] = -mean[c] / stddev[c];
  }
  const int64_t n_pix = row_elems / n_chan;
  auto work = [=, &a, &b](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* s = src + idx[i] * row_elems;
      float* d = dst + i * row_elems;
      for (int64_t p = 0; p < n_pix; ++p) {
        for (int64_t c = 0; c < n_chan; ++c) {
          d[p * n_chan + c] =
              static_cast<float>(s[p * n_chan + c]) * a[c] + b[c];
        }
      }
    }
  };
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || n_idx * row_elems < (1 << 20)) {
    work(0, n_idx);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  const int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(n_idx, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
