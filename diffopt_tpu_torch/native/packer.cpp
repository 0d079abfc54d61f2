// Batched heterogeneous-instance packer: the host-side data path feeding the
// card. Scatters per-instance sparse COO triplets into padded dense batch
// slabs (the static-shaped layout the batched kernels take), multithreaded
// across instances, so that thousands of instances a step are assembled
// without a Python loop on the host.
//
// The port's own copy of diffopt_tpu/native/packer.cpp (same functions, same
// arithmetic). Built at first use by diffopt_tpu_torch/native/__init__.py:
//   g++ -O3 -march=native -fPIC -shared -std=c++17 -pthread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// Scatter COO triplets into a padded dense batch.
//   rows/cols/vals: concatenated triplets for all instances
//   nnz_offsets:    (n_instances + 1) prefix offsets into the triplet arrays
//   out:            (n_instances, max_rows, max_cols) zero-initialized by us
void pack_coo_batch(const int64_t* rows, const int64_t* cols,
                    const double* vals, const int64_t* nnz_offsets,
                    int64_t n_instances, int64_t max_rows, int64_t max_cols,
                    double* out, int n_threads) {
  const int64_t slab = max_rows * max_cols;
  std::memset(out, 0, sizeof(double) * n_instances * slab);
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double* dst = out + i * slab;
      for (int64_t k = nnz_offsets[i]; k < nnz_offsets[i + 1]; ++k) {
        dst[rows[k] * max_cols + cols[k]] += vals[k];
      }
    }
  };
  if (n_threads <= 1 || n_instances < 2) {
    work(0, n_instances);
    return;
  }
  int nt = std::min<int64_t>(n_threads, n_instances);
  std::vector<std::thread> ts;
  int64_t chunk = (n_instances + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, n_instances);
    if (lo < hi) ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

// Pack variable-length dense vectors into a padded (n_instances, max_len)
// batch with a fill value on the padding tail.
void pack_vec_batch(const double* vals, const int64_t* len_offsets,
                    int64_t n_instances, int64_t max_len, double fill,
                    double* out, int n_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double* dst = out + i * max_len;
      int64_t len = len_offsets[i + 1] - len_offsets[i];
      std::memcpy(dst, vals + len_offsets[i], sizeof(double) * len);
      std::fill(dst + len, dst + max_len, fill);
    }
  };
  if (n_threads <= 1 || n_instances < 2) {
    work(0, n_instances);
    return;
  }
  int nt = std::min<int64_t>(n_threads, n_instances);
  std::vector<std::thread> ts;
  int64_t chunk = (n_instances + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, n_instances);
    if (lo < hi) ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
