// Host-side packing kernels for ppca_rs_tpu.
//
// Equivalent of the reference's native data layer
// (ppca/src/dataset.rs MaskedSample::mask_non_finite and the DataFrame
// adapter's dense-array population): the device handles all math via
// XLA/Pallas, so the native layer's job is to get host data into dense
// (values, mask) form at memory bandwidth, multithreaded.

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline int n_workers(int64_t n, int64_t grain) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  int64_t by_grain = n / grain;
  if (by_grain < 1) by_grain = 1;
  return static_cast<int>(std::min<int64_t>(hw, by_grain));
}

template <typename F>
void parallel_for(int64_t n, int64_t grain, F&& body) {
  int workers = n_workers(n, grain);
  if (workers <= 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(workers);
  int64_t chunk = (n + workers - 1) / workers;
  for (int t = 0; t < workers; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([lo, hi, &body] { body(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// One fused pass: filled[i] = finite(in[i]) ? in[i] : 0; mask[i] = finite.
void ppca_mask_non_finite_f64(const double* in, double* filled, bool* mask,
                              int64_t n) {
  parallel_for(n, 1 << 16, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double v = in[i];
      bool finite = std::isfinite(v);
      mask[i] = finite;
      filled[i] = finite ? v : 0.0;
    }
  });
}

// Scatter long-format triplets into a dense row-major (n_samples, n_dims)
// array (pre-filled with NaN by the caller).  Sequential on purpose:
// duplicate (sample, dim) pairs must resolve deterministically last-wins
// (matching numpy fancy assignment); parallel writes to the same element
// would be a data race.  The pass is memory-bound either way.
void ppca_scatter_long_f64(const int64_t* sample_idx, const int64_t* dim_idx,
                           const double* values, int64_t n, double* out,
                           int64_t n_dims) {
  for (int64_t i = 0; i < n; ++i) {
    out[sample_idx[i] * n_dims + dim_idx[i]] = values[i];
  }
}

}  // extern "C"
