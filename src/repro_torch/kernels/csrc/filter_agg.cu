// Masked grouped aggregation over precomputed columns (plain C interface,
// loaded with ctypes).  The in-kernel-predicate form is generated per
// query by repro_torch/kernels/codegen.py around the same kernel.
#include "filter_agg.cuh"

namespace {
constexpr int kMaxVals = 16;
}

extern "C" {

int repro_agg_blocks(long long n) { return repro::agg_blocks(n); }

int repro_filter_agg_max_vals() { return kMaxVals; }

// `cols` is a host array of `n_vals` device pointers to float32[n].
int repro_filter_agg(const uint8_t* mask, const int* gidx,
                     const float* const* cols, int n_vals, long long n,
                     int G, int nb, float* part_sums, int* part_counts,
                     int* part_total, float* sums, int* counts, int* total,
                     cudaStream_t stream) {
  if (n_vals < 0 || n_vals > kMaxVals) return (int)cudaErrorInvalidValue;
  repro::ColumnSource<kMaxVals> src{};
  src.mask = mask;
  src.gidx = gidx;
  for (int k = 0; k < n_vals; ++k) src.cols[k] = cols[k];
  src.n_vals = n_vals;
  return repro::launch_agg<repro::ColumnSource<kMaxVals>, kMaxVals>(
      src, n, G, n_vals, nb, part_sums, part_counts, part_total, sums,
      counts, total, nullptr, stream);
}

}  // extern "C"
