// Masked grouped aggregation over precomputed columns (plain C interface,
// loaded with ctypes).  The in-kernel-predicate form is generated per
// query by repro_torch/kernels/codegen.py around the same kernels.
#include "filter_agg.cuh"

namespace {
constexpr int kMaxVals = 16;
}

extern "C" {

int repro_agg_blocks(long long n, int G, int A) {
  return repro::agg_blocks(n, G, A);
}

int repro_filter_agg_max_vals() { return kMaxVals; }

// `cols` is a host array of `n_vals` device pointers to float32[n]; `ws`,
// `out` and `ticket` as filter_agg.cuh describes them.
int repro_filter_agg(const uint8_t* mask, const int* gidx,
                     const float* const* cols, int n_vals, long long n,
                     int G, int nb, int* ws, int* out, int* ticket,
                     cudaStream_t stream) {
  if (n_vals < 0 || n_vals > kMaxVals) return (int)cudaErrorInvalidValue;
  repro::ColumnSource<kMaxVals> src{};
  src.mask = mask;
  src.gidx = gidx;
  for (int k = 0; k < n_vals; ++k) src.cols[k] = cols[k];
  src.n_vals = n_vals;
  return repro::launch_agg<repro::ColumnSource<kMaxVals>, kMaxVals>(
      src, n, G, n_vals, nb, ws, out, ticket, nullptr, stream);
}

// B bindings (filter_agg.cuh's binding axis): each operand's binding
// stride in elements (0: shared), `ws` B x nb partial rows, `out` B result
// rows `out_row` words apart, `ticket` B tickets at 0.
int repro_filter_agg_batched(const uint8_t* mask, long long mask_stride,
                             const int* gidx, long long gidx_stride,
                             const float* const* cols,
                             const long long* col_strides, int n_vals, int B,
                             long long n, int G, int nb, int* ws, int* out,
                             long long out_row, int* ticket,
                             cudaStream_t stream) {
  if (n_vals < 0 || n_vals > kMaxVals) return (int)cudaErrorInvalidValue;
  repro::ColumnBatch<kMaxVals> bind{};
  bind.base.mask = mask;
  bind.base.gidx = gidx;
  bind.base.n_vals = n_vals;
  bind.mask_stride = mask_stride;
  bind.gidx_stride = gidx_stride;
  for (int k = 0; k < n_vals; ++k) {
    bind.base.cols[k] = cols[k];
    bind.col_stride[k] = col_strides[k];
  }
  return repro::launch_agg_batch<repro::ColumnBatch<kMaxVals>, kMaxVals>(
      bind, B, n, G, n_vals, nb, ws, out, out_row, ticket, nullptr, stream);
}

// The same in the staged register regime (filter_agg.cuh's
// launch_columns_staged): the group index and the value columns shared
// (stride 0), contiguous and 16-byte aligned, the mask shared or batched;
// C blocks a cluster; `ws` B x repro_filter_agg_staged_rows(nb, G, A)
// rows.
int repro_filter_agg_batched_staged(const uint8_t* mask,
                                    long long mask_stride, const int* gidx,
                                    const float* const* cols, int n_vals,
                                    int B, int C, long long n, int G, int nb,
                                    int* ws, int* out, long long out_row,
                                    int* ticket, cudaStream_t stream) {
  if (n_vals < 0 || n_vals > kMaxVals) return (int)cudaErrorInvalidValue;
  repro::ColumnBatch<kMaxVals> bind{};
  bind.base.mask = mask;
  bind.base.gidx = gidx;
  bind.base.n_vals = n_vals;
  bind.mask_stride = mask_stride;
  for (int k = 0; k < n_vals; ++k) bind.base.cols[k] = cols[k];
  return repro::launch_columns_staged<kMaxVals>(bind, B, C, n, G, n_vals, nb,
                                                ws, out, out_row, ticket,
                                                stream);
}

int repro_filter_agg_staged_rows(int nb, int G, int n_vals, int* out) {
  return repro::columns_staged_rows<kMaxVals>(nb, G, n_vals, out);
}

// staged_info (filter_agg.cuh) of the instance (G, n_vals) takes.
int repro_filter_agg_staged_info(int B, int C, int G, int n_vals,
                                 int* out) {
  return repro::columns_staged_info<kMaxVals>(B, C, G, n_vals, out);
}

}  // extern "C"
