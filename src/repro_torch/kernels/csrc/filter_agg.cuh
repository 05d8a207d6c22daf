// Masked grouped aggregation: per group g, the sum of every value column
// over the rows where the predicate holds and the group index is g, the
// number of such rows, and the exact number of rows where the predicate
// holds at all.
//
// Replaces the Pallas kernels `filter_agg` (src/repro/kernels/
// filter_agg.py:58) and `selective_filter_agg` (:156).  With a compaction
// capacity, `selective_filter_agg` also emits the predicate-true row ids
// (and the key->slot vector) from its one pass; here the aggregation
// stores its predicate as one byte per row and the one-launch compaction
// of compact.cuh ranks that mask: 1 B/row written and read once more
// beyond the bound (the columns, 4 B per idx slot, 4 B/row of slot_of),
// which a ranking fused into this pass would save.  The Pallas kernel
// keeps one (G, A) accumulator resident in VMEM across a grid that runs in
// order, and adds each tile into it with a one-hot matmul on the MXU.  A
// CUDA grid has no order and no resident accumulator, so:
//
//   * each block reduces a contiguous chunk of rows into (G, A) float
//     sums and G int counts in shared memory — up to eight replicas, one
//     per warp, to spread the shared-memory atomics; G x (A + 1) words
//     must fit one block's shared memory (the wrapper raises otherwise);
//   * a thread keeps a running sum in registers while consecutive rows of
//     its stride fall into the same group and flushes it to shared memory
//     when the group changes (once per thread when G = 1);
//   * each block writes its partial (replicas summed in a fixed order),
//     and a second pass sums the partials over blocks in block order.
//     The cross-block order is fixed; the order of the shared-memory
//     atomics inside a block is not, so float sums may differ in the last
//     bits from run to run.  Counts are exact integers.
//
// Bound on the card: bytes.  The pass reads every input column once
// (mask 1 B/row, group index 4 B/row and 4 B/row per value column, or the
// columns a generated predicate and its values name) and writes G x A
// floats; the partials add 4 x (G x A + G + 1) bytes per block, which is
// small beside the columns at the engine's shapes (G <= 4096, <= 1024
// blocks).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kAggBlock = 256;
constexpr int kAggRowsPerBlock = 4096;   // fewest rows a block is given
constexpr int kAggMaxBlocks = 1024;      // partials of the second pass
constexpr int kAggMaxReplicas = 8;
constexpr size_t kAggDefaultSmem = 48 * 1024;
constexpr size_t kAggStaticSmem = 1024;      // >= the kernel's static scratch

inline int agg_blocks(long long n) {
  long long b = (n + kAggRowsPerBlock - 1) / kAggRowsPerBlock;
  if (b < 1) b = 1;
  if (b > kAggMaxBlocks) b = kAggMaxBlocks;
  return (int)b;
}

// The precomputed form: a bool mask, an int32 group index and up to
// MAXA float32 value columns.
template <int MAXA>
struct ColumnSource {
  const uint8_t* mask;
  const int* gidx;
  const float* cols[MAXA];
  int n_vals;
  __device__ __forceinline__ bool pred(long long i) const {
    return mask[i] != 0;
  }
  __device__ __forceinline__ int group(long long i) const { return gidx[i]; }
  __device__ __forceinline__ void values(long long i, float* v) const {
#pragma unroll
    for (int k = 0; k < MAXA; ++k)
      if (k < n_vals) v[k] = cols[k][i];
  }
};

// kMask: also store the predicate in mask_out (a separate instantiation,
// so the engine's form pays nothing for it).
template <class Src, int NV, bool kMask>
__global__ void __launch_bounds__(kAggBlock)
agg_kernel(Src src, long long n, long long chunk, int G, int A, int reps,
           float* part_sums, int* part_counts, int* part_total,
           uint8_t* mask_out) {
  constexpr int kV = NV > 0 ? NV : 1;
  extern __shared__ float smem[];
  __shared__ int scratch[kAggBlock / kWarp];
  const int GA = G * A;
  float* s_sums = smem;
  int* s_counts = reinterpret_cast<int*>(smem + (size_t)reps * GA);
  for (int j = threadIdx.x; j < reps * GA; j += kAggBlock) s_sums[j] = 0.f;
  for (int j = threadIdx.x; j < reps * G; j += kAggBlock) s_counts[j] = 0;
  __syncthreads();

  const int rep = (threadIdx.x / kWarp) % reps;
  float* my_sums = s_sums + (size_t)rep * GA;
  int* my_counts = s_counts + rep * G;
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = start + chunk < n ? start + chunk : n;

  float acc[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) acc[k] = 0.f;
  int acc_n = 0, cur = -1, kept = 0;
  for (long long i = start + threadIdx.x; i < end; i += kAggBlock) {
    const bool m = src.pred(i);
    if constexpr (kMask) mask_out[i] = m ? 1 : 0;
    if (!m) continue;
    ++kept;
    const int g = src.group(i);
    if (g < 0 || g >= G) continue;
    if (g != cur) {
      if (cur >= 0) {
#pragma unroll
        for (int k = 0; k < kV; ++k)
          if (k < A) atomicAdd(&my_sums[cur * A + k], acc[k]);
        atomicAdd(&my_counts[cur], acc_n);
      }
      cur = g;
      acc_n = 0;
#pragma unroll
      for (int k = 0; k < kV; ++k) acc[k] = 0.f;
    }
    float v[kV];
    src.values(i, v);
#pragma unroll
    for (int k = 0; k < kV; ++k)
      if (k < A) acc[k] += v[k];
    ++acc_n;
  }
  if (cur >= 0) {
#pragma unroll
    for (int k = 0; k < kV; ++k)
      if (k < A) atomicAdd(&my_sums[cur * A + k], acc[k]);
    atomicAdd(&my_counts[cur], acc_n);
  }
  __syncthreads();

  const long long b = blockIdx.x;
  for (int j = threadIdx.x; j < GA; j += kAggBlock) {
    float s = 0.f;
    for (int r = 0; r < reps; ++r) s += s_sums[(size_t)r * GA + j];
    part_sums[b * GA + j] = s;
  }
  for (int j = threadIdx.x; j < G; j += kAggBlock) {
    int c = 0;
    for (int r = 0; r < reps; ++r) c += s_counts[r * G + j];
    part_counts[b * G + j] = c;
  }
  const int t = block_sum<kAggBlock>(kept, scratch);
  if (threadIdx.x == 0) part_total[b] = t;
}

// Second pass: one thread per output, summing the block partials in
// block order.
__global__ void agg_finalize_kernel(const float* part_sums,
                                    const int* part_counts,
                                    const int* part_total, int nb, int G,
                                    int A, float* sums, int* counts,
                                    int* total) {
  const int GA = G * A;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < GA) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += part_sums[(long long)b * GA + j];
    sums[j] = s;
  } else if (j < GA + G) {
    const int g = j - GA;
    int c = 0;
    for (int b = 0; b < nb; ++b) c += part_counts[(long long)b * G + g];
    counts[g] = c;
  } else if (j == GA + G) {
    int t = 0;
    for (int b = 0; b < nb; ++b) t += part_total[b];
    *total = t;
  }
}

// `nb` must be agg_blocks(n); the partial buffers hold nb x G x A floats,
// nb x G ints and nb ints.  `mask_out` (nullable) receives the predicate
// as one byte per row, for the compaction of compact.cuh to rank.
template <class Src, int NV>
int launch_agg(Src src, long long n, int G, int A, int nb, float* part_sums,
               int* part_counts, int* part_total, float* sums, int* counts,
               int* total, uint8_t* mask_out, cudaStream_t stream) {
  const size_t per_rep = (size_t)G * (A + 1) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // the default per-block budget, less room for the static scratch; a
  // larger accumulator (one replica) opts in to more
  const size_t budget = kAggDefaultSmem - kAggStaticSmem;
  size_t reps = budget / (per_rep > 0 ? per_rep : 1);
  if (reps > (size_t)kAggMaxReplicas) reps = kAggMaxReplicas;
  if (reps < 1) reps = 1;
  const size_t smem = reps * per_rep;
  if (smem + kAggStaticSmem > (size_t)optin) return (int)cudaErrorInvalidValue;
  auto kernel = mask_out != nullptr ? agg_kernel<Src, NV, true>
                                    : agg_kernel<Src, NV, false>;
  if (smem > budget) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long chunk = (n + nb - 1) / nb;
  if (chunk < 1) chunk = 1;
  kernel<<<nb, kAggBlock, smem, stream>>>(
      src, n, chunk, G, A, (int)reps, part_sums, part_counts, part_total,
      mask_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int outs = G * A + G + 1;
  agg_finalize_kernel<<<(outs + 255) / 256, 256, 0, stream>>>(
      part_sums, part_counts, part_total, nb, G, A, sums, counts, total);
  return (int)cudaGetLastError();
}

}  // namespace repro
