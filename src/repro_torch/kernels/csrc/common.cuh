// Shared helpers of the hand-written kernels: block-wide integer sums, and
// (expr.cuh) the helpers the generated expressions call.
#pragma once

#include <cstdint>
#include <type_traits>
#include <utility>

#include <cuda_runtime.h>

#include "expr.cuh"

namespace repro {

constexpr int kWarp = 32;

// The binding axis of the engine's kernels (compact.cuh, filter_agg.cuh):
// a kernel reads binding b's operands (b = blockIdx.y) through a binder's
// `at(b)`, which returns the row source of that binding.  The scalar
// launch hands every block its one source through OneBinding.
template <class Src>
struct OneBinding {
  Src src;
  __device__ __forceinline__ Src at(int) const { return src; }
};

template <class T>
struct is_one_binding : std::false_type {};
template <class S>
struct is_one_binding<OneBinding<S>> : std::true_type {};

// The row source a binder hands out.
template <class Bind>
using bound_source_t =
    std::decay_t<decltype(std::declval<const Bind&>().at(0))>;

// Sums over the warp, valid in lane 0: a shuffle tree, so a float sum is
// added in the same order in every call.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2)
    v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum of `v` over the block; the result is valid in thread 0 only.
// `scratch` holds one int per warp.
template <int BLOCK>
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < BLOCK / kWarp; ++w) total += scratch[w];
  }
  __syncthreads();
  return total;
}

}  // namespace repro
