// Shared helpers of the hand-written kernels: block-wide integer sums, and
// (expr.cuh) the helpers the generated expressions call.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "expr.cuh"

namespace repro {

constexpr int kWarp = 32;

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
