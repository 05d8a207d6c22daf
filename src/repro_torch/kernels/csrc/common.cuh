// Shared helpers of the hand-written kernels: block-wide integer sums, the
// cluster, mbarrier and bulk-copy instructions of sm_90, and (expr.cuh)
// the helpers the generated expressions call.
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

// -- thread-block clusters, mbarriers and the bulk copy (sm_90) --------------
// The staged aggregation (filter_agg.cuh) copies a shared column's slice
// once into the shared memory of every block of a cluster.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: what each did before is
// visible to the others after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// The initialised barriers, visible to the cluster (before its barrier).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// This block's one arrival on `bar`, expecting `bytes` more of copies.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed; the
// copies it counted are then visible to the waiting thread.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n\t.reg .pred rp;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 rp, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, rp;\n\t}"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The same, acquiring what the cluster's arrivals released.
__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar,
                                                  unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n\t.reg .pred rp;\n\t"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
                 "rp, [%1], %2;\n\tselp.u32 %0, 1, 0, rp;\n\t}"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// One arrival on the barrier at `bar`'s offset in block `cta` of the
// cluster, releasing this block's prior reads and writes to the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(unsigned long long* bar,
                                                    unsigned cta) {
  asm volatile("{\n\t.reg .b32 ra;\n\t"
               "mapa.shared::cluster.u32 ra, %0, %1;\n\t"
               "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];"
               "\n\t}"
               :: "r"(smem_u32(bar)), "r"(cta) : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory to `dst`'s offset in the shared memory of every block of the
// cluster in `ctas`, each block's barrier at `bar`'s offset counting them.
__device__ __forceinline__ void bulk_copy_multicast(void* dst,
                                                    const void* src,
                                                    unsigned bytes,
                                                    unsigned long long* bar,
                                                    unsigned short ctas) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)),
         "h"(ctas)
      : "memory");
}

}  // namespace repro
