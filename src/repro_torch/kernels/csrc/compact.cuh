// Stream compaction of a boolean mask (or of a predicate evaluated from
// columns) into (idx int32[cap], count int32[, slot_of int32[n]]).
//
// Replaces the Pallas kernels `compact` / `compact_translate`
// (src/repro/kernels/compact.py:98, :136, body `_compact_body` :55) and
// `compact_pred` (:158).  The Pallas kernel carries the running offset
// across grid steps in `cnt_ref`, relying on the TPU grid running in
// order.  A CUDA grid has no order, so the work is three launches:
//
//   1. count: each block counts the valid rows of its 4096-row chunk
//      (the predicate form evaluates the predicate here and stores it as
//      one byte per row, so the columns are read once);
//   2. scan: one block turns the per-block counts into exclusive offsets
//      and the exact total;
//   3. write: each block re-reads its mask chunk and ranks its rows with
//      a warp ballot + popc and a scan over the block's eight warps, then
//      writes row ids at offset + rank.  Rows are ranked in row order
//      within a block and blocks in block order, so the valid prefix is
//      ascending.  A row whose slot is past `cap` is never written.
//
// Bound on the card: bytes.  One pass reads the mask (1 B/row) or the
// predicate's columns, and writes 4 B per kept row (+4 B/row of slot_of
// with `translate`).  The design re-reads only the 1-byte mask in pass 3
// and the block counts (4 B per 4096 rows); the scan is one block over
// n/4096 counts.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kCompactBlock = 256;
constexpr int kCompactItems = 16;
constexpr int kCompactRows = kCompactBlock * kCompactItems;   // per block
constexpr int kScanBlock = 1024;

struct MaskSource {
  const uint8_t* mask;
  __device__ __forceinline__ bool pred(long long i) const {
    return mask[i] != 0;
  }
};

// Pass 1.  `mask_out` (nullable) receives the evaluated predicate.
template <class Src>
__global__ void __launch_bounds__(kCompactBlock)
compact_count_kernel(Src src, long long n, uint8_t* mask_out,
                     int* block_counts) {
  __shared__ int scratch[kCompactBlock / kWarp];
  const long long base = (long long)blockIdx.x * kCompactRows;
  int c = 0;
#pragma unroll 4
  for (int k = 0; k < kCompactItems; ++k) {
    const long long i = base + (long long)k * kCompactBlock + threadIdx.x;
    if (i < n) {
      const bool m = src.pred(i);
      if (mask_out != nullptr) mask_out[i] = m ? 1 : 0;
      c += m ? 1 : 0;
    }
  }
  const int total = block_sum<kCompactBlock>(c, scratch);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

// Pass 2: exclusive scan of the block counts in one block; `total`
// receives the exact number of valid rows.
__global__ void __launch_bounds__(kScanBlock)
compact_scan_kernel(const int* block_counts, int n_blocks, int* offsets,
                    int* total) {
  __shared__ int warp_tot[kScanBlock / kWarp];
  __shared__ int carry;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int start = 0; start < n_blocks; start += kScanBlock) {
    const int i = start + threadIdx.x;
    const int v = i < n_blocks ? block_counts[i] : 0;
    int incl = v;   // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < kWarp; o *= 2) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == kWarp - 1) warp_tot[warp] = incl;
    __syncthreads();
    int before = 0, round = 0;
    for (int w = 0; w < kScanBlock / kWarp; ++w) {
      const int t = warp_tot[w];
      if (w < warp) before += t;
      round += t;
    }
    if (i < n_blocks) offsets[i] = carry + before + incl - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += round;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

// Pass 3.
__global__ void __launch_bounds__(kCompactBlock)
compact_write_kernel(const uint8_t* mask, long long n, const int* offsets,
                     int* idx, int cap, int* slot_of) {
  __shared__ int warp_tot[kCompactBlock / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const unsigned lt = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * kCompactRows;
  int running = offsets[blockIdx.x];
  for (int k = 0; k < kCompactItems; ++k) {
    const long long i = base + (long long)k * kCompactBlock + threadIdx.x;
    const bool m = i < n && mask[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, m);
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, round = 0;
#pragma unroll
    for (int w = 0; w < kCompactBlock / kWarp; ++w) {
      const int t = warp_tot[w];
      if (w < warp) before += t;
      round += t;
    }
    const int pos = running + before + __popc(ballot & lt);
    if (m && pos < cap) idx[pos] = (int)i;
    if (slot_of != nullptr && i < n) slot_of[i] = m ? pos : -1;
    running += round;
    __syncthreads();   // warp_tot is rewritten next round
  }
}

inline int compact_blocks(long long n) {
  return (int)((n + kCompactRows - 1) / kCompactRows);
}

template <class Src>
int launch_compact_count(Src src, long long n, uint8_t* mask_out,
                         int* block_counts, cudaStream_t stream) {
  const int nb = compact_blocks(n);
  if (nb > 0)
    compact_count_kernel<Src><<<nb, kCompactBlock, 0, stream>>>(
        src, n, mask_out, block_counts);
  return (int)cudaGetLastError();
}

}  // namespace repro
