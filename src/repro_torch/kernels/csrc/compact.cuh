// Ordered stream compaction: the ids of the rows where a predicate holds,
// ascending, into idx int32[cap], with the exact count and, optionally,
// slot_of int32[n] (each valid row's rank, -1 elsewhere).
//
// Replaces the Pallas kernels `compact` / `compact_translate`
// (src/repro/kernels/compact.py:98, :136, body `_compact_body` :55) and
// `compact_pred` (:158).  The Pallas kernel carries the running offset
// across grid steps in `cnt_ref`, relying on the TPU grid running in
// order.  A CUDA grid has no order, so this is a single-pass chained scan
// with decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", NVIDIA 2016), in one launch:
//
//   * a block takes its tile of 4096 rows from an atomic ticket, not from
//     blockIdx.x, so it only ever waits on tiles whose blocks already
//     run, and the scan cannot deadlock whatever the card schedules;
//   * it evaluates its rows once, keeps a warp ballot per 256 rows in
//     registers, and counts the tile;
//   * it publishes that aggregate, sums its predecessors' words looking
//     back 32 tiles at a time (stopping at the first inclusive prefix),
//     and publishes its own inclusive prefix;
//   * it writes row ids at offset + rank.  Rows are ranked in row order
//     (ballot + popc, then an exclusive scan over (item, warp)), so the
//     ids stay ascending; a rank at or past `cap` is never written.  The
//     last tile writes the exact total; `slot_of` is written in the same
//     pass.
//
// Each status word packs the flag (high half: 0 not ready, 1 aggregate,
// 2 inclusive prefix) and the count (low half) into one 64-bit word, read
// and written whole, so no reader sees a flag without its value.
//
// The kernel is a template over its row source: `MaskSource` ranks a
// byte mask; topk.cu instantiates it with a source that ranks the ties of
// its selected key.  `compact_pred` stores its predicate as bytes in a
// first pass (`predicate_bytes_kernel`) and ranks those.
//
// Workspace (int32 words, one allocation): [status 2 per tile][ticket]
// [total][idx cap][slot_of n, with translate][predicate bytes, n / 4
// rounded up, compact_pred only].  One cudaMemsetAsync clears the status
// words, the ticket, the total and idx, so pad slots stay 0.
//
// Bound on the card: bytes.  The mask (1 B/row) is read once; 4 B are
// written per kept row (+4 B/row of slot_of with translate).  The
// predicate form writes and reads its byte mask once more.
#pragma once

#include <climits>

#include "common.cuh"

namespace repro {

constexpr int kCompactBlock = 256;
constexpr int kCompactItems = 16;
constexpr int kCompactRows = kCompactBlock * kCompactItems;   // per tile
constexpr int kCompactWarps = kCompactBlock / kWarp;
constexpr int kCompactSlots = kCompactItems * kCompactWarps;  // (item, warp)
constexpr unsigned long long kTileAggregate = 1ull << 32;
constexpr unsigned long long kTilePrefix = 2ull << 32;

// A row source decides row i in `pred(i)` (which may act on the side).
struct MaskSource {
  const uint8_t* mask;
  __device__ __forceinline__ bool pred(long long i) const {
    return mask[i] != 0;
  }
};

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long w) {
  *(volatile unsigned long long*)p = w;
}

__device__ __forceinline__ int warp_sum_all(int v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The exclusive prefix of tile `tile` (> 0), whose own count is `agg`:
// warp 0 of the block looks back over the predecessors' status words.
__device__ __forceinline__ int look_back(unsigned long long* status, int tile,
                                         int agg) {
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) store_status(&status[tile], kTileAggregate | (unsigned)agg);
  int excl = 0;
  for (int window = tile - 1;; window -= kWarp) {
    const int j = window - lane;       // lane 0 is the nearest predecessor
    unsigned long long w;
    do {                               // tile 0 is always a prefix, so no
      w = j >= 0 ? load_status(&status[j]) : kTilePrefix;   // lane reads
    } while (__any_sync(0xffffffffu, (w >> 32) == 0));      // below j = 0
    const unsigned prefixes = __ballot_sync(0xffffffffu, (w >> 32) == 2);
    const int stop = prefixes ? __ffs(prefixes) - 1 : kWarp - 1;
    excl += warp_sum_all(lane <= stop ? (int)(unsigned)w : 0);
    if (prefixes) break;
  }
  if (lane == 0) store_status(&status[tile], kTilePrefix | (unsigned)(excl + agg));
  return excl;
}

template <class Src>
__global__ void __launch_bounds__(kCompactBlock)
compact_kernel(Src src, long long n, int n_tiles,
               unsigned long long* status, int* ticket, int* total, int* idx,
               int cap, int* slot_of) {
  __shared__ int s_tile, s_offset;
  __shared__ int s_slot[kCompactSlots];      // count, then exclusive offset
  __shared__ int s_warp[kCompactWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long base = (long long)tile * kCompactRows;

  bool m[kCompactItems];
#pragma unroll
  for (int k = 0; k < kCompactItems; ++k) {
    const long long i = base + (long long)k * kCompactBlock + threadIdx.x;
    m[k] = i < n && src.pred(i);
  }
  unsigned ballot[kCompactItems];
#pragma unroll
  for (int k = 0; k < kCompactItems; ++k)
    ballot[k] = __ballot_sync(0xffffffffu, m[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kCompactItems; ++k)
      s_slot[k * kCompactWarps + warp] = __popc(ballot[k]);
  }
  __syncthreads();

  // exclusive scan of the (item, warp) counts, in row order
  const int v = threadIdx.x < kCompactSlots ? s_slot[threadIdx.x] : 0;
  int incl = v;
#pragma unroll
  for (int o = 1; o < kWarp; o *= 2) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == kWarp - 1) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kCompactWarps; ++w) {
    const int t = s_warp[w];
    if (w < warp) before += t;
    agg += t;
  }
  if (threadIdx.x < kCompactSlots) s_slot[threadIdx.x] = before + incl - v;

  if (warp == 0) {
    int excl = 0;
    if (tile == 0) {
      if (lane == 0) store_status(&status[0], kTilePrefix | (unsigned)agg);
    } else {
      excl = look_back(status, tile, agg);
    }
    if (lane == 0) {
      s_offset = excl;
      if (tile == n_tiles - 1) *total = excl + agg;
    }
  }
  __syncthreads();

  const int offset = s_offset;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kCompactItems; ++k) {
    const long long i = base + (long long)k * kCompactBlock + threadIdx.x;
    const int pos = offset + s_slot[k * kCompactWarps + warp] +
                    __popc(ballot[k] & lt);
    if (m[k] && pos < cap) idx[pos] = (int)i;
    if (slot_of != nullptr && i < n) slot_of[i] = m[k] ? pos : -1;
  }
}

// The predicate as one byte per row, for compact_kernel<MaskSource>.
template <class Src>
__global__ void __launch_bounds__(kCompactBlock)
predicate_bytes_kernel(Src src, long long n, uint8_t* out) {
  const long long base = (long long)blockIdx.x * kCompactRows;
#pragma unroll 4
  for (int k = 0; k < kCompactItems; ++k) {
    const long long i = base + (long long)k * kCompactBlock + threadIdx.x;
    if (i < n) out[i] = src.pred(i) ? 1 : 0;
  }
}

inline long long compact_tiles(long long n) {
  return (n + kCompactRows - 1) / kCompactRows;
}

// Words of the status array, the ticket and the total.
inline long long compact_head_words(long long n) {
  return 2 * compact_tiles(n) + 2;
}

// The scan's own scratch at the front of `ws`: status words, ticket, total.
struct CompactScratch {
  unsigned long long* status;
  int* ticket;
  int* total;
};

inline CompactScratch compact_scratch(int* ws, long long n) {
  const long long nb = compact_tiles(n);
  return {reinterpret_cast<unsigned long long*>(ws), ws + 2 * nb,
          ws + 2 * nb + 1};
}

// The one launch; the caller has cleared the scratch.
template <class Src>
int launch_compact(Src src, long long n, CompactScratch s, int* idx, int cap,
                   int* slot_of, cudaStream_t stream) {
  const long long nb = compact_tiles(n);
  if (nb > 0)
    compact_kernel<Src><<<(int)nb, kCompactBlock, 0, stream>>>(
        src, n, (int)nb, s.status, s.ticket, s.total, idx, cap, slot_of);
  return (int)cudaGetLastError();
}

// Words the workspace needs, or -1 for arguments out of range.
inline long long compact_words(long long n, int cap, bool translate,
                               bool bytes) {
  if (n < 0 || n >= INT_MAX || cap < 0) return -1;
  return compact_head_words(n) + cap + (translate ? n : 0) +
         (bytes ? (n + 3) / 4 : 0);
}

// The compaction of a byte mask in the workspace layout above: one memset
// and one launch.
inline int compact_mask_into(const uint8_t* mask, long long n, int* ws,
                             long long ws_words, int cap, bool translate,
                             cudaStream_t stream) {
  const long long need = compact_words(n, cap, translate, false);
  if (need < 0 || ws_words < need) return (int)cudaErrorInvalidValue;
  const long long head = compact_head_words(n);
  const cudaError_t err =
      cudaMemsetAsync(ws, 0, 4 * (size_t)(head + cap), stream);
  if (err != cudaSuccess) return (int)err;
  int* idx = ws + head;
  return launch_compact(MaskSource{mask}, n, compact_scratch(ws, n), idx, cap,
                        translate ? idx + cap : nullptr, stream);
}

// The compaction of a generated predicate: stored as bytes at the end of
// the workspace, then ranked as a mask (one memset, two launches).
template <class Src>
int compact_pred_into(const Src& src, long long n, int* ws,
                      long long ws_words, int cap, bool translate,
                      cudaStream_t stream) {
  const long long need = compact_words(n, cap, translate, true);
  if (need < 0 || ws_words < need) return (int)cudaErrorInvalidValue;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(
      ws + compact_head_words(n) + cap + (translate ? n : 0));
  if (n > 0)
    predicate_bytes_kernel<Src><<<(int)compact_tiles(n), kCompactBlock, 0,
                                  stream>>>(src, n, bytes);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return compact_mask_into(bytes, n, ws, ws_words, cap, translate, stream);
}

}  // namespace repro
