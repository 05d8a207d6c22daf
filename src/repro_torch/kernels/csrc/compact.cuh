// Ordered stream compaction: the ids of the rows where a predicate holds,
// ascending, into idx int32[cap], with the exact count and, optionally,
// slot_of int32[n] (each valid row's rank, -1 elsewhere).
//
// Replaces the Pallas kernels `compact` / `compact_translate`
// (src/repro/kernels/compact.py:98, :136, body `_compact_body` :55) and
// `compact_pred` (:158, body :192).  The Pallas kernel carries the running
// offset across grid steps in `cnt_ref`, relying on the TPU grid running
// in order.  A CUDA grid has no order, so this is a single-pass chained
// scan with decoupled look-back (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016), in one
// launch:
//
//   * a block takes its tile of 4096 rows from an atomic ticket, not from
//     blockIdx.x, so it only ever waits on tiles whose blocks already
//     run, and the scan cannot deadlock whatever the card schedules;
//   * it evaluates its rows once, every item's predicate before the first
//     ballot (a tile wholly below n takes no bounds check, so all its
//     items' loads are in flight together), keeps a warp ballot per 256
//     rows in registers, and counts the tile;
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
// byte mask (`compact`); the generated `compact_pred` libraries
// (codegen.py) instantiate it on their predicate functor, which loads
// every column it reads before it evaluates, so the predicate is
// evaluated inside the scan and no mask is ever stored; topk.cu
// instantiates it with a source that ranks the ties of its selected key.
//
// Workspace (int32 words, one allocation): [status 2 per tile][ticket]
// [total][idx cap][slot_of n, with translate].  One cudaMemsetAsync
// clears the status words, the ticket, the total and idx, so pad slots
// stay 0: a call is one memset and one launch.
//
// The binding axis (the engine's bind-many pass, torch.func.vmap over a
// query's parameters; the reference vmaps its Pallas kernel into a batch
// grid axis): blockIdx.y is the binding.  Each binding b has its own
// workspace row of compact_row_words words (status, ticket, total, idx),
// its own slot_of row, and reads its rows through `bind.at(b)`: a mask
// `stride` bytes from the last binding's, or a generated source whose
// columns and parameters carry a binding stride (0 where the binding
// shares the operand, so a shared column is read from one copy).  A tile
// draws its number from its own binding's ticket and looks back over its
// own binding's status words only (it waits only on tiles of its binding
// whose blocks already run, as in the scalar launch), so B bindings are
// one 2-D memset over the B rows' heads and idx and one launch of tiles x
// B blocks, and binding b's outputs are those of the launch over binding
// b alone.
//
// Bound on the card: bytes.  The mask (1 B/row), or the columns the
// predicate reads, is read once; 4 B are written per kept row (+4 B/row
// of slot_of with translate).
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

// One byte mask a binding, `stride` bytes apart (0: one mask for all).
struct MaskBatch {
  const uint8_t* mask;
  long long stride;
  __device__ __forceinline__ MaskSource at(int b) const {
    return MaskSource{mask + (long long)b * stride};
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

// Binding blockIdx.y reads `bind.at(blockIdx.y)` and writes its workspace
// words `ws_row` words and its slot_of `slot_row` words past binding 0's
// (both 0 in the scalar launch, whose grid has one row).
template <class Bind>
__global__ void __launch_bounds__(kCompactBlock)
compact_kernel(Bind bind, long long n, int n_tiles, int* ws0, int* idx0,
               int cap, int* slot0, long long ws_row, long long slot_row) {
  __shared__ int s_tile, s_offset;
  __shared__ int s_slot[kCompactSlots];      // count, then exclusive offset
  __shared__ int s_warp[kCompactWarps];
  const long long b = blockIdx.y;
  auto src = bind.at((int)b);
  int* ws = ws0 + b * ws_row;
  unsigned long long* status = reinterpret_cast<unsigned long long*>(ws);
  int* ticket = ws + 2 * n_tiles;
  int* total = ticket + 1;
  int* idx = idx0 + b * ws_row;
  int* slot_of = slot0 != nullptr ? slot0 + b * slot_row : nullptr;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long base = (long long)tile * kCompactRows;

  // every item's predicate before the first ballot
  bool m[kCompactItems];
  if (base + kCompactRows <= n) {
#pragma unroll
    for (int k = 0; k < kCompactItems; ++k)
      m[k] = src.pred(base + (long long)k * kCompactBlock + threadIdx.x);
  } else {
#pragma unroll
    for (int k = 0; k < kCompactItems; ++k) {
      const long long i = base + (long long)k * kCompactBlock + threadIdx.x;
      m[k] = i < n && src.pred(i);
    }
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

inline long long compact_tiles(long long n) {
  return (n + kCompactRows - 1) / kCompactRows;
}

// Words of the status array, the ticket and the total.
inline long long compact_head_words(long long n) {
  return 2 * compact_tiles(n) + 2;
}

// The one launch; the caller has cleared the scan's own scratch at the
// front of `ws` (status words, ticket, total: compact_head_words(n)).
template <class Src>
int launch_compact(Src src, long long n, int* ws, int* idx, int cap,
                   int* slot_of, cudaStream_t stream) {
  const long long nb = compact_tiles(n);
  if (nb > 0)
    compact_kernel<OneBinding<Src>><<<(int)nb, kCompactBlock, 0, stream>>>(
        OneBinding<Src>{src}, n, (int)nb, ws, idx, cap, slot_of, 0, 0);
  return (int)cudaGetLastError();
}

// Words the workspace needs, or -1 for arguments out of range.
inline long long compact_words(long long n, int cap, bool translate) {
  if (n < 0 || n >= INT_MAX || cap < 0) return -1;
  return compact_head_words(n) + cap + (translate ? n : 0);
}

// Words of one binding's row of a batched workspace: compact_words padded
// to a quad, so that every row's status words stay 8-byte aligned.
inline long long compact_row_words(long long n, int cap, bool translate) {
  const long long w = compact_words(n, cap, translate);
  return w < 0 ? -1 : (w + 3) / 4 * 4;
}

// The compaction of `src`'s rows in the workspace layout above: one
// memset and one launch.
template <class Src>
int compact_into(const Src& src, long long n, int* ws, long long ws_words,
                 int cap, bool translate, cudaStream_t stream) {
  const long long need = compact_words(n, cap, translate);
  if (need < 0 || ws_words < need) return (int)cudaErrorInvalidValue;
  const long long head = compact_head_words(n);
  const cudaError_t err =
      cudaMemsetAsync(ws, 0, 4 * (size_t)(head + cap), stream);
  if (err != cudaSuccess) return (int)err;
  int* idx = ws + head;
  return launch_compact(src, n, ws, idx, cap,
                        translate ? idx + cap : nullptr, stream);
}

// B bindings: binding b's row of the layout above starts b x
// compact_row_words words into `ws`.  One 2-D memset clears every row's
// head and idx; one launch of tiles x B blocks.
template <class Bind>
int compact_batch_into(const Bind& bind, int B, long long n, int* ws,
                       long long ws_words, int cap, bool translate,
                       cudaStream_t stream) {
  const long long row = compact_row_words(n, cap, translate);
  if (row < 0 || B < 1 || B > 65535 || ws_words < row * B)
    return (int)cudaErrorInvalidValue;
  const long long head = compact_head_words(n);
  cudaError_t err = cudaMemset2DAsync(ws, 4 * (size_t)row, 0,
                                      4 * (size_t)(head + cap), (size_t)B,
                                      stream);
  if (err != cudaSuccess) return (int)err;
  const long long nb = compact_tiles(n);
  int* idx = ws + head;
  if (nb > 0)
    compact_kernel<Bind><<<dim3((unsigned)nb, (unsigned)B), kCompactBlock, 0,
                           stream>>>(bind, n, (int)nb, ws, idx, cap,
                                     translate ? idx + cap : nullptr, row,
                                     row);
  return (int)cudaGetLastError();
}

}  // namespace repro
