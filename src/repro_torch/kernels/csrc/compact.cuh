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
// grid axis) of `compact_pred_batched` where a column differs by binding
// (the byte masks of `compact_batched`, and the predicate over columns
// every binding shares, have kernels of their own, at the end of this
// file): blockIdx.y is the binding.  Each binding b has its own
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

// -- the batched mask compaction: a wide-tile vector scan --------------------
//
// `compact_batched` (the vmapped `compact`) ranks B byte masks, n rows
// each, in one launch of its own kernel: the look-back scan above is
// kept for what it must guarantee (a tile numbered by its binding's
// ticket waits only on tiles of its binding whose blocks already run;
// status words as above), and redesigned for what it moves:
//
//   * a tile is 16,384 rows (512 threads x 32 rows), four times the scalar
//     tile, so a binding draws four times fewer tickets and looks back
//     four times less often;
//   * a thread reads its 32 consecutive mask bytes as two 16-byte loads
//     (three, funnelled by the mask's offset, where a binding's mask is
//     not 16-byte aligned: a (B, n) mask of odd n puts every other row at
//     an odd address), turns them into one 32-bit mask (byte_bits) and
//     ranks them by popc; a warp scan and the warps' totals give each
//     thread its rank in the tile;
//   * warp w's lanes own consecutive 32-row groups of the tile's 1,024-row
//     warp chunk, so lane r's bit mask is group r's ballot: the warp walks
//     its 32 groups and writes each group's kept ids as one coalesced store
//     in row order, with no staging in shared memory; slot_of goes out as
//     eight 16-byte stores a thread (where its row is 16-byte aligned);
//   * the pad zeros: one 2-D memset clears only every row's head (status
//     words, ticket, total), and the kernel writes each idx word once.
//     After a binding's tiles come its pad shares, one a 32,768 words of
//     capacity, each a block drawing a later ticket: it waits for the last
//     tile's inclusive prefix (the count), which a running block
//     publishes, and zeroes its share of idx at or past the count with
//     16-byte stores.  The ids below the count are the tiles' own stores.
//
// Workspace row of a binding (int32 words; rows batch_row_words apart,
// each 16-byte aligned): [status 2 per tile][ticket][padding][total]
// [idx cap][slot_of n, with translate]; the head (status to total) is a
// multiple of 4 words, so idx is 16-byte aligned and [total, idx,
// slot_of] is the packed output.  Bound: bytes (the masks once, the idx
// rows and slot_of once; the ids are the kernel's only data-dependent
// stores).
constexpr int kBatchBlock = 512;
constexpr int kBatchRowsPerThread = 32;
constexpr int kBatchWarps = kBatchBlock / kWarp;
constexpr int kBatchRowsPerWarp = kWarp * kBatchRowsPerThread;
constexpr int kBatchTileRows = kBatchBlock * kBatchRowsPerThread;
constexpr int kBatchPadWords = 32768;        // idx words a pad block zeroes

inline long long batch_tiles(long long n) {
  return (n + kBatchTileRows - 1) / kBatchTileRows;
}

// Words of a row's head: status words, ticket, total, padded to a quad.
inline long long batch_head_words(long long n) {
  return (2 * batch_tiles(n) + 2 + 3) / 4 * 4;
}

// Words of one binding's workspace row, or -1 for arguments out of range.
inline long long batch_row_words(long long n, int cap, bool translate) {
  if (n < 0 || n >= INT_MAX || cap < 0) return -1;
  return (batch_head_words(n) + cap + (translate ? n : 0) + 3) / 4 * 4;
}

inline long long batch_pad_blocks(int cap) {
  return (cap + (long long)kBatchPadWords - 1) / kBatchPadWords;
}

// Four mask bytes as four bits, bit r set where byte r is nonzero.
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  const unsigned hi = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return ((hi >> 7) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned quad_bits(uint4 u) {
  return byte_bits(u.x) | byte_bits(u.y) << 4 | byte_bits(u.z) << 8 |
         byte_bits(u.w) << 12;
}

// Bit j of the result: row r0 + j of `mask` (n rows) is valid.  Rows
// wholly below n are read 16 bytes at a time: two loads where the rows
// start 16-byte aligned, else three aligned loads (each holds a byte of
// the rows, so none leaves the mask's allocation) shifted into place.
__device__ __forceinline__ unsigned mask_bits32(const uint8_t* mask,
                                                long long r0, long long n) {
  const uint8_t* a = mask + r0;
  if (r0 + kBatchRowsPerThread <= n) {
    const unsigned s = (unsigned)((size_t)a & 15);
    if (s == 0) {
      const uint4* p = reinterpret_cast<const uint4*>(a);
      return quad_bits(__ldg(p)) | quad_bits(__ldg(p + 1)) << 16;
    }
    const uint4* p = reinterpret_cast<const uint4*>(a - s);
    const unsigned long long bits =
        (unsigned long long)quad_bits(__ldg(p)) |
        (unsigned long long)quad_bits(__ldg(p + 1)) << 16 |
        (unsigned long long)quad_bits(__ldg(p + 2)) << 32;
    return (unsigned)(bits >> s);
  }
  unsigned bits = 0;
  for (int j = 0; j < kBatchRowsPerThread && r0 + j < n; ++j)
    bits |= (a[j] != 0 ? 1u : 0u) << j;
  return bits;
}

// A pad share `share` of a binding whose status words are `status`
// (n_tiles tiles): the block (BLOCK threads) waits for the last tile's
// inclusive prefix, the count, which a running block publishes, and
// zeroes idx[lo, hi) of its kBatchPadWords words at or past the count with
// 16-byte stores (idx is 16-byte aligned).  `s_count` is a shared word.
template <int BLOCK>
__device__ __forceinline__ void pad_share(const unsigned long long* status,
                                          int n_tiles, int* idx, int cap,
                                          long long share, int* s_count) {
  if (threadIdx.x == 0) {
    int count = 0;
    if (n_tiles > 0) {
      unsigned long long w;
      while (((w = load_status(&status[n_tiles - 1])) >> 32) != 2)
        __nanosleep(64);
      count = (int)(unsigned)w;
    }
    *s_count = count;
  }
  __syncthreads();
  long long lo = share * kBatchPadWords;
  const long long hi = lo + kBatchPadWords < cap ? lo + kBatchPadWords : cap;
  if (lo < *s_count) lo = *s_count;
  long long a = (lo + 3) / 4 * 4;
  if (a > hi) a = hi;
  for (long long i = lo + threadIdx.x; i < a; i += BLOCK) idx[i] = 0;
  for (long long q = a / 4 + threadIdx.x; q < hi / 4; q += BLOCK)
    reinterpret_cast<int4*>(idx)[q] = make_int4(0, 0, 0, 0);
  const long long t = hi / 4 * 4 > a ? hi / 4 * 4 : a;
  for (long long i = t + threadIdx.x; i < hi; i += BLOCK) idx[i] = 0;
}

// Binding blockIdx.y: mask `bind.at(b)`, workspace row b (`row` words
// apart, head `head` words).  A block is a tile or, past the binding's
// n_tiles tickets, a pad share.
template <class Bind>
__global__ void __launch_bounds__(kBatchBlock)
compact_batched_kernel(Bind bind, long long n, int n_tiles, int* ws0,
                       long long row, long long head, int cap,
                       int translate) {
  __shared__ int s_tile, s_offset;
  __shared__ int s_warp[kBatchWarps];       // warp totals, then prefixes
  const long long b = blockIdx.y;
  int* ws = ws0 + b * row;
  unsigned long long* status = reinterpret_cast<unsigned long long*>(ws);
  int* ticket = ws + 2 * n_tiles;
  int* total = ws + head - 1;
  int* idx = ws + head;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;

  if (tile >= n_tiles) {            // a pad share: zeros at or past the count
    pad_share<kBatchBlock>(status, n_tiles, idx, cap, tile - n_tiles,
                           &s_offset);
    return;
  }

  const auto src = bind.at((int)b);
  const long long base = (long long)tile * kBatchTileRows;
  const long long wrow = base + (long long)warp * kBatchRowsPerWarp;
  const long long r0 = wrow + lane * kBatchRowsPerThread;
  const unsigned bits = mask_bits32(src.mask, r0, n);

  // the thread's rank in the tile: a warp scan, then the warps' totals
  const int c = __popc(bits);
  int incl = c;
#pragma unroll
  for (int o = 1; o < kWarp; o *= 2) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == kWarp - 1) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kBatchWarps ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < kWarp; o *= 2) {
      const int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    const int agg = __shfl_sync(0xffffffffu, wi, kWarp - 1);
    if (lane < kBatchWarps) s_warp[lane] = wi - w;
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
  const int e = s_offset + s_warp[warp] + incl - c;

  // group r of the warp's chunk (rows wrow + 32 r ..) is lane r's mask:
  // its kept ids, in row order, as one coalesced store of the warp
  const unsigned lt = (1u << lane) - 1u;
  if (__any_sync(0xffffffffu, bits != 0)) {
    for (int r = 0; r < kWarp; ++r) {
      const unsigned mr = __shfl_sync(0xffffffffu, bits, r);
      const int er = __shfl_sync(0xffffffffu, e, r);
      if ((mr >> lane) & 1u) {
        const int p = er + __popc(mr & lt);
        if (p < cap) idx[p] = (int)(wrow + r * kBatchRowsPerThread + lane);
      }
    }
  }
  if (translate) {                  // each row's rank, -1 where not valid
    int* slot_of = idx + cap;
    int p = e;
    if (r0 + kBatchRowsPerThread <= n && ((size_t)(slot_of + r0) & 15) == 0) {
      int4* out = reinterpret_cast<int4*>(slot_of + r0);
#pragma unroll
      for (int q = 0; q < kBatchRowsPerThread / 4; ++q) {
        int v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = (bits >> (4 * q + k)) & 1u ? p++ : -1;
        out[q] = make_int4(v[0], v[1], v[2], v[3]);
      }
    } else {
      for (int j = 0; j < kBatchRowsPerThread && r0 + j < n; ++j)
        slot_of[r0 + j] = (bits >> j) & 1u ? p++ : -1;
    }
  }
}

// B masks through `bind` (MaskBatch), binding b's workspace row b x
// batch_row_words words into `ws`: one 2-D memset of every row's head and
// one launch of (tiles + pad shares) x B blocks.
template <class Bind>
int compact_batched_into(const Bind& bind, int B, long long n, int* ws,
                         long long ws_words, int cap, bool translate,
                         cudaStream_t stream) {
  const long long row = batch_row_words(n, cap, translate);
  if (row < 0 || cap < 1 || B < 1 || B > 65535 || ws_words < row * B)
    return (int)cudaErrorInvalidValue;
  const long long head = batch_head_words(n);
  cudaError_t err = cudaMemset2DAsync(ws, 4 * (size_t)row, 0,
                                      4 * (size_t)head, (size_t)B, stream);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = batch_tiles(n);
  compact_batched_kernel<Bind>
      <<<dim3((unsigned)(tiles + batch_pad_blocks(cap)), (unsigned)B),
         kBatchBlock, 0, stream>>>(bind, n, (int)tiles, ws, row, head, cap,
                                   translate ? 1 : 0);
  return (int)cudaGetLastError();
}

// -- the batched predicate compaction: one tile for every binding ----------
//
// `compact_pred_batched` (the vmapped `compact_pred`) where every column
// the predicate reads is one that all bindings share (the engine's q12:
// four lineitem columns, the receipt-date window a binding; the wrapper
// decides, compact.shared_tile): the look-back scan above, its 4,096-row
// tile and its status words a binding, but one tile serves every binding,
// so the shared columns enter the SM once a tile, not once a binding:
//
//   * the launch has one ticket (binding 0's ticket word); a block draws a
//     tile and evaluates once a row the predicate's conjuncts that read no
//     parameter (codegen.py splits the top-level conjunction: the
//     generated `Tile`'s `free_pred`), every load of a thread's 16 rows in
//     flight at once, into a ballot word a 32-row group;
//   * it compacts the rows where they hold (the free rows, in row order: a
//     scan of the groups' counts, then popc ranks) into shared memory:
//     each one's row in the tile and the columns the other conjuncts read
//     (`stage`), so no binding looks at a row that no binding can keep;
//   * warp w then takes bindings w, w + 8, ...: for each, its conjuncts
//     (`bound_pred`, over the compacted copy and the binding's parameters)
//     ballotted over the free rows 32 at a time, lane l keeping free groups
//     4l .. 4l + 3; a warp scan of the counts; the look-back over that
//     binding's status words, which waits only on tiles drawn before, whose
//     blocks run, so the scan cannot deadlock; then the ids of each group
//     that keeps a row stored at offset + rank, in row order since the
//     compaction kept it, and with translate every row's slot_of from the
//     group ballots, parked in shared memory;
//   * after the tiles come the pad shares, B x batch_pad_blocks(cap)
//     tickets, each zeroing a binding's idx at or past its count once its
//     last tile has published it (pad_share), so the memset clears only
//     every row's head and every idx word is written once.
//
// Workspace row of a binding (int32 words, rows tile_row_words apart,
// each 16-byte aligned): [status 2 per tile][ticket][padding][total][idx
// cap][slot_of n, with translate], the head a multiple of 4 words, so
// [total, idx, slot_of] is the packed output.  Bound: bytes (the shared
// columns once, every binding's idx and slot_of once).
constexpr int kTileGroups = kCompactRows / kWarp;          // 32-row groups
constexpr int kTileLaneGroups = kTileGroups / kWarp;       // a lane's groups
// the kernel's static shared memory, at most (its arrays and a few words)
constexpr size_t kTileStaticSmem =
    2 * kTileGroups * 4 + kCompactRows * 2 +
    2 * kCompactWarps * kTileGroups * 4 + 64;

inline long long tile_head_words(long long n) {
  return (2 * compact_tiles(n) + 2 + 3) / 4 * 4;
}

inline long long tile_row_words(long long n, int cap, bool translate) {
  if (n < 0 || n >= INT_MAX || cap < 0) return -1;
  return (tile_head_words(n) + cap + (translate ? n : 0) + 3) / 4 * 4;
}

template <class Bind, class Tile>
__global__ void __launch_bounds__(kCompactBlock)
compact_tile_kernel(Bind bind, int B, long long n, int n_tiles, int* ws0,
                    long long row, long long head, int cap, int translate,
                    int pads) {
  using Src = bound_source_t<Bind>;
  extern __shared__ __align__(16) unsigned char s_cols[];
  __shared__ unsigned s_free[kTileGroups];      // a free bit a row
  __shared__ int s_fpre[kTileGroups];           // free rows before group g
  __shared__ unsigned short s_row[kCompactRows];  // the free rows in order
  __shared__ unsigned s_bal[kCompactWarps][kTileGroups];  // with translate:
  __shared__ int s_off[kCompactWarps][kTileGroups];       // a warp's binding
  __shared__ int s_tile, s_count, s_nfree;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const unsigned lt = (1u << lane) - 1u;
  if (threadIdx.x == 0) s_tile = atomicAdd(ws0 + 2 * n_tiles, 1);
  __syncthreads();
  const int tile = s_tile;
  if (tile >= n_tiles) {            // a pad share of binding share / pads
    const int share = tile - n_tiles;
    int* ws = ws0 + (long long)(share / pads) * row;
    pad_share<kCompactBlock>(reinterpret_cast<unsigned long long*>(ws),
                             n_tiles, ws + head, cap, share % pads, &s_count);
    return;
  }

  // the binding-free conjuncts once a row, as a ballot word a 32-row group
  const long long base = (long long)tile * kCompactRows;
  Tile t0;
  static_cast<Src&>(t0) = bind.at(0);
  bool f[kCompactItems];
  if (base + kCompactRows <= n) {
#pragma unroll
    for (int k = 0; k < kCompactItems; ++k)
      f[k] = t0.free_pred(base + k * kCompactBlock + threadIdx.x);
  } else {
#pragma unroll
    for (int k = 0; k < kCompactItems; ++k) {
      const long long i = base + k * kCompactBlock + threadIdx.x;
      f[k] = i < n && t0.free_pred(i);
    }
  }
#pragma unroll
  for (int k = 0; k < kCompactItems; ++k) {     // group 8k + warp
    const unsigned w = __ballot_sync(0xffffffffu, f[k]);
    if (lane == 0) s_free[k * kCompactWarps + warp] = w;
  }
  __syncthreads();
  if (warp == 0) {                  // the groups' free rows before them
    int c[kTileLaneGroups], lc = 0;
#pragma unroll
    for (int q = 0; q < kTileLaneGroups; ++q) {
      c[q] = __popc(s_free[lane * kTileLaneGroups + q]);
      lc += c[q];
    }
    int incl = lc;
#pragma unroll
    for (int o = 1; o < kWarp; o *= 2) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    int e = incl - lc;
#pragma unroll
    for (int q = 0; q < kTileLaneGroups; ++q) {
      s_fpre[lane * kTileLaneGroups + q] = e;
      e += c[q];
    }
    if (lane == kWarp - 1) s_nfree = incl;
  }
  __syncthreads();
  // the free rows, compacted in row order: each one's row and the bound
  // conjuncts' columns at its position
#pragma unroll
  for (int k = 0; k < kCompactItems; ++k) {
    if (!f[k]) continue;
    const int g = k * kCompactWarps + warp, r = k * kCompactBlock + threadIdx.x;
    const int p = s_fpre[g] + __popc(s_free[g] & lt);
    s_row[p] = (unsigned short)r;
    t0.stage(s_cols, base + r, p);
  }
  __syncthreads();
  const int nfree = s_nfree, ngroups = (nfree + kWarp - 1) / kWarp;

  for (int b = warp; b < B; b += kCompactWarps) {
    Tile tb;
    static_cast<Src&>(tb) = bind.at(b);
    // the binding's conjuncts over the free rows, 32 at a time; lane l
    // keeps the ballots of free groups 4l .. 4l + 3
    unsigned mine[kTileLaneGroups];
#pragma unroll
    for (int q = 0; q < kTileLaneGroups; ++q) mine[q] = 0;
    for (int j = 0; j * kTileLaneGroups < ngroups; ++j) {
#pragma unroll
      for (int q = 0; q < kTileLaneGroups; ++q) {
        const int c = j * kTileLaneGroups + q, p = c * kWarp + lane;
        if (c >= ngroups) break;
        const bool m = p < nfree && tb.bound_pred(s_cols, p);
        const unsigned bal = __ballot_sync(0xffffffffu, m);
        if (lane == j) mine[q] = bal;
      }
    }
    int cnt[kTileLaneGroups], lc = 0;
#pragma unroll
    for (int q = 0; q < kTileLaneGroups; ++q) {
      cnt[q] = __popc(mine[q]);
      lc += cnt[q];
    }
    int incl = lc;
#pragma unroll
    for (int o = 1; o < kWarp; o *= 2) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const int agg = __shfl_sync(0xffffffffu, incl, kWarp - 1);
    int* ws = ws0 + (long long)b * row;
    unsigned long long* status = reinterpret_cast<unsigned long long*>(ws);
    int excl = 0;
    if (tile == 0) {
      if (lane == 0) store_status(&status[0], kTilePrefix | (unsigned)agg);
    } else {
      excl = look_back(status, tile, agg);
    }
    if (lane == 0 && tile == n_tiles - 1) ws[head - 1] = excl + agg;
    if (agg == 0 && !translate) continue;

    // the ids of each free group that keeps a row, in row order, a
    // coalesced store of the warp
    int off[kTileLaneGroups];
    off[0] = excl + incl - lc;
#pragma unroll
    for (int q = 1; q < kTileLaneGroups; ++q) off[q] = off[q - 1] + cnt[q - 1];
    int* idx = ws + head;
#pragma unroll
    for (int q = 0; q < kTileLaneGroups; ++q) {
      for (unsigned live = __ballot_sync(0xffffffffu, mine[q] != 0); live;
           live &= live - 1) {
        const int j = __ffs(live) - 1;
        const unsigned bal = __shfl_sync(0xffffffffu, mine[q], j);
        const int pos = __shfl_sync(0xffffffffu, off[q], j) +
                        __popc(bal & lt);
        if (((bal >> lane) & 1u) != 0 && pos < cap)
          idx[pos] = (int)(base +
                           s_row[(j * kTileLaneGroups + q) * kWarp + lane]);
      }
    }
    if (translate) {                // every row's rank, -1 where not kept
#pragma unroll
      for (int q = 0; q < kTileLaneGroups; ++q) {
        s_bal[warp][lane * kTileLaneGroups + q] = mine[q];
        s_off[warp][lane * kTileLaneGroups + q] = off[q];
      }
      __syncwarp();
      int* slot_of = idx + cap;
      for (int g = 0; g < kTileGroups; ++g) {
        const long long i = base + g * kWarp + lane;
        const unsigned fw = s_free[g];
        int v = -1;
        if (((fw >> lane) & 1u) != 0) {
          const int p = s_fpre[g] + __popc(fw & lt), c = p / kWarp;
          const unsigned bal = s_bal[warp][c], below = (1u << (p % kWarp)) - 1u;
          if (((bal >> (p % kWarp)) & 1u) != 0)
            v = s_off[warp][c] + __popc(bal & below);
        }
        if (i < n) slot_of[i] = v;
      }
      __syncwarp();                 // before the warp's next binding
    }
  }
}

// B bindings of a `Tile` over shared columns through `bind`, binding b's
// workspace row b x tile_row_words words into `ws`: one 2-D memset of
// every row's head and one launch of tiles + B x pad shares blocks, the
// staged columns' Tile::kBytes a row in dynamic shared memory.
template <class Bind, class Tile>
int compact_tile_into(const Bind& bind, int B, long long n, int* ws,
                      long long ws_words, int cap, bool translate,
                      cudaStream_t stream) {
  const long long row = tile_row_words(n, cap, translate);
  if (row < 0 || cap < 1 || B < 1 || B > 65535 || ws_words < row * B)
    return (int)cudaErrorInvalidValue;
  const long long head = tile_head_words(n);
  cudaError_t err = cudaMemset2DAsync(ws, 4 * (size_t)row, 0,
                                      4 * (size_t)head, (size_t)B, stream);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = compact_tiles(n), pads = batch_pad_blocks(cap);
  const long long grid = tiles + (long long)B * pads;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Tile::kBytes * kCompactRows;
  auto kernel = compact_tile_kernel<Bind, Tile>;
  if (smem + kTileStaticSmem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)grid, kCompactBlock, smem, stream>>>(
      bind, B, n, (int)tiles, ws, row, head, cap, translate ? 1 : 0,
      (int)pads);
  return (int)cudaGetLastError();
}

}  // namespace repro
