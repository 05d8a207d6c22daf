// Masked grouped aggregation: per group g, the sum of every value column
// over the rows where the predicate holds and the group index is g, the
// number of such rows, and the exact number of rows where the predicate
// holds at all.  A value of a row the predicate drops, or of another
// group, never reaches a group's sum; a kept NaN or infinity reaches its
// own group's sum only (the reference oracle's `where`, not its Pallas
// kernel's one-hot product: see agg_regs.cuh).
//
// Replaces the Pallas kernels `filter_agg` (src/repro/kernels/
// filter_agg.py:58) and `selective_filter_agg` (:156).  With a compaction
// capacity, `selective_filter_agg` also emits the predicate-true row ids
// (and the key->slot vector) from its one pass; here the aggregation
// stores its predicate as one byte per row and the one-launch compaction
// of compact.cuh ranks that mask: 1 B/row written and read once more
// beyond the bound.  The Pallas kernel keeps one (G, A) accumulator
// resident in VMEM across a grid that runs in order.  A CUDA grid has no
// order and no resident accumulator, so every block writes a partial and
// the partials are added afterwards.
//
// Bound on the card: bytes.  The pass reads every input column once
// (mask 1 B/row, group index 4 B/row and 4 B/row per value column, or the
// columns a generated predicate and its values name) and writes G x A
// floats.  Two regimes, chosen from G and A alone (register_regime):
//
//   * register regime (G <= 8 and A <= 8, or G = 1 and A <= 16; every
//     call of the engine's main path): each thread keeps its own
//     (G, A) sums and G counts in registers and adds four consecutive
//     rows at a time, read as float4 / int4 / uchar4 where the column is
//     aligned for it; a row adds to a group by a predicated add
//     (RegAcc::add), so no atomics at all.  Each warp adds its threads'
//     accumulators by a shuffle tree, the block its warps in warp order,
//     and one partial per block goes out.  Rows go to threads by a fixed
//     grid stride over a grid that depends on n and the card only.  The
//     same launch then folds the partials: each block, once its partial
//     is out, fences and draws a ticket; the block that draws the last
//     one adds every block's partials in the fixed order of agg_regs.cuh
//     (lanes over rows in row order, a tree over lanes), writes the
//     result and sets the ticket back to 0.  So a call is one launch and
//     the same inputs give bit-identical sums in every call.
//   * shared-memory regime (everything larger, G x (A + 1) words within
//     one block's shared memory): each block reduces a contiguous chunk
//     of rows into (G, A) sums in shared memory, up to eight replicas,
//     one per warp; a thread keeps a running sum in registers while
//     consecutive rows of its stride fall into the same group and flushes
//     it with shared-memory atomics when the group changes.  The order of
//     those atomics is not fixed, so float sums may differ in the last
//     bits from run to run.  Its outputs reach G x (A + 1) = 57,000 words
//     over up to 1,024 partials, more than one block adds at speed, so a
//     second launch (agg_finalize_kernel, one block per 32 outputs) adds
//     them, in a fixed order too.
//
// The ticket is one int32 that the caller keeps for each (device,
// stream), zeroed once when it is made.  Launches on one stream run one
// after another, and the last block of each leaves the ticket at 0, so
// the next launch on that stream finds it at 0 and no two launches ever
// draw from one ticket at the same time; a launch on another stream has
// its own ticket.
//
// Workspace (int32 words, 16-byte aligned): nb rows of G x A + G + 1
// words padded to a multiple of 4 (agg_row_words), each [G x A float
// sums][G counts][predicate total][padding]; row b is block b's partial.
// The result `out` is one more row of that layout, 16-byte aligned: the
// wrappers put it right after the partials, in the same allocation, while
// the partials are small, and on its own otherwise, so that a kept result
// never holds large partials alive.  Counts and the predicate total are
// exact int32 throughout.
//
// The binding axis (the engine's bind-many pass; the reference vmaps its
// Pallas kernel into a batch grid axis): blockIdx.y is the binding, and a
// block reads binding b's rows through `bind.at(b)` (common.cuh): each
// operand carries a binding stride, 0 where the bindings share it, so a
// shared column stays one copy.  Binding b writes its partials at row b x
// gridDim.x of the workspace, its result `out_row` words past binding
// 0's, and draws from ticket b (the caller keeps one ticket a binding for
// each (device, stream), each left at 0 by its binding's last block).  The
// grid's x extent is the scalar launch's (the register regime takes it
// from the scalar instance's residency), so every binding runs the scalar
// launch's block partition and fold order: in the register regime binding
// b's sums are the scalar launch's on b's operands bit for bit.  B
// bindings are one launch (two in the shared-memory regime).
#pragma once

#include <atomic>

#include "agg_regs.cuh"
#include "common.cuh"

namespace repro {

constexpr int kAggBlock = 256;
// fewest rows a block is given, in the shared and the register regime
// (one quad a thread, so a call of a few hundred thousand rows still
// spreads over the whole card)
constexpr int kAggRowsPerBlock = 4096;
constexpr int kRegRowsPerBlock = 4 * kAggBlock;
constexpr int kAggMaxBlocks = 1024;      // partial rows a call may write
constexpr int kAggMaxReplicas = 8;
constexpr size_t kAggDefaultSmem = 48 * 1024;
constexpr size_t kAggStaticSmem = 1024;      // >= the kernel's static scratch
static_assert(kAggBlock == kFoldThreads, "the fold runs in one agg block");

// Outputs of a call: G x A sums, G counts, the total.
__host__ __device__ __forceinline__ int agg_outputs(int G, int A) {
  return G * A + G + 1;
}

// Words of one row of the workspace: the outputs, padded to a quad so
// that every row starts 16-byte aligned.
__host__ __device__ __forceinline__ int agg_row_words(int G, int A) {
  return (agg_outputs(G, A) + 3) / 4 * 4;
}

// The number of partials a call may write: its partial buffers hold
// that many blocks' sums.  The register regime launches at most as many
// blocks as are resident on the card at once.
inline int agg_blocks(long long n, int G, int A) {
  const long long per =
      register_regime(G, A) ? kRegRowsPerBlock : kAggRowsPerBlock;
  long long b = (n + per - 1) / per;
  if (b < 1) b = 1;
  if (b > kAggMaxBlocks) b = kAggMaxBlocks;
  return (int)b;
}

__device__ __forceinline__ bool aligned_to(const void* p, unsigned bytes) {
  return ((size_t)p & (bytes - 1)) == 0;
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

// The precomputed form over B bindings: each operand's binding stride in
// elements (0: shared by every binding).
template <int MAXA>
struct ColumnBatch {
  ColumnSource<MAXA> base;
  long long mask_stride, gidx_stride;
  long long col_stride[MAXA];
  __device__ __forceinline__ ColumnSource<MAXA> at(int b) const {
    ColumnSource<MAXA> s = base;
    s.mask += b * mask_stride;
    s.gidx += b * gidx_stride;
#pragma unroll
    for (int k = 0; k < MAXA; ++k)
      if (k < s.n_vals) s.cols[k] += b * col_stride[k];
    return s;
  }
};

// One row for the register regime, AM values (zeros past the source's).
template <class Src, int AM>
__device__ __forceinline__ void load_row(const Src& s, long long i, bool* m,
                                         int* g, float (&v)[AM]) {
#pragma unroll
  for (int k = 0; k < AM; ++k) v[k] = 0.f;
  *m = s.pred(i);
  *g = s.group(i);
  s.values(i, v);
}

template <int MAXA, int AM>
__device__ __forceinline__ void load_row(const ColumnSource<MAXA>& s,
                                         long long i, bool* m, int* g,
                                         float (&v)[AM]) {
  *m = s.mask[i] != 0;
  *g = __ldg(s.gidx + i);
#pragma unroll
  for (int k = 0; k < AM; ++k) {
    v[k] = 0.f;
    if (k < s.n_vals) v[k] = __ldg(s.cols[k] + i);
  }
}

// Rows i .. i + 3, all below n.  A generated source evaluates its
// expressions row by row; the precomputed columns are read 16 bytes (the
// mask 4 bytes) at a time wherever the column's address allows it (a
// column may be a view at any row offset).
template <class Src, int AM>
__device__ __forceinline__ void load_quad(const Src& s, long long i,
                                          bool* m, int* g, float (*v)[AM]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) load_row(s, i + r, m + r, g + r, v[r]);
}

template <int MAXA, int AM>
__device__ __forceinline__ void load_quad(const ColumnSource<MAXA>& s,
                                          long long i, bool* m, int* g,
                                          float (*v)[AM]) {
  if (aligned_to(s.mask + i, 4)) {
    const uchar4 u = __ldg(reinterpret_cast<const uchar4*>(s.mask + i));
    m[0] = u.x != 0; m[1] = u.y != 0; m[2] = u.z != 0; m[3] = u.w != 0;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) m[r] = s.mask[i + r] != 0;
  }
  if (aligned_to(s.gidx + i, 16)) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(s.gidx + i));
    g[0] = q.x; g[1] = q.y; g[2] = q.z; g[3] = q.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) g[r] = __ldg(s.gidx + i + r);
  }
#pragma unroll
  for (int k = 0; k < AM; ++k) {
    if (k >= s.n_vals) {
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r][k] = 0.f;
    } else if (aligned_to(s.cols[k] + i, 16)) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(s.cols[k] + i));
      v[0][k] = q.x; v[1][k] = q.y; v[2][k] = q.z; v[3][k] = q.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r][k] = __ldg(s.cols[k] + i + r);
    }
  }
}

// The register regime's fold, run by the grid's last block: adds `rows`
// partial rows of `stride` words (agg_row_words) into `out`, in the order
// of agg_regs.cuh (fold_lane over 16-byte quads, then fold_tree over
// lanes); words below GA are float sums, the rest int counts.
__device__ __forceinline__ void fold_rows(const int* ws, int rows, int* out,
                                          int stride, int O, int GA) {
  __shared__ WordQuad s_fold[kFoldThreads];
  const int quads = (O + 3) / 4, cols = fold_cols(quads);
  const int W = kFoldThreads / cols;
  const int t = threadIdx.x, q = t % cols, r = t / cols;
  const bool live = q < quads;
  bool is_sum[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) is_sum[c] = 4 * q + c < GA;
  WordQuad acc = {{0, 0, 0, 0}};
  if (live) fold_lane(ws + 4 * q, stride, rows, r, W, is_sum, acc.w);
  s_fold[t] = acc;
  __syncthreads();
  // lane r of quad column q is s_fold[r * cols + q]
  fold_tree(s_fold + q, cols, W, live ? r : W, W, is_sum);
  if (live && r == 0) *reinterpret_cast<WordQuad*>(out + 4 * q) = s_fold[t];
}

// kMask: also store the predicate in mask_out (a separate instantiation,
// so the engine's form pays nothing for it).  Binding b = blockIdx.y writes
// partial row b x gridDim.x + blockIdx.x; the last of its blocks to finish
// folds its rows into `out` + b x out_row and resets ticket b.
template <class Bind, int GM, int AM, bool kMask>
__global__ void __launch_bounds__(kAggBlock)
agg_reg_kernel(Bind bind, long long n, int G, int A, int* ws, int* out0,
               long long out_row, int* ticket0, uint8_t* mask0) {
  constexpr int kWarps = kAggBlock / kWarp;
  static_assert(GM * AM + GM + 1 <= 4 * kFoldThreads, "a fold lane a quad");
  __shared__ float s_sum[kWarps][GM * AM];
  __shared__ int s_cnt[kWarps][GM + 1];
  __shared__ int s_last;
  const long long bind_at = blockIdx.y;
  const auto src = bind.at((int)bind_at);
  int* out = out0 + bind_at * out_row;
  int* ticket = ticket0 + bind_at;
  uint8_t* mask_out = kMask ? mask0 + bind_at * n : nullptr;
  RegAcc<GM, AM> acc;
  acc.zero();

  const long long quads = n / 4;
  const long long stride = (long long)gridDim.x * kAggBlock;
  const long long t = (long long)blockIdx.x * kAggBlock + threadIdx.x;
  for (long long q = t; q < quads; q += stride) {
    const long long i = 4 * q;
    bool m[4];
    int g[4];
    float v[4][AM];
    load_quad(src, i, m, g, v);
    if constexpr (kMask) {
      if (aligned_to(mask_out + i, 4)) {
        *reinterpret_cast<uchar4*>(mask_out + i) =
            make_uchar4(m[0], m[1], m[2], m[3]);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) mask_out[i + r] = m[r] ? 1 : 0;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) acc.add(m[r], g[r], G, v[r]);
  }
  if (t < n - 4 * quads) {          // the last n % 4 rows
    const long long i = 4 * quads + t;
    bool m;
    int g;
    float v[AM];
    load_row(src, i, &m, &g, v);
    if constexpr (kMask) mask_out[i] = m ? 1 : 0;
    acc.add(m, g, G, v);
  }

  // warps by shuffle trees, then the block's warps in warp order
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
#pragma unroll
  for (int j = 0; j < GM; ++j) {
    if (j >= G) break;
#pragma unroll
    for (int k = 0; k < AM; ++k) {
      if (k >= A) break;
      const float s = warp_sum(acc.sum[j][k]);
      if (lane == 0) s_sum[warp][j * AM + k] = s;
    }
    const int c = warp_sum(acc.cnt[j]);
    if (lane == 0) s_cnt[warp][j] = c;
  }
  const int kept = warp_sum(acc.kept);
  if (lane == 0) s_cnt[warp][GM] = kept;
  __syncthreads();

  const int GA = G * A, O = agg_outputs(G, A), words = agg_row_words(G, A);
  ws += bind_at * gridDim.x * words;
  int* row = ws + (long long)blockIdx.x * words;
  for (int o = threadIdx.x; o < words; o += kAggBlock) {
    if (o >= O) {
      row[o] = 0;                   // the row's padding
    } else if (o < GA) {
      const int at = (o / A) * AM + o % A;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_sum[w][at];
      row[o] = __float_as_int(s);
    } else {
      const int at = o < GA + G ? o - GA : GM;
      int c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += s_cnt[w][at];
      row[o] = c;
    }
  }

  // the fold: the block that draws the last ticket adds every partial
  __threadfence();                  // this block's row before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();                  // every other row, after the ticket
  fold_rows(ws, (int)gridDim.x, out, words, O, GA);
  if (threadIdx.x == 0) *ticket = 0;
}

template <class Bind, int NV, bool kMask>
__global__ void __launch_bounds__(kAggBlock)
agg_shared_kernel(Bind bind, long long n, long long chunk, int G, int A,
                  int reps, int* ws, uint8_t* mask0) {
  constexpr int kV = NV > 0 ? NV : 1;
  const long long bind_at = blockIdx.y;
  const auto src = bind.at((int)bind_at);
  uint8_t* mask_out = kMask ? mask0 + bind_at * n : nullptr;
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

  int* row = ws + (bind_at * gridDim.x + blockIdx.x) * agg_row_words(G, A);
  for (int j = threadIdx.x; j < GA; j += kAggBlock) {
    float s = 0.f;
    for (int r = 0; r < reps; ++r) s += s_sums[(size_t)r * GA + j];
    row[j] = __float_as_int(s);
  }
  for (int j = threadIdx.x; j < G; j += kAggBlock) {
    int c = 0;
    for (int r = 0; r < reps; ++r) c += s_counts[r * G + j];
    row[GA + j] = c;
  }
  const int t = block_sum<kAggBlock>(kept, scratch);
  if (threadIdx.x == 0) row[GA + G] = t;
}

constexpr int kFinWarps = 32;

// Adds p[w s], p[(w + 32) s], ... below p[nb s] in that order, loading
// four at a time so that four loads are in flight.
template <class T>
__device__ __forceinline__ T strided_sum(const T* p, int w, int nb,
                                         long long s) {
  T acc = 0;
  int b = w;
  for (; b + 3 * kFinWarps < nb; b += 4 * kFinWarps) {
    T x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = p[(b + r * kFinWarps) * s];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc += x[r];
  }
  for (; b < nb; b += kFinWarps) acc += p[b * s];
  return acc;
}

// The shared-memory regime's second launch: `out` = the sum of rows 0 ..
// nb - 1 (rows of `stride` words, O of them outputs), for binding
// blockIdx.y: its rows start b x nb rows into `ws`, its result out_row
// words past binding 0's.  A block takes 32
// outputs, one per lane, so each warp's reads are contiguous; warp w adds
// the partials of blocks w, w + 32, ... in block order, and the 32 warps'
// sums are added by a tree over warps (16, 8, 4, 2, 1 apart).  The order
// is the same in every call.
__global__ void __launch_bounds__(kWarp * kFinWarps)
agg_finalize_kernel(const int* ws, int* out, int nb, int stride, int O,
                    int GA, long long out_row) {
  __shared__ float s_f[kFinWarps][kWarp + 1];
  __shared__ int s_i[kFinWarps][kWarp + 1];
  ws += (long long)blockIdx.y * nb * stride;
  out += (long long)blockIdx.y * out_row;
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const long long o = (long long)blockIdx.x * kWarp + lane;
  float f = 0.f;
  int c = 0;
  if (o < GA)
    f = strided_sum(reinterpret_cast<const float*>(ws) + o, w, nb, stride);
  else if (o < O)
    c = strided_sum(ws + o, w, nb, stride);
  s_f[w][lane] = f;
  s_i[w][lane] = c;
  __syncthreads();
#pragma unroll
  for (int s = kFinWarps / 2; s > 0; s /= 2) {
    if (w < s) {
      s_f[w][lane] += s_f[w + s][lane];
      s_i[w][lane] += s_i[w + s][lane];
    }
    __syncthreads();
  }
  if (w == 0 && o < O)
    out[o] = o < GA ? __float_as_int(s_f[0][lane]) : s_i[0][lane];
}

constexpr int kMaxDevices = 64;

// Blocks of `kernel` resident on the current device at once, asked of
// the CUDA runtime on a device's first call only and kept in `known` (one
// array per kernel instance): the value depends on the instance and the
// device alone, so threads that race to store it store the same number.
template <class K>
int resident_blocks(K kernel, std::atomic<int>* known, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices) {
    *out = known[dev].load(std::memory_order_relaxed);
    if (*out > 0) return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kAggBlock, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  if (dev < kMaxDevices) known[dev].store(*out, std::memory_order_relaxed);
  return 0;
}

// Blocks of the scalar register-regime instance resident on the card at
// once: the grid of its launch, and of a batched launch over the same
// source, so that both partition the rows the same way.
template <class Src, int GM, int AM, bool kMask>
int reg_resident(int* out) {
  static std::atomic<int> known[kMaxDevices];
  return resident_blocks(agg_reg_kernel<OneBinding<Src>, GM, AM, kMask>,
                         known, out);
}

// Launches the register regime (and its fold) over at most `nb` blocks a
// binding, no more than the scalar instance has resident on the card at
// once, and B bindings.
template <class Bind, int GM, int AM, bool kMask>
int launch_reg(Bind bind, int B, long long n, int G, int A, int* ws, int nb,
               int* out, long long out_row, int* ticket, uint8_t* mask_out,
               cudaStream_t stream) {
  using Src = bound_source_t<Bind>;
  int resident = 0;
  const int err = reg_resident<Src, GM, AM, kMask>(&resident);
  if (err != 0) return err;
  const int grid = nb < resident ? nb : resident;
  agg_reg_kernel<Bind, GM, AM, kMask>
      <<<dim3((unsigned)grid, (unsigned)B), kAggBlock, 0, stream>>>(
          bind, n, G, A, ws, out, out_row, ticket, mask_out);
  return (int)cudaGetLastError();
}

// The mask-storing instance exists for the scalar launch only.
template <class Bind, int GM, int AM>
int launch_reg(Bind bind, int B, long long n, int G, int A, int* ws, int nb,
               int* out, long long out_row, int* ticket, uint8_t* mask_out,
               cudaStream_t stream) {
  if constexpr (is_one_binding<Bind>::value) {
    if (mask_out != nullptr)
      return launch_reg<Bind, GM, AM, true>(bind, B, n, G, A, ws, nb, out,
                                            out_row, ticket, mask_out,
                                            stream);
  } else if (mask_out != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_reg<Bind, GM, AM, false>(bind, B, n, G, A, ws, nb, out,
                                         out_row, ticket, nullptr, stream);
}

// The shared regime and its second launch, B bindings.
template <class Bind, int NV>
int launch_shared(Bind bind, int B, long long n, int G, int A, int* ws,
                  int nb, int* out, long long out_row, uint8_t* mask_out,
                  cudaStream_t stream) {
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
  void (*kernel)(Bind, long long, long long, int, int, int, int*, uint8_t*) =
      agg_shared_kernel<Bind, NV, false>;
  if constexpr (is_one_binding<Bind>::value) {
    if (mask_out != nullptr) kernel = agg_shared_kernel<Bind, NV, true>;
  } else if (mask_out != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > budget) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long chunk = (n + nb - 1) / nb;
  if (chunk < 1) chunk = 1;
  kernel<<<dim3((unsigned)nb, (unsigned)B), kAggBlock, smem, stream>>>(
      bind, n, chunk, G, A, (int)reps, ws, mask_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int O = agg_outputs(G, A);
  agg_finalize_kernel<<<dim3((unsigned)((O + kWarp - 1) / kWarp),
                             (unsigned)B),
                        kWarp * kFinWarps, 0, stream>>>(
      ws, out, nb, agg_row_words(G, A), O, G * A, out_row);
  return (int)cudaGetLastError();
}

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// B bindings through `bind` (common.cuh).  `nb` must be agg_blocks(n, G,
// A); `ws` holds B x nb x agg_row_words(G, A) words and `out` B rows of
// that layout, `out_row` words apart (the layout above), and `ticket` B
// tickets, at 0.  `mask_out` (nullable; the scalar launch only) receives
// the predicate as one byte per row, for the compaction of compact.cuh to
// rank.  NV bounds A at compile time; GC is G where the source fixes it (a
// generated source), 0 where G comes at run time (filter_agg.cu), so that
// only the regimes a source can take are instantiated.
template <class Bind, int NV, int GC = 0>
int launch_agg_batch(Bind bind, int B, long long n, int G, int A, int nb,
                     int* ws, int* out, long long out_row, int* ticket,
                     uint8_t* mask_out, cudaStream_t stream) {
  constexpr int kV = NV > 0 ? NV : 1;
  if (A > NV || (GC > 0 && G != GC) || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if constexpr (GC > 0) {
    if constexpr (register_regime(GC, NV))
      return launch_reg<Bind, GC, kV>(bind, B, n, G, A, ws, nb, out, out_row,
                                      ticket, mask_out, stream);
    else
      return launch_shared<Bind, NV>(bind, B, n, G, A, ws, nb, out, out_row,
                                     mask_out, stream);
  } else if (register_regime(G, A)) {
    if (G == 1)
      return launch_reg<Bind, 1, cmin(kV, kRegMaxValsOneGroup)>(
          bind, B, n, G, A, ws, nb, out, out_row, ticket, mask_out, stream);
    return launch_reg<Bind, kRegMaxGroups, cmin(kV, kRegMaxVals)>(
        bind, B, n, G, A, ws, nb, out, out_row, ticket, mask_out, stream);
  }
  return launch_shared<Bind, NV>(bind, B, n, G, A, ws, nb, out, out_row,
                                 mask_out, stream);
}

// The scalar launch: one binding.  `ws` holds nb x agg_row_words(G, A)
// words and `out` one such row, and `ticket` is the stream's ticket, at 0.
template <class Src, int NV, int GC = 0>
int launch_agg(Src src, long long n, int G, int A, int nb, int* ws, int* out,
               int* ticket, uint8_t* mask_out, cudaStream_t stream) {
  return launch_agg_batch<OneBinding<Src>, NV, GC>(
      OneBinding<Src>{src}, 1, n, G, A, nb, ws, out, 0, ticket, mask_out,
      stream);
}

}  // namespace repro
