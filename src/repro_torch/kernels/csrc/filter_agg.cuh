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
// bindings are one launch (two in the shared-memory regime).  That is
// `filter_agg_batched`'s layout where its group index or a value column
// is itself batched; its register regime over a shared group index and
// shared value columns (every engine call), and the batched selective
// aggregation's register regime, run a kernel of their own
// (agg_staged_kernel, below), which reads the columns the bindings share
// once a cluster, not once a binding.
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

// -- the staged register regime: a warp a binding, columns multicast ------
//
// The batched selective aggregation (`selective_filter_agg_batched`, a
// generated source over B bindings) in the register regime.  Binding b's
// partition, quad order and fold are the scalar launch's, so its sums are
// the scalar launch's bit for bit: `parts` blocks of 256 scalar threads
// (the scalar instance's residency, its grid), scalar thread t adding
// quads t, t + stride, ... (stride = parts x 256 quads) and its tail row,
// each warp's sums added by the shuffle tree, each block's warps in warp
// order into its partial row, and the partial rows folded in the order of
// agg_regs.cuh.
//
// What bounds the scalar layout at B bindings is not the columns' reads
// from device memory but their delivery into the SMs: every binding's
// block needs every shared column's rows in its own SM, B times the
// columns in all (10.75 GB for q1 at 64 bindings), and one SM takes them
// in at a few tens of GB/s.  The register accumulators (G x A sums a
// scalar thread) allow about one block of 256 threads of a binding on an
// SM at once, so one SM cannot serve many bindings' blocks from one
// copy.  A warp can: a work unit here is one warp of one partition, the
// 32 scalar threads t = 32 u + lane (u = 8 x + w: partition x, warp w),
// all their steps, and a block is 8 or 16 warps, each warp that unit for
// another binding.  So the unit's rows enter the SM once for all of the
// block's bindings.
//
//   * clusters of C blocks along the bindings (C x warps-a-block bindings a
//     group, B padded to whole groups); the grid is C x K, K the clusters
//     resident at once on the card rounded down to a multiple of the
//     groups, which share the units x groups work items round robin, one
//     wave in all: cluster k serves group k mod groups, so a warp's
//     binding is fixed;
//   * up to kStepsPerSlot steps of a unit (each its warp's 128 rows:
//     kStageRows) are one slot of the cluster's ring: every staged
//     column's slice of each goes once into the shared memory of all C
//     blocks by a bulk copy with multicast, column c issued by block c
//     mod C, a lane a copy; a ring of agg_stages(bytes) slots keeps the
//     next ones in flight;
//   * a block's last warp is its producer: per slot it waits for the
//     block's compute warps to be done with the slot's last use (a `done`
//     mbarrier, one arrival a warp), tells every block of the cluster so
//     (an `empty` mbarrier in each, C arrivals), waits for all of them,
//     and issues the slot's copies, which land on each block's `full`
//     mbarrier (its expected bytes); a compute warp only waits for `full`
//     and arrives on `done`, so neither the cluster's arrivals nor the
//     copies' issue ever holds the adds up;
//   * a staged column is one every binding shares, contiguous, 16-byte
//     aligned (the wrapper decides; filter_agg.staged_columns); the
//     others, and the parameters, are read from device memory as in the
//     scalar kernel, as is a step a warp's quads pass the last whole quad
//     in, and the tail rows;
//   * a unit's warp sums go to its binding's warp row (x, w) in the
//     workspace; once all its units are written, each warp draws its
//     binding's ticket (K / groups warps serve a binding), and the block
//     of the last one has its compute warps add each partition's 8 warp
//     rows in warp order (the scalar block's sum) and fold the partial
//     rows;
//   * padding warps (binding >= B) take part in the barriers and write
//     nothing; a cluster barrier at the start (the barriers initialised)
//     and the end (no block leaves while a peer may still arrive on its
//     barriers).
//
// `Stage` derives from the binding's row source (generated by codegen.py)
// and adds the staged columns: `kCols`, `kBytes` (one stage), `each(f)`
// (f(column, element bytes, offset in the stage) for each), `load(stage,
// quad)` (a lane's quad of each staged column, one vector load each, into
// registers) and `pred_q`, `group_q`, `values_q`, which read those
// registers (row i is slot r of the quad) and device memory for the rest.
//
// A Stage may also fetch a column of its own binding (`kFetch`,
// `fetch(step, row)`, `load_fetched(step)`): the precomputed form's
// ColumnStage does, for its batched mask.  The compute warp issues a
// slot's loads of it from device memory before it waits for the slot, so
// they are in flight while the ring fills (a bulk copy a binding and step
// into the stage was measured 2.3 times slower: 128 small copies a slot
// held the producer warp).
//
// Workspace of a binding (9 x parts rows of agg_row_words words, the
// binding's at b x 9 x parts rows): the warp rows of unit u at row u, the
// partial rows at 8 parts + x.  Bound on the card: the operands' bytes
// once, or the register step's G x (A + 1) predicated adds a row and
// binding (q1: G = 6, A = 7).  The instance's (GM, AM) may exceed (G, A)
// (the precomputed form instantiates a few): a thread's sums of groups
// and values past (G, A) stay 0 and are never written, so the sums that
// are written are those of the (G, A) instance bit for bit.
constexpr int kStageRows = 4 * kWarp;         // a warp's rows of a step
constexpr int kAggWarps = kAggBlock / kWarp;  // warps of a scalar block
constexpr int kAggMaxCluster = 8;             // the portable cluster size
constexpr int kStageBudget = 128 * 1024;      // bytes of a block's ring
constexpr int kMaxStages = 16;
constexpr int kStepsPerSlot = 8;              // a unit's steps a ring slot

__host__ __device__ constexpr int agg_stages(int bytes) {
  return bytes <= 0 ? 1
                    : (kStageBudget / bytes < 2
                           ? 2
                           : (kStageBudget / bytes > kMaxStages
                                  ? kMaxStages
                                  : kStageBudget / bytes));
}

// Warps (bindings) a block of the staged kernel: 8 for up to 8 bindings,
// else 16 (registers allow 16 warps of the register step on an SM).
__host__ __device__ constexpr int staged_warps(int B) {
  return B <= 8 ? 8 : 16;
}

// Whether a Stage fetches a column of its own binding (kFetch).
template <class S, class = void>
struct stage_fetches : std::false_type {};
template <class S>
struct stage_fetches<S, std::void_t<decltype(S::kFetch)>> : std::true_type {};

// The precomputed form's Stage (`filter_agg_batched` in the staged
// register regime): the group index and the value columns are staged,
// each one that every binding shares, contiguous and 16-byte aligned (the
// wrapper decides: filter_agg.staged_operands); the mask, which is
// batched, is fetched by each binding's warp.  A (B, n) mask of odd n
// (5,999,771 rows at SF 1) puts every other binding's rows at an odd
// address, so a lane reads its quad as the one or two aligned words that
// hold it (each holds a byte of the quad, so neither leaves the mask's
// allocation) and funnels them by the quad's offset.  AM value columns at
// most (the instance's register step), n_vals of them staged.
template <int MAXA, int AM>
struct ColumnStage : ColumnSource<MAXA> {
  static constexpr int kCols = 1 + AM;
  static constexpr int kBytes = kCols * 4 * kStageRows;
  static constexpr bool kFetch = true;
  int qg[4];
  float qv[AM][4];
  bool qm[4];
  unsigned mw[kStepsPerSlot][2];   // a slot's mask words, a quad a step

  template <class F>
  __device__ __forceinline__ void each(F&& f) const {
    f(reinterpret_cast<const unsigned char*>(this->gidx), 4, 0);
#pragma unroll
    for (int k = 0; k < AM; ++k)
      if (k < this->n_vals)
        f(reinterpret_cast<const unsigned char*>(this->cols[k]), 4,
          (1 + k) * 4 * kStageRows);
  }
  __device__ __forceinline__ void load(const unsigned char* stage,
                                       int quad) {
    const int4 g = reinterpret_cast<const int4*>(stage)[quad];
    qg[0] = g.x; qg[1] = g.y; qg[2] = g.z; qg[3] = g.w;
#pragma unroll
    for (int k = 0; k < AM; ++k) {
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < this->n_vals)
        w = reinterpret_cast<const float4*>(stage +
                                            (1 + k) * 4 * kStageRows)[quad];
      qv[k][0] = w.x; qv[k][1] = w.y; qv[k][2] = w.z; qv[k][3] = w.w;
    }
  }
  __device__ __forceinline__ void fetch(int ts, long long i) {
    const uint8_t* a = this->mask + i;
    const unsigned s = (unsigned)((size_t)a & 3);
    const unsigned* w = reinterpret_cast<const unsigned*>(a - s);
    mw[ts][0] = __ldg(w);
    mw[ts][1] = s != 0 ? __ldg(w + 1) : 0u;
  }
  __device__ __forceinline__ void load_fetched(int ts) {
    const unsigned s = (unsigned)((size_t)this->mask & 3);
    const unsigned v = __funnelshift_r(mw[ts][0], mw[ts][1], 8 * s);
#pragma unroll
    for (int r = 0; r < 4; ++r) qm[r] = ((v >> (8 * r)) & 0xffu) != 0;
  }
  __device__ __forceinline__ bool pred_q(long long, int r) const {
    return qm[r];
  }
  __device__ __forceinline__ int group_q(long long, int r) const {
    return qg[r];
  }
  __device__ __forceinline__ void values_q(long long, int r,
                                           float* v) const {
#pragma unroll
    for (int k = 0; k < AM; ++k) v[k] = qv[k][r];
  }
};

// Rows i .. i + 3, the staged columns in the quad's registers.
template <class St, int AM>
__device__ __forceinline__ void load_quad_staged(const St& s, long long i,
                                                 bool* m, int* g,
                                                 float (*v)[AM]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < AM; ++k) v[r][k] = 0.f;
    m[r] = s.pred_q(i + r, r);
    g[r] = s.group_q(i + r, r);
    s.values_q(i + r, r, v[r]);
  }
}

// The steps in which every quad of unit u (its first quad 32 u) lies below
// the last quad (32-bit: n < 2^31).
__device__ __forceinline__ unsigned unit_full_steps(unsigned u, unsigned quads,
                                                    unsigned stride) {
  const unsigned first = u * kWarp;
  return quads >= first + kWarp ? (quads - first - kWarp) / stride + 1 : 0;
}

// A barrier of the block's compute warps (`threads` of them), apart from
// its producer warp.
__device__ __forceinline__ void compute_sync(int threads) {
  asm volatile("bar.sync 1, %0;" :: "r"(threads) : "memory");
}

// One arrival of this thread on the block's own barrier `bar`.
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// The register regime's fold (fold_rows, in its order: fold_lane, then
// the tree of fold_tree) by the block's compute warps (`threads` >=
// kFoldThreads of them), their first kFoldThreads threads folding.
__device__ __forceinline__ void fold_rows_compute(const int* ws, int rows,
                                                  int* out, int stride, int O,
                                                  int GA, int threads) {
  __shared__ WordQuad s_fold[kFoldThreads];
  const int quads = (O + 3) / 4, cols = fold_cols(quads);
  const int W = kFoldThreads / cols;
  const int t = threadIdx.x, q = t % cols, r = t / cols;
  const bool live = t < kFoldThreads && q < quads;
  bool is_sum[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) is_sum[c] = 4 * q + c < GA;
  WordQuad acc = {{0, 0, 0, 0}};
  if (live) fold_lane(ws + 4 * q, stride, rows, r, W, is_sum, acc.w);
  if (t < kFoldThreads) s_fold[t] = acc;
  compute_sync(threads);
  for (int h = W / 2; h > 0; h /= 2) {
    if (live && r < h) {
      WordQuad a = s_fold[r * cols + q];
      const WordQuad b = s_fold[(r + h) * cols + q];
#pragma unroll
      for (int c = 0; c < 4; ++c) a.w[c] = add_word(a.w[c], b.w[c], is_sum[c]);
      s_fold[r * cols + q] = a;
    }
    compute_sync(threads);
  }
  if (live && r == 0) *reinterpret_cast<WordQuad*>(out + 4 * q) = s_fold[t];
}

// KB compute warps (a binding each) and, last, the producer warp.
template <class Bind, class Stage, int GM, int AM, int KB>
__global__ void __launch_bounds__((KB + 1) * kWarp, 1)
agg_staged_kernel(Bind bind, int B, long long n, int G, int A, int parts,
                  int groups, int* ws0, int* out0, long long out_row,
                  int* ticket0) {
  using Src = bound_source_t<Bind>;
  constexpr int kSlot = kStepsPerSlot * Stage::kBytes;   // a slot's bytes
  constexpr int S = agg_stages(kSlot);
  constexpr int kCompute = KB * kWarp;
  static_assert(kCompute >= kFoldThreads, "the fold takes 256 threads");
  __shared__ unsigned long long s_full[S], s_done[S], s_empty[S];
  __shared__ int s_last[KB];
  extern __shared__ __align__(128) unsigned char s_stage[];
  const int lane = threadIdx.x % kWarp, kb = threadIdx.x / kWarp;
  const unsigned K = gridDim.y, units = (unsigned)parts * kAggWarps;
  const unsigned items = units * (unsigned)groups;
  const unsigned quads = (unsigned)(n / 4);
  const unsigned stride = (unsigned)parts * kAggBlock;
  const int GA = G * A, O = agg_outputs(G, A), words = agg_row_words(G, A);
  const long long rows_b = (long long)(kAggWarps + 1) * parts;
  // K is a multiple of groups, so cluster k serves binding group k % groups
  // in every item it takes: a warp's binding is fixed
  const int group = (int)(blockIdx.y % (unsigned)groups);
  unsigned rank = 0, C = 1;
  if constexpr (Stage::kCols > 0) {
    rank = cluster_rank();
    C = cluster_blocks();
  }
  if (threadIdx.x < KB) s_last[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      mbar_init(&s_full[k], 1);
      mbar_init(&s_done[k], KB);
      mbar_init(&s_empty[k], C);
    }
    mbar_init_fence();
  }
  if constexpr (Stage::kCols > 0)
    cluster_sync();     // every barrier of the cluster set before a copy
  else
    __syncthreads();

  if (kb == KB) {       // the producer warp: the ring's copies
    if constexpr (Stage::kCols > 0) {
      Stage st;         // the staged columns, which every binding shares
      static_cast<Src&>(st) = bind.at(0);
      // this lane's (column, step) pair of each round of kWarp pairs: the
      // block copies column c where c mod C is its rank
      constexpr int kRounds =
          (Stage::kCols * kStepsPerSlot + kWarp - 1) / kWarp;
      const unsigned char* lsrc[kRounds];
      int lsize[kRounds], loff[kRounds], lstep[kRounds];
#pragma unroll
      for (int rd = 0; rd < kRounds; ++rd) {
        const int p = rd * kWarp + lane, want = p / kStepsPerSlot;
        lstep[rd] = p % kStepsPerSlot;
        lsrc[rd] = nullptr;
        lsize[rd] = loff[rd] = 0;
        int c = 0, o = 0;
        st.each([&](const unsigned char* col, int sz, int of) {
          if ((unsigned)(c++ % (int)C) == rank && o++ == want) {
            lsrc[rd] = col;
            lsize[rd] = sz;
            loff[rd] = of;
          }
        });
      }
      // the bytes of a step: every staged column's slice (ColumnStage
      // stages n_vals + 1 of its kCols)
      unsigned step_tx = Stage::kBytes;
      if constexpr (stage_fetches<Stage>::value) {
        step_tx = 0;
        st.each([&](const unsigned char*, int sz, int) {
          step_tx += (unsigned)sz * kStageRows;
        });
      }
      unsigned j = 0;   // the ring's slot: stage j % S, its use j / S
      for (unsigned i = blockIdx.y; i < items; i += K) {
        const unsigned u = i / (unsigned)groups;
        const unsigned full = unit_full_steps(u, quads, stride);
        for (unsigned s0 = 0; s0 < full; s0 += kStepsPerSlot, ++j) {
          const int nt = full - s0 < (unsigned)kStepsPerSlot
                             ? (int)(full - s0) : kStepsPerSlot;
          const int k = (int)(j % S);
          if (j >= S) {   // stage k's last use, slot j - S, released by
            const unsigned ph = (j / S - 1) & 1;   // every block
            mbar_wait(&s_done[k], ph);
            if (lane < (int)C) mbar_arrive_cluster(&s_empty[k], lane);
            mbar_wait_cluster(&s_empty[k], ph);
          }
          unsigned char* slot = s_stage + (size_t)k * kSlot;
          if (lane == 0) mbar_expect_tx(&s_full[k], nt * step_tx);
          __syncwarp();
          // (column, step) pairs, a lane each: one copy instruction for
          // all of them at once
#pragma unroll
          for (int rd = 0; rd < kRounds; ++rd) {
            const int t = lstep[rd];
            const long long row0 =
                4ll * ((long long)(s0 + t) * stride + (long long)u * kWarp);
            if (lsrc[rd] != nullptr && t < nt)
              bulk_copy_multicast(slot + t * Stage::kBytes + loff[rd],
                                  lsrc[rd] + row0 * lsize[rd],
                                  (unsigned)(lsize[rd] * kStageRows),
                                  &s_full[k],
                                  (unsigned short)((1u << C) - 1u));
          }
        }
      }
    }
  } else {              // a compute warp: binding (group, block, kb)
    const int bind_at = (group * (int)gridDim.x + blockIdx.x) * KB + kb;
    const bool live = bind_at < B;
    Stage st;
    static_cast<Src&>(st) = bind.at(live ? bind_at : 0);
    const Src& src = st;
    int* ws = ws0 + (long long)bind_at * rows_b * words;
    unsigned j = 0;
    for (unsigned i = blockIdx.y; i < items; i += K) {
      const unsigned u = i / (unsigned)groups;
      RegAcc<GM, AM> acc;
      acc.zero();
      const long long t = (long long)u * kWarp + lane;   // scalar thread
      const unsigned steps =
          u * kWarp < quads ? (quads - u * kWarp + stride - 1) / stride : 0;
      unsigned full = 0;
      if constexpr (Stage::kCols > 0) {
        full = unit_full_steps(u, quads, stride);
        for (unsigned s0 = 0; s0 < full; s0 += kStepsPerSlot, ++j) {
          const int nt = full - s0 < (unsigned)kStepsPerSlot
                             ? (int)(full - s0) : kStepsPerSlot;
          const int k = (int)(j % S);
          if constexpr (stage_fetches<Stage>::value) {
            if (live) {
#pragma unroll
              for (int ts = 0; ts < kStepsPerSlot; ++ts)
                if (ts < nt)
                  st.fetch(ts, 4 * ((long long)(s0 + ts) * stride + t));
            }
          }
          mbar_wait(&s_full[k], (j / S) & 1);
          if (live) {
            const unsigned char* slot = s_stage + (size_t)k * kSlot;
            auto one_step = [&](int ts) {
              const unsigned char* step = slot + ts * Stage::kBytes;
              st.load(step, lane);
              if constexpr (stage_fetches<Stage>::value) st.load_fetched(ts);
              bool m[4];
              int g[4];
              float v[4][AM];
              load_quad_staged(st,
                               4 * ((long long)(s0 + ts) * stride + t), m, g,
                               v);
#pragma unroll
              for (int r = 0; r < 4; ++r) acc.add(m[r], g[r], G, v[r]);
            };
            if constexpr (stage_fetches<Stage>::value) {
#pragma unroll
              for (int ts = 0; ts < kStepsPerSlot; ++ts)
                if (ts < nt) one_step(ts);
            } else {
              for (int ts = 0; ts < nt; ++ts) one_step(ts);
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&s_done[k]);   // the warp is done
        }
      }
      if (!live) continue;
      for (unsigned s = full; s < steps; ++s) {    // quads past the last
        const long long q = (long long)s * stride + t;   // whole step:
        if (q < quads) {                                 // device memory
          bool m[4];
          int g[4];
          float v[4][AM];
          load_quad(src, 4 * q, m, g, v);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc.add(m[r], g[r], G, v[r]);
        }
      }
      if (t < n - 4ll * quads) {                   // the last n % 4 rows
        bool m;
        int g;
        float v[AM];
        load_row(src, 4ll * quads + t, &m, &g, v);
        acc.add(m, g, G, v);
      }
      // the warp's sums by the shuffle tree, into its warp row u: G and A
      // are the instance's GM and AM (launch_agg_staged; AM is 1 where A
      // is 0), so the GM x AM trees unroll and interleave
      float sums[GM][AM];
      int cnts[GM];
#pragma unroll
      for (int jg = 0; jg < GM; ++jg) {
#pragma unroll
        for (int k = 0; k < AM; ++k) sums[jg][k] = warp_sum(acc.sum[jg][k]);
        cnts[jg] = warp_sum(acc.cnt[jg]);
      }
      const int kept = warp_sum(acc.kept);
      if (lane == 0 && G == GM && A == AM) {
        // the row [sums][counts][kept][0 ...] by quads, constant indices
        constexpr int kWords = (GM * AM + GM + 1 + 3) / 4 * 4;
        int w[kWords];
#pragma unroll
        for (int o = 0; o < kWords; ++o) w[o] = 0;
#pragma unroll
        for (int jg = 0; jg < GM; ++jg) {
#pragma unroll
          for (int k = 0; k < AM; ++k)
            w[jg * AM + k] = __float_as_int(sums[jg][k]);
          w[GM * AM + jg] = cnts[jg];
        }
        w[GM * AM + GM] = kept;
        int4* row = reinterpret_cast<int4*>(ws + (long long)u * words);
#pragma unroll
        for (int q = 0; q < kWords / 4; ++q)
          row[q] = make_int4(w[4 * q], w[4 * q + 1], w[4 * q + 2],
                             w[4 * q + 3]);
      } else if (lane == 0) {
        // (G, A) below the instance's (GM, AM), or A = 0 where AM is 1:
        // the row of (G, A) word by word
        int* row = ws + (long long)u * words;
#pragma unroll
        for (int jg = 0; jg < GM; ++jg) {
          if (jg >= G) break;
#pragma unroll
          for (int k = 0; k < AM; ++k)
            if (k < A) row[jg * A + k] = __float_as_int(sums[jg][k]);
          row[GA + jg] = cnts[jg];
        }
        row[GA + G] = kept;
        for (int o = O; o < words; ++o) row[o] = 0;
      }
    }
    // every unit of the binding's group that this warp took is written:
    // the binding's ticket counts the K / groups warps that serve it
    if (live && lane == 0) {
      __threadfence();            // the rows before the ticket
      if (atomicAdd(ticket0 + bind_at, 1) == (int)(K / groups) - 1)
        s_last[kb] = 1;
    }
    compute_sync(kCompute);
    for (int f = 0; f < KB; ++f) {    // a binding's last warp: the fold
      if (!s_last[f]) continue;
      const int fb = (group * (int)gridDim.x + blockIdx.x) * KB + f;
      int* fws = ws0 + (long long)fb * rows_b * words;
      int* prow = fws + (long long)kAggWarps * parts * words;
      __threadfence();                // every warp row, after the ticket
      for (long long e = threadIdx.x; e < (long long)parts * words;
           e += kCompute) {           // partition x: its warps in order
        const long long x = e / words;
        const int o = (int)(e % words);
        const int* w0 = fws + x * kAggWarps * words + o;
        int v = 0;
        if (o < GA) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < kAggWarps; ++w)
            s += __int_as_float(__ldcg(w0 + w * words));
          v = __float_as_int(s);
        } else if (o < O) {
#pragma unroll
          for (int w = 0; w < kAggWarps; ++w) v += __ldcg(w0 + w * words);
        }
        prow[e] = v;
      }
      __threadfence();
      compute_sync(kCompute);
      fold_rows_compute(prow, parts, out0 + (long long)fb * out_row, words,
                        O, GA, kCompute);
      if (threadIdx.x == 0) ticket0[fb] = 0;
      compute_sync(kCompute);
    }
  }
  if constexpr (Stage::kCols > 0) cluster_sync();
}

template <class Stage>
constexpr size_t stage_smem() {
  return Stage::kBytes > 0
             ? (size_t)agg_stages(kStepsPerSlot * Stage::kBytes) *
                   kStepsPerSlot * Stage::kBytes
             : 0;
}

// The staged kernel's launch configuration: C x K blocks of KB compute
// warps and a producer warp, K clusters of C along x, its ring of stages.
template <class K>
int staged_config(K kernel, int C, int clusters, int KB, size_t smem,
                  cudaStream_t stream, cudaLaunchConfig_t* cfg,
                  cudaLaunchAttribute* attr) {
  if (smem > 0) {    // the ring beside the static scratch may pass 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)C, (unsigned)clusters);
  cfg->blockDim = dim3((unsigned)((KB + 1) * kWarp));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// Clusters of C blocks of `kernel` resident on the current device at
// once (cudaOccupancyMaxActiveClusters), asked on a device's first call
// for each C only and kept in `known`.
template <class K>
int active_clusters(K kernel, int C, int KB, size_t smem,
                    std::atomic<int> (*known)[4], int* out) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int c = C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2 : 3;
  if (dev < kMaxDevices) {
    *out = known[dev][c].load(std::memory_order_relaxed);
    if (*out > 0) return 0;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = staged_config(kernel, C, 1, KB, smem, 0, &cfg, &attr);
  if (err != 0) return err;
  const cudaError_t e2 = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  if (e2 != cudaSuccess) return (int)e2;
  if (*out < 1) return (int)cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) known[dev][c].store(*out, std::memory_order_relaxed);
  return 0;
}

template <class Bind, class Stage, int GM, int AM, int KB>
int staged_clusters(int C, int* out) {
  static std::atomic<int> known[kMaxDevices][4];
  return active_clusters(agg_staged_kernel<Bind, Stage, GM, AM, KB>, C, KB,
                         stage_smem<Stage>(), known, out);
}

// The partitions of the staged launch: the grid of the scalar register
// instance (Src, GM, AM), at most nb.  Its workspace holds 9 x parts rows
// a binding.
template <class Src, int GM, int AM>
int staged_parts(int nb, int* out) {
  int resident = 0;
  const int err = reg_resident<Src, GM, AM, false>(&resident);
  if (err != 0) return err;
  *out = nb < resident ? nb : resident;
  return 0;
}

template <class Bind, class Stage, int GM, int AM, int KB>
int launch_staged_warps(Bind bind, int B, int C, long long n, int G, int A,
                        int* ws, int parts, int* out, long long out_row,
                        int* ticket, cudaStream_t stream) {
  int clusters = 0;
  int err = staged_clusters<Bind, Stage, GM, AM, KB>(C, &clusters);
  if (err != 0) return err;
  const int groups = (B + C * KB - 1) / (C * KB);
  // one wave: the clusters resident at once share the units x groups
  // work items round robin, as a multiple of groups (so that each cluster
  // serves one group of bindings)
  long long K = clusters;
  const long long items = (long long)parts * kAggWarps * groups;
  if (K > items) K = items;
  K = K / groups * groups;
  if (K < groups) K = groups;
  auto kernel = agg_staged_kernel<Bind, Stage, GM, AM, KB>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = staged_config(kernel, C, (int)K, KB, stage_smem<Stage>(), stream,
                      &cfg, &attr);
  if (err != 0) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, bind, B, n, G, A,
                                           parts, groups, ws, out, out_row,
                                           ticket);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// B bindings in the staged register regime over `parts` partitions, C
// blocks a cluster (a power of two up to kAggMaxCluster) of
// staged_warps(B) bindings each.  A refused cluster launch returns its
// error.
template <class Bind, class Stage, int GM, int AM>
int launch_staged(Bind bind, int B, int C, long long n, int G, int A,
                  int* ws, int parts, int* out, long long out_row,
                  int* ticket, cudaStream_t stream) {
  if (C < 1 || C > kAggMaxCluster || (C & (C - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (staged_warps(B) == 8)
    return launch_staged_warps<Bind, Stage, GM, AM, 8>(
        bind, B, C, n, G, A, ws, parts, out, out_row, ticket, stream);
  return launch_staged_warps<Bind, Stage, GM, AM, 16>(
      bind, B, C, n, G, A, ws, parts, out, out_row, ticket, stream);
}

// The generated source's staged launch: the partitions of its own scalar
// instance (at most nb).
template <class Bind, class Stage, int GM, int AM>
int launch_reg_staged(Bind bind, int B, int C, long long n, int G, int A,
                      int* ws, int nb, int* out, long long out_row,
                      int* ticket, cudaStream_t stream) {
  int parts = 0;
  const int err = staged_parts<bound_source_t<Bind>, GM, AM>(nb, &parts);
  if (err != 0) return err;
  return launch_staged<Bind, Stage, GM, AM>(bind, B, C, n, G, A, ws, parts,
                                            out, out_row, ticket, stream);
}

// What the staged instance takes on this card at B bindings, C blocks a
// cluster: out[0] the clusters resident at once
// (cudaOccupancyMaxActiveClusters), out[1] the ring's shared-memory
// bytes, out[2] its stages, out[3] the staged columns, out[4] the warps
// (bindings) a block; 0, or the error.
template <class Bind, class Stage, int GM, int AM>
int staged_info(int B, int C, int* out) {
  const int err =
      staged_warps(B) == 8
          ? staged_clusters<Bind, Stage, GM, AM, 8>(C, &out[0])
          : staged_clusters<Bind, Stage, GM, AM, 16>(C, &out[0]);
  if (err != 0) return err;
  out[1] = (int)stage_smem<Stage>();
  out[2] = agg_stages(kStepsPerSlot * Stage::kBytes);
  out[3] = Stage::kCols;
  out[4] = staged_warps(B);
  return 0;
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

// The batched selective aggregation (a generated `Batch` and its `Stage`):
// the staged register regime where (GC, NV) takes the register regime,
// else the shared-memory regime as launch_agg_batch (no cluster, nothing
// staged).  `ws` holds B x 9 x parts rows in the staged regime
// (agg_staged_parts), B x nb rows in the other.
template <class Bind, class Stage, int NV, int GC>
int launch_agg_staged(Bind bind, int B, int C, long long n, int G, int A,
                      int nb, int* ws, int* out, long long out_row,
                      int* ticket, cudaStream_t stream) {
  constexpr int kV = NV > 0 ? NV : 1;
  if (A != NV || G != GC || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if constexpr (register_regime(GC, NV))
    return launch_reg_staged<Bind, Stage, GC, kV>(bind, B, C, n, G, A, ws,
                                                  nb, out, out_row, ticket,
                                                  stream);
  else
    return launch_shared<Bind, NV>(bind, B, n, G, A, ws, nb, out, out_row,
                                   nullptr, stream);
}

// The workspace rows a binding of launch_agg_staged needs: 9 x parts in
// the staged register regime, nb in the shared-memory regime.
template <class Bind, int NV, int GC>
int agg_staged_rows(int nb, int* out) {
  constexpr int kV = NV > 0 ? NV : 1;
  if constexpr (register_regime(GC, NV)) {
    const int err = staged_parts<bound_source_t<Bind>, GC, kV>(nb, out);
    *out *= kAggWarps + 1;
    return err;
  } else {
    *out = nb;
    return 0;
  }
}

template <class Bind, class Stage, int NV, int GC>
int agg_staged_info(int B, int C, int* out) {
  constexpr int kV = NV > 0 ? NV : 1;
  if constexpr (register_regime(GC, NV))
    return staged_info<Bind, Stage, GC, kV>(B, C, out);
  else
    return (int)cudaErrorInvalidValue;
}

// -- the precomputed form in the staged register regime --------------------
// `filter_agg_batched` where the group index and every value column are
// shared by every binding, contiguous and 16-byte aligned (the wrapper
// decides: filter_agg.staged_operands): agg_staged_kernel over
// ColumnStage, the mask fetched by each binding's warp.  An instance a
// register step: one group with AM = 1, 2, 4, 8 or 16 value slots (A
// rounded up to a power of two: the engine's scalar aggregations have one
// or two values), else 8 groups of 8 values.  The partitions are the scalar launch's (the
// instance launch_agg_batch takes for (G, A), <1, 16> or <8, 8>), so
// binding b's sums are the scalar `filter_agg` launch's on b's operands
// bit for bit.
template <int V>
using int_c = std::integral_constant<int, V>;

// f(GM, AM, the scalar instance's GM, its AM) for (G, A), as
// integral_constants; (G, A) outside the register regime is refused.
template <int MAXA, class F>
int with_column_stage(int G, int A, F&& f) {
  constexpr int kOne = cmin(MAXA, kRegMaxValsOneGroup);
  constexpr int kMany = cmin(MAXA, kRegMaxVals);
  if (A < 0 || A > MAXA || !register_regime(G, A))
    return (int)cudaErrorInvalidValue;
  if (G > 1) return f(int_c<kRegMaxGroups>{}, int_c<kMany>{},
                      int_c<kRegMaxGroups>{}, int_c<kMany>{});
  if (A <= 1) return f(int_c<1>{}, int_c<1>{}, int_c<1>{}, int_c<kOne>{});
  if (A <= 2) return f(int_c<1>{}, int_c<2>{}, int_c<1>{}, int_c<kOne>{});
  if (A <= 4) return f(int_c<1>{}, int_c<4>{}, int_c<1>{}, int_c<kOne>{});
  if (A <= 8) return f(int_c<1>{}, int_c<cmin(8, kOne)>{}, int_c<1>{},
                       int_c<kOne>{});
  return f(int_c<1>{}, int_c<kOne>{}, int_c<1>{}, int_c<kOne>{});
}

// B bindings of the precomputed form in the staged register regime: `ws`
// holds B x columns_staged_rows(nb) rows, `out` B result rows `out_row`
// words apart, `ticket` B tickets at 0.
template <int MAXA>
int launch_columns_staged(const ColumnBatch<MAXA>& bind, int B, int C,
                          long long n, int G, int A, int nb, int* ws,
                          int* out, long long out_row, int* ticket,
                          cudaStream_t stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  return with_column_stage<MAXA>(G, A, [&](auto gm, auto am, auto sgm,
                                           auto sam) {
    constexpr int GM = decltype(gm)::value, AM = decltype(am)::value;
    int parts = 0;
    const int err = staged_parts<ColumnSource<MAXA>, decltype(sgm)::value,
                                 decltype(sam)::value>(nb, &parts);
    if (err != 0) return err;
    return launch_staged<ColumnBatch<MAXA>, ColumnStage<MAXA, AM>, GM, AM>(
        bind, B, C, n, G, A, ws, parts, out, out_row, ticket, stream);
  });
}

// The workspace rows a binding of launch_columns_staged needs: 9 x parts.
template <int MAXA>
int columns_staged_rows(int nb, int G, int A, int* out) {
  return with_column_stage<MAXA>(G, A, [&](auto, auto, auto sgm, auto sam) {
    const int err = staged_parts<ColumnSource<MAXA>, decltype(sgm)::value,
                                 decltype(sam)::value>(nb, out);
    *out *= kAggWarps + 1;
    return err;
  });
}

// staged_info of the instance launch_columns_staged takes.
template <int MAXA>
int columns_staged_info(int B, int C, int G, int A, int* out) {
  return with_column_stage<MAXA>(G, A, [&](auto gm, auto am, auto, auto) {
    constexpr int GM = decltype(gm)::value, AM = decltype(am)::value;
    return staged_info<ColumnBatch<MAXA>, ColumnStage<MAXA, AM>, GM, AM>(
        B, C, out);
  });
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
