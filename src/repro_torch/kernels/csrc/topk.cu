// Masked top-k: the k largest of v = where(mask, vals, -3e38), in the
// order (value descending, row ascending), with their row ids; -1 for
// the id wherever the value is <= -3e38.  When k > n the input is padded
// with -3e38 up to k rows, so the output always holds k entries.  Plain
// C interface, loaded with ctypes.
//
// Replaces the Pallas kernel `masked_topk` (src/repro/kernels/topk.py:38),
// which extracts each tile's top k by k rounds of max + argmax and merges
// the (tiles, k) partials with `lax.top_k`.  The port follows the
// reference's oracle (`ref.masked_topk_ref`, `jax.lax.top_k`): values
// are ordered by IEEE 754's total order, +NaN > +inf > ... > +0 > -0 >
// ... > -inf > -NaN (NaNs by payload), ties go to the lower row, and the
// id is -1 where `value <= -3e38` compares true, so -inf gets -1 and
// -NaN keeps its row.  The order lives in the key u = order_key(bits of
// v) (radix_select.cuh): as an unsigned integer it orders floats
// totally, with no float compare anywhere in the selection.
//
// A radix select, not a sort: one memset and five launches.
//
//   1-3. three histogram passes over the key's digits (11, 11, 10 bits
//        from the top), each counting the rows whose key matches the
//        prefix chosen so far.  Each block counts in shared memory and
//        adds its bins to a global histogram; the last block to finish
//        (an atomic ticket) picks the digit in which the k-th largest
//        key falls and the rank left to find (`walk_down`), on the
//        device, so no pass waits on the host.  After pass 3 the state
//        holds the key T of the k-th largest row and the count of rows
//        above it (fewer than k).
//   4.   collect: the ordered compaction of compact.cuh over the
//        predicate u == T ranks the ties in row order, and the first
//        k - (count above T) of them are kept; the same pass appends the
//        rows with u > T to a candidate list with an atomic (fewer than k
//        rows, in any order).
//   5.   one block bitonic-sorts the k collected (key, row) pairs by key
//        descending, row ascending, and writes the values (bitwise, from
//        the keys) and the ids.
//
// Masked rows, padding rows and valid -3e38 rows share one key, which
// the histogram passes count in a register and add once per warp, not by
// a shared-memory atomic per row.  The passes read 16 rows per thread
// and iteration, as float4 and uchar4 loads when the columns are aligned.
//
// Bound on the card: bytes, vals (4 B/row) and mask (1 B/row) read once.
// The design reads them four times (three histogram passes and the
// collect pass; at SF 1 the 30 MB fit the 50 MB L2 after the first), and
// otherwise moves O(k + 5,120 bins) words.
#include <climits>

#include "common.cuh"
#include "compact.cuh"
#include "radix_select.cuh"

namespace {

using repro::kWarp;
using repro::RadixState;

constexpr int kMaxK = 1024;
constexpr int kHistBlock = 512;
constexpr int kHistUnroll = 4;
constexpr int kHistMaxBlocks = 264;    // two per SM of an H100
__host__ __device__ constexpr int bins(int pass) {
  return 1 << repro::radix_bits(pass);
}
constexpr int kHistWords = bins(0) + bins(1) + bins(2);
constexpr float kNeg = -3.0e38f;

struct SelectState {
  RadixState radix;      // prefix (T after pass 3), rank, above
  unsigned cand_count;   // rows above T collected so far
  unsigned ticket[repro::kRadixPasses];
  unsigned pad;
};
constexpr int kStateWords = 8;
static_assert(sizeof(SelectState) == 4 * kStateWords, "state layout");

__device__ __forceinline__ unsigned neg_key() {
  return repro::order_key(__float_as_uint(kNeg));
}

__device__ __forceinline__ unsigned row_key(uint8_t m, float x) {
  return repro::order_key(__float_as_uint(m != 0 ? x : kNeg));
}

// Rows of v = where(mask, vals, -3e38); rows [n, n_virt) are padding.  A
// row's value is loaded whatever its mask, so both loads go out at once.
struct Rows {
  const float* vals;
  const uint8_t* mask;
  long long n;
  long long n4;   // rows [0, n4) may be read four at a time (vals 16-byte
                  // and mask 4-byte aligned; n4 = 0 when they are not)
  __device__ __forceinline__ unsigned key(long long i) const {
    return i < n ? row_key(__ldg(mask + i), __ldg(vals + i)) : neg_key();
  }
  // the keys of rows 4g .. 4g + 3, all below n4
  __device__ __forceinline__ void keys4(long long g, unsigned* out) const {
    const float4 x = __ldg(reinterpret_cast<const float4*>(vals) + g);
    const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(mask) + g);
    out[0] = row_key(m.x, x.x);
    out[1] = row_key(m.y, x.y);
    out[2] = row_key(m.z, x.z);
    out[3] = row_key(m.w, x.w);
  }
};

template <int PASS>
__global__ void __launch_bounds__(kHistBlock)
radix_hist_kernel(Rows rows, long long n_virt, int k, unsigned* hist,
                  SelectState* st) {
  constexpr int B = bins(PASS);
  constexpr int kPer = B / kWarp;
  __shared__ unsigned sh[B];
  __shared__ bool s_last;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  for (int b = threadIdx.x; b < B; b += kHistBlock) sh[b] = 0;
  const unsigned prefix = PASS == 0 ? 0u : st->radix.prefix;
  __syncthreads();

  int neg = 0;
  auto tally = [&](unsigned key) {
    if (key == neg_key())
      ++neg;
    else if (repro::radix_match(key, prefix, PASS))
      atomicAdd(&sh[repro::radix_digit(key, PASS)], 1u);
  };
  const long long tid = (long long)blockIdx.x * kHistBlock + threadIdx.x;
  const long long stride = (long long)gridDim.x * kHistBlock;
  const long long groups = rows.n4 / 4;
  for (long long g0 = tid; g0 < groups; g0 += stride * kHistUnroll) {
    unsigned key[4 * kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u)
      if (g0 + u * stride < groups) rows.keys4(g0 + u * stride, key + 4 * u);
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (g0 + u * stride >= groups) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) tally(key[4 * u + j]);
    }
  }
  for (long long i = rows.n4 + tid; i < n_virt; i += stride)
    tally(rows.key(i));
  neg = repro::warp_sum(neg);
  if (lane == 0 && neg > 0 && repro::radix_match(neg_key(), prefix, PASS))
    atomicAdd(&sh[repro::radix_digit(neg_key(), PASS)], (unsigned)neg);
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += kHistBlock)
    if (sh[b] != 0) atomicAdd(&hist[b], sh[b]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&st->ticket[PASS], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block: the global histogram, then warp 0 picks the digit
  __threadfence();
  for (int b = threadIdx.x; b < B; b += kHistBlock) sh[b] = __ldcg(&hist[b]);
  __syncthreads();
  if (warp != 0) return;
  const RadixState in = PASS == 0 ? RadixState{0u, (unsigned)k, 0u}
                                  : st->radix;
  const int lo = B - kPer * (lane + 1);   // lane 0 holds the top digits
  unsigned s = 0;
  for (int d = 0; d < kPer; ++d) s += sh[lo + (d + lane) % kPer];   // skewed
  unsigned incl = s;                                                // banks
#pragma unroll
  for (int o = 1; o < kWarp; o *= 2) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const unsigned excl = incl - s;
  if (excl < in.rank && in.rank <= incl) {
    unsigned before;
    const int d = repro::walk_down(sh + lo, kPer, in.rank - excl, &before);
    RadixState out = in;
    repro::radix_advance(&out, PASS, (unsigned)(lo + d), excl + before);
    st->radix = out;
  }
}

// compact_kernel's row source for step 4: ranks the ties of T, and
// appends the rows above T to the candidates as a side effect.
struct TieSource {
  Rows rows;
  SelectState* st;
  unsigned* cand_key;
  int* cand_row;
  __device__ __forceinline__ bool pred(long long i) const {
    const unsigned key = rows.key(i);
    const unsigned t = st->radix.prefix;
    if (key > t) {
      const unsigned p = atomicAdd(&st->cand_count, 1u);
      if (p < kMaxK) {
        cand_key[p] = key;
        cand_row[p] = (int)i;
      }
    }
    return key == t;
  }
};

__device__ __forceinline__ bool before(unsigned ak, int ar, unsigned bk,
                                       int br) {
  return ak > bk || (ak == bk && ar < br);
}

__global__ void __launch_bounds__(kMaxK)
topk_sort_kernel(const SelectState* st, const unsigned* cand_key,
                 const int* cand_row, const int* tie_row, int k, float* out_v,
                 int* out_i) {
  __shared__ unsigned s_key[kMaxK];
  __shared__ int s_row[kMaxK];
  const int above = (int)st->radix.above;
  const unsigned t = st->radix.prefix;
  int m = 1;
  while (m < k) m <<= 1;
  for (int j = threadIdx.x; j < m; j += kMaxK) {
    unsigned key = 0;        // slack slots sort after every real pair
    int row = INT_MAX;
    if (j < above) {
      key = cand_key[j];
      row = cand_row[j];
    } else if (j < k) {
      key = t;
      row = tie_row[j - above];
    }
    s_key[j] = key;
    s_row[j] = row;
  }
  __syncthreads();
  // bitonic sort: afterwards before(s[j], s[j + 1]) for every j
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < m / 2; p += kMaxK) {
        const int lo = 2 * p - (p & (stride - 1));
        const int hi = lo + stride;
        const unsigned a = s_key[lo], b = s_key[hi];
        const int ia = s_row[lo], ib = s_row[hi];
        const bool forward = (lo & size) == 0;
        if (forward ? before(b, ib, a, ia) : before(a, ia, b, ib)) {
          s_key[lo] = b;
          s_key[hi] = a;
          s_row[lo] = ib;
          s_row[hi] = ia;
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < k; j += kMaxK) {
    const float v = __uint_as_float(repro::key_bits(s_key[j]));
    out_v[j] = v;
    out_i[j] = v <= kNeg ? -1 : s_row[j];
  }
}

// Workspace (int32 words): out_v, out_i, the tie ids, the candidates'
// rows and keys (k each), then, from an even word, compact_kernel's
// scratch, the select state and the three histograms (cleared by one
// memset).
long long tail_start(int k) { return 5LL * k + ((5LL * k) & 1); }

long long workspace_words(long long n_virt, int k) {
  return tail_start(k) + repro::compact_head_words(n_virt) + kStateWords +
         kHistWords;
}

}  // namespace

extern "C" {

int repro_topk_max_k() { return kMaxK; }

long long repro_topk_workspace(long long n, int k) {
  return workspace_words(n > k ? n : k, k);
}

int repro_masked_topk(const float* vals, const uint8_t* mask, long long n,
                      int k, int* ws, long long ws_words,
                      cudaStream_t stream) {
  if (k < 1 || k > kMaxK || n < 0) return (int)cudaErrorInvalidValue;
  const long long n_virt = n > k ? n : k;
  if (n_virt >= INT_MAX || ws_words < workspace_words(n_virt, k))
    return (int)cudaErrorInvalidValue;
  float* out_v = reinterpret_cast<float*>(ws);
  int* out_i = ws + k;
  int* tie_row = ws + 2 * k;
  int* cand_row = ws + 3 * k;
  unsigned* cand_key = reinterpret_cast<unsigned*>(ws + 4 * k);
  int* tail = ws + tail_start(k);
  const long long head = repro::compact_head_words(n_virt);
  SelectState* st = reinterpret_cast<SelectState*>(tail + head);
  unsigned* hist = reinterpret_cast<unsigned*>(tail + head + kStateWords);
  cudaError_t err = cudaMemsetAsync(
      tail, 0, 4 * (size_t)(head + kStateWords + kHistWords), stream);
  if (err != cudaSuccess) return (int)err;

  const bool aligned = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const Rows rows{vals, mask, n, aligned ? n & ~3LL : 0};
  long long grid = (n_virt + 4 * kHistBlock * kHistUnroll - 1) /
                   (4 * kHistBlock * kHistUnroll);
  if (grid > kHistMaxBlocks) grid = kHistMaxBlocks;
  radix_hist_kernel<0><<<(int)grid, kHistBlock, 0, stream>>>(
      rows, n_virt, k, hist, st);
  radix_hist_kernel<1><<<(int)grid, kHistBlock, 0, stream>>>(
      rows, n_virt, k, hist + bins(0), st);
  radix_hist_kernel<2><<<(int)grid, kHistBlock, 0, stream>>>(
      rows, n_virt, k, hist + bins(0) + bins(1), st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int e = repro::launch_compact(
      TieSource{rows, st, cand_key, cand_row}, n_virt, tail, tie_row, k,
      nullptr, stream);
  if (e != 0) return e;
  topk_sort_kernel<<<1, kMaxK, 0, stream>>>(st, cand_key, cand_row, tie_row,
                                            k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
