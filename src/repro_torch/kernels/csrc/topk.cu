// Masked top-k: the k largest of v = where(mask, vals, -3e38), in the
// order (value descending, row ascending), with their row ids; -1 for
// the id wherever the value is <= -3e38.  When k > n the input is padded
// with -3e38 up to k rows, so the output always holds k entries.  Plain
// C interface, loaded with ctypes.
//
// Replaces the Pallas kernel `masked_topk` (src/repro/kernels/topk.py:38).
// The TPU kernel extracts each tile's top k by k rounds of max + argmax
// (argmax takes the first maximum, so ties go to the lower row) and
// merges the (tiles, k) partials with `lax.top_k` outside the kernel,
// which keeps the lower tile first.  Both steps order by the key
// (value descending, row ascending), and that key is a total order on
// distinct rows, so any reduction tree that keeps the k first under it
// gives the same answer.  This kernel does so on the card:
//
//   * level 0: each block loads a tile of 4096 rows as (value, row) pairs
//     into shared memory, sorts them by the key with a bitonic network,
//     and writes its first k;
//   * level l > 0: the same over the (blocks, k) partials of level l - 1,
//     whose pairs still carry their original row ids, until one block
//     remains; that block writes the output and the -1 ids.
//
// Ties are settled by the row id inside the key, never by the order in
// which blocks run or pairs are stored, so they go to the lower row across
// block boundaries too.  Slots past the input (the end of the last tile,
// or a tile's partial with fewer than k rows) hold a sentinel that sorts
// after every real pair, -inf included.  NaN has no place in the order.
//
// Bound on the card: bytes — vals (4 B/row) and mask (1 B/row) read once;
// the partials add 8 k B per 4096 rows.  The sort costs about
// 78 compare-exchange steps of 4096 pairs per tile whatever k is; a
// selection that stops early for small k is later work.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kTile = 4096;
constexpr int kBlock = 1024;
constexpr int kMaxK = 1024;            // kTile / kMaxK >= 4 pairs per level
constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Rows of the raw input: virtual rows [n, n_virt) are masked padding.
struct RawSource {
  const float* vals;
  const uint8_t* mask;
  long long n, n_virt;
  __device__ __forceinline__ bool load(long long r, float* v, int* i) const {
    if (r >= n_virt) return false;
    *v = (r < n && mask[r] != 0) ? vals[r] : kNeg;
    *i = (int)r;
    return true;
  }
};

// Pairs written by the previous level.
struct PairSource {
  const float* v;
  const int* i;
  long long m;
  __device__ __forceinline__ bool load(long long r, float* ov, int* oi) const {
    if (r >= m) return false;
    *ov = v[r];
    *oi = i[r];
    return true;
  }
};

template <class Src>
__global__ void __launch_bounds__(kBlock)
topk_level_kernel(Src src, int k, float* out_v, int* out_i, bool last) {
  __shared__ float s_v[kTile];
  __shared__ int s_i[kTile];
  const long long base = (long long)blockIdx.x * kTile;
  for (int t = threadIdx.x; t < kTile; t += kBlock) {
    float v;
    int i;
    if (!src.load(base + t, &v, &i)) {
      v = __int_as_float(0xff800000);   // -inf
      i = INT_MAX;
    }
    s_v[t] = v;
    s_i[t] = i;
  }
  __syncthreads();
  // bitonic sort: afterwards before(s[j], s[j + 1]) for every j
  for (int size = 2; size <= kTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < kTile / 2; t += kBlock) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const float a = s_v[lo], b = s_v[hi];
        const int ia = s_i[lo], ib = s_i[hi];
        const bool forward = (lo & size) == 0;
        if (forward ? before(b, ib, a, ia) : before(a, ia, b, ib)) {
          s_v[lo] = b;
          s_v[hi] = a;
          s_i[lo] = ib;
          s_i[hi] = ia;
        }
      }
      __syncthreads();
    }
  }
  const long long o = (long long)blockIdx.x * k;
  for (int j = threadIdx.x; j < k; j += kBlock) {
    const float v = s_v[j];
    out_v[o + j] = v;
    out_i[o + j] = (last && v <= kNeg) ? -1 : s_i[j];
  }
}

long long blocks_for(long long m) { return (m + kTile - 1) / kTile; }

}  // namespace

extern "C" {

int repro_topk_max_k() { return kMaxK; }

// Pairs of scratch the launch needs: the first level's partials plus the
// second's (later levels reuse the first buffer).
long long repro_topk_scratch(long long n, int k) {
  const long long nb0 = blocks_for(n > k ? n : k);
  if (nb0 <= 1) return 0;
  const long long nb1 = blocks_for(nb0 * k);
  return nb0 * k + (nb1 > 1 ? nb1 * k : 0);
}

// `scratch_v` / `scratch_i` hold repro_topk_scratch(n, k) pairs; `out_v`
// and `out_i` receive k.
int repro_masked_topk(const float* vals, const uint8_t* mask, long long n,
                      int k, float* scratch_v, int* scratch_i, float* out_v,
                      int* out_i, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || n < 0) return (int)cudaErrorInvalidValue;
  const long long n_virt = n > k ? n : k;
  long long nb = blocks_for(n_virt);
  if (nb > INT_MAX) return (int)cudaErrorInvalidValue;
  // ping-pong between the two halves of the scratch
  float* buf_v[2] = {scratch_v, scratch_v + nb * k};
  int* buf_i[2] = {scratch_i, scratch_i + nb * k};
  const bool final0 = nb == 1;
  topk_level_kernel<RawSource><<<(int)nb, kBlock, 0, stream>>>(
      RawSource{vals, mask, n, n_virt}, k, final0 ? out_v : buf_v[0],
      final0 ? out_i : buf_i[0], final0);
  cudaError_t err = cudaGetLastError();
  int cur = 0;
  while (err == cudaSuccess && nb > 1) {
    const long long m = nb * k;
    nb = blocks_for(m);
    const bool fin = nb == 1;
    topk_level_kernel<PairSource><<<(int)nb, kBlock, 0, stream>>>(
        PairSource{buf_v[cur], buf_i[cur], m}, k, fin ? out_v : buf_v[1 - cur],
        fin ? out_i : buf_i[1 - cur], fin);
    err = cudaGetLastError();
    cur = 1 - cur;
  }
  return (int)err;
}

}  // extern "C"
