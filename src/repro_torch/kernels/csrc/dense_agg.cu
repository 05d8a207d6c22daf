// Dense aggregation over a large key domain (plain C interface, loaded with
// ctypes): for each group g of [0, D), over the rows where the mask holds
// and the key is g, the float32 sums of A value columns, the int32 count
// of rows and the max of C carry columns (int32 or float32), for B
// bindings in one launch.
//
// It replaces no TPU kernel.  The engine's dense aggregation takes it where
// the key domain is past what filter_agg.cuh keeps in one block's shared
// memory (KERNEL_MAX_GROUPS groups): q3 and q18 group lineitem by
// l_orderkey (1,500,000 keys at SF 1), q10 and q13 by customer, q17 by
// part, q7 by two nations and a year (5,000).  There PyTorch spent a D-sized fill, a masked copy of the column
// and an index_add_ or scatter_reduce for every sum, count and carry, and
// the masked-out rows still did their atomic add of zero.
//
// Bound on the card: bytes.  A row the mask drops costs its mask byte and
// nothing else; a kept row reads its key, values and carries once.  The
// outputs are one result row a binding, `row_words` int32 words:
//
//   [counts D][sums of value 0 D] ... [carry 0 D] ...
//
// zeroed by one memset, the sums and counts added into and the carries
// max'ed into with atomics, so the memset and the atomics' traffic are
// the rest of the bytes.  The atomics are cut by combining runs of equal
// adjacent keys inside the warp: lane l takes row r0 + l, a run of equal
// keys among the warp's 32 rows is reduced by a segmented shuffle tree
// (five steps; skipped where every run is one row) and its first lane
// makes one atomic a column.  lineitem is clustered by l_orderkey (1 to 7
// lines an order, in order, and compaction keeps row order), so q3 and
// q18 pay about one atomic an order; unclustered keys pay one a valid row,
// as index_add_ did.  A float sum is exact to float32 rounding in an order
// the atomics choose, as index_add_'s was.
//
// A carry is max'ed as an unsigned integer that orders as the value does:
// an int32 with its sign bit flipped, a float32 with every bit flipped
// when negative and the sign bit set when not, so that the memset's zero
// is below every value.  A second launch (decode) turns a present group's
// carry back into the value and leaves an absent group's at zero; it reads
// the counts and touches no other group.
//
// The mask is read four bytes a lane (128 rows a warp) where the
// binding's mask is 4-byte aligned, and a warp whose 128 rows are all
// dropped goes on at once.  Every offset into the result is 64-bit: 64
// bindings of q3 hold 1.5 GB of results, and B x row_words may pass 2^31
// words.  A key outside [0, D) reaches no group (the engine clamps its
// keys first).
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / kWarp;
constexpr int kMaxCols = 8;       // value columns and carries a launch
constexpr int kChunk = 4 * kWarp;  // rows a warp takes at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSign = 0x80000000u;

// The columns of one launch.  A binding stride is in elements (0: every
// binding reads the same column); an offset is in words of a result row.
struct Columns {
  const float* val[kMaxCols];
  long long val_stride[kMaxCols];
  long long val_off[kMaxCols];
  const unsigned* car[kMaxCols];
  long long car_stride[kMaxCols];
  long long car_off[kMaxCols];
  unsigned car_float;  // bit k: carry k is float32, else int32
  int A, C;
};

__device__ __forceinline__ unsigned encode(unsigned bits, bool is_float) {
  if (!is_float) return bits ^ kSign;
  return (bits & kSign) ? ~bits : (bits | kSign);
}

__device__ __forceinline__ unsigned decode(unsigned e, bool is_float) {
  if (!is_float) return e ^ kSign;
  return (e & kSign) ? (e & ~kSign) : ~e;
}

// 32 rows of binding b, lane l holding row `row` (valid: the mask keeps
// it and it lies below n).  Every lane of the warp calls it.
__device__ __forceinline__ void rows32(bool valid, long long row, int lane,
                                       int b, const int* gidx, int D,
                                       const Columns& cols, int* o) {
  // a kept row's key, values and carries are loaded side by side; a key
  // outside [0, D) then drops the row
  int key = valid ? gidx[row] : -1;
  float v[kMaxCols];
  unsigned c[kMaxCols];
#pragma unroll
  for (int a = 0; a < kMaxCols; ++a) {
    v[a] = 0.f;
    if (a < cols.A && valid)
      v[a] = cols.val[a][(long long)b * cols.val_stride[a] + row];
  }
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    c[k] = 0u;
    if (k < cols.C && valid)
      c[k] = encode(cols.car[k][(long long)b * cols.car_stride[k] + row],
                    (cols.car_float >> k) & 1u);
  }
  if ((unsigned)key >= (unsigned)D) {
    valid = false;
    key = -1;
  }
  const unsigned kept = __ballot_sync(kFull, valid);
  if (kept == 0) return;
  const int up = __shfl_up_sync(kFull, key, 1);
  const int down = __shfl_down_sync(kFull, key, 1);
  const bool head = valid && (lane == 0 || up != key);
  const bool tail = valid && (lane == kWarp - 1 || down != key);
  const unsigned tails = __ballot_sync(kFull, tail);
  // the last lane of this lane's run (a kept lane's run ends at a tail)
  const int end = valid ? __ffs(tails & (kFull << lane)) - 1 : lane;
  if (tails != kept) {  // some run is longer than one row
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const bool take = lane + d <= end;
#pragma unroll
      for (int a = 0; a < kMaxCols; ++a) {
        if (a < cols.A) {
          const float x = __shfl_down_sync(kFull, v[a], d);
          if (take) v[a] += x;
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        if (k < cols.C) {
          const unsigned x = __shfl_down_sync(kFull, c[k], d);
          if (take) c[k] = max(c[k], x);
        }
      }
    }
  }
  if (!head) return;
  atomicAdd(o + key, end - lane + 1);
#pragma unroll
  for (int a = 0; a < kMaxCols; ++a)
    if (a < cols.A)
      atomicAdd(reinterpret_cast<float*>(o + cols.val_off[a]) + key, v[a]);
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k)
    if (k < cols.C)
      atomicMax(reinterpret_cast<unsigned*>(o + cols.car_off[k]) + key, c[k]);
}

// Grid: x strides over the binding's rows in 128-row chunks, a warp a
// chunk; y is the binding.
__global__ void __launch_bounds__(kBlock)
dense_agg_kernel(const unsigned char* __restrict__ mask, long long mask_stride,
                 const int* __restrict__ gidx, long long gidx_stride,
                 Columns cols, long long n, int D, int* __restrict__ out,
                 long long row_words) {
  const int b = blockIdx.y;
  const unsigned char* m = mask + (long long)b * mask_stride;
  const int* g = gidx + (long long)b * gidx_stride;
  int* o = out + (long long)b * row_words;
  const int lane = threadIdx.x % kWarp;
  const long long warps = (long long)gridDim.x * kWarps;
  const bool aligned = ((size_t)m & 3) == 0;
  for (long long r0 = ((long long)blockIdx.x * kWarps + threadIdx.x / kWarp)
                      * kChunk;
       r0 < n; r0 += warps * kChunk) {
    // mask bytes of rows r0 + 4 lane .. r0 + 4 lane + 3, zero past n
    const long long r4 = r0 + 4 * lane;
    unsigned word = 0;
    if (aligned && r4 + 3 < n) {
      word = __ldcs(reinterpret_cast<const unsigned*>(m + r4));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r4 + i < n) word |= (unsigned)__ldcs(m + r4 + i) << (8 * i);
    }
    if (__ballot_sync(kFull, word != 0) == 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // row r0 + 32 j + lane's byte sits in lane 8 j + lane / 4
      const unsigned w = __shfl_sync(kFull, word, 8 * j + lane / 4);
      const bool valid = ((w >> (8 * (lane % 4))) & 0xffu) != 0;
      rows32(valid, r0 + kWarp * j + lane, lane, b, g, D, cols, o);
    }
  }
}

// A present group's carries decoded, an absent one's left at zero.
__global__ void __launch_bounds__(kBlock)
dense_agg_decode(int* __restrict__ out, long long row_words, int D,
                 Columns cols) {
  int* o = out + (long long)blockIdx.y * row_words;
  for (long long g = (long long)blockIdx.x * kBlock + threadIdx.x; g < D;
       g += (long long)gridDim.x * kBlock) {
    if (o[g] == 0) continue;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k < cols.C) {
        unsigned* p = reinterpret_cast<unsigned*>(o + cols.car_off[k]) + g;
        *p = decode(*p, (cols.car_float >> k) & 1u);
      }
    }
  }
}

long long blocks_for(long long want, long long most) {
  if (want > most) want = most;
  return want < 1 ? 1 : want;
}

}  // namespace
}  // namespace repro

extern "C" {

int repro_dense_agg_max_cols() { return repro::kMaxCols; }

// B bindings: `mask`, `gidx` and each column with its binding stride in
// elements (0: shared); `vals` and `cars` host arrays of A and C device
// pointers, `car_float` C flags; `out` B rows of (1 + A + C) D int32
// words, which this call zeroes first.  `sms` the card's multiprocessors.
int repro_dense_agg(const unsigned char* mask, long long mask_stride,
                    const int* gidx, long long gidx_stride,
                    const void* const* vals, const long long* val_strides,
                    int A, const void* const* cars,
                    const long long* car_strides, const int* car_float, int C,
                    int B, long long n, int D, int* out, int sms,
                    cudaStream_t stream) {
  using namespace repro;
  if (A < 0 || A > kMaxCols || C < 0 || C > kMaxCols || B < 1 || B > 65535 ||
      D < 1 || n < 0 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const long long row_words = (long long)D * (1 + A + C);
  Columns cols{};
  cols.A = A;
  cols.C = C;
  for (int a = 0; a < A; ++a) {
    cols.val[a] = static_cast<const float*>(vals[a]);
    cols.val_stride[a] = val_strides[a];
    cols.val_off[a] = (long long)D * (1 + a);
  }
  for (int k = 0; k < C; ++k) {
    cols.car[k] = static_cast<const unsigned*>(cars[k]);
    cols.car_stride[k] = car_strides[k];
    cols.car_off[k] = (long long)D * (1 + A + k);
    if (car_float[k]) cols.car_float |= 1u << k;
  }
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)B * (size_t)row_words * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  // about four blocks' worth a multiprocessor over all bindings
  const long long resident = (long long)sms * (2048 / kBlock) * 4;
  if (n > 0) {
    const long long gx = blocks_for((resident + B - 1) / B,
                                    (n + kChunk * kWarps - 1) /
                                        (kChunk * kWarps));
    dense_agg_kernel<<<dim3((unsigned)gx, (unsigned)B), kBlock, 0, stream>>>(
        mask, mask_stride, gidx, gidx_stride, cols, n, D, out, row_words);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0 && C > 0) {
    const long long gx =
        blocks_for((resident + B - 1) / B, (D + kBlock - 1) / kBlock);
    dense_agg_decode<<<dim3((unsigned)gx, (unsigned)B), kBlock, 0, stream>>>(
        out, row_words, D, cols);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // extern "C"
