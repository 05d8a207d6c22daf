// The register regime of the masked grouped aggregation (filter_agg.cuh):
// which (G, A) it takes, the step that adds one row to a thread's
// accumulators, and the fixed order in which the grid's last block folds
// every block's partials into the result.  Free of CUDA headers, so the
// same definitions also compile as host C++ (the CPU tests run the step on
// non-finite values and the fold's order on random partials).
#pragma once

#if !defined(__CUDACC__) && !defined(__host__)
#define __host__
#endif
#if !defined(__CUDACC__) && !defined(__device__)
#define __device__
#define __forceinline__ inline
#endif

namespace repro {

// The register regime takes G <= 8 groups of A <= 8 values, or one group
// of A <= 16 values; everything larger goes to the shared-memory regime.
constexpr int kRegMaxGroups = 8;
constexpr int kRegMaxVals = 8;
constexpr int kRegMaxValsOneGroup = 16;

__host__ __device__ constexpr bool register_regime(int G, int A) {
  return A >= 0 && ((G == 1 && A <= kRegMaxValsOneGroup) ||
                    (G >= 1 && G <= kRegMaxGroups && A <= kRegMaxVals));
}

// One thread's sums and counts over up to GM groups of AM values, and
// its number of predicate-true rows.
template <int GM, int AM>
struct RegAcc {
  float sum[GM][AM];
  int cnt[GM];
  int kept;

  __host__ __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < GM; ++j) {
      cnt[j] = 0;
#pragma unroll
      for (int k = 0; k < AM; ++k) sum[j][k] = 0.f;
    }
    kept = 0;
  }

  // Adds one row: `m` its predicate, `g` its group index among G groups,
  // `v` its AM values.  The row's values reach group j's sums only where
  // the row is kept and g == j: each sum takes the value or nothing, and
  // never the value times a 0/1 indicator, which would carry a NaN or an
  // infinity of a dropped row, or of another group, into every group
  // (0 * inf = NaN), as the reference's one-hot product does.
  __host__ __device__ __forceinline__ void add(bool m, int g, int G,
                                               const float* v) {
    kept += m ? 1 : 0;
    const int h = (m && g >= 0 && g < G) ? g : -1;
#pragma unroll
    for (int j = 0; j < GM; ++j) {
      const bool hit = h == j;
      cnt[j] += hit ? 1 : 0;
#pragma unroll
      for (int k = 0; k < AM; ++k)
        if (hit) sum[j][k] += v[k];
    }
  }
};

// -- the fold ----------------------------------------------------------------
// The register regime's last block adds `rows` partial rows of `stride`
// words (a multiple of 4; words below GA are float sums, the rest int
// counts) into one result per output, in an order that depends on (rows,
// outputs) alone, never on which block came last.  The block's
// kFoldThreads threads are W lanes for each quad of outputs (W =
// kFoldThreads over the quads rounded up to a power of two): lane r adds
// rows r, r + W, r + 2W, ... in row order, each row's quad read as one
// 16-byte load, eight (then four) in flight at a time; then the W lanes
// are added by a tree (lane r takes lane r + W/2, then r + W/4, ..., 1).
constexpr int kFoldThreads = 256;

__host__ __device__ constexpr int fold_cols(int quads) {
  int c = 1;
  while (c < quads) c *= 2;
  return c;
}

__host__ __device__ constexpr int fold_lanes(int outputs) {
  return kFoldThreads / fold_cols((outputs + 3) / 4);
}

__host__ __device__ __forceinline__ float word_as_float(int w) {
#ifdef __CUDA_ARCH__
  return __int_as_float(w);
#else
  float f;
  __builtin_memcpy(&f, &w, 4);
  return f;
#endif
}

__host__ __device__ __forceinline__ int float_as_word(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int w;
  __builtin_memcpy(&w, &f, 4);
  return w;
#endif
}

// a + b for one word: a float32 sum where `is_sum`, else an int count.
__host__ __device__ __forceinline__ int add_word(int a, int b, bool is_sum) {
  return is_sum ? float_as_word(word_as_float(a) + word_as_float(b)) : a + b;
}

// Four words of a row, 16-byte aligned, so that it moves as one 16-byte
// access (a global load, or a shared-memory load or store in the tree).
struct alignas(16) WordQuad {
  int w[4];
};

// A quad of another block's partial row, read through L2 (its line was
// never in this SM's L1); 16-byte aligned.
__host__ __device__ __forceinline__ WordQuad load_partial_quad(const int* p) {
#ifdef __CUDA_ARCH__
  const int4 q = __ldcg(reinterpret_cast<const int4*>(p));
  return {{q.x, q.y, q.z, q.w}};
#else
  return {{p[0], p[1], p[2], p[3]}};
#endif
}

// Lane r's share of one quad column `p` (the quad's first word in row 0):
// rows r, r + W, ... added in row order into acc[4].
__host__ __device__ __forceinline__ void fold_lane(const int* p,
                                                  long long stride, int rows,
                                                  int r, int W,
                                                  const bool* is_sum,
                                                  int* acc) {
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = 0;
  int b = r;
  for (; b + 7 * W < rows; b += 8 * W) {
    WordQuad x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = load_partial_quad(p + (long long)(b + k * W) * stride);
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = add_word(acc[c], x[k].w[c], is_sum[c]);
  }
  for (; b + 3 * W < rows; b += 4 * W) {
    WordQuad x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = load_partial_quad(p + (long long)(b + k * W) * stride);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = add_word(acc[c], x[k].w[c], is_sum[c]);
  }
  for (; b < rows; b += W) {
    const WordQuad x = load_partial_quad(p + (long long)b * stride);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = add_word(acc[c], x.w[c], is_sum[c]);
  }
}

// The tree over one quad column's W lanes, lane r at lanes[r * spacing]:
// for h = W/2, W/4, ..., 1, lane r < h takes lane r + h.  The caller adds
// into lanes r0, r0 + r_step, ... below h.  On the card every thread of
// the block calls it with its own lane (r0 = its lane, or W where it has
// none; r_step = W) and each level ends at a block barrier; on the host
// one caller takes every lane (r0 = 0, r_step = 1).
__host__ __device__ __forceinline__ void fold_tree(WordQuad* lanes,
                                                  int spacing, int W, int r0,
                                                  int r_step,
                                                  const bool* is_sum) {
  for (int h = W / 2; h > 0; h /= 2) {
    for (int r = r0; r < h; r += r_step) {
      WordQuad a = lanes[r * spacing];
      const WordQuad b = lanes[(r + h) * spacing];
#pragma unroll
      for (int c = 0; c < 4; ++c) a.w[c] = add_word(a.w[c], b.w[c], is_sum[c]);
      lanes[r * spacing] = a;
    }
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
}

// The whole fold on the host, one lane after another, through the
// kernel's own fold_lane and fold_tree (the kernel runs the lanes in
// parallel and the tree in shared memory): `out` receives the `outputs`
// results.
inline void fold_serial(const int* ws, long long stride, int rows,
                        int outputs, int GA, int* out) {
  const int W = fold_lanes(outputs);
  WordQuad lanes[kFoldThreads];
  for (int q = 0; 4 * q < outputs; ++q) {
    bool is_sum[4];
    for (int c = 0; c < 4; ++c) is_sum[c] = 4 * q + c < GA;
    for (int r = 0; r < W; ++r)
      fold_lane(ws + 4 * q, stride, rows, r, W, is_sum, lanes[r].w);
    fold_tree(lanes, 1, W, 0, 1, is_sum);
    for (int c = 0; c < 4 && 4 * q + c < outputs; ++c) out[4 * q + c] = lanes[0].w[c];
  }
}

}  // namespace repro
