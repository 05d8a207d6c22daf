// The register regime of the masked grouped aggregation (filter_agg.cuh):
// which (G, A) it takes, and the step that adds one row to a thread's
// accumulators.  Free of CUDA headers, so the same definitions also
// compile as host C++ (the CPU tests run the step on non-finite values).
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

}  // namespace repro
