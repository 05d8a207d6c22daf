// Foreign-key gather: out[i, :] = table[fk[i], :], and zeros where fk[i]
// lies outside [0, K).  Plain C interface, loaded with ctypes.
//
// Replaces the Pallas kernel `gather_join` (src/repro/kernels/
// gather_join.py:36), which keeps the (K, C) table resident in VMEM and
// spells the gather as a one-hot (T, K) x (K, C) product on the MXU.  On
// Hopper that product spends 2 K C flops per row on what is one load, and
// it turns a NaN or an infinity anywhere in the table into NaN in every
// output row (0 * inf).  This kernel gathers instead, so every output is
// a bit copy of a table entry, or zero.
//
// Bound on the card: bytes.  fk is read once (4 B/row), the table once
// (4 K C B) and the output written once (4 C B/row).  The output is the
// larger stream, so it is cut by output floats, not by rows: thread t of
// the grid stride writes floats j .. j + 3 of the row-major (n, C) output
// as one 16-byte streaming store, so a warp's store covers 512
// contiguous bytes whatever C is.  Float j is row j / C, column j % C (C
// is a compile-time constant for C <= 4).  A thread reads the keys of the
// rows its floats touch: where it covers whole rows it reads them in one
// load (16 B for C = 1, 8 B for C = 2), else one key per row it enters,
// which its warp's neighbours share through L1.  `out` must be 16-byte
// aligned (the wrapper allocates it; the launcher refuses anything else);
// the last n C % 4 floats are written one at a time.  fk may be a view at
// any offset, so every vector load of it checks its own alignment.
//
// The table is read through the read-only path (__ldg) at full occupancy
// (2,048 threads an SM): a table of a few hundred KB stays in L1 and L2,
// a larger one mostly in L2.  Staging the table in shared memory once per
// block (1,024-thread blocks, as many as fit an SM) was measured and
// dropped: on an H100 80GB HBM3 at 700 W it was the slower at both sizes
// tried (chip_smoke.py: device 0.0531 against 0.0410 ms for 5,999,771
// keys into 10,000 x 3, where staging leaves one block an SM; 0.00209
// against 0.00194 ms for 150,000 keys into 25 x 3).
#include "common.cuh"

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ bool aligned_to(const void* p, unsigned bytes) {
  return ((size_t)p & (bytes - 1)) == 0;
}

// table[f * C + c], or zero where f lies outside [0, K).
__device__ __forceinline__ float entry(const float* tab, int K, int C, int f,
                                       int c) {
  if ((unsigned)f >= (unsigned)K) return 0.f;
  return __ldg(tab + (long long)f * C + c);
}

// Row f of a two-column table (8-byte aligned) in one load, or zeros.
__device__ __forceinline__ float2 pair(const float* tab, int K, int f) {
  if ((unsigned)f >= (unsigned)K) return make_float2(0.f, 0.f);
  return __ldg(reinterpret_cast<const float2*>(tab) + f);
}

// Output float j (any j < n C), on its own.
template <int CC>
__device__ __forceinline__ float one(const int* fk, const float* tab, int K,
                                     int Crt, long long j) {
  const int C = CC > 0 ? CC : Crt;
  const long long row = j / C;
  return entry(tab, K, C, __ldg(fk + row), (int)(j - row * C));
}

// Output floats j .. j + 3, all below n C.
template <int CC>
__device__ __forceinline__ float4 quad(const int* fk, const float* tab, int K,
                                       int Crt, long long j) {
  const int C = CC > 0 ? CC : Crt;
  float e[4];
  if constexpr (CC == 1) {            // four whole rows
    int f[4];
    if (aligned_to(fk + j, 16)) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(fk + j));
      f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) f[r] = __ldcs(fk + j + r);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) e[r] = entry(tab, K, 1, f[r], 0);
    return make_float4(e[0], e[1], e[2], e[3]);
  } else {
    long long row = j / C;
    int col = (int)(j - row * C);
    if constexpr (CC == 2) {          // two whole rows
      if (col == 0 && aligned_to(fk + row, 8) && aligned_to(tab, 8)) {
        const int2 q = __ldcs(reinterpret_cast<const int2*>(fk + row));
        const float2 a = pair(tab, K, q.x);
        const float2 b = pair(tab, K, q.y);
        return make_float4(a.x, a.y, b.x, b.y);
      }
    }
    if constexpr (CC == 4) {          // one whole row
      if (col == 0 && aligned_to(tab, 16)) {
        const int f = __ldcs(fk + row);
        if ((unsigned)f >= (unsigned)K) return make_float4(0.f, 0.f, 0.f, 0.f);
        return __ldg(reinterpret_cast<const float4*>(tab) + f);
      }
    }
    int f = __ldg(fk + row);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (col == C) {                 // the quad enters the next row
        col = 0;
        f = __ldg(fk + ++row);
      }
      e[r] = entry(tab, K, C, f, col++);
    }
    return make_float4(e[0], e[1], e[2], e[3]);
  }
}

template <int CC>
__global__ void __launch_bounds__(kBlock)
gather_kernel(const int* __restrict__ fk, const float* __restrict__ table,
              long long n, int K, int Crt, float* __restrict__ out) {
  const long long total = n * (CC > 0 ? CC : Crt);
  const long long quads = total / 4;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = t; q < quads; q += stride)
    __stcs(reinterpret_cast<float4*>(out + 4 * q),
           quad<CC>(fk, table, K, Crt, 4 * q));
  if (t < total - 4 * quads)
    out[4 * quads + t] = one<CC>(fk, table, K, Crt, 4 * quads + t);
}

template <int CC>
int launch(const int* fk, const float* table, long long n, int K, int C,
           float* out, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long grid = (long long)sms * (2048 / kBlock);
  const long long need = (n * C / 4 + kBlock) / kBlock;
  if (grid > need) grid = need;
  gather_kernel<CC><<<(int)grid, kBlock, 0, stream>>>(fk, table, n, K, C,
                                                      out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_gather_join(const int* fk, const float* table, long long n, int K,
                      int C, float* out, cudaStream_t stream) {
  if (n <= 0 || C <= 0) return 0;
  if (((size_t)out & 15) != 0) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1: return launch<1>(fk, table, n, K, C, out, stream);
    case 2: return launch<2>(fk, table, n, K, C, out, stream);
    case 3: return launch<3>(fk, table, n, K, C, out, stream);
    case 4: return launch<4>(fk, table, n, K, C, out, stream);
    default: return launch<0>(fk, table, n, K, C, out, stream);
  }
}

}  // extern "C"
