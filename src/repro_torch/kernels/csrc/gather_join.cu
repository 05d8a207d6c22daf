// Foreign-key gather: out[i, :] = table[fk[i], :], and zeros where fk[i]
// lies outside [0, K).  Plain C interface, loaded with ctypes.
//
// Replaces the Pallas kernel `gather_join` (src/repro/kernels/
// gather_join.py:36), which keeps the (K, C) table resident in VMEM and
// spells the gather as a one-hot (T, K) x (K, C) product on the MXU.  On
// Hopper that product spends 2 K C flops per row on what is one load, and
// it turns a NaN or an infinity anywhere in the table into NaN in every
// output row (0 * inf).  This kernel gathers instead, so every output is
// an exact copy of a table entry, or zero.
//
// Bound on the card: bytes.  fk is read once (4 B/row), the table once
// (4 K C B) and the output written once (4 C B/row).  One thread per row
// reads its key and writes the row's C floats, so a warp's stores cover
// one contiguous span of 32 C floats.  When the table fits one block's
// shared memory (opt-in above 48 KB, up to 227 KB) a persistent grid, as
// many blocks as fit on the card, stages it there once per block and
// walks the rows; a larger table is read from device memory through the
// read-only cache, where the rows a query touches mostly stay in L2.
#include "common.cuh"

namespace {

constexpr int kBlock = 512;
constexpr size_t kSmemLimit = 227 * 1024;   // the card's per-block opt-in

template <bool kShared>
__global__ void __launch_bounds__(kBlock)
gather_kernel(const int* __restrict__ fk, const float* __restrict__ table,
              long long n, int K, int C, float* __restrict__ out) {
  extern __shared__ float s_table[];
  if constexpr (kShared) {
    const long long kc = (long long)K * C;
    for (long long j = threadIdx.x; j < kc; j += kBlock) s_table[j] = table[j];
    __syncthreads();
  }
  for (long long i = (long long)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += (long long)gridDim.x * kBlock) {
    const int f = fk[i];
    const bool ok = f >= 0 && f < K;
    const long long src = ok ? (long long)f * C : 0;
    float* dst = out + i * C;
    for (int c = 0; c < C; ++c) {
      float v = 0.f;
      if (ok) v = kShared ? s_table[src + c] : __ldg(table + src + c);
      dst[c] = v;
    }
  }
}

}  // namespace

extern "C" {

// The largest table, in bytes, that is staged in shared memory.
long long repro_gather_join_smem_limit() { return (long long)kSmemLimit; }

int repro_gather_join(const int* fk, const float* table, long long n, int K,
                      int C, float* out, cudaStream_t stream) {
  if (n <= 0 || C <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long row_blocks = (n + kBlock - 1) / kBlock;
  const size_t bytes = (size_t)K * C * sizeof(float);
  if (bytes <= kSmemLimit) {
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(gather_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_kernel<true>, kBlock, bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    long long grid = (long long)sms * per_sm;
    if (grid > row_blocks) grid = row_blocks;
    gather_kernel<true><<<(int)grid, kBlock, bytes, stream>>>(fk, table, n,
                                                              K, C, out);
  } else {
    long long grid = (long long)sms * 16;
    if (grid > row_blocks) grid = row_blocks;
    gather_kernel<false><<<(int)grid, kBlock, 0, stream>>>(fk, table, n, K,
                                                           C, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
