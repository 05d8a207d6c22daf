// Mask compaction entry points (plain C interface, loaded with ctypes).
// The predicate form is generated per predicate by
// repro_torch/kernels/codegen.py and shares the scan and write passes
// exported here.
#include "compact.cuh"

extern "C" {

int repro_compact_blocks(long long n) { return repro::compact_blocks(n); }

int repro_compact_count(const uint8_t* mask, long long n, int* block_counts,
                        cudaStream_t stream) {
  return repro::launch_compact_count(repro::MaskSource{mask}, n, nullptr,
                                     block_counts, stream);
}

// Passes 2 and 3: offsets + exact total, then the ranked writes.  `idx`
// must hold `cap` zeros on entry (pad slots stay zero); `slot_of` is
// nullable.
int repro_compact_scan_write(const uint8_t* mask, long long n,
                             const int* block_counts, int* offsets,
                             int* total, int* idx, int cap, int* slot_of,
                             cudaStream_t stream) {
  const int nb = repro::compact_blocks(n);
  repro::compact_scan_kernel<<<1, repro::kScanBlock, 0, stream>>>(
      block_counts, nb, offsets, total);
  int err = (int)cudaGetLastError();
  if (err != 0 || nb == 0) return err;
  repro::compact_write_kernel<<<nb, repro::kCompactBlock, 0, stream>>>(
      mask, n, offsets, idx, cap, slot_of);
  return (int)cudaGetLastError();
}

}  // extern "C"
