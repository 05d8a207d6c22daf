// Mask compaction entry points (plain C interface, loaded with ctypes).
// The predicate form is generated per predicate by
// repro_torch/kernels/codegen.py around the same kernel.
#include "compact.cuh"

extern "C" {

int repro_compact_tile_rows() { return repro::kCompactRows; }

long long repro_compact_row_words(long long n, int cap, int translate) {
  return repro::compact_row_words(n, cap, translate != 0);
}

// `ws` holds `ws_words` int32 words in compact.cuh's layout; `translate`
// adds slot_of.
int repro_compact(const uint8_t* mask, long long n, int* ws,
                  long long ws_words, int cap, int translate,
                  cudaStream_t stream) {
  return repro::compact_into(repro::MaskSource{mask}, n, ws, ws_words, cap,
                             translate != 0, stream);
}

// B masks `mask_stride` bytes apart (0: one mask for all), B workspace
// rows of repro_compact_row_words words (compact.cuh's batched layout):
// one memset and one launch.
int repro_compact_batched(const uint8_t* mask, long long mask_stride, int B,
                          long long n, int* ws, long long ws_words, int cap,
                          int translate, cudaStream_t stream) {
  return repro::compact_batch_into(repro::MaskBatch{mask, mask_stride}, B, n,
                                   ws, ws_words, cap, translate != 0, stream);
}

}  // extern "C"
