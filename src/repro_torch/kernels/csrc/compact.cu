// Mask compaction entry points (plain C interface, loaded with ctypes).
// The predicate form is generated per predicate by
// repro_torch/kernels/codegen.py around the same header.
#include "compact.cuh"

extern "C" {

int repro_compact_tile_rows() { return repro::kCompactRows; }

// `ws` holds `ws_words` int32 words in compact.cuh's layout; `translate`
// adds slot_of.
int repro_compact(const uint8_t* mask, long long n, int* ws,
                  long long ws_words, int cap, int translate,
                  cudaStream_t stream) {
  return repro::compact_mask_into(mask, n, ws, ws_words, cap, translate != 0,
                                  stream);
}

}  // extern "C"
