// The order key and the digit walk of masked top-k's radix select
// (topk.cu).  Free of CUDA headers, so the same definitions also compile
// as host C++ (the CPU tests run the walk over numpy histograms that way).
//
// The order is IEEE 754's total order, which `jax.lax.top_k` follows:
// +NaN > +inf > ... > +0 > -0 > ... > -inf > -NaN, NaNs by payload.  As
// an unsigned integer, `order_key(bits)` keeps exactly that order: a
// positive float gains the top bit, a negative one has every bit
// flipped.
//
// The select finds the key T of the k-th largest row in three passes
// over the key's digits, 11, 11 and 10 bits from the top.  Each pass
// counts, per digit, the rows whose key agrees with the prefix chosen so
// far on every higher bit; `walk_down` then picks the digit in which the
// rank still sought falls, and `RadixState` carries the prefix, that
// rank, and the number of rows above the prefix to the next pass.
#pragma once

#if !defined(__CUDACC__) && !defined(__host__)
#define __host__
#endif
#if !defined(__CUDACC__) && !defined(__device__)
#define __device__
#define __forceinline__ inline
#endif

namespace repro {

__host__ __device__ __forceinline__ unsigned order_key(unsigned bits) {
  return bits ^ ((bits & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

// The float bits of an order key (the inverse of order_key).
__host__ __device__ __forceinline__ unsigned key_bits(unsigned key) {
  return key ^ ((key & 0x80000000u) ? 0x80000000u : 0xffffffffu);
}

constexpr int kRadixPasses = 3;

__host__ __device__ constexpr int radix_shift(int pass) {
  return pass == 0 ? 21 : (pass == 1 ? 10 : 0);
}

__host__ __device__ constexpr int radix_bits(int pass) {
  return pass == 2 ? 10 : 11;
}

__host__ __device__ __forceinline__ unsigned radix_digit(unsigned key,
                                                         int pass) {
  return (key >> radix_shift(pass)) & ((1u << radix_bits(pass)) - 1u);
}

// Whether `key` agrees with `prefix` on every bit above the pass's digit.
__host__ __device__ __forceinline__ bool radix_match(unsigned key,
                                                     unsigned prefix,
                                                     int pass) {
  const int hi = radix_shift(pass) + radix_bits(pass);
  return hi >= 32 || (key >> hi) == (prefix >> hi);
}

// Over counts[0, m), taken from the highest index down, the index d at
// which the running count first reaches `rank` (1-based); `*before`
// receives the count of the indices above d.
__host__ __device__ __forceinline__ int walk_down(const unsigned* counts,
                                                  int m, unsigned rank,
                                                  unsigned* before) {
  unsigned c = 0;
  int d = m;
  while (d > 0) {
    --d;
    if (c + counts[d] >= rank) break;
    c += counts[d];
  }
  *before = c;
  return d;
}

struct RadixState {
  unsigned prefix;   // the digits chosen so far, in place
  unsigned rank;     // rank still sought among the rows matching prefix
  unsigned above;    // rows whose key lies above every matching key
};

// After a pass: `digit` was chosen with `before` matching rows above it.
__host__ __device__ __forceinline__ void radix_advance(RadixState* s,
                                                       int pass,
                                                       unsigned digit,
                                                       unsigned before) {
  s->prefix |= digit << radix_shift(pass);
  s->rank -= before;
  s->above += before;
}

}  // namespace repro
