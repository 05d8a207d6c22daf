// Helpers the generated plan expressions call.  Free of CUDA headers, so
// the same definitions also compile as host C++ (the CPU tests check the
// generated expressions that way).
#pragma once

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#endif

namespace repro {

// Civil year of a days-since-1970 date (Hinnant's algorithm, as the
// planner's `Year` node evaluates it).  C's `/` truncates toward zero
// where the reference's `//` floors: the two agree because every operand
// here is positive for dates after 0000-03-01 (z = days + 719468 > 0).
__device__ __forceinline__ int year_of_days(int days) {
  const int z = days + 719468;
  const int era = z / 146097;
  const int doe = z - era * 146097;
  const int yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const int y = yoe + era * 400;
  const int doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const int mp = (5 * doy + 2) / 153;
  const int m = mp < 10 ? mp + 3 : mp - 9;
  return y + (m <= 2);
}

// The float32 bit patterns of infinities and NaN, for literals.
__device__ __forceinline__ float f32_from_bits(unsigned bits) {
  union {
    unsigned u;
    float f;
  } v{bits};
  return v.f;
}

}  // namespace repro
