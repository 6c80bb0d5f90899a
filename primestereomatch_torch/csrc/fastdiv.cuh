// Division of small non-negative integers by a run-time divisor that a
// block uses many times: one multiply in place of the divide.

#pragma once

#include <cuda_runtime.h>

// n / d for 0 <= n < 2**16 and 1 <= d < 2**16
struct FastDiv {
  unsigned m;
  int d;
  __device__ explicit FastDiv(int d_) : m(0xFFFFFFFFu / (unsigned)d_ + 1u), d(d_) {}
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)__umulhi((unsigned)n, m);
  }
};
