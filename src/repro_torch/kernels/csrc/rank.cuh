// Rank helpers of the candidate-count kernels (tau_search.cu and
// topq_threshold.cu): an element's rank among taus sorted in shared memory
// is a binary search, and a tau's place in that order is found by
// comparison (ties by index), so taus may come in any order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// lo + #{lo <= k < hi : v >= a[k]} for a nondecreasing a (lo for a NaN v).
__device__ __forceinline__ int rank_between(float v, const float* a, int lo,
                                            int hi) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v >= a[mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{k < n : v >= a[k]} for a nondecreasing a (0 for a NaN v).
__device__ __forceinline__ int rank_of(float v, const float* a, int n) {
  return rank_between(v, a, 0, n);
}

// A NaN tau sorts as +inf (and counts nothing).
__device__ __forceinline__ float tau_key(float t) {
  return isnan(t) ? INFINITY : t;
}

// Place of key[b] in the ascending order of key[0..n), ties by index.
__device__ __forceinline__ int sorted_pos(const float* key, int n, int b) {
  const float kb = key[b];
  int pos = 0;
  for (int c = 0; c < n; ++c) {
    const float kc = key[c];
    pos += (kc < kb) || (kc == kb && c < b);
  }
  return pos;
}

}  // namespace
