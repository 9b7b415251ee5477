// Rank helpers of the candidate-count kernels (tau_search.cu and
// topq_threshold.cu): an element's rank among taus sorted in shared memory,
// and a tau's place in that order, found by comparison (ties by index), so
// taus may come in any order.
//
// An element's rank r = #{k : |x| >= sorted_k} comes from a binary search
// (rank_of) or from a RankTable over the bit patterns of |x| (table_rank).
// Non-negative floats order as their bit patterns do, so the patterns from
// the smallest positive finite tau to the largest are cut into kBuckets
// buckets of 2^shift patterns each, and entry k of the table holds the rank
// of bucket k's first pattern, flagged when a tau lies inside the bucket.
// An |x| below the range has the rank #{tau <= 0}, one at or above it
// #{tau < +inf} (all B for +inf, 0 for NaN), one inside a bucket without a
// tau the bucket's rank, all from one load; only a bucket holding a tau runs
// a binary search, over its own taus. build_rank_table makes the table of
// one sorted lane with the whole block.

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

constexpr int kBuckets = 4096;             // rank-table buckets
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned kTauInside = 0x8000u;   // flag bit of a table entry

// The range and the ranks outside it of one lane's table; its kBuckets + 1
// uint16 entries are kept beside it.
struct RankTable {
  unsigned lo_bits, hi_bits;   // smallest / largest positive finite tau
  int shift;
  int below;    // #{tau <= 0}: the rank of an |x| under the range
  int finite;   // #{tau < +inf}: the rank of a finite |x| at or over it
  int all;      // B: the rank of +inf
};

constexpr int kTableWords = sizeof(RankTable) / 4;
constexpr int kEntryWords = (kBuckets + 2) / 2;   // kBuckets + 1 uint16

__device__ __forceinline__ int table_rank(float m, const RankTable& t,
                                          const unsigned short* entries,
                                          const float* sorted) {
  const unsigned u = __float_as_uint(m);
  if (u < t.lo_bits) return t.below;
  if (u >= t.hi_bits) return u > kInfBits ? 0 : u == kInfBits ? t.all
                                                              : t.finite;
  const unsigned k = (u - t.lo_bits) >> t.shift;
  const unsigned e = entries[k];
  const int r = (int)(e & ~kTauInside);
  if (!(e & kTauInside)) return r;
  return rank_between(m, sorted, r, (int)(entries[k + 1] & ~kTauInside));
}

__device__ __forceinline__ unsigned bucket_of(float key, const RankTable& t) {
  return (__float_as_uint(key) - t.lo_bits) >> t.shift;
}

// The RankTable of B sorted keys (never NaN) into s_t and its kBuckets + 1
// entries into `entries` (shared or device memory); called by every thread
// of the block after the keys are in place, returns after a __syncthreads.
__device__ __forceinline__ void build_rank_table(const float* sorted, int B,
                                                 RankTable& s_t,
                                                 unsigned short* entries) {
  // the boundaries of the keys <= 0 and of the finite keys: one p in 0..B
  // meets each
  for (int p = threadIdx.x; p <= B; p += blockDim.x) {
    if ((p == 0 || sorted[p - 1] <= 0.f) && (p == B || sorted[p] > 0.f)) {
      s_t.below = p;
    }
    if ((p == 0 || sorted[p - 1] < INFINITY) &&
        (p == B || sorted[p] == INFINITY)) {
      s_t.finite = p;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    RankTable t = s_t;
    const bool any = t.below < t.finite;
    t.lo_bits = any ? __float_as_uint(sorted[t.below]) : kInfBits;
    t.hi_bits = any ? __float_as_uint(sorted[t.finite - 1]) : kInfBits;
    t.shift = 0;
    while (((t.hi_bits - t.lo_bits) >> t.shift) >= (unsigned)kBuckets) {
      ++t.shift;
    }
    t.all = B;
    s_t = t;
  }
  __syncthreads();
  const RankTable t = s_t;
  // entry k = #{keys <= 0} + #{finite keys > 0 in buckets before k},
  // flagged when a key lies in bucket k: each thread fills one run of
  // entries, finding the first by binary search and walking the keys
  // through the rest (runs of 17 for 256 threads, 5 for 1024)
  const int run = (kBuckets + blockDim.x) / blockDim.x;
  const int k0 = threadIdx.x * run;
  if (k0 <= kBuckets) {
    int p = t.below, hi = t.finite;
    while (p < hi) {
      const int mid = (p + hi) >> 1;
      if (bucket_of(sorted[mid], t) < (unsigned)k0) {
        p = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int k1 = k0 + run < kBuckets + 1 ? k0 + run : kBuckets + 1;
    for (int k = k0; k < k1; ++k) {
      while (p < t.finite && bucket_of(sorted[p], t) < (unsigned)k) ++p;
      const bool inside =
          p < t.finite && bucket_of(sorted[p], t) == (unsigned)k;
      entries[k] = (unsigned short)(p | (inside ? kTauInside : 0u));
    }
  }
  __syncthreads();
}

}  // namespace
