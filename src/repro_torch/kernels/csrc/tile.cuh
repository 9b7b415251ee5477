// Tile geometry, loads and the pinned squared-error fold shared by the level
// kernels (level.cu), the tau-search kernels (tau_search.cu) and the
// resident kernels (resident.cu).
//
// A [W, d] operand is walked in tiles of kTile = 8 * 1024 elements per lane
// (the Pallas kernels' (8, 1024) block), with no padding copy: the ragged
// tail of a row is masked in place. A lane's row starts at w*d floats, which
// is 16-byte aligned only when w*d % 4 == 0, so a tile runs a scalar head up
// to the next 16-byte boundary, float4 units through the middle and a scalar
// tail. A global mask row takes the same float4 loads where it has the lane
// row's alignment, and scalar loads where it has not.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSublanes = 8;
constexpr int kLanes = 1024;
constexpr int kTile = kSublanes * kLanes;   // elements per block
constexpr int kThreads = 256;

// The global mask: none, or B rows of d over W cohort-major lanes, lane w
// reading row w / (W / B). A lane-shared [d] mask is B = 1, a cohort-shared
// [B, d] mask B cohorts, a per-lane [W, d] mask B = W.
enum GmaskKind { kGmNone = 0, kGmRows = 1 };

// One unit of a tile: either a float4 (4 elements, 16-byte aligned) or a
// scalar element in the unaligned head or the tail.
struct Unit {
  int local;   // offset of the unit's first element inside the tile
  int cnt;     // 4 or 1
};

struct TileGeom {
  long long row;    // w * d: flat offset of the lane's row
  long long t0;     // first element of the tile inside the row
  int len;          // elements of the tile inside d
  int head;         // scalar elements before the first 16-byte boundary
  int nvec;         // float4 units
  int nunits;
};

__device__ __forceinline__ TileGeom tile_geom_at(long long d, long long tile,
                                                 int lane) {
  TileGeom t;
  t.row = (long long)lane * d;
  t.t0 = tile * kTile;
  long long rem = d - t.t0;
  t.len = rem < kTile ? (int)rem : kTile;
  int mis = (int)((t.row + t.t0) & 3);
  int head = (4 - mis) & 3;
  t.head = head < t.len ? head : t.len;
  t.nvec = (t.len - t.head) >> 2;
  t.nunits = t.head + t.nvec + (t.len - t.head - 4 * t.nvec);
  return t;
}

// The tile of this block: tile blockIdx.x of lane blockIdx.y.
__device__ __forceinline__ TileGeom tile_geom(long long d) {
  return tile_geom_at(d, blockIdx.x, blockIdx.y);
}

__device__ __forceinline__ Unit unit_at(const TileGeom& t, int u) {
  Unit r;
  if (u < t.head) {
    r.local = u;
    r.cnt = 1;
  } else if (u < t.head + t.nvec) {
    r.local = t.head + 4 * (u - t.head);
    r.cnt = 4;
  } else {
    r.local = t.head + 4 * t.nvec + (u - t.head - t.nvec);
    r.cnt = 1;
  }
  return r;
}

// Load cnt elements at p[i]; cnt == 4 means p + i is 16-byte aligned.
__device__ __forceinline__ void ld(const float* __restrict__ p, long long i,
                                   int cnt, float v[4]) {
  if (cnt == 4) {
    float4 q = *reinterpret_cast<const float4*>(p + i);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = p[i];
  }
}

// Scalar loads with no alignment assumption (gmask rows at another
// alignment than the lane's row).
__device__ __forceinline__ void ld_any(const float* __restrict__ p,
                                       long long i, int cnt, float v[4]) {
  for (int k = 0; k < cnt; ++k) v[k] = __ldg(p + i + k);
}

__device__ __forceinline__ void st(float* __restrict__ p, long long i,
                                   int cnt, const float v[4]) {
  if (cnt == 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[i] = v[0];
  }
}

// Flat offset of lane `lane`'s mask row, (lane / lanes_per_cohort) * d.
// Computed once per block.
__device__ __forceinline__ long long gmask_row(int lane, int lanes_per_cohort,
                                               long long d) {
  return (long long)(lane / lanes_per_cohort) * d;
}

// The mask values of one unit. A row at the lane row's offset mod 4 floats
// (every row of a per-lane mask; a shared row only for some lanes) shares
// the unit's 16-byte alignment and takes float4 loads, any other row
// scalar loads. The branch is the same for every thread of a block.
__device__ __forceinline__ void load_gmask(const float* __restrict__ gm,
                                           long long gm_row,
                                           const TileGeom& t, const Unit& u,
                                           float v[4]) {
  const long long i = gm_row + t.t0 + u.local;
  if (((gm_row - t.row) & 3) == 0) {
    ld(gm, i, u.cnt, v);
  } else {
    ld_any(gm, i, u.cnt, v);
  }
}

// Pinned ||e'||^2 of one tile whose e' values sit in s[kTile] (zeros past
// the tile's length): lanes fold 1024 -> 1 (first level fma(a, a, b*b),
// a from the lower half), then sublanes 8 -> 1.
__device__ inline float pinned_tile_err(float* s) {
  __syncthreads();
  for (int k = threadIdx.x; k < kSublanes * (kLanes / 2); k += blockDim.x) {
    int r = k / (kLanes / 2), i = k % (kLanes / 2);
    float a = s[r * kLanes + i], b = s[r * kLanes + i + kLanes / 2];
    s[r * kLanes + i] = __fmaf_rn(a, a, __fmul_rn(b, b));
  }
  __syncthreads();
  for (int n = kLanes / 4; n >= 1; n >>= 1) {
    for (int k = threadIdx.x; k < kSublanes * n; k += blockDim.x) {
      int r = k / n, i = k % n;
      s[r * kLanes + i] = __fadd_rn(s[r * kLanes + i], s[r * kLanes + i + n]);
    }
    __syncthreads();
  }
  for (int m = kSublanes / 2; m >= 1; m >>= 1) {
    if (threadIdx.x < m) {
      int r = threadIdx.x;
      s[r * kLanes] = __fadd_rn(s[r * kLanes], s[(r + m) * kLanes]);
    }
    __syncthreads();
  }
  return s[0];
}

}  // namespace
