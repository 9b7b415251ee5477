// Tile geometry and loads shared by the level kernels (level.cu) and the
// tau-search kernels (tau_search.cu).
//
// A [W, d] operand is walked in tiles of kTile = 8 * 1024 elements per lane
// (the Pallas kernels' (8, 1024) block), with no padding copy: the ragged
// tail of a row is masked in place. A lane's row starts at w*d floats, which
// is 16-byte aligned only when w*d % 4 == 0, so a tile runs a scalar head up
// to the next 16-byte boundary, float4 units through the middle and a scalar
// tail. A lane-shared [d] global mask has another alignment than the rows
// and is read with scalar loads.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSublanes = 8;
constexpr int kLanes = 1024;
constexpr int kTile = kSublanes * kLanes;   // elements per block
constexpr int kThreads = 256;

enum GmaskKind { kGmNone = 0, kGmShared = 1, kGmLane = 2 };

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

// Scalar loads with no alignment assumption (the lane-shared gmask).
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

__device__ __forceinline__ void load_gmask(const float* __restrict__ gm,
                                           int gm_kind, const TileGeom& t,
                                           const Unit& u, float v[4]) {
  if (gm_kind == kGmShared) {
    ld_any(gm, t.t0 + u.local, u.cnt, v);
  } else {
    ld(gm, t.row + t.t0 + u.local, u.cnt, v);
  }
}

}  // namespace
