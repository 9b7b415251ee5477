// Hopper (sm_90a) kernels for one level of W concurrent node steps.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/level.py:
//   cl_fuse_level       <- cl_fuse_level_pallas      (whole CL node step, Algs 3/5)
//   sparsify_ef_level   <- sparsify_ef_level_pallas  (EF + sparsify, Algs 1/2/4)
//   chain_accum_level   <- chain_accum_level_pallas  (IA combine + support counts)
//
// Bound: device-memory bytes. Each element is read once and written once
// with a handful of flops in between; there is no matrix work. The design
// streams every array once with 16-byte loads and stores:
//   * grid = (tiles of d, W lanes); one block walks one 8192-element tile
//     of one lane, so no padding copy of the inputs is ever made and the
//     ragged tail is masked in place;
//   * a lane's row starts at w*d floats, which is 16-byte aligned only when
//     w*d % 4 == 0, so each tile runs a scalar head up to the next 16-byte
//     boundary, float4 units through the middle and a scalar tail;
//   * the global mask is B rows over W cohort-major lanes (B = 1 for a
//     lane-shared [d] mask, B cohorts for a cohort-shared [B, d] mask, B = W
//     for a per-lane [W, d] mask); the W / B lanes of row b read it alike
//     and it is never broadcast to [W, d]. A row takes float4 loads where
//     it has the lane row's alignment, scalar loads elsewhere (tile.cuh);
//   * support counts are reduced per block and added with integer atomics:
//     integer sums are exact in any order;
//   * lanes with valid == 0 write zeros and count nothing.
//
// Rounding matches the jitted JAX reference bit for bit: __fmaf_rn exactly
// where XLA contracts a*b+c (w*g+e, p*g~+gamma_in, m*s+Lambda, and the first
// level of the pinned squared-error fold), __fmul_rn/__fadd_rn/__fsub_rn
// everywhere else so that nvcc cannot contract what XLA did not. Never
// build with --use_fast_math.
//
// The optional pinned ||e'||^2 (err_sq_mode="kernel") keeps the order of
// kernels/level.py::_pinned_tile_err: an 8x1024 tile of e' in shared memory
// folds lanes 1024 -> 1 pairwise, then sublanes 8 -> 1; tile scalars go to
// a [W, n_tiles] scratch and a second kernel sums them left to right.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

// Block-wide sum of per-thread integer counts, added to *out once.
__device__ __forceinline__ void block_count(int mine, int* smem, int* out) {
  unsigned full = 0xffffffffu;
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_down_sync(full, mine, o);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(smem, mine);
  __syncthreads();
  if (threadIdx.x == 0 && *smem) atomicAdd(out, *smem);
}

// Zero the outputs of a padding lane's tile.
__device__ __forceinline__ void zero_tile(const TileGeom& t, float* a,
                                          float* b) {
  const float z[4] = {0.f, 0.f, 0.f, 0.f};
  for (int u = threadIdx.x; u < t.nunits; u += blockDim.x) {
    Unit un = unit_at(t, u);
    long long i = t.row + t.t0 + un.local;
    st(a, i, un.cnt, z);
    if (b) st(b, i, un.cnt, z);
  }
}

// --------------------------------------------------------------------------
// cl_fuse_level
// --------------------------------------------------------------------------

template <int GM, bool MASK, bool ERR>
__global__ void __launch_bounds__(kThreads)
cl_fuse_level_kernel(const float* __restrict__ g, const float* __restrict__ e,
                     const float* __restrict__ gin,
                     const float* __restrict__ weight,
                     const float* __restrict__ tau,
                     const float* __restrict__ part,
                     const float* __restrict__ valid,
                     const float* __restrict__ gm, int gm_lpc,
                     const float* __restrict__ mask, float* __restrict__ gout,
                     float* __restrict__ enew, int* __restrict__ nnz,
                     int* __restrict__ nnz_off, float* __restrict__ tile_err,
                     long long d) {
  __shared__ int cnt_s[2];
  __shared__ float err_s[ERR ? kTile : 1];
  const int w = blockIdx.y;
  const TileGeom t = tile_geom(d);
  const long long gm_row = gmask_row(w, gm_lpc, d);
  if (!(valid[w] > 0.f)) {
    zero_tile(t, gout, enew);
    if (ERR && threadIdx.x == 0) tile_err[(long long)w * gridDim.x + blockIdx.x] = 0.f;
    return;
  }
  if (threadIdx.x < 2) cnt_s[threadIdx.x] = 0;
  if (ERR) {
    for (int k = t.len + threadIdx.x; k < kTile; k += blockDim.x) err_s[k] = 0.f;
  }
  __syncthreads();
  const float wt = weight[w], tw = tau[w], pw = part[w];
  const bool alive = pw > 0.f;
  int my_nnz = 0, my_off = 0;
  for (int u = threadIdx.x; u < t.nunits; u += blockDim.x) {
    const Unit un = unit_at(t, u);
    const long long i = t.row + t.t0 + un.local;
    float vg[4], ve[4], vi[4], vm[4], vk[4], og[4], oe[4];
    ld(g, i, un.cnt, vg);
    ld(e, i, un.cnt, ve);
    ld(gin, i, un.cnt, vi);
    if (GM != kGmNone) load_gmask(gm, gm_row, t, un, vm);
    if (MASK) ld(mask, i, un.cnt, vk);
    for (int k = 0; k < un.cnt; ++k) {
      const float gt = __fmaf_rn(wt, vg[k], ve[k]);
      const float s = __fmaf_rn(pw, gt, vi[k]);
      const float lam_t = GM != kGmNone ? __fmul_rn(__fsub_rn(1.0f, vm[k]), s) : s;
      bool keep = fabsf(lam_t) >= tw;
      if (MASK) keep = keep || (vk[k] > 0.f);
      const float lam = keep ? lam_t : 0.0f;
      float en = __fsub_rn(lam_t, lam);
      float ga = GM != kGmNone ? __fmaf_rn(vm[k], s, lam) : lam;
      if (!alive) {
        ga = vi[k];
        en = gt;
      }
      og[k] = ga;
      oe[k] = en;
      if (ga != 0.f) {
        ++my_nnz;
        if (GM == kGmNone || vm[k] <= 0.f) ++my_off;
      }
      if (ERR) err_s[un.local + k] = en;
    }
    st(gout, i, un.cnt, og);
    st(enew, i, un.cnt, oe);
  }
  block_count(my_nnz, &cnt_s[0], &nnz[w]);
  block_count(my_off, &cnt_s[1], &nnz_off[w]);
  if (ERR) {
    const float te = pinned_tile_err(err_s);
    if (threadIdx.x == 0) tile_err[(long long)w * gridDim.x + blockIdx.x] = te;
  }
}

// --------------------------------------------------------------------------
// sparsify_ef_level
// --------------------------------------------------------------------------

template <bool MASK, bool ERR>
__global__ void __launch_bounds__(kThreads)
sparsify_ef_level_kernel(const float* __restrict__ g,
                         const float* __restrict__ e,
                         const float* __restrict__ mask,
                         const float* __restrict__ weight,
                         const float* __restrict__ tau,
                         const float* __restrict__ valid,
                         float* __restrict__ gbar, float* __restrict__ enew,
                         int* __restrict__ nnz, float* __restrict__ tile_err,
                         long long d) {
  __shared__ int cnt_s[1];
  __shared__ float err_s[ERR ? kTile : 1];
  const int w = blockIdx.y;
  const TileGeom t = tile_geom(d);
  if (!(valid[w] > 0.f)) {
    zero_tile(t, gbar, enew);
    if (ERR && threadIdx.x == 0) tile_err[(long long)w * gridDim.x + blockIdx.x] = 0.f;
    return;
  }
  if (threadIdx.x == 0) cnt_s[0] = 0;
  if (ERR) {
    for (int k = t.len + threadIdx.x; k < kTile; k += blockDim.x) err_s[k] = 0.f;
  }
  __syncthreads();
  const float wt = weight[w], tw = tau[w];
  int my_nnz = 0;
  for (int u = threadIdx.x; u < t.nunits; u += blockDim.x) {
    const Unit un = unit_at(t, u);
    const long long i = t.row + t.t0 + un.local;
    float vg[4], ve[4], vk[4], ob[4], oe[4];
    ld(g, i, un.cnt, vg);
    ld(e, i, un.cnt, ve);
    if (MASK) ld(mask, i, un.cnt, vk);
    for (int k = 0; k < un.cnt; ++k) {
      const float gt = __fmaf_rn(wt, vg[k], ve[k]);
      bool keep = fabsf(gt) >= tw;
      if (MASK) keep = keep || (vk[k] > 0.f);
      const float gb = keep ? gt : 0.0f;
      const float en = __fsub_rn(gt, gb);
      ob[k] = gb;
      oe[k] = en;
      if (gb != 0.f) ++my_nnz;
      if (ERR) err_s[un.local + k] = en;
    }
    st(gbar, i, un.cnt, ob);
    st(enew, i, un.cnt, oe);
  }
  block_count(my_nnz, &cnt_s[0], &nnz[w]);
  if (ERR) {
    const float te = pinned_tile_err(err_s);
    if (threadIdx.x == 0) tile_err[(long long)w * gridDim.x + blockIdx.x] = te;
  }
}

// --------------------------------------------------------------------------
// chain_accum_level
// --------------------------------------------------------------------------

template <int GM>
__global__ void __launch_bounds__(kThreads)
chain_accum_level_kernel(const float* __restrict__ gin,
                         const float* __restrict__ gbar,
                         const float* __restrict__ valid,
                         const float* __restrict__ gm, int gm_lpc,
                         float* __restrict__ gout, int* __restrict__ nnz,
                         int* __restrict__ nnz_off, long long d) {
  __shared__ int cnt_s[2];
  const int w = blockIdx.y;
  const TileGeom t = tile_geom(d);
  const long long gm_row = gmask_row(w, gm_lpc, d);
  if (!(valid[w] > 0.f)) {
    zero_tile(t, gout, nullptr);
    return;
  }
  if (threadIdx.x < 2) cnt_s[threadIdx.x] = 0;
  __syncthreads();
  int my_nnz = 0, my_off = 0;
  for (int u = threadIdx.x; u < t.nunits; u += blockDim.x) {
    const Unit un = unit_at(t, u);
    const long long i = t.row + t.t0 + un.local;
    float vi[4], vb[4], vm[4], og[4];
    ld(gin, i, un.cnt, vi);
    ld(gbar, i, un.cnt, vb);
    if (GM != kGmNone) load_gmask(gm, gm_row, t, un, vm);
    for (int k = 0; k < un.cnt; ++k) {
      const float ga = __fadd_rn(vi[k], vb[k]);
      og[k] = ga;
      if (ga != 0.f) {
        ++my_nnz;
        if (GM == kGmNone || vm[k] <= 0.f) ++my_off;
      }
    }
    st(gout, i, un.cnt, og);
  }
  block_count(my_nnz, &cnt_s[0], &nnz[w]);
  block_count(my_off, &cnt_s[1], &nnz_off[w]);
}

// Per lane: err[w] = tile_err[w, 0] + tile_err[w, 1] + ... left to right.
__global__ void sum_tiles_kernel(const float* __restrict__ tile_err,
                                 float* __restrict__ err, int w_lanes,
                                 int n_tiles) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= w_lanes) return;
  const float* row = tile_err + (long long)w * n_tiles;
  float acc = row[0];
  for (int j = 1; j < n_tiles; ++j) acc = __fadd_rn(acc, row[j]);
  err[w] = acc;
}

inline dim3 level_grid(long long d, int w_lanes) {
  long long tiles = (d + kTile - 1) / kTile;
  if (tiles < 1) tiles = 1;
  return dim3((unsigned)tiles, (unsigned)w_lanes);
}

inline int finish_err(const float* tile_err, float* err, int w_lanes,
                      int n_tiles, cudaStream_t stream) {
  sum_tiles_kernel<<<(w_lanes + 127) / 128, 128, 0, stream>>>(
      tile_err, err, w_lanes, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// --------------------------------------------------------------------------
// C interface (ctypes). Every pointer is a contiguous float32 / int32 CUDA
// buffer checked by the Python wrapper; counts are zeroed here, on the
// caller's stream. Returns cudaGetLastError() after the launches.
// --------------------------------------------------------------------------

extern "C" {

int level_tiles(long long d) { return (int)level_grid(d, 1).x; }

int cl_fuse_level_launch(const float* g, const float* e, const float* gin,
                         const float* weight, const float* tau,
                         const float* part, const float* valid,
                         const float* gm, int gm_lpc, const float* mask,
                         float* gout, float* enew, int* nnz, int* nnz_off,
                         float* tile_err, float* err, int w_lanes,
                         long long d, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaMemsetAsync(nnz, 0, sizeof(int) * w_lanes, stream);
  cudaMemsetAsync(nnz_off, 0, sizeof(int) * w_lanes, stream);
  const dim3 grid = level_grid(d, w_lanes);
  const bool has_mask = mask != nullptr, with_err = err != nullptr;
#define CL_LAUNCH(GMK, MK, ER)                                              \
  cl_fuse_level_kernel<GMK, MK, ER><<<grid, kThreads, 0, stream>>>(         \
      g, e, gin, weight, tau, part, valid, gm, gm_lpc, mask, gout, enew,   \
      nnz, nnz_off, tile_err, d)
#define CL_ERR(GMK, MK) \
  if (with_err) CL_LAUNCH(GMK, MK, true); else CL_LAUNCH(GMK, MK, false)
#define CL_MASK(GMK) \
  if (has_mask) { CL_ERR(GMK, true); } else { CL_ERR(GMK, false); }
  if (gm != nullptr) {
    CL_MASK(kGmRows);
  } else {
    CL_MASK(kGmNone);
  }
#undef CL_MASK
#undef CL_ERR
#undef CL_LAUNCH
  int rc = (int)cudaGetLastError();
  if (rc || !with_err) return rc;
  return finish_err(tile_err, err, w_lanes, (int)grid.x, stream);
}

int sparsify_ef_level_launch(const float* g, const float* e,
                             const float* mask, const float* weight,
                             const float* tau, const float* valid,
                             float* gbar, float* enew, int* nnz,
                             float* tile_err, float* err, int w_lanes,
                             long long d, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaMemsetAsync(nnz, 0, sizeof(int) * w_lanes, stream);
  const dim3 grid = level_grid(d, w_lanes);
  const bool has_mask = mask != nullptr, with_err = err != nullptr;
#define SP_LAUNCH(MK, ER)                                                   \
  sparsify_ef_level_kernel<MK, ER><<<grid, kThreads, 0, stream>>>(          \
      g, e, mask, weight, tau, valid, gbar, enew, nnz, tile_err, d)
  if (has_mask) {
    if (with_err) SP_LAUNCH(true, true); else SP_LAUNCH(true, false);
  } else {
    if (with_err) SP_LAUNCH(false, true); else SP_LAUNCH(false, false);
  }
#undef SP_LAUNCH
  int rc = (int)cudaGetLastError();
  if (rc || !with_err) return rc;
  return finish_err(tile_err, err, w_lanes, (int)grid.x, stream);
}

int chain_accum_level_launch(const float* gin, const float* gbar,
                             const float* valid, const float* gm,
                             int gm_lpc, float* gout, int* nnz,
                             int* nnz_off, int w_lanes, long long d,
                             void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaMemsetAsync(nnz, 0, sizeof(int) * w_lanes, stream);
  cudaMemsetAsync(nnz_off, 0, sizeof(int) * w_lanes, stream);
  const dim3 grid = level_grid(d, w_lanes);
#define CA_LAUNCH(GMK)                                                      \
  chain_accum_level_kernel<GMK><<<grid, kThreads, 0, stream>>>(            \
      gin, gbar, valid, gm, gm_lpc, gout, nnz, nnz_off, d)
  if (gm != nullptr) {
    CA_LAUNCH(kGmRows);
  } else {
    CA_LAUNCH(kGmNone);
  }
#undef CA_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
