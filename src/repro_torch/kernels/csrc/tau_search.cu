// Hopper (sm_90a) kernels of the threshold Top-Q tau search.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/level.py:
//   count_ge_level        <- count_ge_level_pallas        (counts over a
//                            materialized [W, d] x, taus in any order)
//   count_ge_fused_level  <- count_ge_fused_level_pallas  (counts over the
//                            operand rebuilt per element from g, e, gamma_in)
//   hist_topq_level       <- hist_topq_level_pallas       (joint digit
//                            histogram of tau_impl="hist")
//
// All three are integer-exact counts. On the TPU each candidate is one
// vector compare over a whole tile (B passes over the tile), and the
// histogram is a one-hot contraction on the MXU. Here each element finds
// its bin once, by binary search over values held in shared memory, and
// adds 1 to a shared-memory histogram with an integer atomic; blocks add
// their histograms into the output with global integer atomics. Integer
// sums are exact in any order, so the result does not depend on the
// schedule.
//
// Bound: device-memory bytes at large d (each operand array is read once:
// 2-3 [W, d] f32 rows plus the mask), with a log2(B)-step search per
// element on top; at the paper's d = 7850 a launch is one tile per lane and
// launch-bound.
//
// Counts (count_ge_level, count_ge_fused_level):
//   * the lane's B taus are sorted into shared memory (rank by comparison,
//     ties by index; a NaN tau sorts as +inf and counts nothing);
//   * an element's rank r = #{k : |x| >= sorted_k} is a binary search;
//     a shared [B+1] histogram counts the ranks, and blocks add it into a
//     global [W, B+1] scratch;
//   * a second kernel turns the ranks into suffix sums, counts[w, b] =
//     #{rank >= pos_b + 1}, pos_b being tau b's place in the sorted order.
//   Taus in any order give the integers of the plain broadcast comparison,
//   so one kernel serves the materialized and the fused operand.
//
// Histogram (hist_topq_level), per element with tables from
// core/sparsify.py::_hist_tables (tau1 [b], new_lo, w2, top_shift [b+1]):
//   d1 = #{j : |x| >= tau1_j} by binary search; nl, w2e, ts at index d1;
//   d2 = the largest j in 0..b with |x| >= fma(w2e, j, nl), by the same
//        binary search (same midpoints) as the plain version;
//   D2[d1, d2] += 1, and F[d1] += 1 when |x| >= ts.
//   A (b+1)^2 histogram that fits in 48 KB of shared memory (b <= 107) is
//   kept there and flushed once per block; a larger one (up to b = 1024)
//   takes the global-atomics variant, which adds straight into D2 and F.
//
// The operand is rebuilt with the float ops of cl_fuse_level (and of the
// jitted reference): s = fma(w, g, e); s = fma(p, s, gamma_in) with
// gamma_in; s = (1 - m) * s with a global mask; never --use_fast_math.
// Nothing is padded, so no pad count is subtracted and D2[w, 0, 0] holds
// only real elements (the Pallas kernel's holds its zero padding too).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rank.cuh"
#include "tile.cuh"

namespace {

constexpr int kMaxBlocksPerLane = 64;   // tiles are walked grid-stride
constexpr int kSharedLimit = 48 * 1024;

enum Source { kSrcX = 0, kSrcFused = 1 };

struct Operand {
  const float* g;     // x for kSrcX
  const float* e;
  const float* gin;   // null without gamma_in
  const float* gm;    // null, [d] or [W, d]
  const float* w;
  const float* p;
};

// |operand| of one unit (cnt elements) of a tile.
template <int SRC, int GM, bool GAMMA>
__device__ __forceinline__ void load_mag(const Operand& op, float wt,
                                         float pw, const TileGeom& t,
                                         const Unit& un, float mag[4]) {
  const long long i = t.row + t.t0 + un.local;
  float vg[4], ve[4], vi[4], vm[4];
  ld(op.g, i, un.cnt, vg);
  if (SRC == kSrcX) {
    for (int k = 0; k < un.cnt; ++k) mag[k] = fabsf(vg[k]);
    return;
  }
  ld(op.e, i, un.cnt, ve);
  if (GAMMA) ld(op.gin, i, un.cnt, vi);
  if (GM != kGmNone) load_gmask(op.gm, GM, t, un, vm);
  for (int k = 0; k < un.cnt; ++k) {
    float s = __fmaf_rn(wt, vg[k], ve[k]);
    if (GAMMA) s = __fmaf_rn(pw, s, vi[k]);
    if (GM != kGmNone) s = __fmul_rn(__fsub_rn(1.0f, vm[k]), s);
    mag[k] = fabsf(s);
  }
}

// --------------------------------------------------------------------------
// counts: rank histogram, then suffix sums
// --------------------------------------------------------------------------

template <int SRC, int GM, bool GAMMA>
__global__ void __launch_bounds__(kThreads)
count_rank_kernel(Operand op, const float* __restrict__ taus, int nb_taus,
                  int* __restrict__ ranks, long long d, long long n_tiles) {
  extern __shared__ float smem[];
  const int B = nb_taus;
  float* s_key = smem;
  float* s_sorted = smem + B;
  int* s_hist = reinterpret_cast<int*>(smem + 2 * B);   // [B + 1]
  const int w = blockIdx.y;
  const float* trow = taus + (long long)w * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_key[b] = tau_key(trow[b]);
  for (int r = threadIdx.x; r <= B; r += blockDim.x) s_hist[r] = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    s_sorted[sorted_pos(s_key, B, b)] = s_key[b];
  }
  __syncthreads();
  const float wt = SRC == kSrcFused ? op.w[w] : 0.f;
  const float pw = GAMMA ? op.p[w] : 0.f;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileGeom t = tile_geom_at(d, tile, w);
    for (int u = threadIdx.x; u < t.nunits; u += blockDim.x) {
      const Unit un = unit_at(t, u);
      float mag[4];
      load_mag<SRC, GM, GAMMA>(op, wt, pw, t, un, mag);
      for (int k = 0; k < un.cnt; ++k) {
        const int r = rank_of(mag[k], s_sorted, B);
        if (r) atomicAdd(&s_hist[r], 1);
      }
    }
  }
  __syncthreads();
  int* row = ranks + (long long)w * (B + 1);
  for (int r = 1 + threadIdx.x; r <= B; r += blockDim.x) {
    const int c = s_hist[r];
    if (c) atomicAdd(&row[r], c);
  }
}

// One block per lane: counts[w, b] = #{elements of rank >= pos_b + 1}.
__global__ void __launch_bounds__(kThreads)
counts_from_ranks_kernel(const float* __restrict__ taus, int nb_taus,
                         const int* __restrict__ ranks,
                         int* __restrict__ counts) {
  extern __shared__ float smem[];
  const int B = nb_taus;
  float* s_key = smem;
  int* s_suffix = reinterpret_cast<int*>(smem + B);     // [B + 1]
  const int w = blockIdx.x;
  const float* trow = taus + (long long)w * B;
  const int* rrow = ranks + (long long)w * (B + 1);
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_key[b] = tau_key(trow[b]);
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int r = B; r >= 1; --r) {
      acc += rrow[r];
      s_suffix[r] = acc;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    counts[(long long)w * B + b] =
        isnan(trow[b]) ? 0 : s_suffix[sorted_pos(s_key, B, b) + 1];
  }
}

// --------------------------------------------------------------------------
// joint digit histogram
// --------------------------------------------------------------------------

template <int GM, bool GAMMA, bool SHARED>
__global__ void __launch_bounds__(kThreads)
hist_topq_level_kernel(Operand op, const float* __restrict__ tau1,
                       const float* __restrict__ new_lo,
                       const float* __restrict__ w2,
                       const float* __restrict__ top_shift, int branch,
                       int* __restrict__ d2_out, int* __restrict__ f_out,
                       long long d, long long n_tiles) {
  extern __shared__ float smem[];
  const int nb = branch + 1;
  float* s_t1 = smem;
  float* s_nl = s_t1 + branch;
  float* s_w2 = s_nl + nb;
  float* s_ts = s_w2 + nb;
  int* s_d2 = reinterpret_cast<int*>(s_ts + nb);        // [nb * nb]
  int* s_f = s_d2 + nb * nb;                            // [nb]
  const int w = blockIdx.y;
  for (int j = threadIdx.x; j < branch; j += blockDim.x) {
    s_t1[j] = tau1[(long long)w * branch + j];
  }
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    s_nl[j] = new_lo[(long long)w * nb + j];
    s_w2[j] = w2[(long long)w * nb + j];
    s_ts[j] = top_shift[(long long)w * nb + j];
  }
  if (SHARED) {
    for (int j = threadIdx.x; j < nb * nb + nb; j += blockDim.x) s_d2[j] = 0;
  }
  __syncthreads();
  int* g_d2 = d2_out + (long long)w * nb * nb;
  int* g_f = f_out + (long long)w * nb;
  int* hd2 = SHARED ? s_d2 : g_d2;
  int* hf = SHARED ? s_f : g_f;
  const float wt = op.w[w];
  const float pw = GAMMA ? op.p[w] : 0.f;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileGeom t = tile_geom_at(d, tile, w);
    for (int u = threadIdx.x; u < t.nunits; u += blockDim.x) {
      const Unit un = unit_at(t, u);
      float mag[4];
      load_mag<kSrcFused, GM, GAMMA>(op, wt, pw, t, un, mag);
      for (int k = 0; k < un.cnt; ++k) {
        const float m = mag[k];
        const int d1 = rank_of(m, s_t1, branch);
        const float nl = s_nl[d1], w2e = s_w2[d1];
        int lo = 0, hi = nb;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (m >= __fmaf_rn(w2e, (float)mid, nl)) lo = mid; else hi = mid;
        }
        atomicAdd(&hd2[d1 * nb + lo], 1);
        if (m >= s_ts[d1]) atomicAdd(&hf[d1], 1);
      }
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int j = threadIdx.x; j < nb * nb; j += blockDim.x) {
      const int c = s_d2[j];
      if (c) atomicAdd(&g_d2[j], c);
    }
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const int c = s_f[j];
      if (c) atomicAdd(&g_f[j], c);
    }
  }
}

inline long long tiles_of(long long d) { return (d + kTile - 1) / kTile; }

inline dim3 search_grid(long long n_tiles, int w_lanes) {
  const long long x = n_tiles < kMaxBlocksPerLane ? n_tiles : kMaxBlocksPerLane;
  return dim3((unsigned)(x < 1 ? 1 : x), (unsigned)w_lanes);
}

size_t count_smem(int nb_taus) { return (size_t)(3 * nb_taus + 1) * 4; }

template <int SRC, int GM, bool GAMMA>
int count_launch(const Operand& op, const float* taus, int* ranks,
                 int* counts, int w_lanes, int nb_taus, long long d,
                 cudaStream_t stream) {
  cudaMemsetAsync(ranks, 0, sizeof(int) * (size_t)w_lanes * (nb_taus + 1),
                  stream);
  const long long n_tiles = tiles_of(d);
  count_rank_kernel<SRC, GM, GAMMA>
      <<<search_grid(n_tiles, w_lanes), kThreads, count_smem(nb_taus),
         stream>>>(op, taus, nb_taus, ranks, d, n_tiles);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  counts_from_ranks_kernel<<<w_lanes, kThreads,
                             (size_t)(2 * nb_taus + 1) * 4, stream>>>(
      taus, nb_taus, ranks, counts);
  return (int)cudaGetLastError();
}

template <int GM, bool GAMMA>
int hist_launch(const Operand& op, const float* tau1, const float* new_lo,
                const float* w2, const float* top_shift, int* d2, int* f,
                int w_lanes, int branch, long long d, cudaStream_t stream) {
  const int nb = branch + 1;
  cudaMemsetAsync(d2, 0, sizeof(int) * (size_t)w_lanes * nb * nb, stream);
  cudaMemsetAsync(f, 0, sizeof(int) * (size_t)w_lanes * nb, stream);
  const size_t tables = (size_t)(branch + 3 * nb) * 4;
  const size_t shared = tables + (size_t)(nb * nb + nb) * 4;
  const long long n_tiles = tiles_of(d);
  const dim3 grid = search_grid(n_tiles, w_lanes);
  if (shared <= (size_t)kSharedLimit) {
    hist_topq_level_kernel<GM, GAMMA, true><<<grid, kThreads, shared, stream>>>(
        op, tau1, new_lo, w2, top_shift, branch, d2, f, d, n_tiles);
  } else {
    hist_topq_level_kernel<GM, GAMMA, false><<<grid, kThreads, tables, stream>>>(
        op, tau1, new_lo, w2, top_shift, branch, d2, f, d, n_tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// --------------------------------------------------------------------------
// C interface (ctypes). Pointers are contiguous float32 / int32 CUDA buffers
// checked by the Python wrapper; outputs are zeroed here, on the caller's
// stream. Returns cudaGetLastError() after the launches.
// --------------------------------------------------------------------------

extern "C" {

int hist_shared_max_branch() {
  int b = 1;
  while ((size_t)(b + 1 + 3 * (b + 2)) * 4 + (size_t)((b + 2) * (b + 2) + b + 2) * 4
         <= (size_t)kSharedLimit) {
    ++b;
  }
  return b;
}

int count_ge_level_launch(const float* x, const float* taus, int* ranks,
                          int* counts, int w_lanes, int nb_taus, long long d,
                          void* stream_ptr) {
  const Operand op{x, nullptr, nullptr, nullptr, nullptr, nullptr};
  return count_launch<kSrcX, kGmNone, false>(
      op, taus, ranks, counts, w_lanes, nb_taus, d,
      (cudaStream_t)stream_ptr);
}

int count_ge_fused_level_launch(const float* g, const float* e,
                                const float* gin, const float* weight,
                                const float* part, const float* gm,
                                int gm_kind, const float* taus, int* ranks,
                                int* counts, int w_lanes, int nb_taus,
                                long long d, void* stream_ptr) {
  const Operand op{g, e, gin, gm, weight, part};
  cudaStream_t s = (cudaStream_t)stream_ptr;
#define COUNT(GMK, GA)                                                     \
  return count_launch<kSrcFused, GMK, GA>(op, taus, ranks, counts,        \
                                          w_lanes, nb_taus, d, s)
  if (gin != nullptr) {
    if (gm_kind == kGmShared) COUNT(kGmShared, true);
    if (gm_kind == kGmLane) COUNT(kGmLane, true);
    COUNT(kGmNone, true);
  }
  if (gm_kind == kGmShared) COUNT(kGmShared, false);
  if (gm_kind == kGmLane) COUNT(kGmLane, false);
  COUNT(kGmNone, false);
#undef COUNT
}

int hist_topq_level_launch(const float* g, const float* e, const float* gin,
                           const float* weight, const float* part,
                           const float* gm, int gm_kind, const float* tau1,
                           const float* new_lo, const float* w2,
                           const float* top_shift, int* d2, int* f,
                           int w_lanes, int branch, long long d,
                           void* stream_ptr) {
  const Operand op{g, e, gin, gm, weight, part};
  cudaStream_t s = (cudaStream_t)stream_ptr;
#define HIST(GMK, GA)                                                      \
  return hist_launch<GMK, GA>(op, tau1, new_lo, w2, top_shift, d2, f,     \
                              w_lanes, branch, d, s)
  if (gin != nullptr) {
    if (gm_kind == kGmShared) HIST(kGmShared, true);
    if (gm_kind == kGmLane) HIST(kGmLane, true);
    HIST(kGmNone, true);
  }
  if (gm_kind == kGmShared) HIST(kGmShared, false);
  if (gm_kind == kGmLane) HIST(kGmLane, false);
  HIST(kGmNone, false);
#undef HIST
}

}  // extern "C"
