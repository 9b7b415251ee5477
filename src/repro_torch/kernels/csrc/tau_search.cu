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
// its bin once, from values held in shared memory (a table lookup or a
// binary search for the counts, an estimate checked by exact comparisons
// for the histogram), and adds 1 to a shared-memory histogram with an
// integer atomic; blocks add their histograms into the output with global
// integer atomics. Integer sums are exact in any order, so the result does
// not depend on the schedule.
//
// Bound: device-memory bytes at large d (each operand array is read once:
// x, or 2-3 [W, d] f32 rows plus the mask); at the paper's d = 7850 a
// launch is one tile per lane and launch-bound.
//
// Counts (count_ge_level, count_ge_fused_level):
//   * the lane's B taus are sorted into shared memory by each block (rank
//     by comparison, ties by index; a NaN tau sorts as +inf and counts
//     nothing);
//   * an element's rank r = #{k : |x| >= sorted_k} goes into a shared
//     [B+1] histogram, and blocks add it into a global [W, B+1] scratch;
//   * a second kernel turns the ranks into suffix sums, counts[w, b] =
//     #{rank >= pos_b + 1}, pos_b being tau b's place in the sorted order.
//   Taus in any order give the integers of the plain broadcast comparison.
//   count_ge_level takes each rank from the lane's RankTable (rank.cuh, the
//   rule of topq_threshold.cu's count_ge): one load for an |x| outside the
//   buckets that hold a tau, a search over a bucket's own taus otherwise.
//   Each block builds its lane's table in its prologue from the taus it
//   has just sorted, in the same 48 KB as the histogram (the keys share
//   the histogram's words), so every B up to 4095 takes it. Building it
//   in every block cost a launch about 0.004 ms on the card, a W-block
//   table kernel 0.007 ms and one launch more, which the launch-bound
//   paper shape pays in full (benchmarks/torch_count_ablation.cu). Its
//   grid holds as many blocks as the card keeps resident, spread over the
//   lanes (never more than a lane's tiles).
//   float32 rows are read with 16-byte loads, bfloat16 rows with 8-byte
//   ones as the upper halves of float32s (row.cuh), no copy.
//   count_ge_fused_level, whose three rows hide its search, keeps the
//   binary search over the sorted taus and 64 blocks per lane.
//
// Histogram (hist_topq_level), per element with tables from
// core/sparsify.py::_hist_tables (tau1 [b], new_lo, w2, top_shift [b+1]):
//   d1 = #{j : |x| >= tau1_j}; nl, w2e, ts at index d1;
//   d2 = the largest j in 0..b with |x| >= fma(w2e, j, nl) (0 if none),
//        what the plain version's binary search finds;
//   D2[d1, d2] += 1, and F[d1] += 1 when |x| >= ts.
//   The digits are not searched. Bracket r's values sit in one 16-byte
//   shared entry {tau1[r-1], tau1[r], nl, w2e}; d1 is estimated from
//   (|x| - tau1[0]) / w1 and d2 from (|x| - nl) / w2 (reciprocals from the
//   block's prologue), then confirmed by the exact comparisons that define
//   them (tau1[d1-1] <= |x| < tau1[d1]; the candidate fma(w2e, d2, nl) and
//   the next one), and stepped by one where the estimate is off. Only
//   exact comparisons decide, so the digits equal the binary searches'
//   for any tables whose tau1 is nondecreasing without NaN and whose
//   candidates are nondecreasing in j (w2e finite and >= 0, nl finite);
//   a lane whose tables are not so, or an element that needs more than
//   kMaxSteps steps, takes the binary searches (the same midpoints as the
//   plain version). A NaN magnitude has d1 = b (searchsorted's place for
//   it, as in the plain version), d2 = 0 and no flag.
//   F[d1] is counted by its complement: the flag is true for nearly every
//   element of a bracket r >= 1 (top_shift[r] is the top candidate of
//   bracket r - 1, about tau1[r-1]), so a shared atomic per element would
//   pile onto the few bins most magnitudes fall in. G[r] = #{d1 = r, not
//   |x| >= ts} is added instead and F[r] = #{d1 = r} - G[r] at the flush;
//   F[0] (ts = the f32 maximum) is counted directly. Integers, exact.
//   A (b+1)^2 histogram that fits in 48 KB of shared memory (b <= 106) is
//   kept there and flushed once per block; a larger one (up to b = 1024)
//   takes the global-atomics variant, which adds D2 straight into global
//   memory and keeps the row counts #{d1 = r} in shared memory. The grid
//   holds as many blocks as the card keeps resident, spread over the
//   lanes (never more than a lane's tiles).
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
#include "row.cuh"
#include "tile.cuh"

namespace {

constexpr int kMaxBlocksPerLane = 64;   // count_ge_fused_level's grid
constexpr int kSharedLimit = 48 * 1024;

struct Operand {
  const float* g;
  const float* e;
  const float* gin;   // null without gamma_in
  const float* gm;    // null, [d] or [W, d]
  const float* w;
  const float* p;
};

// |operand| of one unit (cnt elements) of a tile.
template <int GM, bool GAMMA>
__device__ __forceinline__ void load_mag(const Operand& op, float wt,
                                         float pw, const TileGeom& t,
                                         const Unit& un, float mag[4]) {
  const long long i = t.row + t.t0 + un.local;
  float vg[4], ve[4], vi[4], vm[4];
  ld(op.g, i, un.cnt, vg);
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

// count_ge_fused_level: ranks by binary search over the lane's taus, sorted
// in shared memory by each block.
template <int GM, bool GAMMA>
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
  const float wt = op.w[w];
  const float pw = GAMMA ? op.p[w] : 0.f;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileGeom t = tile_geom_at(d, tile, w);
    for (int u = threadIdx.x; u < t.nunits; u += blockDim.x) {
      const Unit un = unit_at(t, u);
      float mag[4];
      load_mag<GM, GAMMA>(op, wt, pw, t, un, mag);
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

// The shared memory of a count_ge_level block: the rank histogram [B + 1]
// (the keys while the taus are sorted), the sorted taus [B], the table's
// entries.
struct LaneTable {
  int* hist;
  float* sorted;
  unsigned short* entries;
};

__device__ __forceinline__ LaneTable lane_table_at(float* smem, int B) {
  LaneTable s;
  s.hist = reinterpret_cast<int*>(smem);
  s.sorted = smem + B + 1;
  s.entries = reinterpret_cast<unsigned short*>(s.sorted + B);
  return s;
}

size_t lane_table_smem(int nb_taus) {
  return (size_t)(2 * nb_taus + 1) * 4 + (size_t)kEntryWords * 4;
}

// A count_ge_level block's prologue: lane w's taus sorted, their RankTable
// built into s_t and s.entries, the histogram zeroed.
__device__ __forceinline__ void lane_table_prologue(const float* taus, int B,
                                                    int w, const LaneTable& s,
                                                    RankTable& s_t) {
  const float* trow = taus + (long long)w * B;
  float* s_key = reinterpret_cast<float*>(s.hist);
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_key[b] = tau_key(trow[b]);
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    s.sorted[sorted_pos(s_key, B, b)] = s_key[b];
  }
  __syncthreads();
  for (int r = threadIdx.x; r <= B; r += blockDim.x) s.hist[r] = 0;
  build_rank_table(s.sorted, B, s_t, s.entries);
}

// Call f(v) for each element of lane w in this block's tiles, as float32:
// 4-element units through the middle of a tile (16-byte loads of float32,
// 8-byte loads of bfloat16), the scalar head and tail by the first threads.
template <typename T, typename F>
__device__ __forceinline__ void for_each_lane_element(const T* __restrict__ x,
                                                      int w, long long d,
                                                      long long n_tiles,
                                                      F&& f) {
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileGeom t = tile_geom_at(d, tile, w);
    const long long base = t.row + t.t0;
    for (int u = threadIdx.x; u < t.nvec; u += blockDim.x) {
      float v[4];
      ldf<4>(x, base + t.head + 4 * u, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) f(v[k]);
    }
    const int rest = t.len - 4 * t.nvec;   // head + tail, under 8
    if ((int)threadIdx.x < rest) {
      const int j = (int)threadIdx.x < t.head
                        ? (int)threadIdx.x
                        : t.head + 4 * t.nvec + ((int)threadIdx.x - t.head);
      float v[1];
      ldf<1>(x, base + j, v);
      f(v[0]);
    }
  }
}

// count_ge_level: ranks from the lane's RankTable, built in each block's
// prologue (see the header), over the block's tiles of lane blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
count_table_level_kernel(const T* __restrict__ x,
                         const float* __restrict__ taus, int nb_taus,
                         int* __restrict__ ranks, long long d,
                         long long n_tiles) {
  extern __shared__ float smem[];
  const int B = nb_taus, w = blockIdx.y;
  const LaneTable s = lane_table_at(smem, B);
  __shared__ RankTable s_t;
  lane_table_prologue(taus, B, w, s, s_t);
  const RankTable t = s_t;
  for_each_lane_element(x, w, d, n_tiles, [&](float v) {
    const int r = table_rank(fabsf(v), t, s.entries, s.sorted);
    if (r) atomicAdd(&s.hist[r], 1);
  });
  __syncthreads();
  int* row = ranks + (long long)w * (B + 1);
  for (int r = 1 + threadIdx.x; r <= B; r += blockDim.x) {
    const int c = s.hist[r];
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

// Bracket r of a lane's tables: {tau1[r-1] (-inf for r = 0), tau1[r] (NaN
// for r = b, which no magnitude is >=), new_lo[r], w2[r]}.
__device__ __forceinline__ float4 bracket_of(const float* t1,
                                             const float* nl,
                                             const float* w2, int branch,
                                             int r) {
  return make_float4(r == 0 ? -INFINITY : t1[r - 1],
                     r == branch ? __int_as_float(0x7fffffff) : t1[r],
                     nl[r], w2[r]);
}

// The estimate of both digits: d1 ~ (m - base1) * inv1 + 1 and
// d2 ~ (m - nl) * inv2, clamped to 0..b; `fast` is 0 for a lane whose
// tables do not meet the rule's conditions.
struct DigitRule {
  float base1, inv1, inv2;
  int fast;
};

constexpr int kMaxSteps = 2;   // estimate corrections before the search

__device__ __forceinline__ int clamp_digit(float t, int branch) {
  return (int)fminf(fmaxf(t, 0.f), (float)branch);   // NaN -> 0
}

// d1 by the plain version's binary search over tau1 (the uppers).
__device__ __forceinline__ int search_d1(float m, const float4* br,
                                         int branch) {
  int lo = 0, hi = branch;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (m >= br[mid].y) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// d2 by the plain version's binary search over j in 0..b.
__device__ __forceinline__ int search_d2(float m, float nl, float w2e,
                                         int nb) {
  int lo = 0, hi = nb;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (m >= __fmaf_rn(w2e, (float)mid, nl)) lo = mid; else hi = mid;
  }
  return lo;
}

// Both digits of a magnitude: estimated and checked (FAST, the lane's
// tables meet the rule's conditions), else searched.
template <bool FAST>
__device__ __forceinline__ void digits(float m, const DigitRule& rule,
                                       const float4* br, int branch,
                                       int& d1, int& d2) {
  if (isnan(m)) {   // searchsorted places NaN after every candidate
    d1 = branch;
    d2 = 0;
    return;
  }
  if (!FAST) {
    d1 = search_d1(m, br, branch);
    const float4 e = br[d1];
    d2 = search_d2(m, e.z, e.w, branch + 1);
    return;
  }
  int k = clamp_digit(__fmaf_rn(m - rule.base1, rule.inv1, 1.f), branch);
  float4 e = br[k];
  for (int step = 0;; ++step) {
    const int dir = !(m >= e.x) ? -1 : (m >= e.y ? 1 : 0);
    if (dir == 0) break;
    if (step == kMaxSteps) {
      k = search_d1(m, br, branch);
      e = br[k];
      break;
    }
    k += dir;
    e = br[k];
  }
  d1 = k;
  int c = clamp_digit((m - e.z) * rule.inv2, branch);
  for (int step = 0;; ++step) {
    const int dir =
        c > 0 && !(m >= __fmaf_rn(e.w, (float)c, e.z)) ? -1
        : c < branch && m >= __fmaf_rn(e.w, (float)(c + 1), e.z) ? 1 : 0;
    if (dir == 0) break;
    if (step == kMaxSteps) {
      c = search_d2(m, e.z, e.w, branch + 1);
      break;
    }
    c += dir;
  }
  d2 = c;
}

// The element loop of a block: both digits of each magnitude, D2 (shared
// or global) and G; the global variant also counts #{d1 = r} in s_rows.
template <int GM, bool GAMMA, bool SHARED, bool FAST>
__device__ __forceinline__ void hist_elements(
    const Operand& op, DigitRule rule, const float4* s_br, const float* s_ts,
    int* s_g, int* s_rows, int* g_d2, int branch, long long d,
    long long n_tiles) {
  const int w = blockIdx.y, nb = branch + 1;
  const float wt = op.w[w];
  const float pw = GAMMA ? op.p[w] : 0.f;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileGeom t = tile_geom_at(d, tile, w);
    for (int u = threadIdx.x; u < t.nunits; u += blockDim.x) {
      const Unit un = unit_at(t, u);
      float mag[4];
      load_mag<GM, GAMMA>(op, wt, pw, t, un, mag);
      for (int k = 0; k < un.cnt; ++k) {
        const float m = mag[k];
        int d1, d2;
        digits<FAST>(m, rule, s_br, branch, d1, d2);
        if (SHARED) {
          atomicAdd(&s_rows[d1 * nb + d2], 1);
        } else {
          atomicAdd(&g_d2[d1 * nb + d2], 1);
          atomicAdd(&s_rows[d1], 1);
        }
        const bool ge = m >= s_ts[d1];
        if (d1 == 0 ? ge : !ge) atomicAdd(&s_g[d1], 1);
      }
    }
  }
}

template <int GM, bool GAMMA, bool SHARED>
__global__ void __launch_bounds__(kThreads)
hist_topq_level_kernel(Operand op, const float* __restrict__ tau1,
                       const float* __restrict__ new_lo,
                       const float* __restrict__ w2,
                       const float* __restrict__ top_shift, int branch,
                       int* __restrict__ d2_out, int* __restrict__ f_out,
                       long long d, long long n_tiles) {
  extern __shared__ float4 smem4[];
  const int nb = branch + 1;
  float4* s_br = smem4;                                  // [nb]
  float* s_ts = reinterpret_cast<float*>(s_br + nb);     // [nb]
  int* s_g = reinterpret_cast<int*>(s_ts + nb);          // [nb]: F0, G[r]
  int* s_rows = s_g + nb;          // SHARED: D2 [nb * nb]; else #{d1 = r}
  __shared__ DigitRule s_rule;
  __shared__ int s_slow;
  const int w = blockIdx.y;
  const float* t1 = tau1 + (long long)w * branch;
  const float* nl = new_lo + (long long)w * nb;
  const float* w2l = w2 + (long long)w * nb;
  if (threadIdx.x == 0) s_slow = 0;
  const int n_rows = SHARED ? nb * nb : nb;
  for (int j = threadIdx.x; j < n_rows; j += blockDim.x) s_rows[j] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < nb; r += blockDim.x) {
    s_br[r] = bracket_of(t1, nl, w2l, branch, r);
    s_ts[r] = top_shift[(long long)w * nb + r];
    s_g[r] = 0;
    // the rule's conditions: tau1 nondecreasing without NaN (each tau1[r-1]
    // <= its successor, +inf after the last), candidates nondecreasing in j
    const bool ok = (r == 0 || t1[r - 1] <= (r < branch ? t1[r] : INFINITY))
                    && isfinite(nl[r]) && isfinite(w2l[r]) && w2l[r] >= 0.f;
    if (!ok) atomicAdd(&s_slow, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float span = t1[branch - 1] - t1[0];
    DigitRule rule;
    rule.base1 = t1[0];
    rule.inv1 = branch > 1 ? (float)(branch - 1) / span : 0.f;
    rule.inv2 = 1.f / w2l[0];
    rule.fast = s_slow == 0;
    s_rule = rule;
  }
  __syncthreads();
  int* g_d2 = d2_out + (long long)w * nb * nb;
  // the rule's choice is made once per block: an element loop that could
  // take either path compiles into much slower code (benchmarks/
  // torch_count_ablation.cu, mode 7)
  if (s_rule.fast) {
    hist_elements<GM, GAMMA, SHARED, true>(op, s_rule, s_br, s_ts, s_g,
                                           s_rows, g_d2, branch, d,
                                           n_tiles);
  } else {
    hist_elements<GM, GAMMA, SHARED, false>(op, s_rule, s_br, s_ts, s_g,
                                            s_rows, g_d2, branch, d,
                                            n_tiles);
  }
  __syncthreads();
  if (SHARED) {
    for (int j = threadIdx.x; j < nb * nb; j += blockDim.x) {
      const int c = s_rows[j];
      if (c) atomicAdd(&g_d2[j], c);
    }
  }
  // F[0] counted directly; F[r] = #{d1 = r} - G[r]
  for (int r = threadIdx.x; r < nb; r += blockDim.x) {
    int f = s_g[r];
    if (r > 0) {
      int rows = 0;
      if (SHARED) {
        for (int c = 0; c < nb; ++c) rows += s_rows[r * nb + c];
      } else {
        rows = s_rows[r];
      }
      f = rows - f;
    }
    if (f) atomicAdd(&f_out[(long long)w * nb + r], f);
  }
}

inline long long tiles_of(long long d) { return (d + kTile - 1) / kTile; }

inline dim3 search_grid(long long n_tiles, int w_lanes) {
  const long long x = n_tiles < kMaxBlocksPerLane ? n_tiles : kMaxBlocksPerLane;
  return dim3((unsigned)(x < 1 ? 1 : x), (unsigned)w_lanes);
}

// Blocks per lane: as many as the card keeps resident, spread over the
// lanes, no more than a lane's tiles.
template <typename K>
dim3 resident_grid(K kernel, size_t smem, long long n_tiles, int w_lanes) {
  const long long resident = resident_blocks(kernel, kThreads, smem);
  long long x = (resident + w_lanes - 1) / w_lanes;
  x = x < n_tiles ? x : n_tiles;
  return dim3((unsigned)(x < 1 ? 1 : x), (unsigned)w_lanes);
}

int counts_launch(const float* taus, int* ranks, int* counts, int w_lanes,
                  int nb_taus, cudaStream_t stream) {
  counts_from_ranks_kernel<<<w_lanes, kThreads,
                             (size_t)(2 * nb_taus + 1) * 4, stream>>>(
      taus, nb_taus, ranks, counts);
  return (int)cudaGetLastError();
}

template <int GM, bool GAMMA>
int count_launch(const Operand& op, const float* taus, int* ranks,
                 int* counts, int w_lanes, int nb_taus, long long d,
                 cudaStream_t stream) {
  cudaMemsetAsync(ranks, 0, sizeof(int) * (size_t)w_lanes * (nb_taus + 1),
                  stream);
  const long long n_tiles = tiles_of(d);
  count_rank_kernel<GM, GAMMA>
      <<<search_grid(n_tiles, w_lanes), kThreads,
         (size_t)(3 * nb_taus + 1) * 4, stream>>>(op, taus, nb_taus, ranks,
                                                  d, n_tiles);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return counts_launch(taus, ranks, counts, w_lanes, nb_taus, stream);
}

template <typename T>
int count_table_launch(const void* x, const float* taus, int* ranks,
                       int* counts, int w_lanes, int nb_taus, long long d,
                       cudaStream_t stream) {
  const size_t smem = lane_table_smem(nb_taus);
  if (smem > (size_t)kSharedLimit) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(ranks, 0, sizeof(int) * (size_t)w_lanes * (nb_taus + 1),
                  stream);
  const long long n_tiles = tiles_of(d);
  auto kernel = count_table_level_kernel<T>;
  kernel<<<resident_grid(kernel, smem, n_tiles, w_lanes), kThreads, smem,
           stream>>>(static_cast<const T*>(x), taus, nb_taus, ranks, d,
                     n_tiles);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return counts_launch(taus, ranks, counts, w_lanes, nb_taus, stream);
}

// Shared memory: brackets, top_shift and F0/G (24 bytes per bracket), then
// the (b+1)^2 histogram, or the global variant's row counts.
size_t hist_shared_smem(int branch) {
  const size_t nb = branch + 1;
  return nb * 24 + nb * nb * 4;
}

size_t hist_global_smem(int branch) { return (size_t)(branch + 1) * 28; }

template <int GM, bool GAMMA>
int hist_launch(const Operand& op, const float* tau1, const float* new_lo,
                const float* w2, const float* top_shift, int* d2, int* f,
                int w_lanes, int branch, long long d, cudaStream_t stream) {
  const int nb = branch + 1;
  cudaMemsetAsync(d2, 0, sizeof(int) * (size_t)w_lanes * nb * nb, stream);
  cudaMemsetAsync(f, 0, sizeof(int) * (size_t)w_lanes * nb, stream);
  const long long n_tiles = tiles_of(d);
  const size_t shared = hist_shared_smem(branch);
  if (shared <= (size_t)kSharedLimit) {
    auto kernel = hist_topq_level_kernel<GM, GAMMA, true>;
    kernel<<<resident_grid(kernel, shared, n_tiles, w_lanes), kThreads,
             shared, stream>>>(op, tau1, new_lo, w2, top_shift, branch, d2,
                               f, d, n_tiles);
  } else {
    auto kernel = hist_topq_level_kernel<GM, GAMMA, false>;
    const size_t smem = hist_global_smem(branch);
    kernel<<<resident_grid(kernel, smem, n_tiles, w_lanes), kThreads, smem,
             stream>>>(op, tau1, new_lo, w2, top_shift, branch, d2, f, d,
                       n_tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// --------------------------------------------------------------------------
// C interface (ctypes). Pointers are contiguous float32 / int32 CUDA buffers
// (count_ge_level's x float32 or bfloat16, by dtype, 16-byte aligned)
// checked by the Python wrapper; outputs are zeroed here, on the caller's
// stream. Returns cudaGetLastError() after the launches.
// --------------------------------------------------------------------------

extern "C" {

int hist_shared_max_branch() {
  int b = 1;
  while (hist_shared_smem(b + 1) <= (size_t)kSharedLimit) ++b;
  return b;
}

int count_ge_level_launch(const void* x, int dtype, const float* taus,
                          int* ranks, int* counts, int w_lanes, int nb_taus,
                          long long d, void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (dtype == kBF16) {
    return count_table_launch<__nv_bfloat16>(x, taus, ranks, counts, w_lanes,
                                             nb_taus, d, s);
  }
  return count_table_launch<float>(x, taus, ranks, counts, w_lanes, nb_taus,
                                   d, s);
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
  return count_launch<GMK, GA>(op, taus, ranks, counts, w_lanes, nb_taus, \
                               d, s)
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
