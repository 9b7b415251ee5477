// Ablation of three count kernels of the PyTorch/CUDA port, to see where
// their time goes on the card:
//   hist_topq_level (csrc/tau_search.cu): the joint digit histogram;
//   count_ge        (csrc/topq_threshold.cu): the rank histogram of a row;
//   count_ge_level  (csrc/tau_search.cu): the rank histograms of W lanes.
// The first two kernels below are the binary-search design of both (the
// one before the digit estimate and the rank table), cut back by MODE:
//   0 (a) loads and the operand only, folded into one value;
//   1 (b) (a) plus the d1 binary search (count_ge: the rank search);
//   2 (c) (b) plus the d2 binary search (hist only);
//   3 (d) the whole element loop, atomics included, without the flush;
//   4 (e) the flush alone, from a histogram seeded with the nonzero
//         pattern of the real one.
// The last two are the present kernels' element loops, built from their
// own helpers (the sources are included here), cut back the same way:
//   0 (a) loads only; 1 (b) plus the digits or the table rank; 3 (d) the
//   element loop with its atomics, no flush; 4 (e) the flush alone;
//   5 count_ge's (d) with a histogram per lane of a warp (s_hist[r * 32 +
//   lane], so lanes that land on one rank add into different words), the
//   alternative the kernel does without; 6 the
//   histogram's element loop and flush together; 7 (6) with the check of
//   the tables in the prologue and the choice between estimate and
//   search made per element, not once per block as the kernel makes it.
// count_ge_level, both designs cut back the same way (a), (b), (d), (e):
// the binary search over the taus each block sorts (the design before the
// rank table, copied below) at a given number of blocks per lane or the
// resident grid, and the present kernel's per-lane rank table, built from
// its own helpers; its mode 8 is (e) with the table copied from a scratch
// that a W-block kernel built (level_table_build_launch), so (e) - (8) is
// what building the table in every block costs beside that one launch.
// The folded value goes to a sink only if it equals a constant the data
// never gives, so nothing is dead code. Built and timed by
// benchmarks/torch_count_kernels.py (``ablation``); not part of the port.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "rank.cuh"
#include "row.cuh"
#include "tile.cuh"

namespace {

constexpr unsigned kNever = 0x7fc01234u;
constexpr int kWarpCopies = 32;   // count mode 5: a histogram per warp lane

// |(1 - m) * (p * (w * g + e) + gamma_in)| with a lane-shared [d] mask.
__device__ __forceinline__ void load_mag_fused(
    const float* g, const float* e, const float* gin, const float* gm,
    float wt, float pw, const TileGeom& t, const Unit& un, float mag[4]) {
  const long long i = t.row + t.t0 + un.local;
  float vg[4], ve[4], vi[4], vm[4];
  ld(g, i, un.cnt, vg);
  ld(e, i, un.cnt, ve);
  ld(gin, i, un.cnt, vi);
  load_gmask(gm, kGmShared, t, un, vm);
  for (int k = 0; k < un.cnt; ++k) {
    float s = __fmaf_rn(wt, vg[k], ve[k]);
    s = __fmaf_rn(pw, s, vi[k]);
    s = __fmul_rn(__fsub_rn(1.0f, vm[k]), s);
    mag[k] = fabsf(s);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
hist_ablation_kernel(const float* __restrict__ g, const float* __restrict__ e,
                     const float* __restrict__ gin,
                     const float* __restrict__ gm,
                     const float* __restrict__ weight,
                     const float* __restrict__ part,
                     const float* __restrict__ tau1,
                     const float* __restrict__ new_lo,
                     const float* __restrict__ w2,
                     const float* __restrict__ top_shift, int branch,
                     const int* __restrict__ seed_d2,
                     int* __restrict__ d2_out, int* __restrict__ f_out,
                     unsigned* __restrict__ sink, long long d,
                     long long n_tiles) {
  extern __shared__ float smem[];
  const int nb = branch + 1;
  float* s_t1 = smem;
  float* s_nl = s_t1 + branch;
  float* s_w2 = s_nl + nb;
  float* s_ts = s_w2 + nb;
  int* s_d2 = reinterpret_cast<int*>(s_ts + nb);
  int* s_f = s_d2 + nb * nb;
  const int w = blockIdx.y;
  for (int j = threadIdx.x; j < branch; j += blockDim.x) {
    s_t1[j] = tau1[(long long)w * branch + j];
  }
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    s_nl[j] = new_lo[(long long)w * nb + j];
    s_w2[j] = w2[(long long)w * nb + j];
    s_ts[j] = top_shift[(long long)w * nb + j];
  }
  for (int j = threadIdx.x; j < nb * nb + nb; j += blockDim.x) {
    s_d2[j] = MODE == 4 && j < nb * nb
                  ? (seed_d2[(long long)w * nb * nb + j] != 0)
                  : 0;
  }
  __syncthreads();
  unsigned acc = 0;
  const float wt = weight[w];
  const float pw = part[w];
  if (MODE != 4) {
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const TileGeom t = tile_geom_at(d, tile, w);
      for (int u = threadIdx.x; u < t.nunits; u += blockDim.x) {
        const Unit un = unit_at(t, u);
        float mag[4];
        load_mag_fused(g, e, gin, gm, wt, pw, t, un, mag);
        for (int k = 0; k < un.cnt; ++k) {
          const float m = mag[k];
          if (MODE == 0) {
            acc ^= __float_as_uint(m);
            continue;
          }
          const int d1 = rank_of(m, s_t1, branch);
          if (MODE == 1) {
            acc += (unsigned)d1;
            continue;
          }
          const float nl = s_nl[d1], w2e = s_w2[d1];
          int lo = 0, hi = nb;
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (m >= __fmaf_rn(w2e, (float)mid, nl)) lo = mid; else hi = mid;
          }
          if (MODE == 2) {
            acc += (unsigned)(d1 * nb + lo);
            continue;
          }
          atomicAdd(&s_d2[d1 * nb + lo], 1);
          if (m >= s_ts[d1]) atomicAdd(&s_f[d1], 1);
        }
      }
    }
  }
  if (acc == kNever) sink[0] = acc;
  if (MODE == 3 || MODE == 4) {
    __syncthreads();
  }
  if (MODE == 4) {
    int* g_d2 = d2_out + (long long)w * nb * nb;
    int* g_f = f_out + (long long)w * nb;
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

template <typename T, int MODE>
__global__ void __launch_bounds__(kRowThreads)
count_ablation_kernel(const T* __restrict__ x,
                      const float* __restrict__ sorted, int nb_taus,
                      int* __restrict__ ranks, unsigned* __restrict__ sink,
                      long long d) {
  extern __shared__ float smem[];
  const int B = nb_taus;
  float* s_sorted = smem;
  int* s_hist = reinterpret_cast<int*>(smem + B);
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_sorted[b] = sorted[b];
  for (int r = threadIdx.x; r <= B; r += blockDim.x) {
    s_hist[r] = MODE == 4 ? 1 : 0;
  }
  __syncthreads();
  unsigned acc = 0;
  if (MODE != 4) {
    for_each_unit<VecWidth<T>::N>(d, [&](long long i, auto cnt) {
      constexpr int C = decltype(cnt)::value;
      float mag[C];
      ldf<C>(x, i, mag);
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (MODE == 0) {
          acc ^= __float_as_uint(fabsf(mag[k]));
          continue;
        }
        const int r = rank_of(fabsf(mag[k]), s_sorted, B);
        if (MODE == 1) {
          acc += (unsigned)r;
          continue;
        }
        if (r) atomicAdd(&s_hist[r], 1);
      }
    });
  }
  if (acc == kNever) sink[0] = acc;
  if (MODE == 4) {
    __syncthreads();
    for (int r = 1 + threadIdx.x; r <= B; r += blockDim.x) {
      const int c = s_hist[r];
      if (c) atomicAdd(&ranks[r], c);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
level_search_ablation_kernel(const float* __restrict__ x,
                             const float* __restrict__ taus, int nb_taus,
                             int* __restrict__ ranks,
                             unsigned* __restrict__ sink, long long d,
                             long long n_tiles) {
  extern __shared__ float smem[];
  const int B = nb_taus;
  float* s_key = smem;
  float* s_sorted = smem + B;
  int* s_hist = reinterpret_cast<int*>(smem + 2 * B);
  const int w = blockIdx.y;
  const float* trow = taus + (long long)w * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_key[b] = tau_key(trow[b]);
  for (int r = threadIdx.x; r <= B; r += blockDim.x) s_hist[r] = MODE == 4;
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    s_sorted[sorted_pos(s_key, B, b)] = s_key[b];
  }
  __syncthreads();
  unsigned acc = 0;
  if (MODE != 4) {
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const TileGeom t = tile_geom_at(d, tile, w);
      for (int u = threadIdx.x; u < t.nunits; u += blockDim.x) {
        const Unit un = unit_at(t, u);
        float v[4];
        ld(x, t.row + t.t0 + un.local, un.cnt, v);
        for (int k = 0; k < un.cnt; ++k) {
          const float m = fabsf(v[k]);
          if (MODE == 0) {
            acc ^= __float_as_uint(m);
            continue;
          }
          const int r = rank_of(m, s_sorted, B);
          if (MODE == 1) {
            acc += (unsigned)r;
            continue;
          }
          if (r) atomicAdd(&s_hist[r], 1);
        }
      }
    }
  }
  if (acc == kNever) sink[0] = acc;
  if (MODE == 4) {
    __syncthreads();
    int* row = ranks + (long long)w * (B + 1);
    for (int r = 1 + threadIdx.x; r <= B; r += blockDim.x) {
      const int c = s_hist[r];
      if (c) atomicAdd(&row[r], c);
    }
  }
}

template <int MODE>
int hist_mode(const float* const* p, int branch, const int* seed_d2,
              int* d2, int* f, unsigned* sink, int w_lanes, long long d,
              int per_lane, cudaStream_t s) {
  const int nb = branch + 1;
  const size_t smem = (size_t)(branch + 3 * nb) * 4 +
                      (size_t)(nb * nb + nb) * 4;
  const long long n_tiles = (d + kTile - 1) / kTile;
  hist_ablation_kernel<MODE><<<dim3(per_lane, w_lanes), kThreads, smem, s>>>(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], branch,
      seed_d2, d2, f, sink, d, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int count_mode(const void* x, const float* sorted, int nb_taus, int* ranks,
               unsigned* sink, long long d, cudaStream_t s) {
  const size_t smem = (size_t)(2 * nb_taus + 1) * 4;
  auto kernel = count_ablation_kernel<T, MODE>;
  const int grid = row_grid(kernel, row_units<T>(d), smem);
  kernel<<<grid, kRowThreads, smem, s>>>(static_cast<const T*>(x), sorted,
                                         nb_taus, ranks, sink, d);
  return (int)cudaGetLastError();
}

}  // namespace

namespace present_hist {
#include "tau_search.cu"
}
namespace present_count {
#include "topq_threshold.cu"
}

namespace {

template <int MODE>
__global__ void __launch_bounds__(kThreads)
hist_new_ablation_kernel(present_hist::Operand op,
                         const float* __restrict__ tau1,
                         const float* __restrict__ new_lo,
                         const float* __restrict__ w2,
                         const float* __restrict__ top_shift, int branch,
                         const int* __restrict__ seed_d2,
                         int* __restrict__ d2_out, int* __restrict__ f_out,
                         unsigned* __restrict__ sink, long long d,
                         long long n_tiles) {
  using namespace present_hist;
  extern __shared__ float4 smem4[];
  const int nb = branch + 1;
  float4* s_br = smem4;
  float* s_ts = reinterpret_cast<float*>(s_br + nb);
  int* s_g = reinterpret_cast<int*>(s_ts + nb);
  int* s_rows = s_g + nb;
  __shared__ DigitRule s_rule;
  const int w = blockIdx.y;
  const float* t1 = tau1 + (long long)w * branch;
  const float* nl = new_lo + (long long)w * nb;
  const float* w2l = w2 + (long long)w * nb;
  __shared__ int s_slow;
  if (threadIdx.x == 0) s_slow = 0;
  for (int j = threadIdx.x; j < nb * nb; j += blockDim.x) {
    s_rows[j] = MODE == 4 ? (seed_d2[(long long)w * nb * nb + j] != 0) : 0;
  }
  if (MODE == 7) __syncthreads();
  for (int r = threadIdx.x; r < nb; r += blockDim.x) {
    s_br[r] = bracket_of(t1, nl, w2l, branch, r);
    s_ts[r] = top_shift[(long long)w * nb + r];
    s_g[r] = MODE == 4;
    if (MODE == 7) {
      const bool ok =
          (r == 0 || t1[r - 1] <= (r < branch ? t1[r] : INFINITY)) &&
          isfinite(nl[r]) && isfinite(w2l[r]) && w2l[r] >= 0.f;
      if (!ok) atomicAdd(&s_slow, 1);
    }
  }
  if (MODE == 7) __syncthreads();
  if (threadIdx.x == 0) {
    DigitRule rule;
    rule.base1 = t1[0];
    rule.inv1 = (float)(branch - 1) / (t1[branch - 1] - t1[0]);
    rule.inv2 = 1.f / w2l[0];
    rule.fast = MODE == 7 ? s_slow == 0 : 1;
    s_rule = rule;
  }
  __syncthreads();
  const DigitRule rule = s_rule;
  unsigned acc = 0;
  const float wt = op.w[w];
  const float pw = op.p[w];
  if (MODE != 4) {
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const TileGeom t = tile_geom_at(d, tile, w);
      for (int u = threadIdx.x; u < t.nunits; u += blockDim.x) {
        const Unit un = unit_at(t, u);
        float mag[4];
        load_mag<kGmShared, true>(op, wt, pw, t, un, mag);
        for (int k = 0; k < un.cnt; ++k) {
          const float m = mag[k];
          if (MODE == 0) {
            acc ^= __float_as_uint(m);
            continue;
          }
          int d1, d2;
          if (MODE == 7 && !rule.fast) {
            digits<false>(m, rule, s_br, branch, d1, d2);
          } else {
            digits<true>(m, rule, s_br, branch, d1, d2);
          }
          if (MODE == 1) {
            acc += (unsigned)(d1 * nb + d2);
            continue;
          }
          atomicAdd(&s_rows[d1 * nb + d2], 1);
          const bool ge = m >= s_ts[d1];
          if (d1 == 0 ? ge : !ge) atomicAdd(&s_g[d1], 1);
        }
      }
    }
  }
  if (acc == kNever) sink[0] = acc;
  __syncthreads();
  if (MODE >= 4) {
    int* g_d2 = d2_out + (long long)w * nb * nb;
    for (int j = threadIdx.x; j < nb * nb; j += blockDim.x) {
      const int c = s_rows[j];
      if (c) atomicAdd(&g_d2[j], c);
    }
    for (int r = threadIdx.x; r < nb; r += blockDim.x) {
      int f = s_g[r];
      if (r > 0) {
        int rows = 0;
        for (int c = 0; c < nb; ++c) rows += s_rows[r * nb + c];
        f = rows - f;
      }
      if (f) atomicAdd(&f_out[(long long)w * nb + r], f);
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(present_count::kCountThreads)
count_new_ablation_kernel(const T* __restrict__ x,
                          const float* __restrict__ sorted, int nb_taus,
                          const RankTable* __restrict__ table,
                          const unsigned* __restrict__ entry_words,
                          int* __restrict__ ranks,
                          unsigned* __restrict__ sink, long long d) {
  using namespace present_count;
  extern __shared__ float smem[];
  const int B = nb_taus, R = MODE == 5 ? kWarpCopies : 1;
  float* s_sorted = smem;
  unsigned* s_words = reinterpret_cast<unsigned*>(smem + B);
  const unsigned short* s_entries =
      reinterpret_cast<const unsigned short*>(s_words);
  int* s_hist = reinterpret_cast<int*>(s_words + kEntryWords);
  __shared__ RankTable s_t;
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_sorted[b] = sorted[b];
  for (int j = threadIdx.x; j < kEntryWords; j += blockDim.x) {
    s_words[j] = entry_words[j];
  }
  for (int j = threadIdx.x; j < (B + 1) * R; j += blockDim.x) {
    s_hist[j] = MODE == 4;
  }
  if (threadIdx.x == 0) s_t = *table;
  __syncthreads();
  const RankTable t = s_t;
  int* hist = s_hist + (threadIdx.x & (R - 1));
  unsigned acc = 0;
  if (MODE != 4) {
    for_each_unit<VecWidth<T>::N>(d, [&](long long i, auto cnt) {
      constexpr int C = decltype(cnt)::value;
      float v[C];
      ldf<C>(x, i, v);
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (MODE == 0) {
          acc ^= __float_as_uint(fabsf(v[k]));
          continue;
        }
        const int r = table_rank(fabsf(v[k]), t, s_entries, s_sorted);
        if (MODE == 1) {
          acc += (unsigned)r;
          continue;
        }
        if (r) atomicAdd(&hist[r * R], 1);
      }
    });
  }
  if (acc == kNever) sink[0] = acc;
  __syncthreads();
  if (MODE == 4) {
    for (int r = 1 + threadIdx.x; r <= B; r += blockDim.x) {
      int c = 0;
      for (int j = 0; j < R; ++j) c += s_hist[r * R + ((j + r) & (R - 1))];
      if (c) atomicAdd(&ranks[r], c);
    }
  }
}

// The words of one lane in a table scratch: RankTable, entries, sorted.
__host__ __device__ inline int level_table_words(int nb_taus) {
  return kTableWords + kEntryWords + nb_taus;
}

// One block per lane: the present kernel's prologue, written to a scratch.
__global__ void __launch_bounds__(kThreads)
level_table_build_kernel(const float* __restrict__ taus, int nb_taus,
                         int* __restrict__ tables) {
  using namespace present_hist;
  extern __shared__ float smem[];
  const int B = nb_taus, w = blockIdx.x;
  const LaneTable s = lane_table_at(smem, B);
  __shared__ RankTable s_t;
  lane_table_prologue(taus, B, w, s, s_t);
  int* out = tables + (long long)w * level_table_words(B);
  if (threadIdx.x == 0) *reinterpret_cast<RankTable*>(out) = s_t;
  const int* words = reinterpret_cast<const int*>(s.entries);
  for (int j = threadIdx.x; j < kEntryWords; j += blockDim.x) {
    out[kTableWords + j] = words[j];
  }
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    out[kTableWords + kEntryWords + b] = __float_as_int(s.sorted[b]);
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
level_table_ablation_kernel(const T* __restrict__ x,
                            const float* __restrict__ taus, int nb_taus,
                            const int* __restrict__ tables,
                            int* __restrict__ ranks,
                            unsigned* __restrict__ sink, long long d,
                            long long n_tiles) {
  using namespace present_hist;
  extern __shared__ float smem[];
  const int B = nb_taus, w = blockIdx.y;
  const LaneTable s = lane_table_at(smem, B);
  __shared__ RankTable s_t;
  if (MODE == 8) {
    const int* in = tables + (long long)w * level_table_words(B);
    if (threadIdx.x == 0) s_t = *reinterpret_cast<const RankTable*>(in);
    int* words = reinterpret_cast<int*>(s.entries);
    for (int j = threadIdx.x; j < kEntryWords; j += blockDim.x) {
      words[j] = in[kTableWords + j];
    }
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      s.sorted[b] = __int_as_float(in[kTableWords + kEntryWords + b]);
    }
  } else {
    lane_table_prologue(taus, B, w, s, s_t);
  }
  for (int r = threadIdx.x; r <= B; r += blockDim.x) s.hist[r] = MODE >= 4;
  __syncthreads();
  const RankTable t = s_t;
  unsigned acc = 0;
  if (MODE < 4) {
    for_each_lane_element(x, w, d, n_tiles, [&](float v) {
      const float m = fabsf(v);
      if (MODE == 0) {
        acc ^= __float_as_uint(m);
        return;
      }
      const int r = table_rank(m, t, s.entries, s.sorted);
      if (MODE == 1) {
        acc += (unsigned)r;
        return;
      }
      if (r) atomicAdd(&s.hist[r], 1);
    });
  }
  if (acc == kNever) sink[0] = acc;
  __syncthreads();
  if (MODE >= 4) {
    int* row = ranks + (long long)w * (B + 1);
    for (int r = 1 + threadIdx.x; r <= B; r += blockDim.x) {
      const int c = s.hist[r];
      if (c) atomicAdd(&row[r], c);
    }
  }
}

template <typename T, int MODE>
int level_mode(int design, const void* x, const float* taus, int nb_taus,
               const int* tables, int* ranks, unsigned* sink, int w_lanes,
               long long d, int per_lane, cudaStream_t s) {
  const long long n_tiles = present_hist::tiles_of(d);
  if (design == 0) {
    if (!std::is_same<T, float>::value) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(3 * nb_taus + 1) * 4;
    auto kernel = level_search_ablation_kernel<MODE>;
    const dim3 grid = per_lane > 0 ? dim3(per_lane, w_lanes)
                                   : present_hist::resident_grid(
                                         kernel, smem, n_tiles, w_lanes);
    kernel<<<grid, kThreads, smem, s>>>(static_cast<const float*>(x), taus,
                                        nb_taus, ranks, sink, d, n_tiles);
  } else {
    const size_t smem = present_hist::lane_table_smem(nb_taus);
    auto kernel = level_table_ablation_kernel<T, MODE>;
    const dim3 grid = per_lane > 0 ? dim3(per_lane, w_lanes)
                                   : present_hist::resident_grid(
                                         kernel, smem, n_tiles, w_lanes);
    kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(x), taus,
                                        nb_taus, tables, ranks, sink, d,
                                        n_tiles);
  }
  return (int)cudaGetLastError();
}

template <int MODE>
int hist_new_mode(const float* const* p, int branch, const int* seed_d2,
                  int* d2, int* f, unsigned* sink, int w_lanes, long long d,
                  int per_lane, cudaStream_t s) {
  const present_hist::Operand op{p[0], p[1], p[2], p[3], p[4], p[5]};
  const size_t smem = present_hist::hist_shared_smem(branch);
  const long long n_tiles = (d + kTile - 1) / kTile;
  auto kernel = hist_new_ablation_kernel<MODE>;
  const dim3 grid = per_lane > 0 ? dim3(per_lane, w_lanes)
                                 : present_hist::resident_grid(kernel, smem,
                                                           n_tiles, w_lanes);
  kernel<<<grid, kThreads, smem, s>>>(op, p[6], p[7], p[8], p[9], branch,
                                      seed_d2, d2, f, sink, d, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int count_new_mode(const void* x, const int* scratch, int nb_taus,
                   int* ranks, unsigned* sink, long long d, cudaStream_t s) {
  using namespace present_count;
  const size_t smem = count_table_smem(nb_taus) +
                      (MODE == 5 ? (size_t)(nb_taus + 1) * 4 * (kWarpCopies - 1)
                                 : 0);
  const int* table = scratch + 3 * nb_taus + 1;
  auto kernel = count_new_ablation_kernel<T, MODE>;
  const int grid = row_grid(kernel, row_units<T>(d), smem, kCountThreads);
  kernel<<<grid, kCountThreads, smem, s>>>(
      static_cast<const T*>(x), reinterpret_cast<const float*>(scratch),
      nb_taus, reinterpret_cast<const RankTable*>(table),
      reinterpret_cast<const unsigned*>(table + kTableWords), ranks, sink,
      d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// p: g, e, gamma_in, gm [d], weight, part, tau1, new_lo, w2, top_shift;
// per_lane blocks per lane, or the present kernel's grid for 0.
int hist_new_ablation_launch(int mode, const float* const* p, int branch,
                             const int* seed_d2, int* d2, int* f,
                             unsigned* sink, int w_lanes, long long d,
                             int per_lane, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return hist_new_mode<0>(p, branch, seed_d2, d2, f, sink, w_lanes, d, per_lane, s);
    case 1: return hist_new_mode<1>(p, branch, seed_d2, d2, f, sink, w_lanes, d, per_lane, s);
    case 3: return hist_new_mode<3>(p, branch, seed_d2, d2, f, sink, w_lanes, d, per_lane, s);
    case 6: return hist_new_mode<6>(p, branch, seed_d2, d2, f, sink, w_lanes, d, per_lane, s);
    case 7: return hist_new_mode<7>(p, branch, seed_d2, d2, f, sink, w_lanes, d, per_lane, s);
    default: return hist_new_mode<4>(p, branch, seed_d2, d2, f, sink, w_lanes, d, per_lane, s);
  }
}

// scratch: a count_ge scratch after a count_ge call on the same taus.
int count_new_ablation_launch(int mode, int bf16, const void* x,
                              const int* scratch, int nb_taus, int* ranks,
                              unsigned* sink, long long d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MODES(T)                                                             \
  switch (mode) {                                                            \
    case 0: return count_new_mode<T, 0>(x, scratch, nb_taus, ranks, sink, d, s); \
    case 1: return count_new_mode<T, 1>(x, scratch, nb_taus, ranks, sink, d, s); \
    case 3: return count_new_mode<T, 3>(x, scratch, nb_taus, ranks, sink, d, s); \
    case 5: return count_new_mode<T, 5>(x, scratch, nb_taus, ranks, sink, d, s); \
    default: return count_new_mode<T, 4>(x, scratch, nb_taus, ranks, sink, d, s); \
  }
  if (bf16) MODES(__nv_bfloat16);
  MODES(float);
#undef MODES
}

int level_table_scratch_words(int nb_taus, int w_lanes) {
  return level_table_words(nb_taus) * w_lanes;
}

// The W-block table kernel: each lane's table into `tables`.
int level_table_build_launch(const float* taus, int nb_taus, int* tables,
                             int w_lanes, void* stream) {
  level_table_build_kernel<<<w_lanes, kThreads,
                             present_hist::lane_table_smem(nb_taus),
                             (cudaStream_t)stream>>>(taus, nb_taus, tables);
  return (int)cudaGetLastError();
}

// design 0: the binary search over float32 rows (per_lane blocks per
// lane, or the resident grid for 0); 1: the present rank table over float32
// or bfloat16 rows (mode 8: the table copied from `tables`, which
// level_table_build_launch filled).
int level_ablation_launch(int design, int mode, int bf16, const void* x,
                          const float* taus, int nb_taus, const int* tables,
                          int* ranks, unsigned* sink, int w_lanes,
                          long long d, int per_lane, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LEVEL(T, M) \
  return level_mode<T, M>(design, x, taus, nb_taus, tables, ranks, sink, \
                          w_lanes, d, per_lane, s)
#define MODES(T)                                                     \
  switch (mode) {                                                    \
    case 0: LEVEL(T, 0);                                             \
    case 1: LEVEL(T, 1);                                             \
    case 3: LEVEL(T, 3);                                             \
    case 8: if (design == 1) LEVEL(T, 8);                            \
            return (int)cudaErrorInvalidValue;                       \
    default: LEVEL(T, 4);                                            \
  }
  if (bf16) MODES(__nv_bfloat16);
  MODES(float);
#undef MODES
#undef LEVEL
}

// p: g, e, gamma_in, gm [d], weight, part, tau1, new_lo, w2, top_shift.
int hist_ablation_launch(int mode, const float* const* p, int branch,
                         const int* seed_d2, int* d2, int* f, unsigned* sink,
                         int w_lanes, long long d, int per_lane,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return hist_mode<0>(p, branch, seed_d2, d2, f, sink, w_lanes, d, per_lane, s);
    case 1: return hist_mode<1>(p, branch, seed_d2, d2, f, sink, w_lanes, d, per_lane, s);
    case 2: return hist_mode<2>(p, branch, seed_d2, d2, f, sink, w_lanes, d, per_lane, s);
    case 3: return hist_mode<3>(p, branch, seed_d2, d2, f, sink, w_lanes, d, per_lane, s);
    default: return hist_mode<4>(p, branch, seed_d2, d2, f, sink, w_lanes, d, per_lane, s);
  }
}

int count_ablation_launch(int mode, int bf16, const void* x,
                          const float* sorted, int nb_taus, int* ranks,
                          unsigned* sink, long long d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MODES(T)                                                          \
  switch (mode) {                                                         \
    case 0: return count_mode<T, 0>(x, sorted, nb_taus, ranks, sink, d, s); \
    case 1: return count_mode<T, 1>(x, sorted, nb_taus, ranks, sink, d, s); \
    case 3: return count_mode<T, 3>(x, sorted, nb_taus, ranks, sink, d, s); \
    default: return count_mode<T, 4>(x, sorted, nb_taus, ranks, sink, d, s); \
  }
  if (bf16) MODES(__nv_bfloat16);
  MODES(float);
#undef MODES
}

}  // extern "C"
