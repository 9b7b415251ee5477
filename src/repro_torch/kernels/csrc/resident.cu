// Hopper (sm_90a) resident kernels: one block per lane, the lane's operand
// rebuilt once into shared memory, a whole node-step stage in one launch.
//
// Replaces, for levels whose lane fits one block's shared memory (d at
// most kResidentMaxD; kernels/ops.py::resident_level is the dispatch rule),
// the Pallas TPU kernels of src/repro/kernels/level.py:
//   tau_search_fused_level <- count_ge_fused_level_pallas (:561/:597), once
//                             per round of threshold_for_topq, with the
//                             bracket arithmetic between the rounds
//   cl_fuse_select_level   <- cl_fuse_level_pallas (:395/:444), with the
//                             exact Top-Q support (lax.top_k over the
//                             materialized operand) in front of it
//   ia_fuse_select_level   <- sparsify_ef_level_pallas (:197/:230) then
//                             chain_accum_level_pallas (:282/:308), with the
//                             SIA / RE-SIA / TC-SIA keep mask (the exact
//                             Top-Q support and the mask unions) in front
//
// Bound: at the paper's d = 7850 neither the bytes (a lane reads 3-4 rows
// of 31.4 KB) nor the operations are the limit; the launches and the host
// work around them are. The multi-block forms (count_ge_fused_level,
// cl_fuse_level) take 3 device ops a search round and 1 a fuse, and around
// them the level runs ~10 torch ops a search round (the bracket), or the
// materialized operand, its abs, a stable descending sort, a scatter and a
// cast (exact Top-Q); an SIA-family level adds the mask's product with p,
// the τ fill, RE-SIA's and TC-SIA's support and union ops, and two kernels
// with three memsets, the first writing ḡ to device memory for the second
// to read back. The design folds all of that into one launch: a
// block of 1024 threads per lane keeps the lane's |operand| in shared
// memory (4 bytes an element, so d <= 49152 with room for the rest), and
// the steps that need the whole lane (the max, each round's counts and
// bracket, the q-th largest key, the tie order) meet at __syncthreads
// instead of at kernel boundaries and on the host.
//
// tau_search_fused_level, per lane: |operand| into shared memory and its
// max with torch.amax's NaN rule; then each of the `rounds` rounds of
// core/sparsify.py::threshold_for_topq: candidates fma(w, j, lo), their
// keys sorted in shared memory (tau_search.cu's rule: rank by comparison,
// ties by index, NaN as +inf), each element's rank by binary search into
// a shared [B+1] histogram (warp-aggregated integer atomics), suffix sums,
// counts[b] (0 for a NaN candidate), jstar = #{counts >= q}, and the next
// bracket: new_lo = fma(jstar, w, lo), hi = fma(hi - lo, 1/b, new_lo).
// Writes τ = max(lo, 1e-30) (NaN kept) and every round's counts.
//
// cl_fuse_select_level, per lane: the 32-bit keys of |operand| (the bit
// pattern of the magnitude: -0.0 is +0.0, every NaN one key above +inf)
// into shared memory; a radix select of the q-th largest key K, 8 bits a
// pass from the top (a shared 256-bin histogram of the keys that match the
// digits found so far, the digit found by one warp's scan); every key
// above K is kept, and the keys equal to K lowest index first until q are
// kept (each thread owns a contiguous run of indices, an exclusive block
// scan of their tie counts gives each run its place): the stable
// descending sort's choice, which is lax.top_k's. q <= 0 keeps none, q >= d
// all (sparsify.topq_mask). Then level.cu's CL fuse with τ = +inf and that
// support as mask_in, the operand rebuilt from the inputs: γ_out, e', nnz,
// nnz_off and, with ERR, the pinned ||e'||^2 folded tile by tile in the
// same shared memory (tile.cuh's pinned_tile_err, tiles left to right).
// A lane with p = 0 forwards (γ_in, g~) and selects nothing; a lane with
// valid = 0 writes zeros.
//
// ia_fuse_select_level, per lane: g~ = fma(w, g, e) and the local support
// m_k of x = g~ (TC-SIA: (1 - m) * g~), either the exact Top-q support by
// the same radix select and tie pass (q = cfg.q, TC-SIA q_local) or
// |x| >= τ for a given τ; then the present chain's keep rule term for
// term, keep = |g~| >= τ' or mask > 0, with mask and τ' formed by the f32
// operations core/algorithms.py uses (SIA: m_k · p, τ' = +inf, or no mask
// and τ' = p > 0 ? τ : +inf; RE-SIA: the union of m_k and supp(γ_in), or
// supp(γ_in) alone, times p; TC-SIA: (m + m_k + clamp(supp(γ_in) - m, 0,
// 1) > 0) · p, τ' = +inf); ḡ = keep ? g~ : +0, e' = g~ - ḡ and
// γ_out = γ_in + ḡ on every element (a γ_in of -0.0 comes out +0.0, as
// the chain's add gives), nnz, nnz_off and, with ERR, the pinned ||e'||^2.
// ḡ never leaves the registers. A lane with p = 0 selects nothing (its
// mask is 0; |g~| = +inf is still kept by the τ' = +inf test); a lane with
// valid = 0 writes zeros.
//
// Rounding: the operand is s = fma(w, g, e); s = fma(p, s, γ_in) with γ;
// s = (1 - m) * s with a global mask, as kref.fused_operand; the bracket
// takes the f32 constants the plain search takes (passed in). Only
// __fmaf_rn / __fmul_rn / __fadd_rn / __fsub_rn, never --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rank.cuh"
#include "tile.cuh"

namespace {

constexpr int kResThreads = 1024;
constexpr int kWarps = kResThreads / 32;
constexpr long long kResidentMaxD = 49152;   // 6 tiles: 192 KB of keys
constexpr int kResidentMaxBranch = kResThreads;
constexpr unsigned kNanKey = 0x7f800001u;    // every NaN, above +inf
constexpr unsigned kFull = 0xffffffffu;

struct LaneOperand {
  const float* g;
  const float* e;
  const float* gin;   // null without gamma_in
  const float* gm;    // null, [d], [W, d] or [B, d]
  const float* w;
  const float* p;
  int gm_lpc;         // lanes per mask row
};

// The operand at element i of the lane whose row starts at `row`.
template <bool GM, bool GAMMA>
__device__ __forceinline__ float operand_at(const LaneOperand& op,
                                            long long row, long long gm_row,
                                            long long i, float wt, float pw) {
  float s = __fmaf_rn(wt, __ldg(op.g + row + i), __ldg(op.e + row + i));
  if (GAMMA) s = __fmaf_rn(pw, s, __ldg(op.gin + row + i));
  if (GM) s = __fmul_rn(__fsub_rn(1.0f, __ldg(op.gm + gm_row + i)), s);
  return s;
}

__device__ __forceinline__ unsigned mag_key(float v) {
  const unsigned u = __float_as_uint(v) & 0x7fffffffu;
  return u > 0x7f800000u ? kNanKey : u;
}

// Add 1 to hist[bin] for every thread with bin >= 0; the whole warp calls
// it, and one atomic per distinct bin of the warp is issued.
__device__ __forceinline__ void warp_add_one(int* hist, int bin) {
  const unsigned peers = __match_any_sync(kFull, bin);
  if (bin >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(&hist[bin], __popc(peers));
  }
}

__device__ __forceinline__ int block_sum(int v, int* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = s_warp[lane];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) s_warp[0] = v;
  }
  __syncthreads();
  return s_warp[0];
}

// Largest non-NaN value over the block (every v >= 0).
__device__ __forceinline__ float block_max(float v, float* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = s_warp[lane];
    for (int o = 16; o > 0; o >>= 1) {
      v = fmaxf(v, __shfl_down_sync(kFull, v, o));
    }
    if (lane == 0) s_warp[0] = v;
  }
  __syncthreads();
  return s_warp[0];
}

// Sum of v over the threads before this one, in thread order.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  __syncthreads();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = s_warp[lane];
    int ti = t;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, ti, o);
      if (lane >= o) ti += n;
    }
    s_warp[lane] = ti - t;
  }
  __syncthreads();
  return s_warp[warp] + incl - v;
}

// torch.clamp(x, min=1e-30): NaN stays NaN.
__device__ __forceinline__ float clamp_tiny(float x) {
  return isnan(x) ? x : fmaxf(x, 1e-30f);
}

// --------------------------------------------------------------------------
// tau_search_fused_level
// --------------------------------------------------------------------------

struct Bracket {
  float scale;   // sparsify._HI_SCALE
  float inv;     // f32(1 / branch)
  float hpb;     // sparsify._hi_per_branch(branch), the one-round width
};

template <bool GM, bool GAMMA>
__global__ void __launch_bounds__(kResThreads)
tau_search_resident_kernel(LaneOperand op, int q, int branch, int rounds,
                           Bracket br, float* __restrict__ tau_out,
                           int* __restrict__ counts_out, int w_lanes,
                           long long d) {
  extern __shared__ float smem[];
  const int B = branch;
  float* s_mag = smem;                                      // [d]
  float* s_key = smem + d;                                  // [B]
  float* s_sorted = s_key + B;                              // [B]
  int* s_hist = reinterpret_cast<int*>(s_sorted + B);       // [B + 1]
  __shared__ float s_redf[kWarps];
  __shared__ float s_lo, s_hi;
  const int w = blockIdx.x, tid = threadIdx.x;
  const long long row = (long long)w * d;
  const long long gm_row = GM ? gmask_row(w, op.gm_lpc, d) : 0;
  const float wt = op.w[w];
  const float pw = GAMMA ? op.p[w] : 0.f;
  float mx = 0.f;
  int nan = 0;
  for (long long i = tid; i < d; i += blockDim.x) {
    const float m = fabsf(operand_at<GM, GAMMA>(op, row, gm_row, i, wt, pw));
    s_mag[i] = m;
    if (isnan(m)) {
      nan = 1;
    } else {
      mx = fmaxf(mx, m);
    }
  }
  const int any_nan = __syncthreads_or(nan);
  mx = block_max(mx, s_redf);
  const float hi_max = clamp_tiny(any_nan ? __int_as_float(0x7fffffff) : mx);
  if (tid == 0) {
    s_lo = 0.f;
    s_hi = __fmul_rn(hi_max, br.scale);
  }
  for (int r = 0; r < rounds; ++r) {
    __syncthreads();
    const float lo = s_lo, hi = s_hi;
    const float width = rounds == 1 ? __fmul_rn(hi_max, br.hpb)
                                    : __fmul_rn(__fsub_rn(hi, lo), br.inv);
    float my_tau = 0.f;
    if (tid < B) {
      my_tau = __fmaf_rn(width, (float)(tid + 1), lo);
      s_key[tid] = tau_key(my_tau);
    }
    for (int k = tid; k <= B; k += blockDim.x) s_hist[k] = 0;
    __syncthreads();
    int pos = 0;
    if (tid < B) {
      pos = sorted_pos(s_key, B, tid);
      s_sorted[pos] = s_key[tid];
    }
    __syncthreads();
    for (long long base = 0; base < d; base += blockDim.x) {
      const long long i = base + tid;
      int bin = -1;
      if (i < d) {
        const int rk = rank_of(s_mag[i], s_sorted, B);
        bin = rk ? rk : -1;
      }
      warp_add_one(s_hist, bin);
    }
    __syncthreads();
    // suffix sums s_hist[k] = #{rank >= k}, k = 1..B, by warp 0: lane l
    // holds a run of `per` bins
    if (tid < 32) {
      const int per = (B + 31) / 32;
      const int k0 = 1 + tid * per;
      const int k1 = k0 + per < B + 1 ? k0 + per : B + 1;
      int sum = 0;
      for (int k = k0; k < k1; ++k) sum += s_hist[k];
      int after = sum;   // inclusive suffix over the lanes
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_down_sync(kFull, after, o);
        if (tid + o < 32) after += n;
      }
      int acc = after - sum;
      for (int k = k1 - 1; k >= k0; --k) {
        acc += s_hist[k];
        s_hist[k] = acc;
      }
    }
    __syncthreads();
    int c = 0;
    if (tid < B) {
      c = isnan(my_tau) ? 0 : s_hist[pos + 1];
      counts_out[((long long)r * w_lanes + w) * B + tid] = c;
    }
    const int jstar = __syncthreads_count(tid < B && c >= q);
    if (tid == 0) {
      const float new_lo = __fmaf_rn((float)jstar, width, lo);
      s_hi = __fmaf_rn(__fsub_rn(hi, lo), br.inv, new_lo);
      s_lo = new_lo;
    }
  }
  __syncthreads();
  if (tid == 0) tau_out[w] = clamp_tiny(s_lo);
}

// --------------------------------------------------------------------------
// cl_fuse_select_level
// --------------------------------------------------------------------------

// Radix select over s_key[0..d) (all lanes' threads call it): → the q-th
// largest key K in *K_out and how many keys equal to K are kept in
// *need_out (1 <= need <= #{key == K}); 0 < q < d.
__device__ __forceinline__ void radix_select(const unsigned* s_key,
                                             long long d, int q, int* s_hist,
                                             unsigned* s_prefix, int* s_k) {
  const int tid = threadIdx.x;
  unsigned prefix = 0, pmask = 0;
  int k = q;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int j = tid; j < 256; j += blockDim.x) s_hist[j] = 0;
    __syncthreads();
    for (long long base = 0; base < d; base += blockDim.x) {
      const long long i = base + tid;
      int bin = -1;
      if (i < d) {
        const unsigned key = s_key[i];
        if ((key & pmask) == prefix) bin = (int)((key >> shift) & 255u);
      }
      warp_add_one(s_hist, bin);
    }
    __syncthreads();
    if (tid < 32) {
      // lane l owns digits 255 - 8l down to 248 - 8l
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = s_hist[255 - 8 * tid - j];
        sum += c[j];
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(kFull, incl, o);
        if (tid >= o) incl += n;
      }
      const int excl = incl - sum;
      if (excl < k && incl >= k) {
        int run = excl;
        for (int j = 0; j < 8; ++j) {
          if (run + c[j] >= k) {
            *s_prefix = prefix | ((unsigned)(255 - 8 * tid - j) << shift);
            *s_k = k - run;
            break;
          }
          run += c[j];
        }
      }
    }
    __syncthreads();
    prefix = *s_prefix;
    pmask |= 255u << shift;
    k = *s_k;
  }
}

// The exact Top-q support of the lane's operand (0 < q < d; all the
// block's threads call it): its keys into s_key[0..d), the radix select of
// the q-th largest key K, then s_key[i] = 1 for every key above K and for
// the keys equal to K lowest index first until q (each thread owns a
// contiguous run of indices, an exclusive block scan of their tie counts
// gives each run its place), 0 elsewhere.
template <bool GM, bool GAMMA>
__device__ __forceinline__ void topq_support(const LaneOperand& op,
                                             long long row, long long gm_row,
                                             float wt, float pw, int q,
                                             long long d, unsigned* s_key,
                                             int* s_hist, int* s_red,
                                             unsigned* s_prefix, int* s_k) {
  const int tid = threadIdx.x;
  for (long long i = tid; i < d; i += blockDim.x) {
    s_key[i] = mag_key(operand_at<GM, GAMMA>(op, row, gm_row, i, wt, pw));
  }
  __syncthreads();
  radix_select(s_key, d, q, s_hist, s_prefix, s_k);
  const unsigned K = *s_prefix;
  const int need = *s_k;
  // ties: the keys equal to K, lowest index first
  const long long chunk = (d + blockDim.x - 1) / blockDim.x;
  const long long i0 = tid * chunk;
  const long long i1 = i0 + chunk < d ? i0 + chunk : d;
  int eq = 0;
  for (long long i = i0; i < i1; ++i) eq += s_key[i] == K;
  int before = block_exclusive_scan(eq, s_red);
  for (long long i = i0; i < i1; ++i) {
    const unsigned key = s_key[i];
    bool sel = key > K;
    if (key == K) sel = before++ < need;
    s_key[i] = sel;
  }
  __syncthreads();
}

// The pinned ||e'||^2 of a lane whose e' sits in smem[0..d): zeros up to
// whole tiles, then tile.cuh's fold tile by tile, left to right.
__device__ __forceinline__ float lane_err(float* smem, long long d) {
  const long long tiles = d > 0 ? (d + kTile - 1) / kTile : 1;
  for (long long i = d + threadIdx.x; i < tiles * kTile; i += blockDim.x) {
    smem[i] = 0.f;
  }
  float acc = 0.f;
  for (long long j = 0; j < tiles; ++j) {
    const float te = pinned_tile_err(smem + j * kTile);
    acc = j == 0 ? te : __fadd_rn(acc, te);
  }
  return acc;
}

template <bool GM, bool ERR>
__global__ void __launch_bounds__(kResThreads)
cl_fuse_select_kernel(LaneOperand op, const float* __restrict__ valid, int q,
                      float* __restrict__ gout, float* __restrict__ enew,
                      int* __restrict__ nnz, int* __restrict__ nnz_off,
                      float* __restrict__ err, long long d) {
  extern __shared__ float smem[];
  unsigned* s_key = reinterpret_cast<unsigned*>(smem);   // [d], then e'
  __shared__ int s_hist[256];
  __shared__ int s_red[kWarps];
  __shared__ unsigned s_prefix;
  __shared__ int s_k;
  const int w = blockIdx.x, tid = threadIdx.x;
  const long long row = (long long)w * d;
  if (!(valid[w] > 0.f)) {
    for (long long i = tid; i < d; i += blockDim.x) {
      gout[row + i] = 0.f;
      enew[row + i] = 0.f;
    }
    if (tid == 0) {
      nnz[w] = 0;
      nnz_off[w] = 0;
      if (ERR) err[w] = 0.f;
    }
    return;
  }
  const long long gm_row = GM ? gmask_row(w, op.gm_lpc, d) : 0;
  const float wt = op.w[w], pw = op.p[w];
  const bool alive = pw > 0.f;
  // the support only matters on a live lane; q >= d keeps every element
  const bool select = alive && q > 0 && (long long)q < d;
  const bool keep_all = (long long)q >= d;
  if (select) {
    topq_support<GM, true>(op, row, gm_row, wt, pw, q, d, s_key, s_hist,
                           s_red, &s_prefix, &s_k);
  }
  int my_nnz = 0, my_off = 0;
  for (long long i = tid; i < d; i += blockDim.x) {
    const float vg = __ldg(op.g + row + i), ve = __ldg(op.e + row + i);
    const float vi = __ldg(op.gin + row + i);
    const float vm = GM ? __ldg(op.gm + gm_row + i) : 0.f;
    const float gt = __fmaf_rn(wt, vg, ve);
    const float s = __fmaf_rn(pw, gt, vi);
    const float lam_t = GM ? __fmul_rn(__fsub_rn(1.0f, vm), s) : s;
    const bool sel = select ? s_key[i] != 0u : keep_all;
    const bool keep = fabsf(lam_t) >= INFINITY || sel;
    const float lam = keep ? lam_t : 0.0f;
    float en = __fsub_rn(lam_t, lam);
    float ga = GM ? __fmaf_rn(vm, s, lam) : lam;
    if (!alive) {
      ga = vi;
      en = gt;
    }
    gout[row + i] = ga;
    enew[row + i] = en;
    if (ga != 0.f) {
      ++my_nnz;
      if (!GM || vm <= 0.f) ++my_off;
    }
    if (ERR) smem[i] = en;
  }
  my_nnz = block_sum(my_nnz, s_red);
  my_off = block_sum(my_off, s_red);
  if (tid == 0) {
    nnz[w] = my_nnz;
    nnz_off[w] = my_off;
  }
  if (ERR) {
    const float acc = lane_err(smem, d);
    if (tid == 0) err[w] = acc;
  }
}

// --------------------------------------------------------------------------
// ia_fuse_select_level
// --------------------------------------------------------------------------

enum IaKind { kSia = 0, kReSia = 1, kTcSia = 2 };

// torch.clamp(x, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.f), 1.f);
}

template <int KIND, bool GM, bool EXACT, bool ERR>
__global__ void __launch_bounds__(kResThreads)
ia_fuse_select_kernel(LaneOperand op, const float* __restrict__ valid, int q,
                      const float* __restrict__ tau,
                      float* __restrict__ gout, float* __restrict__ enew,
                      int* __restrict__ nnz, int* __restrict__ nnz_off,
                      float* __restrict__ err, long long d) {
  extern __shared__ float smem[];
  unsigned* s_key = reinterpret_cast<unsigned*>(smem);   // [d], then e'
  __shared__ int s_hist[256];
  __shared__ int s_red[kWarps];
  __shared__ unsigned s_prefix;
  __shared__ int s_k;
  const int w = blockIdx.x, tid = threadIdx.x;
  const long long row = (long long)w * d;
  if (!(valid[w] > 0.f)) {
    for (long long i = tid; i < d; i += blockDim.x) {
      gout[row + i] = 0.f;
      enew[row + i] = 0.f;
    }
    if (tid == 0) {
      nnz[w] = 0;
      nnz_off[w] = 0;
      if (ERR) err[w] = 0.f;
    }
    return;
  }
  const long long gm_row = GM ? gmask_row(w, op.gm_lpc, d) : 0;
  const float wt = op.w[w], pw = op.p[w];
  const bool alive = pw > 0.f;
  // the mask is m · p: the support only matters on a live lane
  const bool select = EXACT && alive && q > 0 && (long long)q < d;
  const bool keep_all = (long long)q >= d;
  const float tw = EXACT ? 0.f : tau[w];
  // τ' of the keep test: the given τ on a live SIA / RE-SIA lane
  const float tk = !EXACT && KIND != kTcSia && alive ? tw : INFINITY;
  if (select) {
    topq_support<GM, false>(op, row, gm_row, wt, pw, q, d, s_key, s_hist,
                            s_red, &s_prefix, &s_k);
  }
  int my_nnz = 0, my_off = 0;
  for (long long i = tid; i < d; i += blockDim.x) {
    const float vg = __ldg(op.g + row + i), ve = __ldg(op.e + row + i);
    const float vi = __ldg(op.gin + row + i);
    const float vm = GM ? __ldg(op.gm + gm_row + i) : 0.f;
    const float gt = __fmaf_rn(wt, vg, ve);
    bool mk;   // the local support m_k
    if (EXACT) {
      mk = select ? s_key[i] != 0u : keep_all;
    } else {
      const float x = GM ? __fmul_rn(__fsub_rn(1.0f, vm), gt) : gt;
      mk = fabsf(x) >= tw;
    }
    bool m;    // mask > 0 before the product with p
    if (KIND == kSia) {
      m = EXACT && mk;
    } else if (KIND == kReSia) {
      m = (EXACT && mk) || vi != 0.f;
    } else {
      const float m_in = clamp01(__fsub_rn(vi != 0.f ? 1.f : 0.f, vm));
      m = __fadd_rn(__fadd_rn(vm, mk ? 1.f : 0.f), m_in) > 0.f;
    }
    const bool keep = fabsf(gt) >= tk || (alive && m);
    const float gb = keep ? gt : 0.0f;
    const float en = __fsub_rn(gt, gb);
    const float ga = __fadd_rn(vi, gb);
    gout[row + i] = ga;
    enew[row + i] = en;
    if (ga != 0.f) {
      ++my_nnz;
      if (!GM || vm <= 0.f) ++my_off;
    }
    if (ERR) smem[i] = en;
  }
  my_nnz = block_sum(my_nnz, s_red);
  my_off = block_sum(my_off, s_red);
  if (tid == 0) {
    nnz[w] = my_nnz;
    nnz_off[w] = my_off;
  }
  if (ERR) {
    const float acc = lane_err(smem, d);
    if (tid == 0) err[w] = acc;
  }
}

// Raise a kernel's dynamic shared memory limit where it needs more than the
// default 48 KB. The attribute belongs to the current device's context (the
// wrapper's device guard), so it is set on every such launch rather than
// remembered once per process: a second card starts at 48 KB again.
template <auto Kernel>
int allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t tau_smem(long long d, int branch) {
  return (size_t)(d + 2 * branch + branch + 1) * 4;
}

size_t select_smem(long long d, bool with_err) {
  const long long n = with_err ? (d + kTile - 1) / kTile * kTile : d;
  return (size_t)(n > 0 ? n : 1) * 4;
}

template <bool GM, bool GAMMA>
int tau_launch(const LaneOperand& op, int q, int branch, int rounds,
               Bracket br, float* tau, int* counts, int w_lanes, long long d,
               cudaStream_t stream) {
  auto kernel = tau_search_resident_kernel<GM, GAMMA>;
  const size_t smem = tau_smem(d, branch);
  const int rc = allow_smem<tau_search_resident_kernel<GM, GAMMA>>(smem);
  if (rc) return rc;
  kernel<<<w_lanes, kResThreads, smem, stream>>>(op, q, branch, rounds, br,
                                                 tau, counts, w_lanes, d);
  return (int)cudaGetLastError();
}

template <bool GM, bool ERR>
int select_launch(const LaneOperand& op, const float* valid, int q,
                  float* gout, float* enew, int* nnz, int* nnz_off,
                  float* err, int w_lanes, long long d, cudaStream_t stream) {
  auto kernel = cl_fuse_select_kernel<GM, ERR>;
  const size_t smem = select_smem(d, ERR);
  const int rc = allow_smem<cl_fuse_select_kernel<GM, ERR>>(smem);
  if (rc) return rc;
  kernel<<<w_lanes, kResThreads, smem, stream>>>(op, valid, q, gout, enew,
                                                 nnz, nnz_off, err, d);
  return (int)cudaGetLastError();
}

template <int KIND, bool GM, bool EXACT, bool ERR>
int ia_launch(const LaneOperand& op, const float* valid, int q,
              const float* tau, float* gout, float* enew, int* nnz,
              int* nnz_off, float* err, int w_lanes, long long d,
              cudaStream_t stream) {
  auto kernel = ia_fuse_select_kernel<KIND, GM, EXACT, ERR>;
  // the keys only for the exact support; e' only with ERR
  const size_t smem = EXACT || ERR ? select_smem(d, ERR) : 4;
  const int rc = allow_smem<ia_fuse_select_kernel<KIND, GM, EXACT, ERR>>(
      smem);
  if (rc) return rc;
  kernel<<<w_lanes, kResThreads, smem, stream>>>(op, valid, q, tau, gout,
                                                 enew, nnz, nnz_off, err, d);
  return (int)cudaGetLastError();
}

// The exact (tau null) or τ-given form, with or without the error.
template <int KIND, bool GM>
int ia_forms(const LaneOperand& op, const float* valid, int q,
             const float* tau, float* gout, float* enew, int* nnz,
             int* nnz_off, float* err, int w_lanes, long long d,
             cudaStream_t s) {
#define IA(EX, ER) \
  return ia_launch<KIND, GM, EX, ER>(op, valid, q, tau, gout, enew, nnz, \
                                     nnz_off, err, w_lanes, d, s)
  if (tau == nullptr) {
    if (err != nullptr) IA(true, true);
    IA(true, false);
  }
  if (err != nullptr) IA(false, true);
  IA(false, false);
#undef IA
}

}  // namespace

// --------------------------------------------------------------------------
// C interface (ctypes). Pointers are contiguous float32 / int32 CUDA buffers
// checked by the Python wrapper; every output is written by the kernel.
// Returns cudaInvalidValue for a lane the resident form does not take,
// else cudaGetLastError() after the launch.
// --------------------------------------------------------------------------

extern "C" {

long long resident_max_d() { return kResidentMaxD; }

int resident_max_branch() { return kResidentMaxBranch; }

int tau_search_fused_level_launch(const float* g, const float* e,
                                  const float* gin, const float* weight,
                                  const float* part, const float* gm,
                                  int gm_lpc, int q, int branch, int rounds,
                                  float scale, float inv, float hpb,
                                  float* tau, int* counts, int w_lanes,
                                  long long d, void* stream_ptr) {
  if (d < 1 || d > kResidentMaxD || branch < 1 ||
      branch > kResidentMaxBranch || rounds < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const LaneOperand op{g, e, gin, gm, weight, part, gm_lpc};
  const Bracket br{scale, inv, hpb};
  cudaStream_t s = (cudaStream_t)stream_ptr;
#define TAU(GMK, GA) \
  return tau_launch<GMK, GA>(op, q, branch, rounds, br, tau, counts, \
                             w_lanes, d, s)
  if (gin != nullptr) {
    if (gm != nullptr) TAU(true, true);
    TAU(false, true);
  }
  if (gm != nullptr) TAU(true, false);
  TAU(false, false);
#undef TAU
}

int cl_fuse_select_level_launch(const float* g, const float* e,
                                const float* gin, const float* weight,
                                const float* part, const float* valid,
                                const float* gm, int gm_lpc, int q,
                                float* gout, float* enew, int* nnz,
                                int* nnz_off, float* err, int w_lanes,
                                long long d, void* stream_ptr) {
  if (d < 1 || d > kResidentMaxD) return (int)cudaErrorInvalidValue;
  const LaneOperand op{g, e, gin, gm, weight, part, gm_lpc};
  cudaStream_t s = (cudaStream_t)stream_ptr;
#define SEL(GMK, ER) \
  return select_launch<GMK, ER>(op, valid, q, gout, enew, nnz, nnz_off, \
                                err, w_lanes, d, s)
  if (gm != nullptr) {
    if (err != nullptr) SEL(true, true);
    SEL(true, false);
  }
  if (err != nullptr) SEL(false, true);
  SEL(false, false);
#undef SEL
}

// kind: 0 SIA, 1 RE-SIA, 2 TC-SIA (the only kind that reads a global
// mask); tau null for the exact Top-q support of q, else τ [W].
int ia_fuse_select_level_launch(const float* g, const float* e,
                                const float* gin, const float* weight,
                                const float* part, const float* valid,
                                const float* gm, int gm_lpc, int kind, int q,
                                const float* tau, float* gout, float* enew,
                                int* nnz, int* nnz_off, float* err,
                                int w_lanes, long long d, void* stream_ptr) {
  if (d < 1 || d > kResidentMaxD) return (int)cudaErrorInvalidValue;
  if (kind != kTcSia && gm != nullptr) return (int)cudaErrorInvalidValue;
  const LaneOperand op{g, e, gin, gm, weight, part, gm_lpc};
  cudaStream_t s = (cudaStream_t)stream_ptr;
#define FORMS(K, GMK) \
  return ia_forms<K, GMK>(op, valid, q, tau, gout, enew, nnz, nnz_off, err, \
                          w_lanes, d, s)
  switch (kind) {
    case kSia: FORMS(kSia, false);
    case kReSia: FORMS(kReSia, false);
    case kTcSia:
      if (gm != nullptr) FORMS(kTcSia, true);
      FORMS(kTcSia, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FORMS
}

}  // extern "C"
