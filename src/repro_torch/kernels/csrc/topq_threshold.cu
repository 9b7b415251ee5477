// Hopper (sm_90a) kernels of the scalar [d] candidate counts for Top-Q.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/topq_threshold.py:
//   count_ge        <- count_ge_pallas        (counts[j] = #{|x_i| >= tau_j})
//   count_ge_fused  <- count_ge_fused_pallas  (the same counts of the
//                      operand w*g + e, or p*(w*g + e) + gamma_in,
//                      rebuilt per element from the raw node inputs)
//
// Both are integer-exact counts, by the rank method of tau_search.cu on one
// row. On the TPU each candidate is one vector compare over a whole tile
// (B passes per tile). Here:
//   1. one block sorts the B taus (rank by comparison, ties by index; a NaN
//      tau sorts as +inf and counts nothing) into a device scratch, with
//      each tau's place in that order;
//   2. the row kernel loads the sorted taus into shared memory; each
//      element finds its rank r = #{k : |x| >= sorted_k} by binary search
//      and adds 1 to a shared [B+1] histogram with an integer atomic; each
//      block adds its histogram into a global one (integer atomics, exact
//      in any order);
//   3. one block turns the rank histogram into suffix sums: counts[b] =
//      #{rank >= place_b + 1}.
// Taus may come in any order and need no check on the host.
//
// Bound: device-memory bytes (x, or g, e and gamma_in, read once), with a
// log2(B)-step search per element on top; a single row fills the card
// through a grid sized from the SM count (not tau_search.cu's 64 blocks
// per lane). Nothing is padded, so no pad count is subtracted, and a tau
// <= 0 counts only the real elements. float32 and bfloat16 rows; the
// operand is rebuilt in float32 with the float ops of the jitted reference:
// s = __fmaf_rn(w, g, e), then s = __fmaf_rn(p, s, gamma_in) with gamma.
// Never build with --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rank.cuh"
#include "row.cuh"

namespace {

constexpr int kSharedLimit = 48 * 1024;

// One block: sorted[place_b] = key_b and place[b] = place_b.
__global__ void __launch_bounds__(kRowThreads)
sort_taus_kernel(const float* __restrict__ taus, int nb_taus,
                 float* __restrict__ sorted, int* __restrict__ place) {
  extern __shared__ float smem[];
  float* s_key = smem;
  for (int b = threadIdx.x; b < nb_taus; b += blockDim.x) {
    s_key[b] = tau_key(taus[b]);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb_taus; b += blockDim.x) {
    const int pos = sorted_pos(s_key, nb_taus, b);
    sorted[pos] = s_key[b];
    place[b] = pos;
  }
}

// ranks[r] += #{elements of rank r}, r = 1..B, over a grid-stride walk.
template <typename T, bool FUSED, bool GAMMA>
__global__ void __launch_bounds__(kRowThreads)
count_rank_row_kernel(const T* __restrict__ g, const T* __restrict__ e,
                      const T* __restrict__ gin,
                      const float* __restrict__ w_ptr, float w_val,
                      const float* __restrict__ p_ptr, float p_val,
                      const float* __restrict__ sorted, int nb_taus,
                      int* __restrict__ ranks, long long d) {
  extern __shared__ float smem[];
  const int B = nb_taus;
  float* s_sorted = smem;
  int* s_hist = reinterpret_cast<int*>(smem + B);      // [B + 1]
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_sorted[b] = sorted[b];
  for (int r = threadIdx.x; r <= B; r += blockDim.x) s_hist[r] = 0;
  __syncthreads();
  const float wt = FUSED ? scalar_arg(w_ptr, w_val) : 0.f;
  const float pw = GAMMA ? scalar_arg(p_ptr, p_val) : 0.f;
  for_each_unit<VecWidth<T>::N>(d, [&](long long i, auto cnt) {
    constexpr int C = decltype(cnt)::value;
    float mag[C];
    ldf<C>(g, i, mag);
    if constexpr (FUSED) {
      float ve[C];
      [[maybe_unused]] float vi[C];
      ldf<C>(e, i, ve);
      if constexpr (GAMMA) ldf<C>(gin, i, vi);
#pragma unroll
      for (int k = 0; k < C; ++k) {
        float s = __fmaf_rn(wt, mag[k], ve[k]);
        if constexpr (GAMMA) s = __fmaf_rn(pw, s, vi[k]);
        mag[k] = s;
      }
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int r = rank_of(fabsf(mag[k]), s_sorted, B);
      if (r) atomicAdd(&s_hist[r], 1);
    }
  });
  __syncthreads();
  for (int r = 1 + threadIdx.x; r <= B; r += blockDim.x) {
    const int c = s_hist[r];
    if (c) atomicAdd(&ranks[r], c);
  }
}

// One block: counts[b] = #{elements of rank >= place_b + 1}.
__global__ void __launch_bounds__(kRowThreads)
counts_from_ranks_row_kernel(const float* __restrict__ taus, int nb_taus,
                             const int* __restrict__ place,
                             const int* __restrict__ ranks,
                             int* __restrict__ counts) {
  extern __shared__ float smem[];
  int* s_suffix = reinterpret_cast<int*>(smem);        // [B + 1]
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int r = nb_taus; r >= 1; --r) {
      acc += ranks[r];
      s_suffix[r] = acc;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb_taus; b += blockDim.x) {
    counts[b] = isnan(taus[b]) ? 0 : s_suffix[place[b] + 1];
  }
}

struct RowOperand {
  const void* g;      // x of count_ge
  const void* e;
  const void* gin;    // null without gamma_in
  const float* w_ptr;
  float w_val;
  const float* p_ptr;
  float p_val;
};

// The scratch holds sorted taus [B] (as float), places [B], ranks [B + 1].
template <typename T, bool FUSED, bool GAMMA>
int count_typed(const RowOperand& op, const float* taus, int nb_taus,
                int* scratch, int* counts, long long d, cudaStream_t s) {
  float* sorted = reinterpret_cast<float*>(scratch);
  int* place = scratch + nb_taus;
  int* ranks = scratch + 2 * nb_taus;
  cudaMemsetAsync(ranks, 0, sizeof(int) * (size_t)(nb_taus + 1), s);
  sort_taus_kernel<<<1, kRowThreads, (size_t)nb_taus * 4, s>>>(
      taus, nb_taus, sorted, place);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const size_t smem = (size_t)(2 * nb_taus + 1) * 4;
  if (smem > (size_t)kSharedLimit) return (int)cudaErrorInvalidValue;
  auto kernel = count_rank_row_kernel<T, FUSED, GAMMA>;
  const int grid = row_grid(kernel, row_units<T>(d), smem);
  kernel<<<grid, kRowThreads, smem, s>>>(
      static_cast<const T*>(op.g), static_cast<const T*>(op.e),
      static_cast<const T*>(op.gin), op.w_ptr, op.w_val, op.p_ptr, op.p_val,
      sorted, nb_taus, ranks, d);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  counts_from_ranks_row_kernel<<<1, kRowThreads, (size_t)(nb_taus + 1) * 4,
                                 s>>>(taus, nb_taus, place, ranks, counts);
  return (int)cudaGetLastError();
}

template <bool FUSED, bool GAMMA>
int count_dtype(const RowOperand& op, int dtype, const float* taus,
                int nb_taus, int* scratch, int* counts, long long d,
                cudaStream_t s) {
  if (dtype == kBF16) {
    return count_typed<__nv_bfloat16, FUSED, GAMMA>(op, taus, nb_taus,
                                                    scratch, counts, d, s);
  }
  return count_typed<float, FUSED, GAMMA>(op, taus, nb_taus, scratch, counts,
                                          d, s);
}

}  // namespace

// --------------------------------------------------------------------------
// C interface (ctypes). Rows are contiguous, 16-byte aligned [d] CUDA
// buffers of one dtype (kF32 or kBF16), taus a float32 [B] buffer, the
// scratch an int32 [3B + 1] buffer, counts int32 [B], all checked by the
// Python wrapper. Returns cudaGetLastError() after the launches.
// --------------------------------------------------------------------------

extern "C" {

int count_ge_launch(const void* x, int dtype, const float* taus, int nb_taus,
                    int* scratch, int* counts, long long d,
                    void* stream_ptr) {
  const RowOperand op{x, nullptr, nullptr, nullptr, 0.f, nullptr, 0.f};
  return count_dtype<false, false>(op, dtype, taus, nb_taus, scratch, counts,
                                   d, (cudaStream_t)stream_ptr);
}

int count_ge_fused_launch(const void* g, const void* e, const void* gin,
                          const float* w_ptr, float w_val, const float* p_ptr,
                          float p_val, int dtype, const float* taus,
                          int nb_taus, int* scratch, int* counts, long long d,
                          void* stream_ptr) {
  const RowOperand op{g, e, gin, w_ptr, w_val, p_ptr, p_val};
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (gin != nullptr) {
    return count_dtype<true, true>(op, dtype, taus, nb_taus, scratch, counts,
                                   d, s);
  }
  return count_dtype<true, false>(op, dtype, taus, nb_taus, scratch, counts,
                                  d, s);
}

}  // extern "C"
