// Hopper (sm_90a) kernels of the scalar [d] candidate counts for Top-Q.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/topq_threshold.py:
//   count_ge        <- count_ge_pallas        (counts[j] = #{|x_i| >= tau_j})
//   count_ge_fused  <- count_ge_fused_pallas  (the same counts of the
//                      operand w*g + e, or p*(w*g + e) + gamma_in,
//                      rebuilt per element from the raw node inputs)
//
// Both are integer-exact counts of ranks. On the TPU each candidate is one
// vector compare over a whole tile (B passes per tile). Here:
//   1. one block sorts the B taus (rank by comparison, ties by index; a NaN
//      tau sorts as +inf and counts nothing) into a device scratch, with
//      each tau's place in that order;
//   2. the row kernel finds each element's rank r = #{k : |x| >= sorted_k}
//      and adds 1 to a shared [B+1] histogram with an integer atomic; each
//      block adds its histogram into a global one (integer atomics, exact
//      in any order);
//   3. one block turns the rank histogram into suffix sums: counts[b] =
//      #{rank >= place_b + 1}.
// Taus may come in any order and need no check on the host.
//
// count_ge finds ranks by table lookup, not by search: the sort block also
// builds the RankTable of the sorted taus (rank.cuh: kBuckets buckets over
// the bit patterns from the smallest positive finite tau to the largest,
// one load per element outside the buckets that hold a tau) into the
// scratch, and each block of the row kernel copies it into shared memory.
// tau_search.cu's count_ge_level builds the same table per lane with the
// same device code. The rank histogram is one shared [B + 1] array: copies per
// lane of a warp were measured and bought nothing, even on a row whose
// elements all share one rank (benchmarks/torch_count_ablation.cu, mode 5).
// count_ge_fused, whose three rows hide its search, keeps the binary
// search over the sorted taus.
//
// Bound: device-memory bytes (x, or g, e and gamma_in, read once); a
// single row fills the card through a grid sized from the SM count (not
// tau_search.cu's 64 blocks per lane). Nothing is padded, so no pad count
// is subtracted, and a tau <= 0 counts only the real elements. float32 and
// bfloat16 rows; the operand is rebuilt in float32 with the float ops of
// the jitted reference: s = __fmaf_rn(w, g, e), then s = __fmaf_rn(p, s,
// gamma_in) with gamma. Never build with --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rank.cuh"
#include "row.cuh"

namespace {

constexpr int kSharedLimit = 48 * 1024;
constexpr int kSortThreads = 1024;
constexpr int kCountThreads = 512;     // fewer blocks, fewer flush atomics

// One block: sorted[place_b] = key_b and place[b] = place_b; with TABLE
// also the RankTable of the sorted keys and its kBuckets + 1 entries.
template <bool TABLE>
__global__ void __launch_bounds__(kSortThreads)
sort_taus_kernel(const float* __restrict__ taus, int nb_taus,
                 float* __restrict__ sorted, int* __restrict__ place,
                 RankTable* __restrict__ table,
                 unsigned short* __restrict__ entries) {
  extern __shared__ float smem[];
  const int B = nb_taus;
  float* s_key = smem;
  float* s_sorted = smem + B;                               // TABLE: [B]
  __shared__ RankTable s_t;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    s_key[b] = tau_key(taus[b]);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int pos = sorted_pos(s_key, B, b);
    sorted[pos] = s_key[b];
    place[b] = pos;
    if (TABLE) s_sorted[pos] = s_key[b];
  }
  if (!TABLE) return;
  __syncthreads();
  build_rank_table(s_sorted, B, s_t, entries);
  if (threadIdx.x == 0) *table = s_t;
}

size_t sort_smem(int nb_taus, bool table) {
  return (size_t)nb_taus * (table ? 8 : 4);
}

// Sorted taus, the table's entries and the rank histogram.
size_t count_table_smem(int nb_taus) {
  return (size_t)nb_taus * 4 + (size_t)kEntryWords * 4 +
         (size_t)(nb_taus + 1) * 4;
}

// count_ge: ranks[r] += #{elements of rank r}, r = 1..B, each rank from
// the table (see the header), over a grid-stride walk.
template <typename T>
__global__ void __launch_bounds__(kCountThreads)
count_rank_table_kernel(const T* __restrict__ x,
                        const float* __restrict__ sorted, int nb_taus,
                        const RankTable* __restrict__ table,
                        const unsigned* __restrict__ entry_words,
                        int* __restrict__ ranks, long long d) {
  extern __shared__ float smem[];
  const int B = nb_taus;
  float* s_sorted = smem;                                          // [B]
  unsigned* s_words = reinterpret_cast<unsigned*>(smem + B);
  const unsigned short* s_entries =
      reinterpret_cast<const unsigned short*>(s_words);
  int* s_hist = reinterpret_cast<int*>(s_words + kEntryWords);    // [B+1]
  __shared__ RankTable s_t;
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_sorted[b] = sorted[b];
  for (int j = threadIdx.x; j < kEntryWords; j += blockDim.x) {
    s_words[j] = entry_words[j];
  }
  for (int r = threadIdx.x; r <= B; r += blockDim.x) s_hist[r] = 0;
  if (threadIdx.x == 0) s_t = *table;
  __syncthreads();
  const RankTable t = s_t;
  for_each_unit<VecWidth<T>::N>(d, [&](long long i, auto cnt) {
    constexpr int C = decltype(cnt)::value;
    float v[C];
    ldf<C>(x, i, v);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int r = table_rank(fabsf(v[k]), t, s_entries, s_sorted);
      if (r) atomicAdd(&s_hist[r], 1);
    }
  });
  __syncthreads();
  for (int r = 1 + threadIdx.x; r <= B; r += blockDim.x) {
    const int c = s_hist[r];
    if (c) atomicAdd(&ranks[r], c);
  }
}

// count_ge_fused: ranks[r] += #{elements of rank r}, r = 1..B, each rank
// by binary search over the sorted taus, over a grid-stride walk.
template <typename T, bool GAMMA>
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
  const float wt = scalar_arg(w_ptr, w_val);
  const float pw = GAMMA ? scalar_arg(p_ptr, p_val) : 0.f;
  for_each_unit<VecWidth<T>::N>(d, [&](long long i, auto cnt) {
    constexpr int C = decltype(cnt)::value;
    float mag[C], ve[C];
    [[maybe_unused]] float vi[C];
    ldf<C>(g, i, mag);
    ldf<C>(e, i, ve);
    if constexpr (GAMMA) ldf<C>(gin, i, vi);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      float s = __fmaf_rn(wt, mag[k], ve[k]);
      if constexpr (GAMMA) s = __fmaf_rn(pw, s, vi[k]);
      mag[k] = s;
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
  const void* g;
  const void* e;
  const void* gin;    // null without gamma_in
  const float* w_ptr;
  float w_val;
  const float* p_ptr;
  float p_val;
};

// The scratch holds sorted taus [B] (as float), places [B], ranks [B + 1],
// then count_ge's RankTable and its entries.
int scratch_words(int nb_taus) {
  return 3 * nb_taus + 1 + kTableWords + kEntryWords;
}

template <bool TABLE>
int sort_launch(const float* taus, int nb_taus, int* scratch,
                cudaStream_t s) {
  float* sorted = reinterpret_cast<float*>(scratch);
  int* place = scratch + nb_taus;
  int* ranks = scratch + 2 * nb_taus;
  int* table = ranks + nb_taus + 1;
  cudaMemsetAsync(ranks, 0, sizeof(int) * (size_t)(nb_taus + 1), s);
  sort_taus_kernel<TABLE><<<1, TABLE ? kSortThreads : kRowThreads,
                            sort_smem(nb_taus, TABLE), s>>>(
      taus, nb_taus, sorted, place, reinterpret_cast<RankTable*>(table),
      reinterpret_cast<unsigned short*>(table + kTableWords));
  return (int)cudaGetLastError();
}

int counts_launch(const float* taus, int nb_taus, int* scratch, int* counts,
                  cudaStream_t s) {
  counts_from_ranks_row_kernel<<<1, kRowThreads, (size_t)(nb_taus + 1) * 4,
                                 s>>>(taus, nb_taus, scratch + nb_taus,
                                      scratch + 2 * nb_taus, counts);
  return (int)cudaGetLastError();
}

template <typename T>
int count_ge_typed(const void* x, const float* taus, int nb_taus,
                   int* scratch, int* counts, long long d, cudaStream_t s) {
  const size_t smem = count_table_smem(nb_taus);
  if (smem > (size_t)kSharedLimit) return (int)cudaErrorInvalidValue;
  int rc = sort_launch<true>(taus, nb_taus, scratch, s);
  if (rc) return rc;
  const int* table = scratch + 3 * nb_taus + 1;
  auto kernel = count_rank_table_kernel<T>;
  const int grid = row_grid(kernel, row_units<T>(d), smem, kCountThreads);
  kernel<<<grid, kCountThreads, smem, s>>>(
      static_cast<const T*>(x), reinterpret_cast<const float*>(scratch),
      nb_taus, reinterpret_cast<const RankTable*>(table),
      reinterpret_cast<const unsigned*>(table + kTableWords),
      scratch + 2 * nb_taus, d);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return counts_launch(taus, nb_taus, scratch, counts, s);
}

template <typename T, bool GAMMA>
int count_fused_typed(const RowOperand& op, const float* taus, int nb_taus,
                      int* scratch, int* counts, long long d,
                      cudaStream_t s) {
  const size_t smem = (size_t)(2 * nb_taus + 1) * 4;
  if (smem > (size_t)kSharedLimit) return (int)cudaErrorInvalidValue;
  int rc = sort_launch<false>(taus, nb_taus, scratch, s);
  if (rc) return rc;
  auto kernel = count_rank_row_kernel<T, GAMMA>;
  const int grid = row_grid(kernel, row_units<T>(d), smem);
  kernel<<<grid, kRowThreads, smem, s>>>(
      static_cast<const T*>(op.g), static_cast<const T*>(op.e),
      static_cast<const T*>(op.gin), op.w_ptr, op.w_val, op.p_ptr, op.p_val,
      reinterpret_cast<const float*>(scratch), nb_taus,
      scratch + 2 * nb_taus, d);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return counts_launch(taus, nb_taus, scratch, counts, s);
}

template <bool GAMMA>
int count_fused_dtype(const RowOperand& op, int dtype, const float* taus,
                      int nb_taus, int* scratch, int* counts, long long d,
                      cudaStream_t s) {
  if (dtype == kBF16) {
    return count_fused_typed<__nv_bfloat16, GAMMA>(op, taus, nb_taus,
                                                   scratch, counts, d, s);
  }
  return count_fused_typed<float, GAMMA>(op, taus, nb_taus, scratch, counts,
                                         d, s);
}

}  // namespace

// --------------------------------------------------------------------------
// C interface (ctypes). Rows are contiguous, 16-byte aligned [d] CUDA
// buffers of one dtype (kF32 or kBF16), taus a float32 [B] buffer, the
// scratch an int32 [count_scratch_words(B)] buffer, counts int32 [B], all
// checked by the Python wrapper. Returns cudaGetLastError() after the
// launches.
// --------------------------------------------------------------------------

extern "C" {

int count_scratch_words(int nb_taus) { return scratch_words(nb_taus); }

int count_ge_launch(const void* x, int dtype, const float* taus, int nb_taus,
                    int* scratch, int* counts, long long d,
                    void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (dtype == kBF16) {
    return count_ge_typed<__nv_bfloat16>(x, taus, nb_taus, scratch, counts,
                                         d, s);
  }
  return count_ge_typed<float>(x, taus, nb_taus, scratch, counts, d, s);
}

int count_ge_fused_launch(const void* g, const void* e, const void* gin,
                          const float* w_ptr, float w_val, const float* p_ptr,
                          float p_val, int dtype, const float* taus,
                          int nb_taus, int* scratch, int* counts, long long d,
                          void* stream_ptr) {
  const RowOperand op{g, e, gin, w_ptr, w_val, p_ptr, p_val};
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (gin != nullptr) {
    return count_fused_dtype<true>(op, dtype, taus, nb_taus, scratch, counts,
                                   d, s);
  }
  return count_fused_dtype<false>(op, dtype, taus, nb_taus, scratch, counts,
                                  d, s);
}

}  // extern "C"
