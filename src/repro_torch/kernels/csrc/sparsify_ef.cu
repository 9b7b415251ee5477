// Hopper (sm_90a) kernel of the scalar [d] fused error feedback + sparsify.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/sparsify_ef.py:
//   sparsify_ef <- sparsify_ef_pallas
//     g~ = w*g + e; keep = |g~| >= tau or mask_in > 0;
//     gbar = keep ? g~ : 0; e' = g~ - gbar; nnz = #{gbar != 0}
//
// Bound: device-memory bytes. One read of g, e (and the float32 mask) and
// one write of gbar and e' per element, with three flops in between. The
// design streams one row with 16-byte loads and stores (row.cuh): no
// padding copy, the ragged tail masked in place, a grid sized from the SM
// count, nnz reduced in shared memory and flushed with one integer atomic
// per block. float32 and bfloat16 rows; arithmetic in float32, bfloat16
// stores rounded to nearest even, nnz counted before that rounding. A null
// mask means the threshold alone keeps (nothing extra is read).
//
// Rounding matches the jitted JAX reference bit for bit: g~ is
// __fmaf_rn(w, g, e), where XLA contracts w*g + e; e' is __fsub_rn. Never
// build with --use_fast_math. w and tau come as a value or, when the
// pointer is not null, from the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row.cuh"

namespace {

template <typename T, bool MASK>
__global__ void __launch_bounds__(kRowThreads)
sparsify_ef_kernel(const T* __restrict__ g, const T* __restrict__ e,
                   const float* __restrict__ mask,
                   const float* __restrict__ w_ptr, float w_val,
                   const float* __restrict__ tau_ptr, float tau_val,
                   T* __restrict__ gbar, T* __restrict__ enew,
                   int* __restrict__ nnz, long long d) {
  __shared__ int cnt_s;
  if (threadIdx.x == 0) cnt_s = 0;
  __syncthreads();
  const float wt = scalar_arg(w_ptr, w_val), tw = scalar_arg(tau_ptr, tau_val);
  int mine = 0;
  for_each_unit<VecWidth<T>::N>(d, [&](long long i, auto cnt) {
    constexpr int C = decltype(cnt)::value;
    float vg[C], ve[C], ob[C], oe[C];
    [[maybe_unused]] float vm[C];
    ldf<C>(g, i, vg);
    ldf<C>(e, i, ve);
    if constexpr (MASK) ldf<C>(mask, i, vm);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float gt = __fmaf_rn(wt, vg[k], ve[k]);
      bool keep = fabsf(gt) >= tw;
      if constexpr (MASK) keep = keep || (vm[k] > 0.f);
      const float gb = keep ? gt : 0.0f;
      ob[k] = gb;
      oe[k] = __fsub_rn(gt, gb);
      mine += gb != 0.f;
    }
    stf<C>(gbar, i, ob);
    stf<C>(enew, i, oe);
  });
  block_count(mine, &cnt_s, nnz);
}

template <typename T, bool MASK>
int sparsify_ef_typed(const void* g, const void* e, const float* mask,
                      const float* w_ptr, float w_val, const float* tau_ptr,
                      float tau_val, void* gbar, void* enew, int* nnz,
                      long long d, cudaStream_t s) {
  const int grid = row_grid(sparsify_ef_kernel<T, MASK>, row_units<T>(d), 0);
  sparsify_ef_kernel<T, MASK><<<grid, kRowThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(e), mask, w_ptr, w_val,
      tau_ptr, tau_val, static_cast<T*>(gbar), static_cast<T*>(enew), nnz,
      d);
  return (int)cudaGetLastError();
}

template <typename T>
int sparsify_ef_masked(const void* g, const void* e, const float* mask,
                       const float* w_ptr, float w_val, const float* tau_ptr,
                       float tau_val, void* gbar, void* enew, int* nnz,
                       long long d, cudaStream_t s) {
  if (mask != nullptr) {
    return sparsify_ef_typed<T, true>(g, e, mask, w_ptr, w_val, tau_ptr,
                                      tau_val, gbar, enew, nnz, d, s);
  }
  return sparsify_ef_typed<T, false>(g, e, mask, w_ptr, w_val, tau_ptr,
                                     tau_val, gbar, enew, nnz, d, s);
}

}  // namespace

// --------------------------------------------------------------------------
// C interface (ctypes). g and e are contiguous, 16-byte aligned [d] CUDA
// buffers of one dtype (kF32 or kBF16), mask a float32 [d] buffer or null,
// all checked by the Python wrapper; nnz is zeroed here, on the caller's
// stream. Returns cudaGetLastError() after the launch.
// --------------------------------------------------------------------------

extern "C" {

int sparsify_ef_launch(const void* g, const void* e, const float* mask,
                       const float* w_ptr, float w_val, const float* tau_ptr,
                       float tau_val, int dtype, void* gbar, void* enew,
                       int* nnz, long long d, void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  cudaMemsetAsync(nnz, 0, sizeof(int), s);
  if (dtype == kBF16) {
    return sparsify_ef_masked<__nv_bfloat16>(g, e, mask, w_ptr, w_val,
                                             tau_ptr, tau_val, gbar, enew,
                                             nnz, d, s);
  }
  return sparsify_ef_masked<float>(g, e, mask, w_ptr, w_val, tau_ptr,
                                   tau_val, gbar, enew, nnz, d, s);
}

}  // extern "C"
