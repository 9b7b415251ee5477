// Hopper (sm_90a) kernels of the scalar [d] IA combine steps.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/chain_accum.py:
//   chain_accum <- chain_accum_pallas  (gamma_out = gamma_in + gbar, nnz)
//   cl_fuse     <- cl_fuse_pallas      (the CL-SIA node step given tau:
//                  gamma~ = w*g + e + gamma_in; gamma_out = |gamma~| >= tau
//                  ? gamma~ : 0; e' = gamma~ - gamma_out; nnz)
//
// Bound: device-memory bytes. Each element is read once and written once
// with two or three flops in between. The design streams one row with
// 16-byte loads and stores (row.cuh): no padding copy, the ragged tail
// masked in place, a grid sized from the SM count, nnz reduced in shared
// memory and flushed with one integer atomic per block. float32 and
// bfloat16 rows; arithmetic in float32, bfloat16 stores rounded to nearest
// even, nnz counted on the float32 values before that rounding.
//
// Rounding matches the jitted JAX reference bit for bit: XLA contracts
// w*g + e into one FMA and adds gamma_in after it, so gamma~ is
// __fadd_rn(__fmaf_rn(w, g, e), gamma_in); __fsub_rn for e'. Never build
// with --use_fast_math. w and tau come as a value or, when the pointer is
// not null, from the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
chain_accum_kernel(const T* __restrict__ gin, const T* __restrict__ gbar,
                   T* __restrict__ gout, int* __restrict__ nnz,
                   long long d) {
  __shared__ int cnt_s;
  if (threadIdx.x == 0) cnt_s = 0;
  __syncthreads();
  int mine = 0;
  for_each_unit<VecWidth<T>::N>(d, [&](long long i, auto cnt) {
    constexpr int C = decltype(cnt)::value;
    float vi[C], vb[C], og[C];
    ldf<C>(gin, i, vi);
    ldf<C>(gbar, i, vb);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      og[k] = __fadd_rn(vi[k], vb[k]);
      mine += og[k] != 0.f;
    }
    stf<C>(gout, i, og);
  });
  block_count(mine, &cnt_s, nnz);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
cl_fuse_kernel(const T* __restrict__ g, const T* __restrict__ e,
               const T* __restrict__ gin, const float* __restrict__ w_ptr,
               float w_val, const float* __restrict__ tau_ptr, float tau_val,
               T* __restrict__ gout, T* __restrict__ enew,
               int* __restrict__ nnz, long long d) {
  __shared__ int cnt_s;
  if (threadIdx.x == 0) cnt_s = 0;
  __syncthreads();
  const float wt = scalar_arg(w_ptr, w_val), tw = scalar_arg(tau_ptr, tau_val);
  int mine = 0;
  for_each_unit<VecWidth<T>::N>(d, [&](long long i, auto cnt) {
    constexpr int C = decltype(cnt)::value;
    float vg[C], ve[C], vi[C], og[C], oe[C];
    ldf<C>(g, i, vg);
    ldf<C>(e, i, ve);
    ldf<C>(gin, i, vi);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float gt = __fadd_rn(__fmaf_rn(wt, vg[k], ve[k]), vi[k]);
      const float ga = fabsf(gt) >= tw ? gt : 0.0f;
      og[k] = ga;
      oe[k] = __fsub_rn(gt, ga);
      mine += ga != 0.f;
    }
    stf<C>(gout, i, og);
    stf<C>(enew, i, oe);
  });
  block_count(mine, &cnt_s, nnz);
}

template <typename T>
int chain_accum_typed(const void* gin, const void* gbar, void* gout,
                      int* nnz, long long d, cudaStream_t s) {
  const int grid = row_grid(chain_accum_kernel<T>, row_units<T>(d), 0);
  chain_accum_kernel<T><<<grid, kRowThreads, 0, s>>>(
      static_cast<const T*>(gin), static_cast<const T*>(gbar),
      static_cast<T*>(gout), nnz, d);
  return (int)cudaGetLastError();
}

template <typename T>
int cl_fuse_typed(const void* g, const void* e, const void* gin,
                  const float* w_ptr, float w_val, const float* tau_ptr,
                  float tau_val, void* gout, void* enew, int* nnz,
                  long long d, cudaStream_t s) {
  const int grid = row_grid(cl_fuse_kernel<T>, row_units<T>(d), 0);
  cl_fuse_kernel<T><<<grid, kRowThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(e),
      static_cast<const T*>(gin), w_ptr, w_val, tau_ptr, tau_val,
      static_cast<T*>(gout), static_cast<T*>(enew), nnz, d);
  return (int)cudaGetLastError();
}

}  // namespace

// --------------------------------------------------------------------------
// C interface (ctypes). Rows are contiguous, 16-byte aligned [d] CUDA
// buffers of one dtype (kF32 or kBF16), checked by the Python wrapper; nnz
// is zeroed here, on the caller's stream. Returns cudaGetLastError() after
// the launch.
// --------------------------------------------------------------------------

extern "C" {

int chain_accum_launch(const void* gin, const void* gbar, int dtype,
                       void* gout, int* nnz, long long d, void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  cudaMemsetAsync(nnz, 0, sizeof(int), s);
  if (dtype == kBF16) {
    return chain_accum_typed<__nv_bfloat16>(gin, gbar, gout, nnz, d, s);
  }
  return chain_accum_typed<float>(gin, gbar, gout, nnz, d, s);
}

int cl_fuse_launch(const void* g, const void* e, const void* gin,
                   const float* w_ptr, float w_val, const float* tau_ptr,
                   float tau_val, int dtype, void* gout, void* enew,
                   int* nnz, long long d, void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  cudaMemsetAsync(nnz, 0, sizeof(int), s);
  if (dtype == kBF16) {
    return cl_fuse_typed<__nv_bfloat16>(g, e, gin, w_ptr, w_val, tau_ptr,
                                        tau_val, gout, enew, nnz, d, s);
  }
  return cl_fuse_typed<float>(g, e, gin, w_ptr, w_val, tau_ptr, tau_val,
                              gout, enew, nnz, d, s);
}

}  // extern "C"
