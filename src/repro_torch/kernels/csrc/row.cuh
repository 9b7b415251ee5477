// One contiguous [d] row, as the scalar kernels walk it (chain_accum.cu,
// sparsify_ef.cu, topq_threshold.cu).
//
// A row is cut into 16-byte units, 4 float32 or 8 bfloat16 values each,
// and one scalar unit per element of the ragged tail (d % N): nothing is
// padded. Every row pointer is 16-byte aligned (the wrapper copies a view
// that is not), so vector unit u starts at element u * N and needs no
// scalar head; a float32 mask beside a bfloat16 row reads its 8 values as
// two float4s. Blocks walk the units grid-stride, and the grid is sized
// from the SM count and the kernel's occupancy, not from d, so a single
// row fills the card. Support counts are reduced in shared memory and
// added to the output with one integer atomic per block, exact in any
// order. Only __syncthreads and atomicAdd synchronise threads (no warp
// intrinsics), so the kernels also run under a host emulation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

// The element count of a unit, as a type: f(i, Cnt<C>()) handles C values.
template <int C> struct Cnt { static constexpr int value = C; };

template <typename T>
inline long long row_units(long long d) {
  constexpr int N = VecWidth<T>::N;
  return d / N + d % N;
}

// Call f(first element, Cnt<N or 1>) for each unit of this thread.
template <int N, typename F>
__device__ __forceinline__ void for_each_unit(long long d, F&& f) {
  const long long nvec = d / N, nunits = nvec + d % N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < nunits; u += stride) {
    if (u < nvec) {
      f(u * N, Cnt<N>());
    } else {
      f(nvec * N + (u - nvec), Cnt<1>());
    }
  }
}

// Load C values at p[i] as float32; C > 1 means p + i is 16-byte aligned.
template <int C>
__device__ __forceinline__ void ldf(const float* __restrict__ p, long long i,
                                    float (&v)[C]) {
  if constexpr (C == 1) {
    v[0] = p[i];
  } else {
#pragma unroll
    for (int k = 0; k < C; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i + k);
      v[k] = q.x;
      v[k + 1] = q.y;
      v[k + 2] = q.z;
      v[k + 3] = q.w;
    }
  }
}

// bfloat16 to float32 is exact: the 16 bits are the float's upper half.
// C = 4 (tau_search.cu's tiles) reads 8 bytes, C = 8 16 bytes.
template <int C>
__device__ __forceinline__ void ldf(const __nv_bfloat16* __restrict__ p,
                                    long long i, float (&v)[C]) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  if constexpr (C == 1) {
    v[0] = __uint_as_float((unsigned)h[i] << 16);
  } else if constexpr (C == 4) {   // 8 bytes: p + i is 8-byte aligned
    const uint2 q = *reinterpret_cast<const uint2*>(h + i);
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
    static_assert(C == 8, "a bfloat16 vector unit holds 8 values");
    const uint4 q = *reinterpret_cast<const uint4*>(h + i);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

template <int C>
__device__ __forceinline__ void stf(float* __restrict__ p, long long i,
                                    const float (&v)[C]) {
  if constexpr (C == 1) {
    p[i] = v[0];
  } else {
#pragma unroll
    for (int k = 0; k < C; k += 4) {
      *reinterpret_cast<float4*>(p + i + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  }
}

// float32 to bfloat16, rounded to nearest even (as astype / .to() round).
__device__ __forceinline__ unsigned bf16_bits(float f) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <int C>
__device__ __forceinline__ void stf(__nv_bfloat16* __restrict__ p,
                                    long long i, const float (&v)[C]) {
  unsigned short* h = reinterpret_cast<unsigned short*>(p);
  if constexpr (C == 1) {
    h[i] = (unsigned short)bf16_bits(v[0]);
  } else {
    static_assert(C == 8, "a bfloat16 vector unit holds 8 values");
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = bf16_bits(v[2 * k]) | (bf16_bits(v[2 * k + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(h + i) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A scalar argument: read from the device when given a pointer (a tau that
// a search left on the card costs no host sync), else the value passed.
__device__ __forceinline__ float scalar_arg(const float* p, float v) {
  return p != nullptr ? *p : v;
}

// Add this thread's count into *s (zeroed before a __syncthreads), then
// the block's total into *out with one integer atomic.
__device__ __forceinline__ void block_count(int mine, int* s, int* out) {
  if (mine) atomicAdd(s, mine);
  __syncthreads();
  if (threadIdx.x == 0 && *s) atomicAdd(out, *s);
}

// Blocks of `threads` threads that the card keeps resident at once.
template <typename K>
inline long long resident_blocks(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

// Blocks for `units` units: no more than fill every SM at the kernel's
// occupancy (the rest is walked grid-stride), no fewer than one.
template <typename K>
inline int row_grid(K kernel, long long units, size_t smem,
                    int threads = kRowThreads) {
  const long long cap = resident_blocks(kernel, threads, smem);
  const long long want = (units + threads - 1) / threads;
  const long long g = want < cap ? want : cap;
  return (int)(g < 1 ? 1 : g);
}

}  // namespace
