// Shared helpers for the port's hand-written kernels: element types,
// 16-byte vector loads and stores, named barriers, and block-wide
// reductions.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace hvd {

// dtype codes passed from Python (ops/cuda/_build.py DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half(v);
}

// 16-byte vector loads need 16-byte aligned rows.
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Number of T in one 16-byte vector.
template <typename T> struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

// Load 16 bytes (Vec<T>::kN elements) at p, which must be 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::kN; ++i) out[i] = to_float(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::kN; ++i) e[i] = from_float<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Named barriers (ids 1-15; 0 is __syncthreads').  bar_sync waits until
// `count` threads (a multiple of 32, whole warps) have reached barrier
// `id`; bar_arrive counts this warp's threads toward it without waiting.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Sum of v over the block; every thread gets the result.  `scratch`
// holds at least 32 floats; the call synchronises the block twice.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : 0.f;
  return warp_sum(v);
}

// Merge of two (max, sum-of-exp) pairs of an online logsumexp.  The
// running max starts at -1e30 (finite), so exp() never sees inf - inf.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void block_lse(float& m, float& s,
                                          float* scratch_m,
                                          float* scratch_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
  __syncthreads();
  if (lane == 0) {
    scratch_m[warp] = m;
    scratch_s[warp] = s;
  }
  __syncthreads();
  m = lane < nwarps ? scratch_m[lane] : -1e30f;
  s = lane < nwarps ? scratch_s[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
}

}  // namespace hvd

// Dispatch on a dtype code: defines `scalar_t` inside the body.
#define HVD_DISPATCH(code, ...)                          \
  switch (code) {                                        \
    case hvd::kFloat32: {                                \
      using scalar_t = float;                            \
      __VA_ARGS__;                                       \
    } break;                                             \
    case hvd::kBFloat16: {                               \
      using scalar_t = __nv_bfloat16;                    \
      __VA_ARGS__;                                       \
    } break;                                             \
    case hvd::kFloat16: {                                \
      using scalar_t = __half;                           \
      __VA_ARGS__;                                       \
    } break;                                             \
    default:                                             \
      return cudaErrorInvalidValue;                      \
  }
