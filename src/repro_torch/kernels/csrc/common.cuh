// Shared helpers of the port's CUDA kernels: dtype codes, conversions,
// warp reductions, and the C-visible error-string hook.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes passed from the Python wrappers
enum DTypeCode { DT_F32 = 0, DT_BF16 = 1 };

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// round-to-nearest-even, as torch's float -> bfloat16 cast
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// extern "C" const char* <prefix>_error_string(int): cudaGetErrorString
// for the code a launch function returned.
#define DEFINE_ERROR_STRING(prefix)                                    \
  extern "C" const char* prefix##_error_string(int e) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(e));            \
  }
