// Shared helpers of the port's CUDA kernels: dtype codes, conversions,
// ex2 / rcp / sqrt .approx and the RG-LRU's gate functions, cp.async,
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

// whether p is 16-byte aligned, as a 16-byte vector load or copy needs
__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 2^v through the special-function unit (MUFU.EX2; relative error
// ~2^-22, subnormals flushed): 2^0 is exactly 1
__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// ex2_approx taken anew where it is written: the compiler may not reuse
// an earlier result for the same input, and so keep it in a register
__device__ __forceinline__ float ex2_approx_anew(float v) {
  float r;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// One state's step of the selective scan, h e + (dt x) B, with e = exp(dt
// A): the forward kernel and the backward's recompute of its states take
// it alike (one rounded product, then one fused multiply-add), so the
// recompute ends in the forward's states bit for bit.
__device__ __forceinline__ float ssm_step(float h, float e, float dtx,
                                          float b) {
  return __fmaf_rn(h, e, __fmul_rn(dtx, b));
}

// 1 / v and sqrt(v) through the special-function unit (MUFU.RCP,
// MUFU.SQRT; subnormals flushed): rcp_approx(inf) = 0, rcp_approx(0) = inf
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// The RG-LRU's gate functions (csrc/rglru_scan.cu and its backward).
// sigmoid: 1 / (1 + 2^(-v log2 e)), one MUFU.EX2 and one MUFU.RCP; v =
// -1e9 gives 1 / inf = 0 exactly
__device__ __forceinline__ float sigmoid_f(float v) {
  return rcp_approx(1.f + ex2_approx(v * -1.4426950408889634f));
}

// torch.nn.functional.softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus_f(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// cp.async of a 16-byte chunk into shared memory, bypassing L1; the
// bytes past `bytes` (0 or 16) are filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
