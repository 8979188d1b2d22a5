// LoRA-fused projection y = x W + s (x A) B (+ bias), the Hopper
// replacement of the TPU kernel
// repro/kernels/lora_matmul.py::lora_matmul_pallas (body _kernel).
//
// What bounds it on an H100: at prefill (M = B * S in the thousands) the
// 2 M K N flops of x W; at decode (M = 8) the K N weight bytes, which every
// call reads once. The rank-r branch adds 2 M r (K + N) flops and K r + r N
// bytes, both small for r = 8. What the design does about the bound: the
// branch rides the main product's K loop, so x is read once for both, and
// the rank-r u = x A stays in f32 registers and shared memory (as the TPU
// kernel keeps it in f32 scratch) and never reaches device memory. This
// first version accumulates in f32 on the CUDA cores; a wgmma version for
// the prefill shapes and a split-K version for decode are later work.
//
// The tile loop lives in lora_tile.cuh, shared with the multi-tenant
// kernels lora_bgmv_rows.cu and lora_bgmv_seq.cu so that the three agree
// bit for bit per row.
#include "lora_tile.cuh"

namespace {

using namespace lora_tile;

template <typename T>
__global__ void __launch_bounds__(NT)
lora_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ bias, T* __restrict__ y, int M,
                   int N, int K, int r, float scale) {
  tile<T, false>(x, w, a, b, bias, nullptr, y, M, N, K, r, scale,
                 blockIdx.y * BM, blockIdx.x * BN);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* a,
                   const void* b, const void* bias, void* y, int M, int N,
                   int K, int r, float scale, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_matmul_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(bias), static_cast<T*>(y), M, N, K, r, scale);
  return cudaGetLastError();
}

}  // namespace

// x (M, K), w (K, N), a (K, r), b (r, N), bias (N,) or null, y (M, N):
// contiguous, one dtype. 1 <= r <= 32.
extern "C" int lora_matmul_launch(const void* x, const void* w,
                                  const void* a, const void* b,
                                  const void* bias, void* y, int M, int N,
                                  int K, int r, float scale, int dtype,
                                  void* stream) {
  if (r < 1 || r > RMAX) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(x, w, a, b, bias, y, M, N, K, r, scale, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, w, a, b, bias, y, M, N, K, r, scale, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(lora_matmul)
