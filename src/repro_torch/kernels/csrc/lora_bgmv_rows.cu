// Multi-tenant LoRA projection at decode, one adapter per row:
// y[m] = x[m] W + s (x[m] A[ids[m]]) B[ids[m]] (+ bias), the Hopper
// replacement of the TPU kernel
// repro/kernels/lora_bgmv.py::lora_bgmv_rows_pallas (body _rows_kernel).
//
// What bounds it on an H100: at decode (M = 8 rows) the K N bytes of the
// shared weight, read once per call, as for lora_matmul; the adapters add
// the used slots' (K + N) r bytes. What the design does about it: x W is
// lora_matmul's tile loop (lora_tile.cuh), so W is read once whatever the
// mix of slots. The TPU kernel sweeps every slot with masked accumulation,
// a workaround for staging the stack in VMEM blocks; that is not carried
// over. Here each row's u = x A[id] and rank-r epilogue read its own slot
// straight from device memory: the stack is a few hundred KB and stays in
// L2, so no slot is staged or swept and a row costs one adapter's work.
//
// Grid: (N tiles, M tiles); the ids are read on the device, no host sync.
#include "lora_tile.cuh"

namespace {

using namespace lora_tile;

template <typename T>
__global__ void __launch_bounds__(NT)
lora_bgmv_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ bias, const int* __restrict__ ids,
                      T* __restrict__ y, int M, int N, int K, int r,
                      float scale) {
  tile<T, true>(x, w, a, b, bias, ids, y, M, N, K, r, scale,
                blockIdx.y * BM, blockIdx.x * BN);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* a,
                   const void* b, const void* bias, const int* ids, void* y,
                   int M, int N, int K, int r, float scale,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_bgmv_rows_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(bias), ids, static_cast<T*>(y), M, N, K, r,
      scale);
  return cudaGetLastError();
}

}  // namespace

// x (M, K), w (K, N), a (n_slots, K, r), b (n_slots, r, N), bias (N,) or
// null, ids (M,) int32 in [0, n_slots), y (M, N): contiguous, one dtype but
// ids. 1 <= r <= 32.
extern "C" int lora_bgmv_rows_launch(const void* x, const void* w,
                                     const void* a, const void* b,
                                     const void* bias, const void* ids,
                                     void* y, int M, int N, int K, int r,
                                     float scale, int dtype, void* stream) {
  if (r < 1 || r > RMAX) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  if (dtype == DT_F32)
    return launch<float>(x, w, a, b, bias, id, y, M, N, K, r, scale, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, w, a, b, bias, id, y, M, N, K, r, scale,
                                 st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(lora_bgmv_rows)
