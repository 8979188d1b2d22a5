// Multi-tenant LoRA projection at prefill, one adapter per sequence:
// y[b] = x[b] W + s (x[b] A[ids[b]]) B[ids[b]] (+ bias), the Hopper
// replacement of the TPU kernel
// repro/kernels/lora_bgmv.py::lora_bgmv_seq_pallas (body _seq_kernel).
//
// What bounds it on an H100: as lora_matmul at prefill, the 2 B S K N flops
// of x W (B * S in the thousands); the adapters add B S r (K + N) flops and
// at most n_slots (K + N) r bytes. What the design does about it: the TPU
// kernel scalar-prefetches the ids so that each sequence's BlockSpec picks
// its own adapter block; here each block reads its sequence's id on the
// device and offsets A and B to that slot, then runs lora_matmul's tile
// loop (lora_tile.cuh) unchanged, so a row equals lora_matmul with its
// sequence's adapter bit for bit and costs what lora_matmul costs.
//
// Grid: (N tiles, S tiles, sequence); no host sync, no gathered copy.
#include "lora_tile.cuh"

namespace {

using namespace lora_tile;

template <typename T>
__global__ void __launch_bounds__(NT)
lora_bgmv_seq_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ a, const T* __restrict__ b,
                     const T* __restrict__ bias, const int* __restrict__ ids,
                     T* __restrict__ y, int S, int N, int K, int r,
                     float scale) {
  const long long seq = blockIdx.z;
  const long long slot = ids[seq];
  tile<T, false>(x + seq * S * K, w, a + slot * K * r, b + slot * r * N,
                 bias, nullptr, y + seq * S * N, S, N, K, r, scale,
                 blockIdx.y * BM, blockIdx.x * BN);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* a,
                   const void* b, const void* bias, const int* ids, void* y,
                   int B, int S, int N, int K, int r, float scale,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (S + BM - 1) / BM, B);
  lora_bgmv_seq_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(bias), ids, static_cast<T*>(y), S, N, K, r,
      scale);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, K), w (K, N), a (n_slots, K, r), b (n_slots, r, N), bias (N,) or
// null, ids (B,) int32 in [0, n_slots), y (B, S, N): contiguous, one dtype
// but ids. 1 <= r <= 32, B <= 65535.
extern "C" int lora_bgmv_seq_launch(const void* x, const void* w,
                                    const void* a, const void* b,
                                    const void* bias, const void* ids,
                                    void* y, int B, int S, int N, int K,
                                    int r, float scale, int dtype,
                                    void* stream) {
  if (r < 1 || r > RMAX || B > 65535) return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  if (dtype == DT_F32)
    return launch<float>(x, w, a, b, bias, id, y, B, S, N, K, r, scale, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, w, a, b, bias, id, y, B, S, N, K, r,
                                 scale, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(lora_bgmv_seq)
