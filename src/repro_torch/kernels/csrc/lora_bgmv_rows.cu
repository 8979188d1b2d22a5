// tracelint: kernel-op=lora_bgmv oracle=lora_bgmv
// Multi-tenant LoRA projection at decode, one adapter per row:
// y[m] = x[m] W + s (x[m] A[ids[m]]) B[ids[m]] (+ bias), the Hopper
// replacement of the TPU kernel
// repro/kernels/lora_bgmv.py::lora_bgmv_rows_pallas (body _rows_kernel).
//
// What bounds it on an H100: at decode (M = 8 rows) the K N bytes of the
// shared weight, read once per call, as for lora_matmul; the adapters add
// the used slots' (K + N) r bytes. The TPU kernel sweeps every slot with
// masked accumulation, a workaround for staging the stack in VMEM blocks;
// that is not carried over: each row's u and rank-r epilogue read its own
// slot, so a row costs one adapter's work.
//
// The design runs lora_matmul's tiles, so that each row equals
// lora_matmul with its own adapter bit for bit: bf16 the u pass
// (lora_u.cuh, slot ids[m]) and the tensor-core tile (lora_wgmma.cuh, each
// row's B read from L2 in the epilogue); f32 the CUDA-core tile
// (lora_tile.cuh, PER_ROW). A design for the decode shape itself (split-K
// over more blocks, since M 8 uses 8 of a tile's 128 rows and N / 128
// blocks stream W) is still open, and needs the same change in
// lora_matmul to keep the contract.
//
// Grid: (N tiles, M tiles); the ids are read on the device, no host sync.
#include "lora_tile.cuh"
#include "lora_wgmma.cuh"

namespace {

__global__ void __launch_bounds__(lora_tile::NT)
lora_bgmv_rows_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ bias,
                          const int* __restrict__ ids, float* __restrict__ y,
                          int M, int N, int K, int r, float scale) {
  lora_tile::tile<true>(x, w, a, b, bias, ids, y, M, N, K, r, scale,
                        blockIdx.y * lora_tile::BM,
                        blockIdx.x * lora_tile::BN);
}

cudaError_t launch_f32(const void* x, const void* w, const void* a,
                       const void* b, const void* bias, const int* ids,
                       void* y, int M, int N, int K, int r, float scale,
                       cudaStream_t stream) {
  using namespace lora_tile;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_bgmv_rows_f32_kernel<<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), ids, static_cast<float*>(y), M, N, K,
      r, scale);
  return cudaGetLastError();
}

}  // namespace

// x (M, K), w (K, N), a (n_slots, K, r), b (n_slots, r, N), bias (N,) or
// null, ids (M,) int32 in [0, n_slots), y (M, N): contiguous, one dtype but
// ids. 1 <= r <= 32. bf16: u is an (M, r) f32 scratch, K and N are
// multiples of 8 and x, w 16-byte aligned (the wrapper pads); f32: u is
// unused.
extern "C" int lora_bgmv_rows_launch(const void* x, const void* w,
                                     const void* a, const void* b,
                                     const void* bias, const void* ids,
                                     void* u, void* y, int M, int N, int K,
                                     int r, float scale, int dtype,
                                     void* stream) {
  if (r < 1 || r > lora_tile::RMAX) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  if (dtype == DT_F32)
    return launch_f32(x, w, a, b, bias, id, y, M, N, K, r, scale, st);
  if (dtype == DT_BF16)
    return lora_wgmma::launch<Slot::PER_ROW>(x, w, a, b, bias, id,
                                             static_cast<float*>(u), y, 1, M,
                                             N, K, r, scale, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(lora_bgmv_rows)
