// tracelint: kernel-op=lora_bgmv oracle=lora_bgmv
// Multi-tenant LoRA projection at prefill, one adapter per sequence:
// y[b] = x[b] W + s (x[b] A[ids[b]]) B[ids[b]] (+ bias), the Hopper
// replacement of the TPU kernel
// repro/kernels/lora_bgmv.py::lora_bgmv_seq_pallas (body _seq_kernel).
//
// What bounds it on an H100: as lora_matmul at prefill, the 2 B S K N flops
// of x W, 105 GFLOP at B 8 x S 512, K = N = 3584: 0.107 ms at the bf16
// tensor-core peak. The adapters add B S r (K + N) flops and at most
// n_slots (K + N) r bytes.
//
// What held the first version back (10.02 ms at that shape on an H100 at
// 700 W, 38x cuBLAS's addmm and ~1 % of the bf16 peak): it ran lora_matmul's
// CUDA-core tile, every product an f32 FMA, bf16 widened to f32 in shared
// memory, loads staged through registers, u = x A redone in every N tile.
//
// What the design does: bf16 runs lora_matmul's tensor-core path. The u
// pass (lora_u.cuh) takes each row's adapter from ids[m / S]; the tile
// (lora_wgmma.cuh) reads its sequence's id on the device and stages that
// slot's B tile for the epilogue. x has a 3-D tensor map (K, S, B), so
// each sequence's tiles start at its own row 0, as lora_matmul on x[b]
// alone does, and a tile past a sequence's end reads zeros, not the next
// sequence: a row equals lora_matmul with its sequence's adapter bit for
// bit. f32 keeps the CUDA-core tile (lora_tile.cuh), one adapter per
// block. The TPU kernel scalar-prefetches the ids into its BlockSpecs;
// here no host sync and no gathered copy.
//
// Grid: (N tiles, S tiles, sequence).
#include "lora_tile.cuh"
#include "lora_wgmma.cuh"

namespace {

__global__ void __launch_bounds__(lora_tile::NT)
lora_bgmv_seq_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ a,
                         const float* __restrict__ b,
                         const float* __restrict__ bias,
                         const int* __restrict__ ids, float* __restrict__ y,
                         int S, int N, int K, int r, float scale) {
  const long long seq = blockIdx.z;
  const long long slot = ids[seq];
  lora_tile::tile<false>(x + seq * S * K, w, a + slot * K * r,
                         b + slot * r * N, bias, nullptr, y + seq * S * N, S,
                         N, K, r, scale, blockIdx.y * lora_tile::BM,
                         blockIdx.x * lora_tile::BN);
}

cudaError_t launch_f32(const void* x, const void* w, const void* a,
                       const void* b, const void* bias, const int* ids,
                       void* y, int B, int S, int N, int K, int r,
                       float scale, cudaStream_t stream) {
  using namespace lora_tile;
  dim3 grid((N + BN - 1) / BN, (S + BM - 1) / BM, B);
  lora_bgmv_seq_f32_kernel<<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), ids, static_cast<float*>(y), S, N, K,
      r, scale);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, K), w (K, N), a (n_slots, K, r), b (n_slots, r, N), bias (N,) or
// null, ids (B,) int32 in [0, n_slots), y (B, S, N): contiguous, one dtype
// but ids. 1 <= r <= 32, B <= 65535. bf16: u is a (B * S, r) f32 scratch,
// K and N are multiples of 8 and x, w 16-byte aligned (the wrapper pads);
// f32: u is unused.
extern "C" int lora_bgmv_seq_launch(const void* x, const void* w,
                                    const void* a, const void* b,
                                    const void* bias, const void* ids,
                                    void* u, void* y, int B, int S, int N,
                                    int K, int r, float scale, int dtype,
                                    void* stream) {
  if (r < 1 || r > lora_tile::RMAX || B > 65535) return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  if (dtype == DT_F32)
    return launch_f32(x, w, a, b, bias, id, y, B, S, N, K, r, scale, st);
  if (dtype == DT_BF16)
    return lora_wgmma::launch<Slot::PER_SEQ>(x, w, a, b, bias, id,
                                             static_cast<float*>(u), y, B, S,
                                             N, K, r, scale, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(lora_bgmv_seq)
