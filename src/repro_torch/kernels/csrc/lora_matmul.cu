// tracelint: kernel-op=lora_matmul oracle=lora_matmul
// LoRA-fused projection y = x W + s (x A) B (+ bias), the Hopper
// replacement of the TPU kernel
// repro/kernels/lora_matmul.py::lora_matmul_pallas (body _kernel).
//
// What bounds it on an H100: at prefill and in training (M = B * S in the
// thousands) the 2 M K N flops of x W, 105 GFLOP at M 4096, K = N = 3584:
// 0.107 ms at the bf16 tensor-core peak; at decode (M = 8) the K N weight
// bytes, which every call reads once. The rank-r branch adds 2 M r (K + N)
// flops and K r + r N bytes, both small for r = 8.
//
// What held the first version back (~10 ms at M 4096 on an H100 at 700 W,
// ~1 % of the bf16 peak): every product an f32 FMA on the CUDA cores,
// bf16 widened to f32 before shared memory, loads staged through
// registers with two block barriers per 32-deep step, and u = x A
// recomputed in every N tile.
//
// What the design does: bf16 runs on the tensor cores. A pass computes
// u = x A in f32, one warp per row (lora_u.cuh), then the tile
// (lora_wgmma.cuh) runs x W through wgmma on TMA-loaded, 128-byte-swizzled
// stages of a 4-deep ring and adds s u B (+ bias) in its epilogue: two
// launches per call. The TPU kernel keeps u in VMEM scratch; here it is an
// (M, r) f32 scratch, one more read of x. f32 keeps the CUDA-core tile
// (lora_tile.cuh), since TF32 would round its operands. The dx of the
// backward (lora_matmul(dy, Wᵀ, Bᵀ, Aᵀ)) runs this kernel too.
//
// lora_bgmv_rows.cu and lora_bgmv_seq.cu run the same tiles, so the three
// agree bit for bit per row in each dtype.
#include "lora_tile.cuh"
#include "lora_wgmma.cuh"

namespace {

__global__ void __launch_bounds__(lora_tile::NT)
lora_matmul_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ bias, float* __restrict__ y,
                       int M, int N, int K, int r, float scale) {
  lora_tile::tile<false>(x, w, a, b, bias, nullptr, y, M, N, K, r, scale,
                         blockIdx.y * lora_tile::BM,
                         blockIdx.x * lora_tile::BN);
}

cudaError_t launch_f32(const void* x, const void* w, const void* a,
                       const void* b, const void* bias, void* y, int M,
                       int N, int K, int r, float scale,
                       cudaStream_t stream) {
  using namespace lora_tile;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_matmul_f32_kernel<<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, K, r,
      scale);
  return cudaGetLastError();
}

// One 128 x 128 x 64 tile of x W through the ring's boxes, swizzle and
// wgmma descriptors, f32 out (y[m * 128 + n]): the layout check of the
// tensor-core tile, against x.float() @ w.float().
__global__ void __launch_bounds__(lora_wgmma::NT, 1)
probe_kernel(const __grid_constant__ CUtensorMap tmx,
             const __grid_constant__ CUtensorMap tmw, float* y) {
  using namespace lora_wgmma;
  const Ring g = ring_setup();
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  if (tid == 0) issue_stage(g, &tmx, &tmw, 0, 0, 0, 0);
  __syncwarp();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(smem_addr(&g.full[0]), 0);
  fence_acc(acc);
  wgmma_fence();
  mma_stage(acc, g, 0, wg);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        y[(wg * 64 + frag_row(t, h)) * BN + frag_col(t, i) + e] =
            acc[4 * i + 2 * h + e];
}

}  // namespace

// x (M, K), w (K, N), a (K, r), b (r, N), bias (N,) or null, y (M, N):
// contiguous, one dtype. 1 <= r <= 32. bf16: u is an (M, r) f32 scratch,
// K and N are multiples of 8 and x, w 16-byte aligned (the wrapper pads);
// f32: u is unused.
extern "C" int lora_matmul_launch(const void* x, const void* w,
                                  const void* a, const void* b,
                                  const void* bias, void* u, void* y, int M,
                                  int N, int K, int r, float scale,
                                  int dtype, void* stream) {
  if (r < 1 || r > lora_tile::RMAX) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_f32(x, w, a, b, bias, y, M, N, K, r, scale, st);
  if (dtype == DT_BF16)
    return lora_wgmma::launch<Slot::ONE>(x, w, a, b, bias, nullptr,
                                         static_cast<float*>(u), y, 1, M, N,
                                         K, r, scale, st);
  return cudaErrorInvalidValue;
}

// The layout check of the tensor-core tile: y (128, 128) f32 = x (128, 64)
// W (64, 128), both bf16, through one stage of the ring.
extern "C" int lora_wgmma_probe_launch(const void* x, const void* w, void* y,
                                       void* stream) {
  using namespace lora_wgmma;
  CUtensorMap tmx, tmw;
  cudaError_t e = encode_maps(&tmx, &tmw, x, w, 1, BM, BN, BK);
  if (e != cudaSuccess) return e;
  if ((e = raise_smem<probe_kernel, SMEM_BYTES>()) != cudaSuccess) return e;
  probe_kernel<<<1, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tmx, tmw, static_cast<float*>(y));
  return cudaGetLastError();
}

DEFINE_ERROR_STRING(lora_matmul)
