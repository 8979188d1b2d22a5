// The rank-r pass of the bf16 LoRA kernels:
//
//   u[m, j] = sum_k x[m, k] A[slot(m)][k, j]      (f32, r <= 32)
//
// with slot(m) as `Slot` below. One warp per row: lane l sums
// k = l, l + 32, ... in rising order, then a fixed butterfly of shuffles
// adds the lanes. The order depends on the row alone, so u has the same
// bits in all three kernels, and the tile (lora_wgmma.cuh) is a plain x W
// product with one epilogue. A warp reads x's row 64 bytes and A's rows
// 32 x r x 2 bytes at a time, both contiguous (A's r = 8 rows as one
// 16-byte load a lane).
//
// The TPU kernel keeps u in VMEM scratch beside the main product. Here it
// is an (M, r) f32 scratch the wrapper allocates (128 KB at M 4096, r 8)
// and costs one more read of x: 29 MB at the prefill shape (B 8 x S 512,
// K 3584), ~9 us at 3.35 TB/s, and every row reads all of A[slot] (57 KB
// at K 3584, r 8) from L1.
#pragma once

#include "common.cuh"

// Whose adapter row m takes: slot 0 (lora_matmul), ids[m / S]
// (lora_bgmv_seq) or ids[m] (lora_bgmv_rows).
enum class Slot { ONE, PER_SEQ, PER_ROW };

namespace lora_u {

constexpr int NT = 256, ROWS_PER_BLOCK = NT / 32;

// RT: the smallest of 8, 16, 32 that holds r (the accumulators stay in
// registers). x (M, K) bf16; a (n_slots, K, r) bf16; u (M, r) f32.
template <Slot MODE, int RT>
__global__ void __launch_bounds__(NT)
lora_u_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ a,
              const int* __restrict__ ids, float* __restrict__ u, int M,
              int K, int r, int S) {
  const long long m =
      blockIdx.x * (long long)ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;                            // the whole warp
  const long long slot = MODE == Slot::PER_SEQ   ? ids[m / S]
                         : MODE == Slot::PER_ROW ? ids[m]
                                                 : 0;
  const __nv_bfloat16* xm = x + m * K;
  const __nv_bfloat16* am = a + slot * K * r;
  // whole A rows as 16-byte loads where r fills RT and the slot is aligned
  // (warp-uniform; the values, and so the sums, are the same either way)
  const bool vec = RT % 8 == 0 && r == RT &&
                   reinterpret_cast<uintptr_t>(am) % 16 == 0;
  float acc[RT];
#pragma unroll
  for (int j = 0; j < RT; ++j) acc[j] = 0.f;
#pragma unroll 16                               // loads in flight at small M
  for (int k = lane; k < K; k += 32) {
    const float xf = to_f32(xm[k]);
    const __nv_bfloat16* ak = am + (long long)k * r;
    float av[RT];
    if (vec) {
#pragma unroll
      for (int q = 0; q < RT / 8; ++q) {
        const uint4 raw = reinterpret_cast<const uint4*>(ak)[q];
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int t = 0; t < 8; ++t) av[8 * q + t] = to_f32(h[t]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < RT; ++j) av[j] = j < r ? to_f32(ak[j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[j] = __fmaf_rn(xf, av[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    if (j < r) {                                 // r is warp-uniform
      const float v = warp_sum(acc[j]);
      if (lane == j) u[m * r + j] = v;
    }
  }
}

template <Slot MODE, int RT>
cudaError_t launch_rt(const void* x, const void* a, const int* ids,
                      float* u, int M, int K, int r, int S,
                      cudaStream_t stream) {
  const unsigned blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  lora_u_kernel<MODE, RT><<<blocks, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(a), ids, u, M, K, r, S);
  return cudaGetLastError();
}

// S: rows per sequence (Slot::PER_SEQ only).
template <Slot MODE>
cudaError_t launch(const void* x, const void* a, const int* ids, float* u,
                   int M, int K, int r, int S, cudaStream_t stream) {
  if (r <= 8) return launch_rt<MODE, 8>(x, a, ids, u, M, K, r, S, stream);
  if (r <= 16) return launch_rt<MODE, 16>(x, a, ids, u, M, K, r, S, stream);
  return launch_rt<MODE, 32>(x, a, ids, u, M, K, r, S, stream);
}

}  // namespace lora_u
