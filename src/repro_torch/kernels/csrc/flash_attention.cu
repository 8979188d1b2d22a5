// Flash attention for prefill (GQA, prefix-KV, sliding window, position
// masks), the Hopper replacement of the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body _kernel).
//
// What bounds it on an H100: the score and p @ V products, 4 * D flops per
// visible (query, key) pair. The causal triangle halves the pairs, and the
// visible pairs, not the bytes of q/k/v (read once per q tile from L2),
// set the work. This first version computes them in f32 on the CUDA cores
// (about 67 TFLOP/s of peak, not the 989 TFLOP/s of bf16 tensor cores);
// a wgmma version is later work. What the design does about the bound:
// it never forms the (S, T) score matrix in device memory (online softmax
// over 32-key tiles, f32 state in registers), skips whole key tiles that no
// row of the block can see (the causal upper triangle) and never skips the
// prefix slots, and shares each K/V tile in shared memory among the 16
// query rows of a block.
//
// Grid: (ceil(S / 16), Hq, B); 16 query rows per block: 4 warps of 4 rows
// at head dims up to 128, 8 warps of 2 rows up to 256 (attn_tile.cuh; that
// instance takes its ~82 KB of shared memory dynamically). GQA: query head
// h reads KV head h / (Hq / Hkv).
#include "attn_tile.cuh"

namespace {

constexpr int BQ = 16;              // query rows per block

template <typename T, int DM>
__global__ void __launch_bounds__(TileShape<DM>::NW * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, T* __restrict__ out,
                       int S, int T_len, int Hq, int Hkv, int D, float scale,
                       int causal, int window) {
  constexpr int NW = TileShape<DM>::NW, RPW = TileShape<DM>::RPW;
  constexpr int NI = DM / 32;
  BlockSmem<DM, BQ>& blk = block_smem<DM, BQ>();
  float* Qs = blk.Qs;
  int* qpos_s = blk.qpos;

  const int s0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nrows = min(BQ, S - s0);

  for (int idx = threadIdx.x; idx < BQ * D; idx += NW * 32) {
    const int r = idx / D, d = idx - r * D;
    Qs[r * DM + d] = r < nrows
        ? to_f32(q[(((long long)b * S + s0 + r) * Hq + h) * D + d]) : 0.f;
  }
  if (threadIdx.x < BQ)
    qpos_s[threadIdx.x] = threadIdx.x < nrows ? q_pos[s0 + threadIdx.x] : 0;
  __syncthreads();

  const long long kv_stride = (long long)Hkv * D;
  const long long base = (long long)b * T_len * kv_stride + (long long)hk * D;
  float acc[RPW][NI];
  attend_tiles<T, NW, RPW>(Qs, qpos_s, nrows, k + base, v + base, kv_stride,
                           kv_pos, T_len, D, scale, causal, window, blk.sm,
                           acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NW * i;
    if (r >= nrows) continue;
    T* orow = out + (((long long)b * S + s0 + r) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NI; ++j)
      if (lane + 32 * j < D) orow[lane + 32 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T, int DM>
cudaError_t launch_dm(const void* q, const void* k, const void* v,
                      const int* q_pos, const int* kv_pos, void* out, int B,
                      int S, int T_len, int Hq, int Hkv, int D, float scale,
                      int causal, int window, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  size_t smem;
  const cudaError_t e =
      dynamic_smem<DM, BQ>(flash_attention_kernel<T, DM>, &smem);
  if (e != cudaSuccess) return e;
  flash_attention_kernel<T, DM><<<grid, TileShape<DM>::NW * 32, smem,
                                  stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), S,
      T_len, Hq, Hkv, D, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int S, int T_len, int Hq, int Hkv, int D, float scale,
                   int causal, int window, cudaStream_t stream) {
  if (D <= 128)
    return launch_dm<T, 128>(q, k, v, q_pos, kv_pos, out, B, S, T_len, Hq,
                             Hkv, D, scale, causal, window, stream);
  return launch_dm<T, 256>(q, k, v, q_pos, kv_pos, out, B, S, T_len, Hq,
                           Hkv, D, scale, causal, window, stream);
}

}  // namespace

// q (B, S, Hq, D), k/v (B, T, Hkv, D), out (B, S, Hq, D): contiguous, one
// dtype; q_pos (S,), kv_pos (T,) int32. D <= 256, Hq % Hkv == 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int* q_pos,
                                      const int* kv_pos, void* out, int B,
                                      int S, int T_len, int Hq, int Hkv,
                                      int D, float scale, int causal,
                                      int window, int dtype, void* stream) {
  if (D > DMAX || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(q, k, v, q_pos, kv_pos, out, B, S, T_len, Hq, Hkv,
                         D, scale, causal, window, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, B, S, T_len,
                                 Hq, Hkv, D, scale, causal, window, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(flash_attention)
