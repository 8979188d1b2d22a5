// Flash decode: one query token per row against its KV cache, the Hopper
// replacement of the TPU kernel
// repro/kernels/flash_decode.py::flash_decode_pallas (body _kernel).
//
// What bounds it on an H100: bytes. Each decode step reads the whole cache
// of every row once (2 * B * T * Hkv * D elements) for only 4 * D flops per
// (query head, key), far below the card's ~295 flops per byte. What the
// design does about the bound: one block per (row, KV head) streams that
// head's keys through shared memory exactly once, and the g = Hq / Hkv
// query heads that share the KV head (g = 7 for qwen2-7b, not a power of
// two) ride along in the same block, so grouped queries cost no extra
// cache reads. Per-row q_pos and (B, T) kv_pos mask each row on its own:
// +1e9 sentinel slots never show, negative (prefix) slots always do.
//
// Known limit, left for a split-KV version: at 8 rows x 4 KV heads the grid
// is only 32 blocks on 132 SMs (8 blocks at recurrentgemma's one KV head),
// so most of the card idles during decode.
//
// Grid: (Hkv, B); at head dims up to 128, 4 warps, query head j of the
// group on warp j % 4; up to 256, 8 warps, query head j on warp j % 8
// (attn_tile.cuh; that instance takes its ~82 KB of shared memory
// dynamically). Up to 16 query heads per KV head either way.
#include "attn_tile.cuh"

namespace {

constexpr int GMAX = 16;                // largest GQA group taken

template <typename T, int DM>
__global__ void __launch_bounds__(TileShape<DM>::NW * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, T* __restrict__ out,
                    int T_len, int Hq, int Hkv, int D, float scale,
                    int causal, int window) {
  constexpr int NW = TileShape<DM>::NW, RPW = TileShape<DM>::RPW;
  constexpr int NI = DM / 32;
  BlockSmem<DM, GMAX>& blk = block_smem<DM, GMAX>();
  float* Qs = blk.Qs;
  int* qpos_s = blk.qpos;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int g = Hq / Hkv;
  const T* qg = q + ((long long)b * Hq + (long long)hk * g) * D;

  for (int idx = threadIdx.x; idx < g * D; idx += NW * 32) {
    const int r = idx / D, d = idx - r * D;
    Qs[r * DM + d] = to_f32(qg[(long long)r * D + d]);
  }
  if (threadIdx.x < g) qpos_s[threadIdx.x] = q_pos[b];
  __syncthreads();

  const long long kv_stride = (long long)Hkv * D;
  const long long base = (long long)b * T_len * kv_stride + (long long)hk * D;
  float acc[RPW][NI];
  attend_tiles<T, NW, RPW>(Qs, qpos_s, g, k + base, v + base, kv_stride,
                           kv_pos + (long long)b * T_len, T_len, D, scale,
                           causal, window, blk.sm, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* og = out + ((long long)b * Hq + (long long)hk * g) * D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NW * i;
    if (r >= g) continue;
#pragma unroll
    for (int j = 0; j < NI; ++j)
      if (lane + 32 * j < D)
        og[(long long)r * D + lane + 32 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T, int DM>
cudaError_t launch_dm(const void* q, const void* k, const void* v,
                      const int* q_pos, const int* kv_pos, void* out, int B,
                      int T_len, int Hq, int Hkv, int D, float scale,
                      int causal, int window, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  size_t smem;
  const cudaError_t e =
      dynamic_smem<DM, GMAX>(flash_decode_kernel<T, DM>, &smem);
  if (e != cudaSuccess) return e;
  flash_decode_kernel<T, DM><<<grid, TileShape<DM>::NW * 32, smem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), T_len,
      Hq, Hkv, D, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int T_len, int Hq, int Hkv, int D, float scale, int causal,
                   int window, cudaStream_t stream) {
  if (D <= 128)
    return launch_dm<T, 128>(q, k, v, q_pos, kv_pos, out, B, T_len, Hq, Hkv,
                             D, scale, causal, window, stream);
  return launch_dm<T, 256>(q, k, v, q_pos, kv_pos, out, B, T_len, Hq, Hkv,
                           D, scale, causal, window, stream);
}

}  // namespace

// q (B, Hq, D), k/v (B, T, Hkv, D), out (B, Hq, D): contiguous, one dtype;
// q_pos (B,), kv_pos (B, T) int32. D <= 256, Hq / Hkv <= 16.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const int* q_pos,
                                   const int* kv_pos, void* out, int B,
                                   int T_len, int Hq, int Hkv, int D,
                                   float scale, int causal, int window,
                                   int dtype, void* stream) {
  if (D > DMAX || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(q, k, v, q_pos, kv_pos, out, B, T_len, Hq, Hkv, D,
                         scale, causal, window, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, B, T_len, Hq,
                                 Hkv, D, scale, causal, window, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(flash_decode)
