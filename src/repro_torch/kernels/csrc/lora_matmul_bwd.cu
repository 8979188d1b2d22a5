// Adapter gradients of the LoRA-fused projection y = x W + s (x A) B:
//   dA = s x^T (dy B^T)   (K, r) f32
//   dB = s (x A)^T dy     (r, N) f32
// the Hopper replacement of the TPU kernel
// repro/kernels/lora_matmul.py::lora_matmul_bwd_pallas (body _bwd_kernel).
// The frozen-weight gradient dW = x^T dy is never formed.
//
// What bounds it on an H100: the bytes of x (M, K) and dy (M, N), each
// read once (at M 1024, K N 3584, bf16: 14.7 MB, 4.4 us at 3.35 TB/s);
// the 4 M r (K + N) flops are 1/448 of the forward's x W at r = 8. The
// TPU kernel sweeps M sequentially with K and N whole in VMEM and the two
// adapter-sized sums resident across grid steps. Blocks on the card run in
// no order and share nothing, so the sweep becomes two phases:
//
// 1. lora_bwd_rank_kernel: one warp per row m forms u[m] = x[m] A and
//    g[m] = s dy[m] B^T (r values each, f32) and writes them to two (M, r)
//    f32 scratch buffers (2 M r floats, 64 KB at M 1024, r 8: negligible
//    beside x and dy);
// 2. lora_bwd_sweep_kernel: one block per 64-column tile of dA (columns
//    of x) or of dB (columns of dy) loops over all of M in a fixed order,
//    four row groups per block reduced through shared memory in a fixed
//    order.
//
// No atomics: every output element is one fixed sequence of f32
// operations, so results are deterministic run to run. u and g stay f32,
// as the TPU kernel keeps them (the XLA route rounds them to the input
// dtype first). This first version runs on the CUDA cores and is far from
// the byte bound: phase 2 has (K + N) / 64 blocks, 112 at the q shape.
#include "common.cuh"

namespace {

constexpr int RMAX = 32;                      // largest LoRA rank taken
constexpr int NT = 256;                       // threads per block
constexpr int ROWS1 = NT / 32;                // phase 1: rows per block
constexpr int TC = 64;                        // phase 2: columns per block
constexpr int MG = NT / TC;                   // phase 2: row groups
constexpr int MC = 64;                        // phase 2: rows per stage

// u = x A and g = s dy B^T for rows [blockIdx.x * ROWS1, ...): one warp per
// row, lanes stride over K (N), then a butterfly sum per rank entry.
template <typename T>
__global__ void __launch_bounds__(NT)
lora_bwd_rank_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const T* __restrict__ a, const T* __restrict__ b,
                     float* __restrict__ u, float* __restrict__ g, int M,
                     int N, int K, int r, float scale) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * ROWS1 + threadIdx.x / 32;
  if (m >= M) return;                         // whole warp leaves together
  float ua[RMAX], ga[RMAX];
#pragma unroll
  for (int j = 0; j < RMAX; ++j) ua[j] = ga[j] = 0.f;

  const T* xm = x + (long long)m * K;
  for (int k = lane; k < K; k += 32) {
    const float xv = to_f32(xm[k]);
    const T* ak = a + (long long)k * r;
#pragma unroll
    for (int j = 0; j < RMAX; ++j)
      if (j < r) ua[j] += xv * to_f32(ak[j]);
  }
  const T* dym = dy + (long long)m * N;
  for (int n = lane; n < N; n += 32) {
    const float dv = to_f32(dym[n]);
#pragma unroll
    for (int j = 0; j < RMAX; ++j)
      if (j < r) ga[j] += dv * to_f32(b[(long long)j * N + n]);
  }
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    if (j < r) {                              // r is uniform over the warp
      const float us = warp_sum(ua[j]), gs = warp_sum(ga[j]);
      if (lane == 0) {
        u[(long long)m * r + j] = us;
        g[(long long)m * r + j] = scale * gs;
      }
    }
  }
}

// out[c, j] = mul * sum_m src[m, c] * rk[m, j] for the TC columns
// [c0, c0 + TC) of src (M, C); written as (C, r) (dA) or, transposed, as
// (r, C) (dB). Thread (col, grp) sums rows m = grp, grp + MG, ... of each
// stage of MC rows; the MG partial sums are then added in group order.
// (transposed is a runtime flag: a template flag would instantiate the
// shared arrays twice in one kernel, over the 48 KB static limit.)
template <typename T>
__device__ __forceinline__ void sweep(const T* __restrict__ src,
                                      const float* __restrict__ rk,
                                      float* __restrict__ out, int M, int C,
                                      int r, float mul, int c0,
                                      bool transposed) {
  __shared__ float Rs[MC][RMAX];
  __shared__ float red[MG][TC][RMAX + 1];
  const int tid = threadIdx.x;
  const int col = tid % TC, grp = tid / TC;
  const int c = c0 + col;
  float acc[RMAX];
#pragma unroll
  for (int j = 0; j < RMAX; ++j) acc[j] = 0.f;

  for (int m0 = 0; m0 < M; m0 += MC) {
    const int rows = min(MC, M - m0);
    for (int e = tid; e < MC * RMAX; e += NT) {
      const int mm = e / RMAX, j = e % RMAX;
      Rs[mm][j] = (mm < rows && j < r) ? rk[(long long)(m0 + mm) * r + j]
                                       : 0.f;
    }
    __syncthreads();
    if (c < C) {
      for (int mm = grp; mm < rows; mm += MG) {
        const float sv = to_f32(src[(long long)(m0 + mm) * C + c]);
#pragma unroll
        for (int j = 0; j < RMAX; ++j)
          if (j < r) acc[j] += sv * Rs[mm][j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < RMAX; ++j)
    if (j < r) red[grp][col][j] = acc[j];
  __syncthreads();
  // each (column, rank) entry: the MG group sums in fixed order
  for (int e = tid; e < TC * r; e += NT) {
    const int cl = e / r, j = e % r;
    const int cc = c0 + cl;
    if (cc >= C) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < MG; ++q) s += red[q][cl][j];
    if (transposed)
      out[(long long)j * C + cc] = mul * s;
    else
      out[(long long)cc * r + j] = mul * s;
  }
}

// blocks [0, nK) sweep x against g into dA; blocks [nK, nK + nN) sweep dy
// against u into dB (times s)
template <typename T>
__global__ void __launch_bounds__(NT)
lora_bwd_sweep_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ u,
                      const float* __restrict__ g, float* __restrict__ da,
                      float* __restrict__ db, int M, int N, int K, int r,
                      float scale, int nK) {
  if ((int)blockIdx.x < nK)
    sweep<T>(x, g, da, M, K, r, 1.f, blockIdx.x * TC, false);
  else
    sweep<T>(dy, u, db, M, N, r, scale, (blockIdx.x - nK) * TC, true);
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, const void* a,
                   const void* b, float* u, float* g, float* da, float* db,
                   int M, int N, int K, int r, float scale,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  if (M > 0) {
    lora_bwd_rank_kernel<T><<<(M + ROWS1 - 1) / ROWS1, NT, 0, stream>>>(
        xt, dyt, static_cast<const T*>(a), static_cast<const T*>(b), u, g,
        M, N, K, r, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int nK = (K + TC - 1) / TC, nN = (N + TC - 1) / TC;
  if (nK + nN == 0) return cudaSuccess;
  // with M == 0 the sweep writes zeros
  lora_bwd_sweep_kernel<T><<<nK + nN, NT, 0, stream>>>(
      xt, dyt, u, g, da, db, M, N, K, r, scale, nK);
  return cudaGetLastError();
}

}  // namespace

// x (M, K), dy (M, N), a (K, r), b (r, N): contiguous, one dtype.
// u, g (M, r) f32 scratch; da (K, r), db (r, N) f32 outputs. 1 <= r <= 32.
extern "C" int lora_matmul_bwd_launch(const void* x, const void* dy,
                                      const void* a, const void* b, void* u,
                                      void* g, void* da, void* db, int M,
                                      int N, int K, int r, float scale,
                                      int dtype, void* stream) {
  if (r < 1 || r > RMAX) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *uf = static_cast<float*>(u), *gf = static_cast<float*>(g);
  float *daf = static_cast<float*>(da), *dbf = static_cast<float*>(db);
  if (dtype == DT_F32)
    return launch<float>(x, dy, a, b, uf, gf, daf, dbf, M, N, K, r, scale,
                         st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, dy, a, b, uf, gf, daf, dbf, M, N, K, r,
                                 scale, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(lora_matmul_bwd)
