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
// Tiles: one block per (64 x 64) output tile, 256 threads, each thread 4 x 4
// outputs at stride 16; K in steps of 32 through shared memory, the next
// step's tiles loading into registers while the current one computes (so
// a block waits for memory about once per step, not once per element).
// u for the block's 64 rows is recomputed per N tile, which costs
// 2 * 64 * r * K per block against 2 * 64 * 64 * K for the main product
// (1/8 at r = 8).
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int TX = 16, TY = 16, NT = TX * TY;
constexpr int RMAX = 32;                      // largest LoRA rank taken
constexpr int UPT = BM * RMAX / NT;           // u entries per thread
constexpr int XPT = BM * BK / NT, WPT = BK * BN / NT, APT = BK * RMAX / NT;

template <typename T>
__global__ void __launch_bounds__(NT)
lora_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ bias, T* __restrict__ y, int M,
                   int N, int K, int r, float scale) {
  __shared__ float Xs[BK][BM + 1];            // transposed x tile
  __shared__ float Ws[BK][BN];
  __shared__ float As[BK][RMAX];
  __shared__ float Us[BM][RMAX + 1];
  __shared__ float Bs[RMAX][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4] = {};
  float u_acc[UPT] = {};

  // the next K step's tiles load into registers while this one computes
  T xr[XPT], wr[WPT], ar[APT];
  auto load = [&](int k0) {
#pragma unroll
    for (int it = 0; it < XPT; ++it) {
      const int e = tid + NT * it, rr = e / BK, c = e % BK;
      const int m = m0 + rr, kk = k0 + c;
      xr[it] = (m < M && kk < K) ? x[(long long)m * K + kk] : from_f32<T>(0.f);
    }
#pragma unroll
    for (int it = 0; it < WPT; ++it) {
      const int e = tid + NT * it, rr = e / BN, c = e % BN;
      const int kk = k0 + rr, n = n0 + c;
      wr[it] = (kk < K && n < N) ? w[(long long)kk * N + n] : from_f32<T>(0.f);
    }
#pragma unroll
    for (int it = 0; it < APT; ++it) {
      const int e = tid + NT * it, rr = e / RMAX, j = e % RMAX;
      const int kk = k0 + rr;
      ar[it] = (kk < K && j < r) ? a[(long long)kk * r + j] : from_f32<T>(0.f);
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int it = 0; it < XPT; ++it) {
      const int e = tid + NT * it;
      Xs[e % BK][e / BK] = to_f32(xr[it]);
    }
#pragma unroll
    for (int it = 0; it < WPT; ++it) {
      const int e = tid + NT * it;
      Ws[e / BN][e % BN] = to_f32(wr[it]);
    }
#pragma unroll
    for (int it = 0; it < APT; ++it) {
      const int e = tid + NT * it;
      As[e / RMAX][e % RMAX] = to_f32(ar[it]);
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * wv[j];
    }
#pragma unroll
    for (int e = 0; e < UPT; ++e) {
      const int p = tid + NT * e;
      if (p < BM * r) {
        const int m = p / r, j = p % r;
        float s = 0.f;
        for (int kk = 0; kk < BK; ++kk) s += Xs[kk][m] * As[kk][j];
        u_acc[e] += s;
      }
    }
    __syncthreads();
  }

  // epilogue: y = acc + s * u B[:, tile] + bias, cast to the output dtype
#pragma unroll
  for (int e = 0; e < UPT; ++e) {
    const int p = tid + NT * e;
    if (p < BM * r) Us[p / r][p % r] = u_acc[e];
  }
  for (int idx = tid; idx < r * BN; idx += NT) {
    const int j = idx / BN, c = idx % BN;
    const int n = n0 + c;
    Bs[j][c] = n < N ? to_f32(b[(long long)j * N + n]) : 0.f;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ml = ty + TY * i, m = m0 + ml;
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int nl = tx + TX * jj, n = n0 + nl;
      if (n >= N) continue;
      float lo = 0.f;
      for (int j = 0; j < r; ++j) lo += Us[ml][j] * Bs[j][nl];
      float out = acc[i][jj] + scale * lo;
      if (bias != nullptr) out += to_f32(bias[n]);
      y[(long long)m * N + n] = from_f32<T>(out);
    }
  }
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
