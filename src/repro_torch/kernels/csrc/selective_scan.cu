// Mamba-1 selective scan, the Hopper replacement of the TPU kernel
// repro/kernels/selective_scan.py::selective_scan_pallas (body _kernel):
//
//   dA = exp(dt A);  h = h dA + (dt x) B;  y = sum_n h C + D x
//
// per batch row b and channel c, with the (Di, N) state in f32 across the
// whole sequence. Returns y (B, S, Di) in x's dtype and h_final (B, Di, N)
// in f32.
//
// What bounds it on an H100: the B S Di N exponentials, through the
// special-function units at 16 per clock per SM (compute capability 9.0;
// 537 M at B 8, S 512, Di 8192, N 16, about 0.13 ms), more than its bytes
// (x and dt read and y written once, about 0.06 ms). The recurrence is a
// chain over time, so a first version is latency-bound on that chain.
//
// What the design does about it. The TPU kernel keeps a (block_d, N)
// state in VMEM scratch across a sequential grid axis of time chunks;
// here one thread owns one (b, c) pair and keeps its N state values in
// registers for the whole sequence, so the state never reaches device
// memory between steps, and the chunk axis becomes a loop over time
// inside the thread. Neighbouring threads take neighbouring channels, so
// the loads of x and dt and the stores of y are coalesced. B[b, t, :] and
// C[b, t, :] are shared by every channel of a row: each tile of TS time
// steps stages them once in shared memory, as f32. Each thread loads its
// tile's x and dt into registers before the tile's steps, which puts
// those loads in flight together. The step order is the TPU kernel's, so
// a step with dt = 0 (a padded column of a ragged wave) multiplies the
// state by exp(0) = 1 and adds 0: the state passes through bit for bit.
// Any S and any Di are taken (the last channel block is masked); N <= 16.
//
// B and C arrive as strided views of the x_proj output (B, S, dt_rank +
// 2N): the wrapper passes their batch and time strides in elements, so no
// copy is made. h0 is absent (zeros), per row (B, Di, N), or one (Di, N)
// state shared by every row (batch stride 0).
#include "common.cuh"

namespace {

constexpr int NT = 128;     // channels per block, one per thread
constexpr int TS = 16;      // time steps per shared-memory tile
constexpr int NMAX = 16;    // largest state width

// NC > 0: the state width is the compile-time NC; NC == 0: n_rt <= NMAX
template <typename T, int NC>
__global__ void __launch_bounds__(NT)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ D,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ hT, int S, int Di, int n_rt,
                      long long bc_sb, long long bc_st, long long h0_sb) {
  constexpr int NM = NC > 0 ? NC : NMAX;
  const int N = NC > 0 ? NC : n_rt;
  __shared__ float sB[TS][NM];
  __shared__ float sC[TS][NM];

  const int b = blockIdx.y;
  const int c = blockIdx.x * NT + threadIdx.x;
  const bool live = c < Di;

  float h[NM], a[NM];
#pragma unroll
  for (int n = 0; n < NM; ++n) {
    const bool on = live && n < N;
    a[n] = on ? A[(size_t)c * N + n] : 0.f;
    h[n] = (on && h0 != nullptr)
               ? h0[(size_t)b * h0_sb + (size_t)c * N + n] : 0.f;
  }
  const float d = live ? D[c] : 0.f;
  const size_t row0 = (size_t)b * S;
  const T* Bb = Bm + (size_t)b * bc_sb;
  const T* Cb = Cm + (size_t)b * bc_sb;

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int nt = min(TS, S - t0);
    __syncthreads();                 // the previous tile's B, C are used
    for (int i = threadIdx.x; i < TS * NM; i += NT) {
      const int tt = i / NM, n = i % NM;
      float bv = 0.f, cv = 0.f;
      if (tt < nt && n < N) {
        const size_t o = (size_t)(t0 + tt) * bc_st + n;
        bv = to_f32(Bb[o]);
        cv = to_f32(Cb[o]);
      }
      sB[tt][n] = bv;
      sC[tt][n] = cv;
    }
    __syncthreads();
    if (!live) continue;

    float xv[TS], dv[TS];
#pragma unroll
    for (int tt = 0; tt < TS; ++tt) {
      xv[tt] = 0.f;
      dv[tt] = 0.f;
      if (tt < nt) {
        const size_t o = (row0 + t0 + tt) * Di + c;
        xv[tt] = to_f32(x[o]);
        dv[tt] = to_f32(dt[o]);
      }
    }
#pragma unroll
    for (int tt = 0; tt < TS; ++tt) {
      if (tt < nt) {
        const float dtx = dv[tt] * xv[tt];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NM; ++n) {
          if (n < N) {
            const float dA = expf(dv[tt] * a[n]);
            h[n] = h[n] * dA + dtx * sB[tt][n];
            acc += h[n] * sC[tt][n];
          }
        }
        y[(row0 + t0 + tt) * Di + c] = from_f32<T>(acc + d * xv[tt]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NM; ++n)
      if (n < N) hT[((size_t)b * Di + c) * N + n] = h[n];
  }
}

template <typename T, int NC>
cudaError_t launch_n(const void* x, const void* dt, const float* A,
                     const void* Bm, const void* Cm, const float* D,
                     const float* h0, void* y, float* hT, int batch, int S,
                     int Di, int N, long long bc_sb, long long bc_st,
                     long long h0_sb, cudaStream_t stream) {
  dim3 grid((Di + NT - 1) / NT, batch);
  selective_scan_kernel<T, NC><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), D, h0,
      static_cast<T*>(y), hT, S, Di, N, bc_sb, bc_st, h0_sb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D,
                   const float* h0, void* y, float* hT, int batch, int S,
                   int Di, int N, long long bc_sb, long long bc_st,
                   long long h0_sb, cudaStream_t st) {
  if (N == 16)
    return launch_n<T, 16>(x, dt, A, Bm, Cm, D, h0, y, hT, batch, S, Di, N,
                           bc_sb, bc_st, h0_sb, st);
  if (N == 8)
    return launch_n<T, 8>(x, dt, A, Bm, Cm, D, h0, y, hT, batch, S, Di, N,
                          bc_sb, bc_st, h0_sb, st);
  return launch_n<T, 0>(x, dt, A, Bm, Cm, D, h0, y, hT, batch, S, Di, N,
                        bc_sb, bc_st, h0_sb, st);
}

}  // namespace

// x, dt (batch, S, Di) contiguous in one dtype; A (Di, N), D (Di,) f32
// contiguous; Bm, Cm in x's dtype with element (b, t, n) at
// b * bc_sb + t * bc_st + n; h0 f32 (Di, N)-contiguous at batch stride
// h0_sb, or null; y (batch, S, Di) in x's dtype, hT (batch, Di, N) f32.
// 1 <= N <= 16.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* Cm, const void* D,
                                     const void* h0, void* y, void* hT,
                                     int batch, int S, int Di, int N,
                                     long long bc_sb, long long bc_st,
                                     long long h0_sb, int dtype,
                                     void* stream) {
  if (N < 1 || N > NMAX) return cudaErrorInvalidValue;
  if (batch == 0 || Di == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  if (dtype == DT_F32)
    return launch<float>(x, dt, Af, Bm, Cm, Df, h0f, y, hTf, batch, S, Di,
                         N, bc_sb, bc_st, h0_sb, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, dt, Af, Bm, Cm, Df, h0f, y, hTf, batch,
                                 S, Di, N, bc_sb, bc_st, h0_sb, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(selective_scan)
