// tracelint: kernel-op=selective_scan oracle=selective_scan
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
// (x and dt read and y written once, about 0.06 ms) and its ~4 f32
// operations a state and step (about 0.03 ms at 67 TFLOP/s).
//
// What the design does about it. The TPU kernel keeps a (block_d, N)
// state in VMEM scratch across a sequential grid axis of time chunks; here
// the state stays in registers for the whole sequence and the chunk axis
// becomes a loop over tiles of TS steps inside the block. The exponentials
// are independent of the state, so the units that compute them can be kept
// busy if enough warps are on the card and none waits on a load:
//
// (a) the N states of a channel split over 4 warps (LPC): warp q of a
//     block owns states q NPL .. q NPL + NPL - 1 (NPL = NM / 4: 4 at N 16)
//     of the block's 32 channels, one channel a lane: 4x the threads of one
//     thread a channel, 262,144 at B 8, Di 8192; blocks of 128 threads,
//     the grid (Di / 32, B). A step's B and C values are then the same for
//     the whole warp (one broadcast read of shared memory each), and x and
//     dt are 32 neighbouring channels. Each warp writes its states' sum
//     h C (rising n) a step to shared memory; after the tile,
//     y = ((p0 + p1) + (p2 + p3)) + d x, in that fixed order.
// (b) each tile's x, dt, B and C are copied into a 4-stage ring in shared
//     memory by cp.async, two tiles ahead of the steps that use them (rows
//     past S zero-filled by the copy), so no step waits on device memory;
//     each warp converts its own B and C slice to f32, and one
//     __syncthreads a tile separates the stages. Within a tile each step's
//     operands are read from shared memory one step ahead. At N 16 in
//     bf16 a block takes 69 registers a thread and 30 KB: 7 blocks an SM.
// (c) one MUFU.EX2 an exponential: exp(dt A) = 2^(dt A log2 e) with A
//     scaled by log2 e once, ex2.approx.ftz (relative error ~2^-22). dt = 0
//     gives 2^0 = 1 exactly.
// Earlier versions of this kernel, timed on an H100 (700 W) at B 8, S 512,
// Di 8192, N 16, bf16 (device time), show what each step bought: 4 lanes
// of one warp a channel with shuffles, 0.37 ms (each step's 16-byte B and
// C reads split into quarter-warps); states over 4 warps, 0.39 (a branch a
// step kept the steps from overlapping); the tile unguarded, 0.29;
// operands a step ahead, 0.275; without device-memory traffic the same
// steps took 0.197, and x and dt fetched one tile ahead into registers
// left ~0.05 of the loads exposed.
//
// (d) training: with a checkpoint buffer (B, ceil(S / TS), N, Di) f32 the
//     kernel also stores, at each tile boundary, the state before the tile
//     (from registers, one store a state), which the backward
//     (csrc/selective_scan_bwd.cu) recomputes each tile's states from; a
//     separate instance (CK) does so, and serving's (no buffer) is the
//     kernel without the stores.
//
// The step order is the TPU kernel's: h = h dA + (dt x) B in time order,
// so a step with dt = 0 (a padded column of a ragged wave) multiplies the
// state by exactly 1 and adds 0: the state passes through bit for bit.
// Any S and any Di are taken (the last channel block is masked); N <= 16.
//
// B and C arrive as strided views of the x_proj output (B, S, dt_rank +
// 2N): the wrapper passes their batch and time strides in elements, so no
// copy is made. h0 is absent (zeros), per row (B, Di, N), or one (Di, N)
// state shared by every row (batch stride 0).
#include "common.cuh"

namespace {

constexpr int LPC = 4;              // warps (state groups) a channel
constexpr int CB = 32;              // channels a block, one a lane
constexpr int NT = CB * LPC;        // threads a block
constexpr int TS = 16;              // time steps a tile
constexpr int ST = 4;               // stages of the shared-memory ring
constexpr int NMAX = 16;            // largest state width
constexpr float LOG2E = 1.4426950408889634f;

// NC > 0: the state width is the compile-time NC; NC == 0: n_rt <= NMAX.
// CK: store the state before each tile into ck (B, ceil(S / TS), N, Di).
template <typename T, int NC, bool CK>
__global__ void __launch_bounds__(NT, 4)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ D,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ hT, float* __restrict__ ck, int S,
                      int Di, int n_rt, long long bc_sb, long long bc_st,
                      long long h0_sb) {
  constexpr int NM = NC > 0 ? NC : NMAX;
  constexpr int NPL = NM / LPC;               // states a warp
  constexpr int VEC = 16 / (int)sizeof(T);    // elements a 16-byte chunk
  constexpr int CHK = CB / VEC;               // x chunks a tile row
  constexpr int XC = TS * CHK;                // x (and dt) chunks a tile
  constexpr int BCH = NM / VEC;               // B (and C) chunks a step
  constexpr int BC = TS * BCH;                // B (and C) chunks a tile
  static_assert(NM % LPC == 0 && NM % VEC == 0, "state split");
  __shared__ __align__(16) T xs[ST][TS][CB];
  __shared__ __align__(16) T ds[ST][TS][CB];
  __shared__ __align__(16) T bcs[ST][2][TS][NM];      // B, C as loaded
  __shared__ __align__(16) float wbc[LPC][2][TS][NPL]; // a warp's, in f32
  __shared__ float ps[2][LPC][TS][CB];        // y's partials by warp

  const int N = NC > 0 ? NC : n_rt;
  const int tid = threadIdx.x, lane = tid % 32, ch = tid % CB, q = tid / CB;
  const int b = blockIdx.y, c0 = blockIdx.x * CB, c = c0 + ch;
  const bool live = c < Di;
  const bool wide = Di % VEC == 0 && c0 + CB <= Di && aligned16(x) &&
                    aligned16(dt);
  const size_t row0 = (size_t)b * S;
  const T* Bb = Bm + (size_t)b * bc_sb;
  const T* Cb = Cm + (size_t)b * bc_sb;
  const bool bcwide = N == NM && bc_st % VEC == 0 && aligned16(Bb) &&
                      aligned16(Cb);
  const T zero = from_f32<T>(0.f);

  float h[NPL], a2[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int n = q * NPL + i;
    const bool on = live && n < N;
    a2[i] = on ? A[(size_t)c * N + n] * LOG2E : 0.f;
    h[i] = (on && h0 != nullptr)
               ? h0[(size_t)b * h0_sb + (size_t)c * N + n] : 0.f;
  }
  const float d = live ? D[c] : 0.f;

  // tile t0's x, dt, B and C into stage st: 16-byte cp.async copies (rows
  // past S filled with zeros) where whole and aligned, else element by
  // element; one commit group a tile
  auto issue = [&](int st, int t0) {
    const int nt = min(TS, S - t0);
    const size_t base = (row0 + t0) * Di + c0;
    for (int k = tid; k < 2 * XC; k += NT) {
      const int kk = k % XC, tt = kk / CHK, cv = kk % CHK * VEC;
      const T* src = (k < XC ? x : dt) + base + (size_t)tt * Di + cv;
      T* dst = k < XC ? &xs[st][tt][cv] : &ds[st][tt][cv];
      if (wide) {
        cp_async16(dst, tt < nt ? src : x, tt < nt ? 16 : 0);
      } else {
        for (int v = 0; v < VEC; ++v)
          dst[v] = tt < nt && c0 + cv + v < Di ? src[v] : zero;
      }
    }
    for (int k = tid; k < 2 * BC; k += NT) {
      const int kk = k % BC, tt = kk / BCH, nv = kk % BCH * VEC;
      const T* src = (k < BC ? Bb : Cb) + (size_t)(t0 + tt) * bc_st + nv;
      T* dst = &bcs[st][k < BC ? 0 : 1][tt][nv];
      if (bcwide) {
        cp_async16(dst, tt < nt ? src : Bb, tt < nt ? 16 : 0);
      } else {
        for (int v = 0; v < VEC; ++v)
          dst[v] = tt < nt && nv + v < N ? src[v] : zero;
      }
    }
    cp_async_commit();
  };
  // y of a finished tile from its partials and x; thread tid emits steps
  // q, q + 4, ... of its own channel (d is its D)
  auto emit = [&](int pbuf, int st, int t0) {
    const int nt = min(TS, S - t0);
    T* yt = y + (row0 + t0) * Di + c;
    constexpr int PL = TS * CB;               // one partial's plane
#pragma unroll
    for (int tt = q; tt < TS; tt += LPC) {
      const float* pp = &ps[pbuf][0][tt][ch];
      const float v = ((pp[0] + pp[PL]) + (pp[2 * PL] + pp[3 * PL])) +
                      d * to_f32(xs[st][tt][ch]);
      if (tt < nt && live) yt[tt * Di] = from_f32<T>(v);
    }
  };

  issue(0, 0);
  if (TS < S) issue(1, TS); else cp_async_commit();
  int t_last = 0;
  for (int i = 0, t0 = 0; t0 < S; ++i, t0 += TS) {
    const int st = i % ST;
    cp_async_wait<1>();                       // tile i has landed
    __syncthreads();
    if (t0 + 2 * TS < S)                      // two tiles ahead
      issue((i + 2) % ST, t0 + 2 * TS);
    else
      cp_async_commit();
    if (i > 0) emit((i - 1) & 1, (i + ST - 1) % ST, t0 - TS);
    if constexpr (CK) {
      if (live) {
        const int nck = (S + TS - 1) / TS;
        float* ckt = ck + ((size_t)b * nck + i) * N * Di + c;
#pragma unroll
        for (int j = 0; j < NPL; ++j)
          if (q * NPL + j < N) ckt[(size_t)(q * NPL + j) * Di] = h[j];
      }
    }
    // this warp's B and C of the tile, as f32
    for (int e = lane; e < 2 * TS * NPL; e += 32) {
      const int which = e / (TS * NPL), tt = e / NPL % TS, j = e % NPL;
      wbc[q][which][tt][j] = to_f32(bcs[st][which][tt][q * NPL + j]);
    }
    __syncwarp();
    // steps past S read x = dt = 0 (zero-filled): 2^0 = 1 and (0 x) B = 0
    // leave h as it was, so the tile runs unguarded; emit drops their y.
    // Each step's operands are read one step ahead (software pipelining).
    const T* xb = &xs[st][0][ch];
    const T* db = &ds[st][0][ch];
    const float* bb = &wbc[q][0][0][0];
    const float* cb = &wbc[q][1][0][0];
    float* pb = &ps[i & 1][q][0][ch];
    auto bc = [&](int tt, float (&bv)[NPL], float (&cv)[NPL]) {
      if constexpr (NPL == 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(bb + tt * NPL);
        const float4 c4 = *reinterpret_cast<const float4*>(cb + tt * NPL);
        bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
        cv[0] = c4.x; cv[1] = c4.y; cv[2] = c4.z; cv[3] = c4.w;
      } else {
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          bv[j] = bb[tt * NPL + j];
          cv[j] = cb[tt * NPL + j];
        }
      }
    };
    T xn = xb[0], dn = db[0];
    float bn[NPL], cn[NPL];
    bc(0, bn, cn);
#pragma unroll
    for (int tt = 0; tt < TS; ++tt) {
      const float xv = to_f32(xn), dv = to_f32(dn);
      float bt[NPL], ct[NPL];
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        bt[j] = bn[j];
        ct[j] = cn[j];
      }
      if (tt + 1 < TS) {
        xn = xb[(tt + 1) * CB];
        dn = db[(tt + 1) * CB];
        bc(tt + 1, bn, cn);
      }
      const float dtx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        h[j] = ssm_step(h[j], ex2_approx(dv * a2[j]), dtx, bt[j]);
        acc += h[j] * ct[j];
      }
      pb[tt * CB] = acc;
    }
    t_last = t0;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (S > 0) {
    const int last = t_last / TS;
    emit(last & 1, last % ST, t_last);
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = q * NPL + j;
      if (n < N) hT[((size_t)b * Di + c) * N + n] = h[j];
    }
  }
}

template <typename T, int NC>
cudaError_t launch_n(const void* x, const void* dt, const float* A,
                     const void* Bm, const void* Cm, const float* D,
                     const float* h0, void* y, float* hT, float* ck,
                     int batch, int S, int Di, int N, long long bc_sb,
                     long long bc_st, long long h0_sb, cudaStream_t stream) {
  dim3 grid((Di + CB - 1) / CB, batch);
  auto kernel = ck != nullptr ? selective_scan_kernel<T, NC, true>
                              : selective_scan_kernel<T, NC, false>;
  kernel<<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), D, h0,
      static_cast<T*>(y), hT, ck, S, Di, N, bc_sb, bc_st, h0_sb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D,
                   const float* h0, void* y, float* hT, float* ck, int batch,
                   int S, int Di, int N, long long bc_sb, long long bc_st,
                   long long h0_sb, cudaStream_t st) {
  if (N == 16)
    return launch_n<T, 16>(x, dt, A, Bm, Cm, D, h0, y, hT, ck, batch, S, Di,
                           N, bc_sb, bc_st, h0_sb, st);
  if (N == 8)
    return launch_n<T, 8>(x, dt, A, Bm, Cm, D, h0, y, hT, ck, batch, S, Di,
                          N, bc_sb, bc_st, h0_sb, st);
  return launch_n<T, 0>(x, dt, A, Bm, Cm, D, h0, y, hT, ck, batch, S, Di, N,
                        bc_sb, bc_st, h0_sb, st);
}

}  // namespace

// x, dt (batch, S, Di) contiguous in one dtype; A (Di, N), D (Di,) f32
// contiguous; Bm, Cm in x's dtype with element (b, t, n) at
// b * bc_sb + t * bc_st + n; h0 f32 (Di, N)-contiguous at batch stride
// h0_sb, or null; y (batch, S, Di) in x's dtype, hT (batch, Di, N) f32;
// ck (batch, ceil(S / 16), N, Di) f32, the state before every 16 steps,
// or null (not stored). 1 <= N <= 16.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* Cm, const void* D,
                                     const void* h0, void* y, void* hT,
                                     void* ck, int batch, int S, int Di,
                                     int N,
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
  float* ckf = static_cast<float*>(ck);
  if (dtype == DT_F32)
    return launch<float>(x, dt, Af, Bm, Cm, Df, h0f, y, hTf, ckf, batch, S,
                         Di, N, bc_sb, bc_st, h0_sb, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, dt, Af, Bm, Cm, Df, h0f, y, hTf, ckf,
                                 batch, S, Di, N, bc_sb, bc_st, h0_sb, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(selective_scan)
