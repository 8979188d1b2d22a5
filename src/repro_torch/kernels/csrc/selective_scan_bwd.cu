// The VJP of the Mamba-1 selective scan (csrc/selective_scan.cu). No TPU
// kernel is replaced: the reference differentiates the scan through XLA
// (repro/kernels/ops.py::_selective_scan_assoc), so this kernel was added
// to keep a gradient through the scan on the card off the plain version.
//
// Forward, per batch row b, channel c and state n (f32 state):
//   dA_t = exp(dt_t A);  h_t = h_{t-1} dA_t + (dt_t x_t) B_t;
//   y_t = sum_n C_t h_t + D x_t
// Backward in time from g = dh_final (dL/dh_t):
//   g += dy_t C_t;  dx_t = D dy_t + dt_t sum_n g B_t;
//   ddt_t = sum_n g (A dA_t h_{t-1} + x_t B_t);
//   dB_t = sum_c g dt_t x_t;  dC_t = sum_c dy_t h_t;
//   dA += g dt_t dA_t h_{t-1};  dD += dy_t x_t;  g *= dA_t;  dh0 = g.
//
// What bounds it on an H100: its f32 operations, ~18 a state and step
// (the forward's step, for the states, and the reverse step: 2.4 G at B
// 4, S 256, Di 8192, N 16, about 0.036 ms at 67 TFLOP/s), then the B S Di
// N exponentials through the special-function units (16 per clock per
// SM: 134 M, 0.032 ms taken once) and its bytes (x, dt and dy read, dx
// and ddt written, in bf16: about 84 MB, 0.025 ms).
//
// Design: a simple kernel, right first. The states are not stored by the
// forward (37 GB at the round's shape over 64 layers): each block (the
// forward's: 32 channels of one row, a channel's N states over 4 warps,
// one channel a lane) reruns the forward's steps from h0 and keeps the
// state before every chunk of TS steps in a global scratch (B, S / TS, N,
// Di) f32; then it walks the chunks in reverse, recomputes a chunk's
// states from its checkpoint into shared memory, and runs the reverse
// recurrence over them. Each exponential is thus taken three times. The
// rerun uses the forward kernel's exact arithmetic (ex2.approx of dt times
// A log2 e, h dA + (dt x) B written alike): its final state is the forward
// kernel's h_final bit for bit (hT_out, a test hook). A chunk's operands
// are staged in shared memory as f32, zero past S and past Di: there dt =
// 0 gives dA = 1, and dy = 0 adds nothing, so the chunks run unguarded.
//
// Sums in a fixed order, so that every call gives the same bits: dx and
// ddt add the 4 warps' partials as ((p0 + p1) + (p2 + p3)); dB and dC sum
// a step's 32 channels inside the warp (a transposing butterfly: 2 NPL
// sums in 2 NPL - 1 + 5 - log2(2 NPL) shuffles) into a per-block partial
// (B, Di / 32, S, 2, N) that the wrapper sums over the blocks; dA and dD
// accumulate over time in registers into per-row partials that the
// wrapper sums over the rows. A padded column (dt = 0, dy = 0) passes g
// through unchanged and adds exact zeros, so a right-padded row's valid
// part gets the gradients of the row run alone.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int LPC = 4;              // warps (state groups) a channel
constexpr int CB = 32;              // channels a block, one a lane
constexpr int NT = CB * LPC;        // threads a block
constexpr int TS = 16;              // steps a chunk (between checkpoints)
constexpr int NMAX = 16;            // largest state width
constexpr float LOG2E = 1.4426950408889634f;

template <int NM>
struct Smem {
  float sts[TS][NM / LPC][NT];      // a chunk's states h_t, by thread
  float xs[TS][CB], ds[TS][CB], gs[TS][CB];   // x, dt, dy of the chunk
  float bs[TS][NM], cs[TS][NM];     // B, C of the chunk
  float px[LPC][TS][CB];            // dx's partials by warp
  float pd[LPC][TS][CB];            // ddt's partials by warp
};

// In lane L, the warp-wide sum of v[L >> (5 - log2 V)]: each halving
// stage keeps half of the values and adds the other half from the lane
// `off` away, then the last stages add the same value across lanes.
template <int V>
__device__ __forceinline__ float lane_sums(float (&v)[V], int lane) {
  static_assert(V >= 1 && V <= 32 && (V & (V - 1)) == 0, "power of 2");
  constexpr int STAGES = V >= 32 ? 5 : V >= 16 ? 4 : V >= 8 ? 3
                         : V >= 4 ? 2 : V >= 2 ? 1 : 0;
#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    const int off = 16 >> st, half = V >> (st + 1);
    const bool up = lane & off;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = up ? v[k] : v[k + half];
      const float keep = up ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(FULL_MASK, send, off);
    }
  }
  float s = v[0];
#pragma unroll
  for (int off = 16 >> STAGES; off > 0; off >>= 1)
    s += __shfl_xor_sync(FULL_MASK, s, off);
  return s;
}

// NC > 0: the state width is the compile-time NC; NC == 0: n_rt <= NMAX
template <typename T, int NC>
__global__ void __launch_bounds__(NT)
selective_scan_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ h0, const T* __restrict__ dy,
    const float* __restrict__ dhT, T* __restrict__ dx, T* __restrict__ ddt,
    float* __restrict__ dbc, float* __restrict__ dA_part,
    float* __restrict__ dD_part, float* __restrict__ dh0,
    float* __restrict__ hT_out, float* __restrict__ ck, int S, int Di,
    int n_rt, long long bc_sb, long long bc_st, long long h0_sb) {
  constexpr int NM = NC > 0 ? NC : NMAX;
  constexpr int NPL = NM / LPC;               // states a warp
  constexpr int V = 2 * NPL;                  // dB and dC sums a step
  constexpr int SH = V >= 32 ? 0 : V >= 16 ? 1 : V >= 8 ? 2 : V >= 4 ? 3
                     : V >= 2 ? 4 : 5;        // lane_sums' index shift
  static_assert(NM % LPC == 0, "state split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NM>& sm = *reinterpret_cast<Smem<NM>*>(smem_raw);

  const int N = NC > 0 ? NC : n_rt;
  const int tid = threadIdx.x, lane = tid % 32, ch = lane, q = tid / 32;
  const int b = blockIdx.y, c0 = blockIdx.x * CB, c = c0 + ch;
  const bool live = c < Di;
  const int nck = (S + TS - 1) / TS, nblk = gridDim.x;
  const size_t row0 = (size_t)b * S;
  const T* Bb = Bm + (size_t)b * bc_sb;
  const T* Cb = Cm + (size_t)b * bc_sb;
  float* ckb = ck + (size_t)b * nck * N * Di;

  float a2[NPL], af[NPL], h[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = q * NPL + j;
    const bool on = live && n < N;
    af[j] = on ? A[(size_t)c * N + n] : 0.f;
    a2[j] = on ? A[(size_t)c * N + n] * LOG2E : 0.f;   // as the forward
    h[j] = (on && h0 != nullptr)
               ? h0[(size_t)b * h0_sb + (size_t)c * N + n] : 0.f;
  }
  const float d = live ? D[c] : 0.f;

  // chunk t0's x, dt and B (and, for the reverse walk, dy and C) as f32,
  // zero past S and past Di
  auto stage = [&](int t0, bool rev) {
    const int nt = min(TS, S - t0);
    for (int k = tid; k < TS * CB; k += NT) {
      const int tt = k / CB, cc = k % CB;
      const bool ok = tt < nt && c0 + cc < Di;
      const size_t o = (row0 + t0 + tt) * Di + c0 + cc;
      sm.xs[tt][cc] = ok ? to_f32(x[o]) : 0.f;
      sm.ds[tt][cc] = ok ? to_f32(dt[o]) : 0.f;
      if (rev) sm.gs[tt][cc] = ok ? to_f32(dy[o]) : 0.f;
    }
    for (int k = tid; k < TS * NM; k += NT) {
      const int tt = k / NM, n = k % NM;
      const bool ok = tt < nt && n < N;
      const size_t o = (size_t)(t0 + tt) * bc_st + n;
      sm.bs[tt][n] = ok ? to_f32(Bb[o]) : 0.f;
      if (rev) sm.cs[tt][n] = ok ? to_f32(Cb[o]) : 0.f;
    }
  };
  // one step of the forward kernel's recurrence, on this thread's states
  auto step = [&](float (&hh)[NPL], int tt) {
    const float xv = sm.xs[tt][ch], dv = sm.ds[tt][ch];
    const float dtx = dv * xv;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const float dA = ex2_approx(dv * a2[j]);
      hh[j] = hh[j] * dA + dtx * sm.bs[tt][q * NPL + j];
    }
  };

  // pass 1: the forward's steps from h0, the state before each chunk kept
  for (int k = 0; k < nck; ++k) {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = q * NPL + j;
      if (live && n < N) ckb[((size_t)k * N + n) * Di + c] = h[j];
    }
    __syncthreads();                          // the last chunk is read
    stage(k * TS, false);
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < TS; ++tt) step(h, tt);
  }
  if (hT_out != nullptr && live) {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = q * NPL + j;
      if (n < N) hT_out[((size_t)b * Di + c) * N + n] = h[j];
    }
  }

  // pass 2: the chunks in reverse
  float g[NPL], dAacc[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = q * NPL + j;
    g[j] = (live && n < N && dhT != nullptr)
               ? dhT[((size_t)b * Di + c) * N + n] : 0.f;
    dAacc[j] = 0.f;
  }
  float dDacc = 0.f;
  for (int k = nck - 1; k >= 0; --k) {
    const int t0 = k * TS, nt = min(TS, S - t0);
    __syncthreads();                          // the last chunk is read
    stage(t0, true);
    float hk[NPL], hh[NPL];
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = q * NPL + j;
      hk[j] = hh[j] = (live && n < N) ? ckb[((size_t)k * N + n) * Di + c]
                                      : 0.f;
    }
    __syncthreads();
    // the chunk's states, recomputed from its checkpoint
#pragma unroll
    for (int tt = 0; tt < TS; ++tt) {
      step(hh, tt);
#pragma unroll
      for (int j = 0; j < NPL; ++j) sm.sts[tt][j][tid] = hh[j];
    }
    // the reverse recurrence
#pragma unroll 2
    for (int tt = TS - 1; tt >= 0; --tt) {
      const float xv = sm.xs[tt][ch], dv = sm.ds[tt][ch];
      const float gy = sm.gs[tt][ch], dtx = dv * xv;
      float px = 0.f, pd = 0.f, v[V];
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int n = q * NPL + j;
        const float bt = sm.bs[tt][n], ct = sm.cs[tt][n];
        const float e = ex2_approx(dv * a2[j]);
        const float hp = tt > 0 ? sm.sts[max(tt - 1, 0)][j][tid] : hk[j];
        g[j] += gy * ct;
        px += g[j] * bt;
        pd += g[j] * (af[j] * e * hp + xv * bt);
        v[j] = g[j] * dtx;
        v[NPL + j] = gy * sm.sts[tt][j][tid];
        dAacc[j] += g[j] * dv * e * hp;
        g[j] *= e;
      }
      sm.px[q][tt][ch] = dv * px;
      sm.pd[q][tt][ch] = pd;
      if (q == 0) dDacc += gy * xv;
      const float s = lane_sums<V>(v, lane);
      const int idx = lane >> SH, n = q * NPL + idx % NPL;
      if (lane % (1 << SH) == 0 && tt < nt && n < N)
        dbc[((((size_t)b * nblk + blockIdx.x) * S + t0 + tt) * 2 +
             idx / NPL) * N + n] = s;
    }
    __syncthreads();
    // dx and ddt of the chunk: thread tid emits steps q, q + 4, ... of
    // its channel
    constexpr int PL = TS * CB;               // one warp's partial plane
#pragma unroll
    for (int tt = q; tt < TS; tt += LPC) {
      if (tt < nt && live) {
        const float* ppx = &sm.px[0][tt][ch];
        const float* ppd = &sm.pd[0][tt][ch];
        const size_t o = (row0 + t0 + tt) * Di + c;
        const float sx = (ppx[0] + ppx[PL]) + (ppx[2 * PL] + ppx[3 * PL]);
        dx[o] = from_f32<T>(d * sm.gs[tt][ch] + sx);
        const float sd = (ppd[0] + ppd[PL]) + (ppd[2 * PL] + ppd[3 * PL]);
        ddt[o] = from_f32<T>(sd);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = q * NPL + j;
      if (n >= N) continue;
      const size_t o = ((size_t)b * Di + c) * N + n;
      if (dh0 != nullptr) dh0[o] = g[j];
      if (dA_part != nullptr) dA_part[o] = dAacc[j];
    }
    if (q == 0 && dD_part != nullptr) dD_part[(size_t)b * Di + c] = dDacc;
  }
}

template <typename T, int NC>
cudaError_t launch_n(const void* x, const void* dt, const float* A,
                     const void* Bm, const void* Cm, const float* D,
                     const float* h0, const void* dy, const float* dhT,
                     void* dx, void* ddt, float* dbc, float* dA_part,
                     float* dD_part, float* dh0, float* hT_out, float* ck,
                     int batch, int S, int Di, int N, long long bc_sb,
                     long long bc_st, long long h0_sb, cudaStream_t stream) {
  constexpr int NM = NC > 0 ? NC : NMAX;
  constexpr int BYTES = sizeof(Smem<NM>);
  const cudaError_t raised =
      hopper::raise_smem<selective_scan_bwd_kernel<T, NC>, BYTES>();
  if (raised != cudaSuccess) return raised;
  dim3 grid((Di + CB - 1) / CB, batch);
  selective_scan_bwd_kernel<T, NC><<<grid, NT, BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), D, h0,
      static_cast<const T*>(dy), dhT, static_cast<T*>(dx),
      static_cast<T*>(ddt), dbc, dA_part, dD_part, dh0, hT_out, ck, S, Di,
      N, bc_sb, bc_st, h0_sb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D,
                   const float* h0, const void* dy, const float* dhT,
                   void* dx, void* ddt, float* dbc, float* dA_part,
                   float* dD_part, float* dh0, float* hT_out, float* ck,
                   int batch, int S, int Di, int N, long long bc_sb,
                   long long bc_st, long long h0_sb, cudaStream_t st) {
  if (N == 16)
    return launch_n<T, 16>(x, dt, A, Bm, Cm, D, h0, dy, dhT, dx, ddt, dbc,
                           dA_part, dD_part, dh0, hT_out, ck, batch, S, Di,
                           N, bc_sb, bc_st, h0_sb, st);
  if (N == 8)
    return launch_n<T, 8>(x, dt, A, Bm, Cm, D, h0, dy, dhT, dx, ddt, dbc,
                          dA_part, dD_part, dh0, hT_out, ck, batch, S, Di,
                          N, bc_sb, bc_st, h0_sb, st);
  return launch_n<T, 0>(x, dt, A, Bm, Cm, D, h0, dy, dhT, dx, ddt, dbc,
                        dA_part, dD_part, dh0, hT_out, ck, batch, S, Di, N,
                        bc_sb, bc_st, h0_sb, st);
}

}  // namespace

// Forward operands as selective_scan_launch takes them; dy (batch, S, Di)
// contiguous in x's dtype; dhT (batch, Di, N) f32 or null (zeros). Out: dx,
// ddt (batch, S, Di) in x's dtype; dbc (batch, ceil(Di / 32), S, 2, N) f32,
// the per-block partials of dB and dC; dA_part (batch, Di, N) and dD_part
// (batch, Di) f32 per-row partials, or null (not computed); dh0 (batch,
// Di, N) f32; hT_out (batch, Di, N) f32 or null; ck a (batch, ceil(S /
// 16), N, Di) f32 scratch. 1 <= N <= 16.
extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* h0, const void* dy,
    const void* dhT, void* dx, void* ddt, void* dbc, void* dA_part,
    void* dD_part, void* dh0, void* hT_out, void* ck, int batch, int S,
    int Di, int N, long long bc_sb, long long bc_st, long long h0_sb,
    int dtype, void* stream) {
  if (N < 1 || N > NMAX) return cudaErrorInvalidValue;
  if (batch == 0 || Di == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  if (dtype == DT_F32)
    return launch<float>(x, dt, f(A), Bm, Cm, f(D), f(h0), dy, f(dhT), dx,
                         ddt, w(dbc), w(dA_part), w(dD_part), w(dh0),
                         w(hT_out), w(ck), batch, S, Di, N, bc_sb, bc_st,
                         h0_sb, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, dt, f(A), Bm, Cm, f(D), f(h0), dy,
                                 f(dhT), dx, ddt, w(dbc), w(dA_part),
                                 w(dD_part), w(dh0), w(hT_out), w(ck), batch,
                                 S, Di, N, bc_sb, bc_st, h0_sb, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(selective_scan_bwd)
