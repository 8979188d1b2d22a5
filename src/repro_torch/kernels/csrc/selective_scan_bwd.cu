// tracelint: kernel-op=selective_scan oracle=selective_scan
// The VJP of the Mamba-1 selective scan (csrc/selective_scan.cu). No TPU
// kernel is replaced: the reference differentiates the scan through XLA
// (repro/kernels/ops.py::_selective_scan_assoc), so this kernel was added
// to keep a gradient through the scan on the card off the plain version.
//
// Forward, per batch row b, channel c and state n (f32 state):
//   e_t = exp(dt_t A);  h_t = h_{t-1} e_t + (dt_t x_t) B_t;
//   y_t = sum_n C_t h_t + D x_t
// Backward in time from g = dh_final (dL/dh_t):
//   g += dy_t C_t;  dx_t = D dy_t + dt_t sum_n g B_t;
//   ddt_t = sum_n A (g e_t) h_{t-1} + x_t sum_n g B_t;
//   dB_t = sum_c g dt_t x_t;  dC_t = sum_c dy_t h_t;
//   dA += dt_t (g e_t) h_{t-1};  dD += dy_t x_t;  g *= e_t;  dh0 = g.
//
// What bounds it on an H100: its f32 operations, ~18 a state and step
// (the forward's step, for the states, and the reverse step: 2.4 G at B
// 4, S 256, Di 8192, N 16, about 0.036 ms at 67 TFLOP/s), then the B S Di
// N exponentials through the special-function units (16 per clock per
// SM: 134 M, 0.032 ms taken once) and its bytes (x, dt and dy read, dx
// and ddt written, in bf16: about 84 MB, 0.025 ms).
//
// Design. The block is the forward's: 32 channels of one row, one a
// lane, a channel's N states over 4 warps (NPL = N / 4 a thread), the
// grid (Di / 32, B). Per state and step the work is a few f32 operations
// and one exponential, so what matters is how many instructions a
// state-step issues and that no step waits:
//
// (a) the forward writes the checkpoints. The forward kernel, given a
//     buffer (B, ceil(S / TS), N, Di) f32, stores the state before each
//     tile of TS = 16 steps; autograd keeps it for this kernel. So the
//     backward does not rerun the forward: each chunk of 16 steps is
//     recomputed once from its checkpoint (one exponential a
//     state-step), then walked in reverse (one more). The recompute
//     takes the forward's arithmetic (ex2.approx(dt A log2 e), then
//     ssm_step from common.cuh), so its states are the forward's bit for
//     bit: the last chunk's recompute ends in the forward's h_final
//     (hT_out, a test hook).
// (b) the chunks' x, dt, dy, B and C are copied by cp.async into a
//     4-stage ring two chunks ahead, in reverse time order, rows past S
//     zero-filled by the copy (the forward's issue scheme; element loads
//     where a row is unaligned), and each warp converts its B and C slice
//     to f32. One __syncthreads a chunk; the next chunk's checkpoint is
//     loaded into registers a chunk ahead. Zero-filled steps have dt = 0
//     and dy = 0: 2^0 = 1 and every term is 0, so chunks run unguarded.
// (c) the chunk's 16 states are kept in registers (NPL x 16 a thread),
//     so the reverse step reads no stored state from shared memory: h_t
//     and h_{t-1} are registers. The reverse step takes each exponential
//     again rather than keep the recompute's. ddt takes the product g e_t,
//     which the reverse step forms anyway, so the A e h_{t-1} term costs
//     two operations a state.
// (d) dA and dD are accumulated only in the instance that is asked for
//     them (AD); the training round asks for neither.
// (e) dB and dC: each warp-step sums its 2 NPL values over the 32 lanes
//     with a transposing butterfly (2 NPL - 1 + 5 - log2(2 NPL)
//     shuffles) into per-block partials (B, Di / 32, S, 2, N) that the
//     wrapper sums over the blocks.
//
// Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W; device time from
// torch.profiler, scripts/time_scan_kernels.py and
// scripts/time_scan_variants.py, the parent tree alternated) at the HFSL
// round's call (B 4, S 256, Di 8192, N 16, bf16, no dh_final, dA and dD
// not asked): 200.2-202.6 us, against 394.1-395.3 for the first version
// (the forward rerun from h0, each chunk staged by plain loads between
// two barriers, a chunk's states in shared memory). Variants of this
// kernel, each one change: the states in shared memory (a thread's in a
// row of its own, 85 KB a block, 2 blocks an SM) 305.5; the exponentials
// kept by the compiler for the reverse walk instead of taken again 208.3
// (registers spill); 3 blocks an SM (up to 170 registers, not 128)
// 199.8; B and C read as 16-byte words in place of the compiler's loads
// 207.6 (another call, the parent 392.1-393.9 there); two steps a
// butterfly 628-644 (its values went to local memory); the butterfly
// left out (wrong dB and dC, timing only) 147.5, so summing more channels
// inside a thread first could save at most ~54 us. What holds it back is
// what it issues: ~3,650 SASS instructions, nearly all in the loop body
// that walks one chunk of 16 steps and NPL = 4 states a thread, so ~57 a
// state-step, of which ~1,000 f32 (FMUL, FFMA, FADD), ~1,100 integer and
// address work, ~220 moves, ~540 shared-memory loads and stores and
// shuffles, 124 MUFU.EX2; 1.95x faster than the first
// version, 5.6x the 0.0361 ms bound. The forward's checkpoint stores cost
// it ~2.1 us at the same call (69.0-69.6 -> 71.6-71.7 us).
//
// Sums in a fixed order, so that every call gives the same bits: dx and
// ddt add the 4 warps' partials as ((p0 + p1) + (p2 + p3)) in shared
// memory (double-buffered, written out a chunk later), the butterfly's
// order is fixed, dA and dD accumulate over time in registers into
// per-row partials that the wrapper sums over the rows. A padded column
// (dt = 0, dy = 0) passes g through unchanged and adds exact zeros, so a
// right-padded row's valid part gets the gradients of the row run alone.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int LPC = 4;              // warps (state groups) a channel
constexpr int CB = 32;              // channels a block, one a lane
constexpr int NT = CB * LPC;        // threads a block
constexpr int TS = 16;              // steps a chunk (between checkpoints)
constexpr int ST = 4;               // stages of the ring
constexpr int NMAX = 16;            // largest state width
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int NM>
struct Smem {
  T xs[ST][TS][CB], ds[ST][TS][CB], gs[ST][TS][CB];   // x, dt, dy
  T bcs[ST][2][TS][NM];             // B, C as loaded
  float wbc[LPC][2][TS][NM / LPC];  // a warp's B and C slice, in f32
  float px[2][LPC][TS][CB];         // sum over a warp's states of g B
  float pd[2][LPC][TS][CB];         // ... of A (g e) h_{t-1}
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

// NC > 0: the state width is the compile-time NC; NC == 0: n_rt <= NMAX.
// AD: accumulate dA and dD.
template <typename T, int NC, bool AD>
__global__ void __launch_bounds__(NT, 4)
selective_scan_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ ck, const T* __restrict__ dy,
    const float* __restrict__ dhT, T* __restrict__ dx, T* __restrict__ ddt,
    float* __restrict__ dbc, float* __restrict__ dA_part,
    float* __restrict__ dD_part, float* __restrict__ dh0,
    float* __restrict__ hT_out, int S, int Di, int n_rt, long long bc_sb,
    long long bc_st) {
  constexpr int NM = NC > 0 ? NC : NMAX;
  constexpr int NPL = NM / LPC;               // states a warp
  constexpr int V = 2 * NPL;                  // dB and dC sums a step
  constexpr int SH = V >= 32 ? 0 : V >= 16 ? 1 : V >= 8 ? 2 : V >= 4 ? 3
                     : V >= 2 ? 4 : 5;        // lane_sums' index shift
  constexpr int VEC = 16 / (int)sizeof(T);    // elements a 16-byte chunk
  constexpr int CHK = CB / VEC;               // chunks a row of 32 channels
  constexpr int XC = TS * CHK;                // chunks of x (dt, dy) a stage
  constexpr int BCH = NM / VEC;               // B (and C) chunks a step
  constexpr int BC = TS * BCH;                // B (and C) chunks a stage
  static_assert(NM % LPC == 0 && NM % VEC == 0, "state split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, NM>& sm = *reinterpret_cast<Smem<T, NM>*>(smem_raw);

  const int N = NC > 0 ? NC : n_rt;
  const int tid = threadIdx.x, lane = tid % 32, ch = lane, q = tid / 32;
  const int b = blockIdx.y, c0 = blockIdx.x * CB, c = c0 + ch;
  const bool live = c < Di;
  const int nck = (S + TS - 1) / TS, nblk = gridDim.x;
  const size_t row0 = (size_t)b * S;
  const T* Bb = Bm + (size_t)b * bc_sb;
  const T* Cb = Cm + (size_t)b * bc_sb;
  const bool wide = Di % VEC == 0 && c0 + CB <= Di && aligned16(x) &&
                    aligned16(dt) && aligned16(dy);
  const bool bcwide = N == NM && bc_st % VEC == 0 && aligned16(Bb) &&
                      aligned16(Cb);
  const T zero = from_f32<T>(0.f);
  const float* ckb = ck + (size_t)b * nck * N * Di;

  float a2[NPL], af[NPL], g[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = q * NPL + j;
    const bool on = live && n < N;
    af[j] = on ? A[(size_t)c * N + n] : 0.f;
    a2[j] = af[j] * LOG2E;                    // as the forward
    g[j] = (on && dhT != nullptr) ? dhT[((size_t)b * Di + c) * N + n] : 0.f;
  }
  const float d = live ? D[c] : 0.f;

  // chunk nck - 1 - i into stage i % ST (rows past S and channels past Di
  // zero-filled); one commit group a call, empty past the first chunk
  auto issue = [&](int i) {
    if (i < nck) {
      const int st = i % ST, t0 = (nck - 1 - i) * TS, nt = min(TS, S - t0);
      const size_t base = (row0 + t0) * Di + c0;
      for (int k = tid; k < 3 * XC; k += NT) {
        const int op = k / XC, kk = k % XC, tt = kk / CHK;
        const int cv = kk % CHK * VEC;
        const T* src = (op == 0 ? x : op == 1 ? dt : dy) + base +
                       (size_t)tt * Di + cv;
        T* dst = op == 0 ? &sm.xs[st][tt][cv]
                 : op == 1 ? &sm.ds[st][tt][cv] : &sm.gs[st][tt][cv];
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
        T* dst = &sm.bcs[st][k < BC ? 0 : 1][tt][nv];
        if (bcwide) {
          cp_async16(dst, tt < nt ? src : Bb, tt < nt ? 16 : 0);
        } else {
          for (int v = 0; v < VEC; ++v)
            dst[v] = tt < nt && nv + v < N ? src[v] : zero;
        }
      }
    }
    cp_async_commit();
  };
  // the state before chunk k, this thread's states
  auto ckload = [&](int k, float (&h)[NPL]) {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = q * NPL + j;
      h[j] = live && n < N ? ckb[((size_t)k * N + n) * Di + c] : 0.f;
    }
  };
  // dx and ddt of the chunk walked in iteration i: thread tid emits steps
  // q, q + 4, ... of its channel
  auto emit = [&](int i) {
    const int st = i % ST, pb = i & 1, t0 = (nck - 1 - i) * TS;
    const int nt = min(TS, S - t0);
    constexpr int PL = TS * CB;               // one warp's partial plane
#pragma unroll
    for (int tt = q; tt < TS; tt += LPC) {
      if (tt < nt && live) {
        const float* ppx = &sm.px[pb][0][tt][ch];
        const float* ppd = &sm.pd[pb][0][tt][ch];
        const float sx = (ppx[0] + ppx[PL]) + (ppx[2 * PL] + ppx[3 * PL]);
        const float sd = (ppd[0] + ppd[PL]) + (ppd[2 * PL] + ppd[3 * PL]);
        const float gy = to_f32(sm.gs[st][tt][ch]);
        const float xv = to_f32(sm.xs[st][tt][ch]);
        const float dv = to_f32(sm.ds[st][tt][ch]);
        const size_t o = (row0 + t0 + tt) * Di + c;
        dx[o] = from_f32<T>(d * gy + dv * sx);
        ddt[o] = from_f32<T>(sd + xv * sx);
      }
    }
  };

  float hn[NPL], dAacc[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) dAacc[j] = 0.f;
  float dDacc = 0.f;
  issue(0);
  issue(1);
  if (nck > 0) ckload(nck - 1, hn);
  for (int i = 0; i < nck; ++i) {
    const int k = nck - 1 - i, st = i % ST, pb = i & 1, t0 = k * TS;
    const int nt = min(TS, S - t0);
    cp_async_wait<1>();                       // chunk i has landed
    __syncthreads();
    issue(i + 2);                             // into chunk i - 2's stage
    if (i > 0) emit(i - 1);
    float hk[NPL];
#pragma unroll
    for (int j = 0; j < NPL; ++j) hk[j] = hn[j];
    if (k > 0) ckload(k - 1, hn);             // a chunk ahead
    // this warp's B and C of the chunk, as f32
    for (int e = lane; e < 2 * TS * NPL; e += 32) {
      const int which = e / (TS * NPL), tt = e / NPL % TS, j = e % NPL;
      sm.wbc[q][which][tt][j] = to_f32(sm.bcs[st][which][tt][q * NPL + j]);
    }
    __syncwarp();
    const T* xb = &sm.xs[st][0][ch];
    const T* db = &sm.ds[st][0][ch];
    const T* gb = &sm.gs[st][0][ch];
    const float* bb = &sm.wbc[q][0][0][0];
    const float* cb = &sm.wbc[q][1][0][0];
    // the chunk's states from its checkpoint, as the forward steps
    float hr[TS][NPL];
    float h[NPL];
#pragma unroll
    for (int j = 0; j < NPL; ++j) h[j] = hk[j];
#pragma unroll
    for (int tt = 0; tt < TS; ++tt) {
      const float dv = to_f32(db[tt * CB]);
      const float dtx = dv * to_f32(xb[tt * CB]);
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        h[j] = ssm_step(h[j], ex2_approx(dv * a2[j]), dtx, bb[tt * NPL + j]);
        hr[tt][j] = h[j];
      }
    }
    if (i == 0 && hT_out != nullptr && live) {
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int n = q * NPL + j;
        if (n < N) hT_out[((size_t)b * Di + c) * N + n] = h[j];
      }
    }
    // the reverse recurrence; h_t is carried from the step after
    float* pxw = &sm.px[pb][q][0][ch];
    float* pdw = &sm.pd[pb][q][0][ch];
#pragma unroll
    for (int tt = TS - 1; tt >= 0; --tt) {
      const float xv = to_f32(xb[tt * CB]), dv = to_f32(db[tt * CB]);
      const float gy = to_f32(gb[tt * CB]), dtx = dv * xv;
      float px = 0.f, pd = 0.f, v[V];
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const float bt = bb[tt * NPL + j], ct = cb[tt * NPL + j];
        const float ht = h[j];
        h[j] = tt > 0 ? hr[tt > 0 ? tt - 1 : 0][j] : hk[j];   // h_{t-1}
        g[j] += gy * ct;
        px += g[j] * bt;
        v[j] = g[j] * dtx;
        v[NPL + j] = gy * ht;
        // e_t taken again: kept from the recompute, the exponentials
        // would take 64 more registers a thread
        g[j] *= ex2_approx_anew(dv * a2[j]);  // g e_t
        const float gh = g[j] * h[j];
        pd += af[j] * gh;
        if constexpr (AD) dAacc[j] += dv * gh;
      }
      pxw[tt * CB] = px;
      pdw[tt * CB] = pd;
      if constexpr (AD) {
        if (q == 0) dDacc += gy * xv;
      }
      const float s = lane_sums<V>(v, lane);
      const int idx = lane >> SH, n = q * NPL + idx % NPL;
      if (lane % (1 << SH) == 0 && tt < nt && n < N)
        dbc[((((size_t)b * nblk + blockIdx.x) * S + t0 + tt) * 2 +
             idx / NPL) * N + n] = s;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (nck > 0) emit(nck - 1);
  if (live) {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = q * NPL + j;
      if (n >= N) continue;
      const size_t o = ((size_t)b * Di + c) * N + n;
      dh0[o] = g[j];
      if constexpr (AD) {
        if (dA_part != nullptr) dA_part[o] = dAacc[j];
      }
    }
    if constexpr (AD) {
      if (q == 0 && dD_part != nullptr) dD_part[(size_t)b * Di + c] = dDacc;
    }
  }
}

template <typename T, int NC, bool AD>
cudaError_t launch_ad(const void* x, const void* dt, const float* A,
                      const void* Bm, const void* Cm, const float* D,
                      const float* ck, const void* dy, const float* dhT,
                      void* dx, void* ddt, float* dbc, float* dA_part,
                      float* dD_part, float* dh0, float* hT_out, int batch,
                      int S, int Di, int N, long long bc_sb, long long bc_st,
                      cudaStream_t stream) {
  constexpr int NM = NC > 0 ? NC : NMAX;
  constexpr int BYTES = sizeof(Smem<T, NM>);
  const cudaError_t raised =
      hopper::raise_smem<selective_scan_bwd_kernel<T, NC, AD>, BYTES>();
  if (raised != cudaSuccess) return raised;
  dim3 grid((Di + CB - 1) / CB, batch);
  selective_scan_bwd_kernel<T, NC, AD><<<grid, NT, BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), D, ck,
      static_cast<const T*>(dy), dhT, static_cast<T*>(dx),
      static_cast<T*>(ddt), dbc, dA_part, dD_part, dh0, hT_out, S, Di, N,
      bc_sb, bc_st);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_n(const void* x, const void* dt, const float* A,
                     const void* Bm, const void* Cm, const float* D,
                     const float* ck, const void* dy, const float* dhT,
                     void* dx, void* ddt, float* dbc, float* dA_part,
                     float* dD_part, float* dh0, float* hT_out, int batch,
                     int S, int Di, int N, long long bc_sb, long long bc_st,
                     cudaStream_t st) {
  if (dA_part != nullptr || dD_part != nullptr)
    return launch_ad<T, NC, true>(x, dt, A, Bm, Cm, D, ck, dy, dhT, dx, ddt,
                                  dbc, dA_part, dD_part, dh0, hT_out, batch,
                                  S, Di, N, bc_sb, bc_st, st);
  return launch_ad<T, NC, false>(x, dt, A, Bm, Cm, D, ck, dy, dhT, dx, ddt,
                                 dbc, dA_part, dD_part, dh0, hT_out, batch, S,
                                 Di, N, bc_sb, bc_st, st);
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D,
                   const float* ck, const void* dy, const float* dhT,
                   void* dx, void* ddt, float* dbc, float* dA_part,
                   float* dD_part, float* dh0, float* hT_out, int batch,
                   int S, int Di, int N, long long bc_sb, long long bc_st,
                   cudaStream_t st) {
  if (N == 16)
    return launch_n<T, 16>(x, dt, A, Bm, Cm, D, ck, dy, dhT, dx, ddt, dbc,
                           dA_part, dD_part, dh0, hT_out, batch, S, Di, N,
                           bc_sb, bc_st, st);
  if (N == 8)
    return launch_n<T, 8>(x, dt, A, Bm, Cm, D, ck, dy, dhT, dx, ddt, dbc,
                          dA_part, dD_part, dh0, hT_out, batch, S, Di, N,
                          bc_sb, bc_st, st);
  return launch_n<T, 0>(x, dt, A, Bm, Cm, D, ck, dy, dhT, dx, ddt, dbc,
                        dA_part, dD_part, dh0, hT_out, batch, S, Di, N,
                        bc_sb, bc_st, st);
}

}  // namespace

// Forward operands as selective_scan_launch takes them, h0 replaced by ck:
// (batch, ceil(S / 16), N, Di) f32, the state before every 16 steps as
// the forward kernel stores it; dy (batch, S, Di) contiguous in x's dtype;
// dhT (batch, Di, N) f32 or null (zeros). Out: dx, ddt (batch, S, Di) in
// x's dtype; dbc (batch, ceil(Di / 32), S, 2, N) f32, the per-block
// partials of dB and dC; dA_part (batch, Di, N) and dD_part (batch, Di)
// f32 per-row partials, or null (not computed); dh0 (batch, Di, N) f32;
// hT_out (batch, Di, N) f32 or null. 1 <= N <= 16.
extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* ck, const void* dy,
    const void* dhT, void* dx, void* ddt, void* dbc, void* dA_part,
    void* dD_part, void* dh0, void* hT_out, int batch, int S, int Di, int N,
    long long bc_sb, long long bc_st, int dtype, void* stream) {
  if (N < 1 || N > NMAX) return cudaErrorInvalidValue;
  if (batch == 0 || Di == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  if (dtype == DT_F32)
    return launch<float>(x, dt, f(A), Bm, Cm, f(D), f(ck), dy, f(dhT), dx,
                         ddt, w(dbc), w(dA_part), w(dD_part), w(dh0),
                         w(hT_out), batch, S, Di, N, bc_sb, bc_st, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, dt, f(A), Bm, Cm, f(D), f(ck), dy,
                                 f(dhT), dx, ddt, w(dbc), w(dA_part),
                                 w(dD_part), w(dh0), w(hT_out), batch, S, Di,
                                 N, bc_sb, bc_st, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(selective_scan_bwd)
