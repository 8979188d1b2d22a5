// The VJP of the RG-LRU recurrence (csrc/rglru_scan.cu). No TPU kernel is
// replaced: the reference differentiates the recurrence through XLA
// (repro/kernels/ops.py::_rglru_assoc), so this kernel was added to keep
// a gradient through it on the card off the plain version.
//
// Forward, per batch row b and channel w (f32 state), with
// log_a = -c softplus(-a_param) and s_t = sqrt(max(1 - a_t^2, 0)):
//   a_t = exp(sigmoid(r_t) log_a);  u_t = s_t sigmoid(i_t) x_t;
//   h_t = a_t h_{t-1} + u_t
// Backward in time from g = dh_final (dL/dh_t):
//   g += dhs_t;  dx = g s sigmoid(i);  di = g s x sigmoid'(i);
//   da = g h_{t-1} - g sigmoid(i) x a / s;  dr = da a log_a sigmoid'(r);
//   da_param += da a sigmoid(r) c sigmoid(-a_param);  g *= a_t;  dh0 = g.
//
// What bounds it on an H100: bytes. x, r, i and dhs are read and dx, dr,
// di written once (14 bytes an element in bf16: 37 MB at B 4, S 256, W
// 2560, about 0.011 ms at 3.35 TB/s), against 7 special-function
// operations an element (0.0044 ms) and a serial chain of S steps per
// (row, channel).
//
// Design: a simple kernel, right first. One thread a chain (row b,
// channel w), NT channels of one row a block. The f32 states are not
// saved by the forward (hs comes back in x's dtype): the thread reruns the
// forward's chain from h0 and keeps the state before every chunk of TS
// steps in a global scratch (B, S / TS, W) f32; then it walks the chunks
// in reverse, recomputes a chunk's states from its checkpoint into shared
// memory, and runs the reverse recurrence over them. The gates are
// recomputed with the forward kernel's arithmetic (ex2 / rcp / sqrt
// .approx, a_t^2 and the chain's multiply-add unfused), so the rerun's
// final state is the forward kernel's h_final bit for bit (hT_out, a test
// hook). Steps past S are not run (the forward's are the identity there).
//
// A saturated gate keeps the reference's semantics: r = -1e9 (a ragged
// row's padding) gives sigmoid(r) = 0, a_t = 1 and s_t = 0, so
// -a / s = -1 / 0 = -inf: dr and da_param are not finite there, as
// autograd through the plain version and the reference's XLA gradient
// give them, while dx, di and dh0 stay finite (s_t = 0, g *= 1). a_param's
// gradient is a per-row partial (B, W) that the wrapper sums over the
// rows, in a fixed order.
#include "common.cuh"

namespace {

constexpr int NT = 32;      // channels a block, one a thread
constexpr int TS = 32;      // steps a chunk (between checkpoints)
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                      const T* __restrict__ ig,
                      const float* __restrict__ a_param,
                      const float* __restrict__ h0,
                      const T* __restrict__ dhs,
                      const float* __restrict__ dhT, T* __restrict__ dx,
                      T* __restrict__ dr, T* __restrict__ di,
                      float* __restrict__ da_part, float* __restrict__ dh0,
                      float* __restrict__ hT_out, float* __restrict__ ck,
                      int S, int W, long long h0_sb, float c) {
  __shared__ float hsm[TS][NT];               // a chunk's states

  const int tid = threadIdx.x, b = blockIdx.y;
  const int w = blockIdx.x * NT + tid;
  if (w >= W) return;                         // no barrier below
  const int nck = (S + TS - 1) / TS;
  const size_t row0 = (size_t)b * S;
  const float p = a_param[w];
  // as the forward: a_t = 2^(sigmoid(r_t) log_a log2 e)
  const float log_a2 = -c * softplus_f(-p) * LOG2E;
  const float log_a = -c * softplus_f(-p);
  float* ckb = ck + (size_t)b * nck * W;

  struct Gate {
    float a, u, sr, si, s, v, xv;
  };
  // step t's gates, as the forward kernel computes them
  auto gate = [&](int t) {
    const size_t o = (row0 + t) * W + w;
    Gate G;
    G.xv = to_f32(x[o]);
    G.sr = sigmoid_f(to_f32(r[o]));
    G.si = sigmoid_f(to_f32(ig[o]));
    G.a = ex2_approx(G.sr * log_a2);
    G.v = 1.f - __fmul_rn(G.a, G.a);
    G.s = sqrt_approx(fmaxf(G.v, 0.f));
    G.u = G.s * (G.si * G.xv);
    return G;
  };

  // pass 1: the forward's chain from h0, the state before each chunk kept
  float h = h0 != nullptr ? h0[(size_t)b * h0_sb + w] : 0.f;
  for (int k = 0; k < nck; ++k) {
    const int t0 = k * TS, nt = min(TS, S - t0);
    ckb[(size_t)k * W + w] = h;
#pragma unroll 8
    for (int tt = 0; tt < nt; ++tt) {
      const Gate G = gate(t0 + tt);
      h = __fadd_rn(__fmul_rn(G.a, h), G.u);
    }
  }
  if (hT_out != nullptr) hT_out[(size_t)b * W + w] = h;

  // pass 2: the chunks in reverse
  float g = dhT != nullptr ? dhT[(size_t)b * W + w] : 0.f;
  float dp = 0.f;                             // sum of da a sigmoid(r)
  for (int k = nck - 1; k >= 0; --k) {
    const int t0 = k * TS, nt = min(TS, S - t0);
    const float hk = ckb[(size_t)k * W + w];
    float hh = hk;
#pragma unroll 8
    for (int tt = 0; tt < nt; ++tt) {
      const Gate G = gate(t0 + tt);
      hh = __fadd_rn(__fmul_rn(G.a, hh), G.u);
      hsm[tt][tid] = hh;
    }
#pragma unroll 4
    for (int tt = nt - 1; tt >= 0; --tt) {
      const Gate G = gate(t0 + tt);
      const size_t o = (row0 + t0 + tt) * W + w;
      const float hp = tt > 0 ? hsm[max(tt - 1, 0)][tid] : hk;
      g += to_f32(dhs[o]);
      const float gs = g * G.s;
      // ds/da = -a / s where 1 - a^2 >= 0 (-inf at a saturated gate)
      const float dsda = G.v >= 0.f ? -G.a * rcp_approx(G.s) : 0.f;
      const float da = g * hp + g * (G.si * G.xv) * dsda;
      dx[o] = from_f32<T>(gs * G.si);
      di[o] = from_f32<T>(gs * G.xv * (G.si * (1.f - G.si)));
      dr[o] = from_f32<T>(da * G.a * log_a * (G.sr * (1.f - G.sr)));
      dp += da * G.a * G.sr;
      g *= G.a;
    }
  }
  if (dh0 != nullptr) dh0[(size_t)b * W + w] = g;
  if (da_part != nullptr)
    da_part[(size_t)b * W + w] = dp * c * (1.f / (1.f + expf(p)));
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const void* ig,
                   const float* a_param, const float* h0, const void* dhs,
                   const float* dhT, void* dx, void* dr, void* di,
                   float* da_part, float* dh0, float* hT_out, float* ck,
                   int batch, int S, int W, long long h0_sb, float c,
                   cudaStream_t stream) {
  dim3 grid((W + NT - 1) / NT, batch);
  rglru_scan_bwd_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(ig), a_param, h0, static_cast<const T*>(dhs),
      dhT, static_cast<T*>(dx), static_cast<T*>(dr), static_cast<T*>(di),
      da_part, dh0, hT_out, ck, S, W, h0_sb, c);
  return cudaGetLastError();
}

}  // namespace

// Forward operands as rglru_scan_launch takes them; dhs (batch, S, W)
// contiguous in x's dtype; dhT (batch, W) f32 or null (zeros). Out: dx,
// dr, di (batch, S, W) in x's dtype; da_part (batch, W) f32, a_param's
// per-row partial, or null (not computed); dh0 (batch, W) f32; hT_out
// (batch, W) f32 or null; ck a (batch, ceil(S / 32), W) f32 scratch.
extern "C" int rglru_scan_bwd_launch(const void* x, const void* r,
                                     const void* ig, const void* a_param,
                                     const void* h0, const void* dhs,
                                     const void* dhT, void* dx, void* dr,
                                     void* di, void* da_part, void* dh0,
                                     void* hT_out, void* ck, int batch,
                                     int S, int W, long long h0_sb, float c,
                                     int dtype, void* stream) {
  if (batch == 0 || W == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  if (dtype == DT_F32)
    return launch<float>(x, r, ig, f(a_param), f(h0), dhs, f(dhT), dx, dr,
                         di, w(da_part), w(dh0), w(hT_out), w(ck), batch, S,
                         W, h0_sb, c, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, r, ig, f(a_param), f(h0), dhs, f(dhT),
                                 dx, dr, di, w(da_part), w(dh0), w(hT_out),
                                 w(ck), batch, S, W, h0_sb, c, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(rglru_scan_bwd)
