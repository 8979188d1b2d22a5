// tracelint: kernel-op=rglru oracle=rglru
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
// operations an element (0.0044 ms) and two serial chains of S steps per
// (row, channel).
//
// Design: the forward kernel's structure, run backwards. A block owns CB
// = 32 channels of one row and NW warps (rglru_scan.bwd_plan: 8), and
// walks chunks of TS = 32 steps in reverse, three phases a chunk with a
// __syncthreads between them:
//
// (a) the chunk's x, r, i and dhs arrive by cp.async in a ring AHEAD
//     chunks ahead (rows past S and channels past W zero-filled; the
//     element route of plain loads where a row's pitch is not a multiple
//     of 16 bytes or an operand is unaligned).
// (b) gates: all warps compute the chunk's a_t, s_t, sigmoid(r_t) and
//     sigmoid(i_t) once into shared memory, one channel a lane, with the
//     forward's instructions (ex2 / rcp / sqrt .approx). Steps past S get
//     a_t = 1 and s_t = 0 (so u_t = 0), as the forward's gate stage.
// (c) chains: warp 0 runs the h chain from the chunk's checkpoint (the
//     state before the chunk, stored by the forward kernel and kept by
//     autograd; loaded a chunk ahead), h = a_t h + u_t with u_t = s_t
//     (sigmoid(i_t) x_t), one rounded product and one rounded add, as the
//     forward, so the last chunk's chain ends in the forward's h_final bit
//     for bit (hT_out, a test hook); it stages h_{t-1} for each step.
//     Warp 1 runs the g chain backwards at the same time, g += dhs_t,
//     staged, then g *= a_t, carried across chunks in its registers.
// (d) elementwise: all warps compute dx, di, dr and da_param's terms from
//     g_t, h_{t-1} and the gates, 16-byte vectors of channels a thread,
//     and store them as 16-byte vectors.
// So every input is loaded once and every gate computed once a call. The
// ring stage of a chunk is refilled after the chunk's elementwise phase:
// one issue a chunk, AHEAD chunks ahead.
//
// Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W; device time from
// torch.profiler, scripts/time_scan_kernels.py, the parent tree
// alternated) at the HFSL round's call (B 4, S 256, W 2560, bf16, a
// shared h0, no dh_final, a_param not asked): 35.7-35.9 us, against
// 103.8-103.9 for the first version (one thread a chain, every input
// loaded and every gate computed three times); 3.3x the 0.0110 ms bound.
// What holds it back, by reading the design: a block's three phases a
// chunk run in series between barriers, and in the chains' phase six of
// its eight warps wait; 320 blocks, ~2.4 an SM, leave those waits little
// to hide them. The forward's checkpoint stores cost it ~0.3 us at the
// same call (16.8-17.0 -> 17.3-17.4 us).
//
// A saturated gate keeps the reference's semantics: r = -1e9 (a ragged
// row's padding) gives sigmoid(r) = 0, a_t = 1 and s_t = 0, so
// -a / s = -1 / 0 = -inf: dr and da_param are not finite there, as
// autograd through the plain version and the reference's XLA gradient
// give them, while dx, di and dh0 stay finite (s_t = 0, g *= 1). A padded
// step passes g through unchanged (dhs = 0, a_t = 1) and h too, so a
// right-padded row's valid part gets the gradients of the row run alone.
// a_param's gradient is summed in a fixed order: each thread over its
// steps, then the threads of a channel in rising order, into a per-row
// partial (B, W) that the wrapper sums over the rows.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CB = 32;      // channels a block, one a lane of the chains
constexpr int TS = 32;      // steps a chunk (between checkpoints)
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int ST>
struct Smem {
  T in[ST][4][TS][CB];      // the ring: x, r, i, dhs as loaded
  float a[TS][CB];          // a_t (1 past S)
  float s[TS][CB];          // sqrt(max(1 - a_t^2, 0)) (0 past S)
  float si[TS][CB];         // sigmoid(i_t)
  float sr[TS][CB];         // sigmoid(r_t)
  float hg[2][TS][CB];      // h_{t-1} and g_t from the chains; at the end
                            // the threads' da_param partials
  float log_a[CB];          // a channel's log_a
};

template <typename T, int NW, int AHEAD>
__global__ void __launch_bounds__(NW * 32)
rglru_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                      const T* __restrict__ ig,
                      const float* __restrict__ a_param,
                      const float* __restrict__ ck,
                      const T* __restrict__ dhs,
                      const float* __restrict__ dhT, T* __restrict__ dx,
                      T* __restrict__ dr, T* __restrict__ di,
                      float* __restrict__ da_part, float* __restrict__ dh0,
                      float* __restrict__ hT_out, int S, int W, float c,
                      bool wide) {
  constexpr int NT = NW * 32, ST = AHEAD + 1;
  constexpr int VEC = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  constexpr int CH = CB / VEC;               // chunks a row of a chunk
  constexpr int PER = TS * CH;               // chunks an operand's chunk
  static_assert(TS % NW == 0 && NW >= 2, "gates over the warps, 2 chains");
  static_assert(NT * VEC <= 2 * TS * CB, "da_param partials in hg");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, ST>& sm = *reinterpret_cast<Smem<T, ST>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, q = tid / 32;
  const int b = blockIdx.y, c0 = blockIdx.x * CB, w = c0 + lane;
  const bool live = w < W;
  const size_t row0 = (size_t)b * S;
  const int nck = (S + TS - 1) / TS;
  const float p = live ? a_param[w] : 0.f;
  // as the forward: a_t = 2^(sigmoid(r_t) log_a log2 e)
  const float log_a = live ? -c * softplus_f(-p) : 0.f;
  const float log_a2 = log_a * LOG2E;
  if (tid < CB) sm.log_a[tid] = log_a;        // read after the first barrier

  // chunk nck - 1 - i into stage i % ST; one commit group a call, empty
  // past the first chunk
  auto issue = [&](int i) {
    if (i < nck) {
      T(*dst)[TS][CB] = sm.in[i % ST];
      const int t0 = (nck - 1 - i) * TS, rows = min(TS, S - t0);
      if (wide) {
        for (int k = tid; k < 4 * PER; k += NT) {
          const int op = k / PER, tt = k % PER / CH, cv = k % CH * VEC;
          const bool ok = tt < rows && c0 + cv < W;
          const T* src = (op == 0 ? x : op == 1 ? r : op == 2 ? ig : dhs) +
                         (row0 + t0 + tt) * W + c0 + cv;
          cp_async16(&dst[op][tt][cv], ok ? src : x, ok ? 16 : 0);
        }
      } else {
        for (int k = tid; k < 4 * TS * CB; k += NT) {
          const int op = k / (TS * CB), tt = k / CB % TS, cc = k % CB;
          T v = from_f32<T>(0.f);
          if (tt < rows && c0 + cc < W)
            v = (op == 0 ? x : op == 1 ? r : op == 2 ? ig : dhs)
                [(row0 + t0 + tt) * W + c0 + cc];
          dst[op][tt][cc] = v;
        }
      }
    }
    cp_async_commit();
  };

  float hn = 0.f;                             // warp 0: next checkpoint
  if (q == 0 && live && nck > 0)
    hn = ck[((size_t)b * nck + nck - 1) * W + w];
  float g = q == 1 && live && dhT != nullptr ? dhT[(size_t)b * W + w] : 0.f;
  float dp[VEC];                              // da_param partials
#pragma unroll
  for (int e = 0; e < VEC; ++e) dp[e] = 0.f;

#pragma unroll
  for (int j = 0; j < AHEAD; ++j) issue(j);
  for (int i = 0; i < nck; ++i) {
    const int k = nck - 1 - i, t0 = k * TS;
    const T(*in)[TS][CB] = sm.in[i % ST];
    cp_async_wait<AHEAD - 1>();               // chunk i has landed
    __syncthreads();                          // chunk i - 1 is done
    issue(i + AHEAD);                         // into chunk i - 1's stage
    // (b) the gates, warp q taking steps q, q + NW, ...
#pragma unroll
    for (int m = 0; m < TS / NW; ++m) {
      const int tt = q + m * NW;
      const float sr = sigmoid_f(to_f32(in[1][tt][lane]));
      const float si = sigmoid_f(to_f32(in[2][tt][lane]));
      const float at = ex2_approx(sr * log_a2);
      const float st = sqrt_approx(fmaxf(1.f - __fmul_rn(at, at), 0.f));
      const bool on = live && t0 + tt < S;
      sm.a[tt][lane] = on ? at : 1.f;
      sm.s[tt][lane] = on ? st : 0.f;
      sm.si[tt][lane] = si;
      sm.sr[tt][lane] = sr;
    }
    __syncthreads();
    // (c) the two chains
    if (q == 0) {
      float h = hn;
      if (k > 0 && live) hn = ck[((size_t)b * nck + k - 1) * W + w];
#pragma unroll
      for (int tt = 0; tt < TS; ++tt) {
        const float u = sm.s[tt][lane] *
                        (sm.si[tt][lane] * to_f32(in[0][tt][lane]));
        sm.hg[0][tt][lane] = h;
        h = __fadd_rn(__fmul_rn(sm.a[tt][lane], h), u);
      }
      if (i == 0 && hT_out != nullptr && live) hT_out[(size_t)b * W + w] = h;
    } else if (q == 1) {
#pragma unroll
      for (int tt = TS - 1; tt >= 0; --tt) {
        g += to_f32(in[3][tt][lane]);
        sm.hg[1][tt][lane] = g;
        g *= sm.a[tt][lane];
      }
    }
    __syncthreads();
    // (d) elementwise, VEC channels of one step a thread
    for (int v = tid; v < PER; v += NT) {
      const int tt = v / CH, cv = v % CH * VEC;
      if (t0 + tt >= S) continue;
      alignas(16) T ox[VEC], orr[VEC], oi[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int cc = cv + e;
        const float gv = sm.hg[1][tt][cc], hp = sm.hg[0][tt][cc];
        const float at = sm.a[tt][cc], st = sm.s[tt][cc];
        const float si = sm.si[tt][cc], sr = sm.sr[tt][cc];
        const float xv = to_f32(in[0][tt][cc]);
        const float gs = gv * st;
        // ds/da = -a / s where 1 - a^2 >= 0 (-inf at a saturated gate)
        const float dsda = 1.f - __fmul_rn(at, at) >= 0.f
                               ? -at * rcp_approx(st) : 0.f;
        const float da = gv * hp + gv * (si * xv) * dsda;
        ox[e] = from_f32<T>(gs * si);
        oi[e] = from_f32<T>(gs * xv * (si * (1.f - si)));
        orr[e] = from_f32<T>(da * at * sm.log_a[cc] * (sr * (1.f - sr)));
        dp[e] += da * at * sr;
      }
      const size_t o = (row0 + t0 + tt) * W + c0 + cv;
      if (wide) {
        if (c0 + cv < W) {
          *reinterpret_cast<int4*>(dx + o) = *reinterpret_cast<int4*>(ox);
          *reinterpret_cast<int4*>(dr + o) = *reinterpret_cast<int4*>(orr);
          *reinterpret_cast<int4*>(di + o) = *reinterpret_cast<int4*>(oi);
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (c0 + cv + e < W) {
            dx[o + e] = ox[e];
            dr[o + e] = orr[e];
            di[o + e] = oi[e];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (q == 1 && live && dh0 != nullptr) dh0[(size_t)b * W + w] = g;
  if (da_part != nullptr) {
    __syncthreads();
    float* parts = &sm.hg[0][0][0];           // (NT, VEC)
#pragma unroll
    for (int e = 0; e < VEC; ++e) parts[tid * VEC + e] = dp[e];
    __syncthreads();
    if (tid < CB && live) {
      // channel tid's partials: threads tid / VEC, + CH, ... in order
      float acc = 0.f;
      for (int t = tid / VEC; t < NT; t += CH)
        acc += parts[t * VEC + tid % VEC];
      da_part[(size_t)b * W + w] = acc * c * (1.f / (1.f + expf(p)));
    }
  }
}

template <typename T, int NW, int AHEAD>
cudaError_t launch(const void* x, const void* r, const void* ig,
                   const float* a_param, const float* ck, const void* dhs,
                   const float* dhT, void* dx, void* dr, void* di,
                   float* da_part, float* dh0, float* hT_out, int batch,
                   int S, int W, float c, bool wide, cudaStream_t stream) {
  constexpr int BYTES = sizeof(Smem<T, AHEAD + 1>);
  const cudaError_t raised =
      hopper::raise_smem<rglru_scan_bwd_kernel<T, NW, AHEAD>, BYTES>();
  if (raised != cudaSuccess) return raised;
  dim3 grid((W + CB - 1) / CB, batch);
  rglru_scan_bwd_kernel<T, NW, AHEAD><<<grid, NW * 32, BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(ig), a_param, ck, static_cast<const T*>(dhs),
      dhT, static_cast<T*>(dx), static_cast<T*>(dr), static_cast<T*>(di),
      da_part, dh0, hT_out, S, W, c, wide);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_plan(const void* x, const void* r, const void* ig,
                        const float* a_param, const float* ck,
                        const void* dhs, const float* dhT, void* dx,
                        void* dr, void* di, float* da_part, float* dh0,
                        float* hT_out, int batch, int S, int W, float c,
                        int warps, int ahead, bool wide, cudaStream_t st) {
  if (wide && !(W * sizeof(T) % 16 == 0 && aligned16(x) && aligned16(r) &&
                aligned16(ig) && aligned16(dhs) && aligned16(dx) &&
                aligned16(dr) && aligned16(di)))
    return cudaErrorMisalignedAddress;
  if (warps == 8 && ahead == 3)
    return launch<T, 8, 3>(x, r, ig, a_param, ck, dhs, dhT, dx, dr, di,
                           da_part, dh0, hT_out, batch, S, W, c, wide, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Forward operands as rglru_scan_launch takes them, h0 replaced by ck:
// (batch, ceil(S / 32), W) f32, the state before every 32 steps as the
// forward kernel stores it; dhs (batch, S, W) contiguous in x's dtype;
// dhT (batch, W) f32 or null (zeros). Out: dx, dr, di (batch, S, W) in
// x's dtype; da_part (batch, W) f32, a_param's per-row partial, or null
// (not computed); dh0 (batch, W) f32; hT_out (batch, W) f32 or null;
// warps, ahead and the route (wide: cp.async, else element loads) from
// rglru_scan.bwd_plan.
extern "C" int rglru_scan_bwd_launch(const void* x, const void* r,
                                     const void* ig, const void* a_param,
                                     const void* ck, const void* dhs,
                                     const void* dhT, void* dx, void* dr,
                                     void* di, void* da_part, void* dh0,
                                     void* hT_out, int batch, int S, int W,
                                     float c, int warps, int ahead, int wide,
                                     int dtype, void* stream) {
  if (batch == 0 || W == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  if (dtype == DT_F32)
    return launch_plan<float>(x, r, ig, f(a_param), f(ck), dhs, f(dhT), dx,
                              dr, di, w(da_part), w(dh0), w(hT_out), batch,
                              S, W, c, warps, ahead, wide != 0, st);
  if (dtype == DT_BF16)
    return launch_plan<__nv_bfloat16>(x, r, ig, f(a_param), f(ck), dhs,
                                      f(dhT), dx, dr, di, w(da_part),
                                      w(dh0), w(hT_out), batch, S, W, c,
                                      warps, ahead, wide != 0, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(rglru_scan_bwd)
