// tracelint: kernel-op=rglru oracle=rglru
// RG-LRU recurrence, the Hopper replacement of the TPU kernel
// repro/kernels/rglru_scan.py::rglru_pallas (body _kernel):
//
//   log_a = -c softplus(-a_param)                 (per channel)
//   a_t = exp(sigmoid(r_t) log_a)
//   h = a_t h + sqrt(max(1 - a_t^2, 0)) (sigmoid(i_t) x_t)
//
// per batch row b and channel w, with the state in f32 across the whole
// sequence. Returns h_seq (B, S, W) in x's dtype and h_final (B, W) f32.
//
// What bounds it on an H100: bytes. x, r and i are read and h written once
// (8 bytes per element in bf16: 84 MB at B 8, S 512, W 2560, about 0.025
// ms at 3.35 TB/s), against 6 special-function operations per element
// (three powers of 2, two reciprocals, one square root: 63 M at 16 per
// clock per SM, about 0.015 ms) and a serial chain of S dependent
// multiply-adds per (row, channel), about 2 us at S 512.
//
// What the design does about it. The TPU kernel keeps a (1, block_w)
// state in VMEM scratch across a sequential grid axis of time chunks; here
// a block owns CB = 32 channels of one row and walks the sequence in tiles
// of TS steps (32 in bf16, 16 in f32: 2 KB an operand a tile), with NW
// warps and a ring AHEAD tiles deep from rglru_scan.plan: 4 warps and 2
// tiles where the grid fills the card (B 8, W 2560: 640 blocks, one wave
// of up to 5 an SM at 92 registers and 39 KB), 16 warps and 3 tiles for a
// small grid such as a one-row refill (80 blocks).
//
// (a) the tile's x, r and i are copied by cp.async into a ring of
//     AHEAD + 1 stages in shared memory, AHEAD tiles ahead of the tile
//     whose gates are computed, so no step waits on device memory. Rows
//     whose pitch is not a multiple of 16 bytes (or operands not 16-byte
//     aligned) take the element route instead: plain loads into the same
//     ring, element stores.
// (b) the gates do not depend on h, so all NW warps compute a tile's a_t
//     and u_t (f32) into shared memory, one channel a lane, warp q taking
//     steps q, q + NW, ...: NW times the threads of one thread a chain.
//     Each power of 2, reciprocal and square root is one special-function
//     instruction (ex2 / rcp / sqrt .approx.ftz): with the precise expf,
//     division and sqrtf the kernel took 0.0646 ms at B 8 at its best
//     plan, against 0.0421 (device time on an H100 at 700 W), and the
//     results stay within one bf16 ulp, 6e-7 in f32, of the precise
//     ones. Every step at or past S, and every channel past W, gets
//     a_t = 1 and u_t = 0 exactly. A zero-filled step would not do:
//     x = r = i = 0 gives a_t = 2^(l / 2) < 1 (l = log_a log2 e), and h
//     would decay.
// (c) one warp runs the chain of the tile, one lane a channel, from
//     shared memory, its operands read a group of 8 steps ahead:
//     h = a_t h + u_t, rounded as the plain version rounds it (no
//     contraction into an FMA) and in the TPU kernel's order. Each h is
//     staged in shared memory in the output dtype, and all warps store the
//     tile in 16-byte vectors. The chain of tile j runs on warp j % NW and
//     the state passes between tiles in shared memory, so every warp gets
//     the same share of chains.
// (d) one __syncthreads a tile: in iteration j one warp runs tile j's
//     chain, then all warps copy tile j + 1 + AHEAD into the ring, store
//     tile j - 1's h and compute tile j + 1's gates (a and u, and the h
//     staging, are double-buffered).
//
// (e) training: with a checkpoint buffer (B, ceil(S / 32), W) f32 the
//     chain warp also stores the state before every 32 steps (at the start
//     of a tile: every tile in bf16, every other one in f32), which the
//     backward (csrc/rglru_scan_bwd.cu) recomputes each chunk's states
//     from; a separate instance (CK) does so, and serving's (no buffer) is
//     the kernel without the stores.
//
// A padded column (r = -1e9: sigmoid 1 / inf = 0, a_t = 2^0 = 1, u_t = 0)
// multiplies by exactly 1 and adds exactly 0, so a padded row ends in its
// solo state bit for bit. Any S and any W are taken (the last channel
// block is masked). h0 is absent (zeros), per row (B, W), or one (W,)
// state shared by every row (batch stride 0).
#include "common.cuh"

namespace {

constexpr int CB = 32;      // channels a block, one a lane of the chain
constexpr int GRP = 8;      // chain steps whose operands are read together
constexpr int CK_STEPS = 32;  // steps between the checkpoints

template <typename T, int ST>
struct Smem {
  static constexpr int TS = 64 / (int)sizeof(T);   // time steps a tile
  T in[ST][3][TS][CB];     // the ring: x, r, i as loaded
  float a[2][TS][CB];      // a_t of a tile
  float u[2][TS][CB];      // u_t of a tile
  T hb[2][TS][CB];         // h of a tile, in the output dtype
  float h[CB];             // the state between tiles
};

constexpr float LOG2E = 1.4426950408889634f;

// the gates' special functions (rcp_approx, sqrt_approx, sigmoid_f,
// softplus_f) are in common.cuh, shared with the backward

// CK: store the state before every CK_STEPS steps into ck (B, ceil(S /
// CK_STEPS), W)
template <typename T, int NW, int AHEAD, bool CK>
__global__ void __launch_bounds__(NW * 32)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const T* __restrict__ ig, const float* __restrict__ a_param,
                  const float* __restrict__ h0, T* __restrict__ hs,
                  float* __restrict__ hT, float* __restrict__ ck, int S,
                  int W, long long h0_sb, float c, bool wide) {
  constexpr int NT = NW * 32, ST = AHEAD + 1;
  using Sm = Smem<T, ST>;
  constexpr int TS = Sm::TS;
  constexpr int VEC = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  constexpr int CH = CB / VEC;               // chunks a tile row
  constexpr int PER = TS * CH;               // chunks an operand's tile
  static_assert(TS % NW == 0 && TS % GRP == 0, "tile split");
  __shared__ __align__(16) Sm sm;

  const int tid = threadIdx.x, lane = tid % 32, q = tid / 32;
  const int b = blockIdx.y, c0 = blockIdx.x * CB, w = c0 + lane;
  const bool live = w < W;
  const size_t row0 = (size_t)b * S;
  const int nt = (S + TS - 1) / TS;
  // log_a in base 2: a_t = 2^(sigmoid(r_t) log_a log2 e)
  const float log_a2 = live ? -c * softplus_f(-a_param[w]) * LOG2E : 0.f;

  // tile j's x, r and i into stage j % ST (rows past S and channels past
  // W zero-filled); one commit group a tile, empty past the last
  auto issue = [&](int j) {
    if (j < nt) {
      T(*dst)[TS][CB] = sm.in[j % ST];
      const int t0 = j * TS, rows = min(TS, S - t0);
      if (wide) {
        for (int k = tid; k < 3 * PER; k += NT) {
          const int op = k / PER, tt = k % PER / CH, cv = k % CH * VEC;
          const bool ok = tt < rows && c0 + cv < W;
          const T* src = (op == 0 ? x : op == 1 ? r : ig) +
                         (row0 + t0 + tt) * W + c0 + cv;
          cp_async16(&dst[op][tt][cv], ok ? src : x, ok ? 16 : 0);
        }
      } else {
        for (int k = tid; k < 3 * TS * CB; k += NT) {
          const int op = k / (TS * CB), tt = k / CB % TS, cc = k % CB;
          T v = from_f32<T>(0.f);
          if (tt < rows && c0 + cc < W)
            v = (op == 0 ? x : op == 1 ? r : ig)[(row0 + t0 + tt) * W + c0 +
                                                 cc];
          dst[op][tt][cc] = v;
        }
      }
    }
    cp_async_commit();
  };
  // tile j's a_t and u_t, from its stage of the ring
  auto gates = [&](int j) {
    const T(*src)[TS][CB] = sm.in[j % ST];
    const int buf = j & 1, t0 = j * TS;
#pragma unroll
    for (int g = 0; g < TS / NW; ++g) {
      const int tt = q + g * NW;
      const float xv = to_f32(src[0][tt][lane]);
      const float rv = to_f32(src[1][tt][lane]);
      const float iv = to_f32(src[2][tt][lane]);
      const float at = ex2_approx(sigmoid_f(rv) * log_a2);
      const float ut = sqrt_approx(fmaxf(1.f - __fmul_rn(at, at), 0.f)) *
                       (sigmoid_f(iv) * xv);
      const bool on = live && t0 + tt < S;
      sm.a[buf][tt][lane] = on ? at : 1.f;
      sm.u[buf][tt][lane] = on ? ut : 0.f;
    }
  };
  // tile j's chain, on the calling warp: every step, padded ones too
  auto chain = [&](int j) {
    const int buf = j & 1;
    float h = sm.h[lane];
    if constexpr (CK) {
      if (j * TS % CK_STEPS == 0 && live)
        ck[((size_t)b * ((S + CK_STEPS - 1) / CK_STEPS) + j * TS / CK_STEPS)
           * W + w] = h;
    }
    float an[GRP], un[GRP];
#pragma unroll
    for (int k = 0; k < GRP; ++k) {
      an[k] = sm.a[buf][k][lane];
      un[k] = sm.u[buf][k][lane];
    }
#pragma unroll
    for (int g = 0; g < TS; g += GRP) {
      float ac[GRP], uc[GRP];
#pragma unroll
      for (int k = 0; k < GRP; ++k) {
        ac[k] = an[k];
        uc[k] = un[k];
      }
      if (g + GRP < TS) {
#pragma unroll
        for (int k = 0; k < GRP; ++k) {
          an[k] = sm.a[buf][g + GRP + k][lane];
          un[k] = sm.u[buf][g + GRP + k][lane];
        }
      }
#pragma unroll
      for (int k = 0; k < GRP; ++k) {
        h = __fadd_rn(__fmul_rn(ac[k], h), uc[k]);
        sm.hb[buf][g + k][lane] = from_f32<T>(h);
      }
    }
    sm.h[lane] = h;
  };
  // tile j's h from the staging buffer to hs: steps before S, channels
  // before W
  auto store = [&](int j) {
    const T(*hb)[CB] = sm.hb[j & 1];
    const int t0 = j * TS, rows = min(TS, S - t0);
    if (wide) {
      for (int k = tid; k < PER; k += NT) {
        const int tt = k / CH, cv = k % CH * VEC;
        if (tt < rows && c0 + cv < W)
          *reinterpret_cast<int4*>(hs + (row0 + t0 + tt) * W + c0 + cv) =
              *reinterpret_cast<const int4*>(&hb[tt][cv]);
      }
    } else {
      for (int k = tid; k < TS * CB; k += NT) {
        const int tt = k / CB, cc = k % CB;
        if (tt < rows && c0 + cc < W)
          hs[(row0 + t0 + tt) * W + c0 + cc] = hb[tt][cc];
      }
    }
  };

  if (tid < CB)
    sm.h[tid] = live && h0 != nullptr ? h0[(size_t)b * h0_sb + w] : 0.f;
#pragma unroll
  for (int j = 0; j <= AHEAD; ++j) issue(j);
  cp_async_wait<AHEAD>();                     // tile 0 has landed
  __syncthreads();
  if (nt > 0) gates(0);
  for (int j = 0; j < nt; ++j) {
    cp_async_wait<AHEAD - 1>();               // tile j + 1 has landed
    __syncthreads();
    if (q == j % NW) chain(j);
    issue(j + 1 + AHEAD);                     // into tile j's stage
    if (j > 0) store(j - 1);
    if (j + 1 < nt) gates(j + 1);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (nt > 0) store(nt - 1);
  if (tid < CB && live) hT[(size_t)b * W + w] = sm.h[tid];
}

template <typename T, int NW, int AHEAD>
cudaError_t launch(const void* x, const void* r, const void* ig,
                   const float* a_param, const float* h0, void* hs,
                   float* hT, float* ck, int batch, int S, int W,
                   long long h0_sb, float c, bool wide, cudaStream_t stream) {
  static_assert(sizeof(Smem<T, AHEAD + 1>) <= 48 * 1024,
                "static shared memory");
  dim3 grid((W + CB - 1) / CB, batch);
  auto kernel = ck != nullptr ? rglru_scan_kernel<T, NW, AHEAD, true>
                              : rglru_scan_kernel<T, NW, AHEAD, false>;
  kernel<<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(ig), a_param, h0, static_cast<T*>(hs), hT, ck, S,
      W, h0_sb, c, wide);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_plan(const void* x, const void* r, const void* ig,
                        const float* a_param, const float* h0, void* hs,
                        float* hT, float* ck, int batch, int S, int W,
                        long long h0_sb, float c, int warps, int ahead,
                        bool wide, cudaStream_t st) {
  if (wide && !(W * sizeof(T) % 16 == 0 && aligned16(x) && aligned16(r) &&
                aligned16(ig) && aligned16(hs)))
    return cudaErrorMisalignedAddress;
  if (warps == 4 && ahead == 2)
    return launch<T, 4, 2>(x, r, ig, a_param, h0, hs, hT, ck, batch, S, W,
                           h0_sb, c, wide, st);
  if (warps == 16 && ahead == 3)
    return launch<T, 16, 3>(x, r, ig, a_param, h0, hs, hT, ck, batch, S, W,
                            h0_sb, c, wide, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, r, ig (batch, S, W) contiguous in one dtype; a_param (W,) f32; h0 f32
// W-contiguous at batch stride h0_sb, or null; hs (batch, S, W) in x's
// dtype, hT (batch, W) f32; ck (batch, ceil(S / 32), W) f32, the state
// before every 32 steps, or null (not stored); warps, ahead and the route
// (wide: cp.async, else element loads) from rglru_scan.plan.
extern "C" int rglru_scan_launch(const void* x, const void* r,
                                 const void* ig, const void* a_param,
                                 const void* h0, void* hs, void* hT,
                                 void* ck, int batch, int S, int W,
                                 long long h0_sb,
                                 float c, int warps, int ahead, int wide,
                                 int dtype, void* stream) {
  if (batch == 0 || W == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a_param);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  float* ckf = static_cast<float*>(ck);
  if (dtype == DT_F32)
    return launch_plan<float>(x, r, ig, af, h0f, hs, hTf, ckf, batch, S, W,
                              h0_sb, c, warps, ahead, wide != 0, st);
  if (dtype == DT_BF16)
    return launch_plan<__nv_bfloat16>(x, r, ig, af, h0f, hs, hTf, ckf, batch,
                                      S, W, h0_sb, c, warps, ahead,
                                      wide != 0, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(rglru_scan)
