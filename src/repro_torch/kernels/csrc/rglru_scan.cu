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
// ms at 3.35 TB/s), against about 6 special-function operations per
// element (three exponentials, two reciprocals, one square root: 63 M at 16
// per clock per SM, about 0.015 ms). The recurrence is a chain over time,
// and one thread per (row, channel) gives only B W = 20,480 chains, about
// 5 warps per SM, so a first version is latency-bound on memory and on
// that chain.
//
// What the design does about it. The TPU kernel keeps a (1, block_w)
// state in VMEM scratch across a sequential grid axis of time chunks; here
// one thread owns one (b, w) pair and keeps its state in a register for the
// whole sequence, and the chunk axis becomes a loop over tiles of TS steps
// inside the thread. Neighbouring threads take neighbouring channels, so
// every load and store is coalesced. The gates do not depend on h, so only
// one multiply-add per step is serial: each tile's x, r and i are loaded
// into registers one tile ahead (the loads of tile j + 1 are in flight
// while tile j's gates and chain are computed), the tile's gates are
// computed together (independent work for the special-function units),
// and then the chain runs over the tile. The chain and 1 - a_t^2 are
// rounded as the plain version rounds them (no contraction into an FMA),
// in the TPU kernel's order: a padded column (r = -1e9: sigmoid 0, a_t = 1)
// multiplies by exactly 1 and adds exactly 0, so a padded row ends in its
// solo state bit for bit. Any S and any W are taken (the last channel
// block is masked). Blocks of 64 threads spread the 320 blocks of the full
// size over all 132 SMs.
//
// h0 is absent (zeros), per row (B, W), or one (W,) state shared by every
// row (batch stride 0).
#include "common.cuh"

namespace {

constexpr int NT = 64;      // channels per block, one per thread
constexpr int TS = 16;      // time steps per register tile

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

// torch.nn.functional.softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus_f(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const T* __restrict__ ig, const float* __restrict__ a_param,
                  const float* __restrict__ h0, T* __restrict__ hs,
                  float* __restrict__ hT, int S, int W, long long h0_sb,
                  float c) {
  const int b = blockIdx.y;
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;                  // no block-wide synchronisation
  const float log_a = -c * softplus_f(-a_param[w]);
  float h = h0 != nullptr ? h0[(size_t)b * h0_sb + w] : 0.f;
  const size_t base = (size_t)b * S * W + w;

  T xn[TS], rn[TS], in[TS];            // the next tile, in flight
  auto load = [&](int t0) {
#pragma unroll
    for (int tt = 0; tt < TS; ++tt) {
      const bool ok = t0 + tt < S;
      const size_t o = base + (size_t)(t0 + tt) * W;
      xn[tt] = ok ? x[o] : from_f32<T>(0.f);
      rn[tt] = ok ? r[o] : from_f32<T>(0.f);
      in[tt] = ok ? ig[o] : from_f32<T>(0.f);
    }
  };
  load(0);
  for (int t0 = 0; t0 < S; t0 += TS) {
    float a[TS], u[TS];
#pragma unroll
    for (int tt = 0; tt < TS; ++tt) {
      const float at = expf(sigmoid_f(to_f32(rn[tt])) * log_a);
      a[tt] = at;
      u[tt] = sqrtf(fmaxf(1.f - __fmul_rn(at, at), 0.f))
              * (sigmoid_f(to_f32(in[tt])) * to_f32(xn[tt]));
    }
    if (t0 + TS < S) load(t0 + TS);    // in flight while the chain runs
#pragma unroll
    for (int tt = 0; tt < TS; ++tt) {
      if (t0 + tt < S) {
        h = __fadd_rn(__fmul_rn(a[tt], h), u[tt]);
        hs[base + (size_t)(t0 + tt) * W] = from_f32<T>(h);
      }
    }
  }
  hT[(size_t)b * W + w] = h;
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const void* ig,
                   const float* a_param, const float* h0, void* hs,
                   float* hT, int batch, int S, int W, long long h0_sb,
                   float c, cudaStream_t stream) {
  dim3 grid((W + NT - 1) / NT, batch);
  rglru_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(ig), a_param, h0, static_cast<T*>(hs), hT, S,
      W, h0_sb, c);
  return cudaGetLastError();
}

}  // namespace

// x, r, ig (batch, S, W) contiguous in one dtype; a_param (W,) f32; h0 f32
// W-contiguous at batch stride h0_sb, or null; hs (batch, S, W) in x's
// dtype, hT (batch, W) f32.
extern "C" int rglru_scan_launch(const void* x, const void* r,
                                 const void* ig, const void* a_param,
                                 const void* h0, void* hs, void* hT,
                                 int batch, int S, int W, long long h0_sb,
                                 float c, int dtype, void* stream) {
  if (batch == 0 || W == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a_param);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  if (dtype == DT_F32)
    return launch<float>(x, r, ig, af, h0f, hs, hTf, batch, S, W, h0_sb, c,
                         st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, r, ig, af, h0f, hs, hTf, batch, S, W,
                                 h0_sb, c, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(rglru_scan)
