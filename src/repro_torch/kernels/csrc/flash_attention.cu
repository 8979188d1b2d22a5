// tracelint: kernel-op=flash_attention oracle=attention
// Flash attention for prefill (GQA, prefix-KV, sliding window, position
// masks), the Hopper replacement of the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body _kernel).
//
// What bounds it on an H100: the score and p @ V products, 4 * D flops per
// visible (query, key) pair (16 GFLOP for qwen2-7b's prefill of 8 x 512
// tokens: 0.016 ms at the bf16 tensor-core peak), or the bytes of q, k, v
// and out, each moved once (0.020 ms there). The causal triangle halves
// the pairs, and the visible pairs, not the bytes, set the work.
//
// What held the first version back (2.665 ms at that shape on an H100 at
// 700 W, 19x one library call): every product an f32 FMA on the CUDA
// cores, each lane scoring a key as a serial dot product that reads two
// shared-memory words per FMA, 16 query rows a block; bound by shared
// loads.
//
// What the design does: bf16 runs on the tensor cores (attn_wgmma.cuh):
// Q by TMA once, K / V tiles of 64 keys through a TMA ring, S = Q Kᵀ and
// O += P V by wgmma with P from registers, the online softmax on the
// accumulator fragment, 64 query rows a warpgroup (one warpgroup a block,
// two blocks an SM, at head dims up to 128; two warpgroups sharing each
// K / V tile at 256), and whole key tiles that no row can see skipped
// before they are loaded (the causal upper triangle, sentinel tails) while
// the prefix slots are always visited. It never forms the (S, T) score
// matrix in device memory. Instances DM = 64, 128, 256 for D <= 64, <=
// 128, <= 256 (vit-edge; qwen2-7b and llava; recurrentgemma-2b). f32
// keeps the CUDA-core tile of attn_tile.cuh (TF32 would round its
// operands): grid (ceil(S / 16), Hq, B), 16 query rows a block, 4 warps at
// head dims up to 128, 8 up to 256. GQA: query head h reads KV head
// h / (Hq / Hkv).
#include "attn_tile.cuh"
#include "attn_wgmma.cuh"

namespace {

constexpr int BQ = 16;              // query rows per block

template <typename T, int DM>
__global__ void __launch_bounds__(TileShape<DM>::NW * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, T* __restrict__ out,
                       int S, int T_len, int Hq, int Hkv, int D, float scale,
                       int causal, int window) {
  constexpr int NW = TileShape<DM>::NW, RPW = TileShape<DM>::RPW;
  constexpr int NI = DM / 32;
  BlockSmem<DM, BQ>& blk = block_smem<DM, BQ>();
  float* Qs = blk.Qs;
  int* qpos_s = blk.qpos;

  const int s0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nrows = min(BQ, S - s0);

  for (int idx = threadIdx.x; idx < BQ * D; idx += NW * 32) {
    const int r = idx / D, d = idx - r * D;
    Qs[r * DM + d] = r < nrows
        ? to_f32(q[(((long long)b * S + s0 + r) * Hq + h) * D + d]) : 0.f;
  }
  if (threadIdx.x < BQ)
    qpos_s[threadIdx.x] = threadIdx.x < nrows ? q_pos[s0 + threadIdx.x] : 0;
  __syncthreads();

  const long long kv_stride = (long long)Hkv * D;
  const long long base = (long long)b * T_len * kv_stride + (long long)hk * D;
  float acc[RPW][NI];
  attend_tiles<T, NW, RPW>(Qs, qpos_s, nrows, k + base, v + base, kv_stride,
                           kv_pos, T_len, D, scale, causal, window, blk.sm,
                           acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NW * i;
    if (r >= nrows) continue;
    T* orow = out + (((long long)b * S + s0 + r) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NI; ++j)
      if (lane + 32 * j < D) orow[lane + 32 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T, int DM>
cudaError_t launch_dm(const void* q, const void* k, const void* v,
                      const int* q_pos, const int* kv_pos, void* out, int B,
                      int S, int T_len, int Hq, int Hkv, int D, float scale,
                      int causal, int window, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  size_t smem;
  const cudaError_t e =
      dynamic_smem<DM, BQ>(flash_attention_kernel<T, DM>, &smem);
  if (e != cudaSuccess) return e;
  flash_attention_kernel<T, DM><<<grid, TileShape<DM>::NW * 32, smem,
                                  stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), S,
      T_len, Hq, Hkv, D, scale, causal, window);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* q_pos, const int* kv_pos, void* out, int B,
                       int S, int T_len, int Hq, int Hkv, int D, float scale,
                       int causal, int window, cudaStream_t stream) {
  if (D <= 128)
    return launch_dm<float, 128>(q, k, v, q_pos, kv_pos, out, B, S, T_len,
                                 Hq, Hkv, D, scale, causal, window, stream);
  return launch_dm<float, 256>(q, k, v, q_pos, kv_pos, out, B, S, T_len, Hq,
                               Hkv, D, scale, causal, window, stream);
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* out,
                        int B, int S, int T_len, int Hq, int Hkv, int D,
                        float scale, int causal, int window,
                        cudaStream_t stream) {
  if (D <= 64)
    return attn_wgmma::launch<64>(q, k, v, q_pos, kv_pos, out, B, S, T_len,
                                  Hq, Hkv, D, scale, causal, window, stream);
  if (D <= 128)
    return attn_wgmma::launch<128>(q, k, v, q_pos, kv_pos, out, B, S, T_len,
                                   Hq, Hkv, D, scale, causal, window, stream);
  return attn_wgmma::launch<256>(q, k, v, q_pos, kv_pos, out, B, S, T_len,
                                 Hq, Hkv, D, scale, causal, window, stream);
}

// The layout checks of the tensor-core tile: one block, one stage of the
// ring, f32 out. QK: S (BM x 64) = q (BM x D) k (64 x D)ᵀ, K-major B. PV:
// O (BM x D) = p (BM x 64, bf16, loaded into the A fragment) v (64 x D),
// N-major B.
template <int DM>
__global__ void __launch_bounds__(attn_wgmma::Shape<DM>::NT)
attn_probe_qk_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv, float* out) {
  using namespace attn_wgmma;
  const Smem sm = smem_setup<DM>(mask_words(BN));
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  if (tid == 0) {
    issue_q<DM>(sm, &tmq, 0, 0, 0);
    issue_kv<DM>(sm, &tmk, &tmv, 0, 0, 0, 0);
  }
  mbar_wait(smem_addr(sm.qbar), 0);
  mbar_wait(smem_addr(&sm.full[0]), 0);
  float sc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  wgmma_fence();
  mma_qk<DM>(sc, sm.q, sm.kv, wg);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(wg * 64 + frag_row(t, hh)) * BN + frag_col(t, i) + e] =
            sc[4 * i + 2 * hh + e];
}

template <int DM>
__global__ void __launch_bounds__(attn_wgmma::Shape<DM>::NT)
attn_probe_pv_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     const __nv_bfloat16* __restrict__ pm, int D,
                     float* out) {
  using namespace attn_wgmma;
  using Sh = Shape<DM>;
  const Smem sm = smem_setup<DM>(mask_words(BN));
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  if (tid == 0) issue_kv<DM>(sm, &tmk, &tmv, 0, 0, 0, 0);
  // element pairs of P as the kernel packs them from S's accumulator
  uint32_t pf[BN / 16][4];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pf[j][x] = *reinterpret_cast<const uint32_t*>(
          pm + (wg * 64 + frag_row(t, x % 2)) * BN + 16 * j + 8 * (x / 2) +
          2 * (t % 4));
  float o[DM / 2];
#pragma unroll
  for (int i = 0; i < DM / 2; ++i) o[i] = 0.f;
  mbar_wait(smem_addr(&sm.full[0]), 0);
  wgmma_fence();
  mma_pv<DM>(o, pf, sm.kv + Sh::KV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
  fence_frag(pf);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int i = 0; i < DM / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = frag_col(t, i) + e;
        if (col < D)
          out[(wg * 64 + frag_row(t, hh)) * D + col] = o[4 * i + 2 * hh + e];
      }
}

// One probe at instance DM: q (BM, D), k and v (64, D) bf16; pm (BM, 64)
// bf16 or null (QK); out f32.
template <int DM>
cudaError_t probe_dm(const void* q, const void* k, const void* v,
                     const void* pm, int D, float* out, cudaStream_t st) {
  using namespace attn_wgmma;
  using Sh = Shape<DM>;
  constexpr int SMEM = static_cast<int>(smem_bytes<DM>(BN)), NT = Sh::NT;
  CUtensorMap tmq, tmk, tmv;
  cudaError_t e = encode_maps<DM>(&tmq, &tmk, &tmv, q, k, v, 1, Sh::BM,
                                  BN, 1, 1, D);
  if (e != cudaSuccess) return e;
  if (pm == nullptr) {
    if ((e = raise_smem<attn_probe_qk_kernel<DM>, SMEM>()) != cudaSuccess)
      return e;
    attn_probe_qk_kernel<DM><<<1, NT, SMEM, st>>>(tmq, tmk, tmv, out);
  } else {
    if ((e = raise_smem<attn_probe_pv_kernel<DM>, SMEM>()) != cudaSuccess)
      return e;
    attn_probe_pv_kernel<DM><<<1, NT, SMEM, st>>>(
        tmq, tmk, tmv, static_cast<const __nv_bfloat16*>(pm), D, out);
  }
  return cudaGetLastError();
}

}  // namespace

// q (B, S, Hq, D), k/v (B, T, Hkv, D), out (B, S, Hq, D): contiguous, one
// dtype; q_pos (S,), kv_pos (T,) int32. D <= 256, Hq % Hkv == 0. bf16:
// D % 8 == 0 and 16-byte bases (the wrapper pads D and copies a
// misaligned base).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int* q_pos,
                                      const int* kv_pos, void* out, int B,
                                      int S, int T_len, int Hq, int Hkv,
                                      int D, float scale, int causal,
                                      int window, int dtype, void* stream) {
  if (D > DMAX || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_f32(q, k, v, q_pos, kv_pos, out, B, S, T_len, Hq, Hkv, D,
                      scale, causal, window, st);
  if (dtype == DT_BF16)
    return launch_bf16(q, k, v, q_pos, kv_pos, out, B, S, T_len, Hq, Hkv, D,
                       scale, causal, window, st);
  return cudaErrorInvalidValue;
}

// The tensor-core tile's layout checks (probe_dm): pm null runs S = q kᵀ
// into out (BM, 64), else O = pm v into out (BM, D); BM is
// attn_wgmma_block_rows(D). D % 8 == 0, <= 256.
extern "C" int attn_wgmma_probe_launch(const void* q, const void* k,
                                       const void* v, const void* pm, int D,
                                       void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (D <= 64) return probe_dm<64>(q, k, v, pm, D, o, st);
  if (D <= 128) return probe_dm<128>(q, k, v, pm, D, o, st);
  return probe_dm<256>(q, k, v, pm, D, o, st);
}

// Query rows a block of the bf16 instance that takes head dim D.
extern "C" int attn_wgmma_block_rows(int D) {
  using attn_wgmma::Shape;
  return D <= 64 ? Shape<64>::BM : D <= 128 ? Shape<128>::BM
                                            : Shape<256>::BM;
}

DEFINE_ERROR_STRING(flash_attention)
