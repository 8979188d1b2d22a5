// tracelint: kernel-op=flash_decode oracle=decode_attention
// Flash decode: one query token per row against its KV cache, the Hopper
// replacement of the TPU kernel
// repro/kernels/flash_decode.py::flash_decode_pallas (body _kernel), whose
// grid (B, Hkv, KV chunks) walks the chunks in order, carrying (m, l, acc)
// in VMEM from one chunk to the next.
//
// What bounds it on an H100: bytes. Each decode step reads the whole
// visible cache of every row once (2 * D bf16 a key and KV head) for only
// 4 * D flops per (query head, key), far below the card's ~295 flops per
// byte.
//
// bf16 (every serving path): the split-KV tile of decode_split.cuh. The
// TPU's sequential chunk axis becomes parallel blocks, grid (splits, Hkv,
// B), each folding a run of 64-key tiles that TMA brings into a ring,
// with the group's query heads as the 16 rows of mma.sync products, and a
// combine in the block that finishes a (row, KV head) last. The prefix
// bank is read in place (its own tensor map), not concatenated in front
// of the cache. Instances for head dims up to 64, 128 and 256
// (vit-edge; qwen2-7b; recurrentgemma-2b).
//
// f32 (the token-exact checks; no serving path runs f32): the CUDA-core
// tile of attn_tile.cuh, unchanged: grid (Hkv, B), one block per (KV head,
// row) streaming its keys through 32-key tiles in shared memory, the g
// query heads of the group riding along; the wrapper concatenates a
// prefix bank in front of the cache. At head dims up to 128, 4 warps,
// query head j of the group on warp j % 4; up to 256, 8 warps (~82 KB of
// shared memory, dynamic). Up to 16 query heads per KV head either way.
#include "attn_tile.cuh"
#include "decode_split.cuh"

namespace {

constexpr int GMAX = 16;                // largest GQA group taken

template <typename T, int DM>
__global__ void __launch_bounds__(TileShape<DM>::NW * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, T* __restrict__ out,
                    float* __restrict__ lse, int T_len, int Hq, int Hkv,
                    int D, float scale, int causal, int window) {
  constexpr int NW = TileShape<DM>::NW, RPW = TileShape<DM>::RPW;
  constexpr int NI = DM / 32;
  BlockSmem<DM, GMAX>& blk = block_smem<DM, GMAX>();
  float* Qs = blk.Qs;
  int* qpos_s = blk.qpos;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int g = Hq / Hkv;
  const T* qg = q + ((long long)b * Hq + (long long)hk * g) * D;

  for (int idx = threadIdx.x; idx < g * D; idx += NW * 32) {
    const int r = idx / D, d = idx - r * D;
    Qs[r * DM + d] = to_f32(qg[(long long)r * D + d]);
  }
  if (threadIdx.x < g) qpos_s[threadIdx.x] = q_pos[b];
  __syncthreads();

  const long long kv_stride = (long long)Hkv * D;
  const long long base = (long long)b * T_len * kv_stride + (long long)hk * D;
  float acc[RPW][NI];
  attend_tiles<T, NW, RPW>(Qs, qpos_s, g, k + base, v + base, kv_stride,
                           kv_pos + (long long)b * T_len, T_len, D, scale,
                           causal, window, blk.sm, acc, Strided(),
                           lse == nullptr ? nullptr
                                          : lse + (long long)b * Hq +
                                                (long long)hk * g);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* og = out + ((long long)b * Hq + (long long)hk * g) * D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NW * i;
    if (r >= g) continue;
#pragma unroll
    for (int j = 0; j < NI; ++j)
      if (lane + 32 * j < D)
        og[(long long)r * D + lane + 32 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T, int DM>
cudaError_t launch_dm(const void* q, const void* k, const void* v,
                      const int* q_pos, const int* kv_pos, void* out,
                      float* lse, int B, int T_len, int Hq, int Hkv, int D,
                      float scale, int causal, int window,
                      cudaStream_t stream) {
  dim3 grid(Hkv, B);
  size_t smem;
  const cudaError_t e =
      dynamic_smem<DM, GMAX>(flash_decode_kernel<T, DM>, &smem);
  if (e != cudaSuccess) return e;
  flash_decode_kernel<T, DM><<<grid, TileShape<DM>::NW * 32, smem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), lse,
      T_len, Hq, Hkv, D, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, float* lse,
                   int B, int T_len, int Hq, int Hkv, int D, float scale,
                   int causal, int window, cudaStream_t stream) {
  if (D <= 128)
    return launch_dm<T, 128>(q, k, v, q_pos, kv_pos, out, lse, B, T_len, Hq,
                             Hkv, D, scale, causal, window, stream);
  return launch_dm<T, 256>(q, k, v, q_pos, kv_pos, out, lse, B, T_len, Hq,
                           Hkv, D, scale, causal, window, stream);
}

// The bf16 tile's layout checks: one block, one tile. QK: S (16 x 64) = q
// (16 x D) k (64 x D)ᵀ; PV: O (16 x D) = pm (16 x 64, bf16, loaded into
// the A fragment as fold_tile packs P) v (64 x D), each warp's 16 keys
// summed in warp order. out f32.
template <int DM>
__global__ void __launch_bounds__(decode_split::NT)
decode_probe_kernel(const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ pm, int D,
                    float* __restrict__ out) {
  using namespace decode_split;
  using Sh = Shape<DM>;
  const Smem sm = carve<DM>(1, 0);
  QRegs<DM> qr;
  qr.load(q, ROWS, D);
  qr.store(sm.work);
  __syncthreads();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, t4 = lane % 4, nkb = (D + 63) / 64;
  const int d16 = (D + 15) / 16;
  if (tid == 0) {
    const uint32_t bar = smem_addr(&sm.full[0]);
    mbar_expect_tx(bar, 2 * nkb * Sh::KV_BOX);
    for (int i = 0; i < nkb; ++i) {
      tma_load_4d(sm.ring + i * Sh::KV_BOX, &tmk, bar, 64 * i, 0, 0, 0);
      tma_load_4d(sm.ring + Sh::KV_BYTES + i * Sh::KV_BOX, &tmv, bar,
                  64 * i, 0, 0, 0);
    }
  }
  mbar_wait(smem_addr(&sm.full[0]), 0);
  if (pm == nullptr) {
    float s[2][4];
    warp_qk<DM>(s, sm.q, sm.ring, d16);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(gid + 8 * (e / 2)) * BN + 16 * warp + 8 * j + 2 * t4 +
            (e & 1)] = s[j][e];
    return;
  }
  const __nv_bfloat16* pr = pm + 16 * warp + 2 * t4;
  uint32_t pa[4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
    pa[x] = *reinterpret_cast<const uint32_t*>(
        pr + (gid + 8 * (x % 2)) * BN + 8 * (x / 2));
  float o[DM / 8][4];
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  warp_pv<DM>(o, pa, sm.ring + Sh::KV_BYTES, d16);
  __syncthreads();                 // Q and the ring become the warps' sums
  float* ow = reinterpret_cast<float*>(sm.work);
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ow[(warp * ROWS + gid + 8 * (e / 2)) * DM + 8 * n + 2 * t4 + (e & 1)] =
          o[n][e];
  __syncthreads();
  for (int idx = tid; idx < ROWS * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    float acc = 0.f;
    for (int w = 0; w < NW; ++w) acc += ow[(w * ROWS + r) * DM + d];
    out[idx] = acc;
  }
}

template <int DM>
cudaError_t probe_dm(const void* map_k, const void* map_v, const void* q,
                     const void* pm, int D, float* out, cudaStream_t st) {
  using namespace decode_split;
  constexpr int SMEM = static_cast<int>(smem_bytes<DM>(1, 0));
  cudaError_t e = raise_smem<decode_probe_kernel<DM>, SMEM>();
  if (e != cudaSuccess) return e;
  CUtensorMap mk, mv;
  memcpy(&mk, map_k, sizeof(mk));
  memcpy(&mv, map_v, sizeof(mv));
  decode_probe_kernel<DM><<<1, NT, SMEM, st>>>(
      mk, mv, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pm), D, out);
  return cudaGetLastError();
}

}  // namespace

// f32 only (the bf16 calls take flash_decode_bf16_launch): q (B, Hq, D),
// k/v (B, T, Hkv, D), out (B, Hq, D), contiguous; q_pos (B,), kv_pos
// (B, T) int32. D <= 256, Hq / Hkv <= 16. lse (B, Hq) f32 or null: each
// row's log-sum-exp of its visible scores (the partial mode: a row that
// sees no key gets -inf and a zero output).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const int* q_pos,
                                   const int* kv_pos, void* out, void* lse,
                                   int B, int T_len, int Hq, int Hkv, int D,
                                   float scale, int causal, int window,
                                   int dtype, void* stream) {
  if (D > DMAX || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX ||
      dtype != DT_F32)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  return launch<float>(q, k, v, q_pos, kv_pos, out, static_cast<float*>(lse),
                       B, T_len, Hq, Hkv, D, scale, causal, window,
                       static_cast<cudaStream_t>(stream));
}

// A tensor map of the bf16 tile (decode_split::encode_map) into out's 128
// bytes: (D, H, rows, nbatch), box 64 x 1 x box_rows x 1.
extern "C" int flash_decode_encode_map(void* out, const void* base, int D,
                                       int H, int rows, int nbatch,
                                       int box_rows) {
  return decode_split::encode_map(out, base, D, H, rows, nbatch, box_rows);
}

// bf16: q (B, Hq, D), out (B, Hq, D), contiguous; q_pos (B,), kv_pos
// (B, T) int32; maps (encode_map images) over k / v (B, T, Hkv, D) and the
// prefix bank (n_p, Hkv, D), or (B, n_p, Hkv, D) with prefix_per_row, or
// a stacked (n_slots, n_p, Hkv, D) bank with prefix_ids (B,) int32 naming
// each row's slot (any map when n_p == 0); work holds B * Hkv * n_splits * g * (D + 2) floats;
// counters B * Hkv ints, 0 (and left at 0). D % 8 == 0, D <= 256,
// Hq / Hkv <= 16; tps and n_splits from flash_decode.py::split_plan.
// lse (B, Hq) f32 or null, as in flash_decode_launch.
extern "C" int flash_decode_bf16_launch(
    const void* q, const int* q_pos, const int* kv_pos, void* out,
    void* lse, const void* map_k, const void* map_v, const void* map_pk,
    const void* map_pv, const int* prefix_ids, void* work, int* counters,
    int B, int T_len, int n_p, int prefix_per_row, int n_slots, int Hq,
    int Hkv, int D, float scale, int causal, int window, int tps,
    int n_splits, void* stream) {
  if (D > DMAX || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > GMAX || n_p < 0 || T_len < 0 ||
      (prefix_ids != nullptr && n_slots < 1))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int g = Hq / Hkv;
  decode_split::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.q_pos = q_pos;
  p.kv_pos = kv_pos;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.part_o = static_cast<float*>(work);
  p.part_ml = p.part_o + (long long)B * Hkv * n_splits * g * D;
  p.counters = counters;
  p.T = T_len;
  p.n_p = n_p;
  p.prefix_per_row = prefix_per_row;
  p.prefix_ids = prefix_ids;
  p.n_slots = n_slots;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.tps = tps;
  p.n_splits = n_splits;
  p.nkb = (D + 63) / 64;
  p.scale_log2 = scale * 1.4426950408889634f;
  const void* const maps[4] = {map_k, map_v, map_pk, map_pv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return decode_split::launch<64, false>(maps, p, B, st);
  if (D <= 128) return decode_split::launch<128, false>(maps, p, B, st);
  return decode_split::launch<256, false>(maps, p, B, st);
}

// The bf16 tile's layout checks (decode_probe_kernel): map_k / map_v over
// (64, D) bf16 tensors (H 1, rows 64, nbatch 1, box 64); q (16, D); pm
// null runs S = q kᵀ into out (16, 64), else O = pm v into out (16, D).
extern "C" int decode_split_probe_launch(const void* map_k,
                                         const void* map_v, const void* q,
                                         const void* pm, int D, void* out,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (D % 8 != 0 || D <= 0 || D > 256) return cudaErrorInvalidValue;
  if (D <= 64) return probe_dm<64>(map_k, map_v, q, pm, D, o, st);
  if (D <= 128) return probe_dm<128>(map_k, map_v, q, pm, D, o, st);
  return probe_dm<256>(map_k, map_v, q, pm, D, o, st);
}

DEFINE_ERROR_STRING(flash_decode)
