// tracelint: kernel-op=flash_decode_paged oracle=paged_decode_attention
// Paged flash decode: one query token per row against a block-pool KV cache
// addressed through a per-row block table, with the layer's prefix-KV slots
// in front. The Hopper replacement of the TPU kernel
// repro/kernels/flash_decode.py::flash_decode_paged_pallas (body
// _paged_kernel, one grid step per pool block through the scalar-prefetched
// table), which the TPU route takes only without a prefix bank; this kernel
// takes the prefix bank itself, so a paged drain never gathers a row's
// cache into a dense copy.
//
// Keys, in order: the n_p prefix slots (position -1, always visible), then
// cache positions 0 .. maxb * bs - 1, position t living at
// pool[table[b, t / bs], t % bs] (an entry >= n_blocks is the sentinel and
// is clamped into the pool: such slots lie past q_pos and are masked).
// Visibility is causal only: t is visible iff t <= q_pos[b].
//
// What bounds it on an H100: bytes, as for flash_decode.cu: each step reads
// every visible key of every row once for 4 * D flops per (query head, key).
//
// bf16 (every serving path): decode_split.cuh's split-KV tile with the
// paged loader: the pool is a 4-D tensor map over (D, Hkv, bs, n_blocks),
// a 64-key tile is 64 / bs boxes (one of 64 rows when bs >= 64) whose
// coordinate is the table entry, and a split's table entries are staged in
// shared memory once (clamped into the pool; keys past the table read the
// last pool block and are masked). Only the loads differ from the dense
// kernel: the tiles (the prefix in tiles of its own, then the cache from
// slot 0), the splits, the skipped tiles and every sum are those of
// flash_decode.cu over the prefix and pool[table], so the two kernels agree
// bit for bit. Head dims up to 64 and 128.
//
// f32 (the token-exact checks): attn_tile.cuh's CUDA-core tile, unchanged:
// grid (Hkv, B), one block per (KV head, row), the g query heads riding
// along, 32-key tiles resolving each key's row through the table
// (PagedKV, attend_tiles' accessor), bit for bit the dense f32 kernel on
// cat(prefix, pool[table]).
//
// Head dims up to 128: no model that the paged engine pages has a larger
// one (recurrentgemma's head dim 256 is all local attention, which keeps
// its dense rolling buffer).
#include "attn_tile.cuh"
#include "decode_split.cuh"

namespace {

constexpr int NW = 4;
constexpr int RPW = 4;
constexpr int GMAX = NW * RPW;          // largest GQA group taken
constexpr int DP = 128;                 // largest head dim taken
constexpr int NI = DP / 32;

// Keys of one (row, KV head): n_p prefix rows, then the pool through the
// row's table. Pointers are already offset to the KV head.
template <typename T>
struct PagedKV {
  static constexpr bool on = true;
  const T* __restrict__ pk;             // prefix key j at pk + j * kv_stride
  const T* __restrict__ pv;
  const T* __restrict__ k_pool;
  const T* __restrict__ v_pool;
  const int* __restrict__ table;        // this row's maxb entries
  int n_p, bs_log2, n_blocks;
  long long kv_stride;                  // Hkv * D

  __device__ __forceinline__ int pos(int t) const {
    return t < n_p ? -1 : t - n_p;
  }
  __device__ __forceinline__ long long pool_off(int u) const {
    const int blk = min(max(table[u >> bs_log2], 0), n_blocks - 1);
    const int bs = 1 << bs_log2;
    return ((long long)blk * bs + (u & (bs - 1))) * kv_stride;
  }
  __device__ __forceinline__ const T* krow(int t) const {
    return t < n_p ? pk + (long long)t * kv_stride : k_pool + pool_off(t - n_p);
  }
  __device__ __forceinline__ const T* vrow(int t) const {
    return t < n_p ? pv + (long long)t * kv_stride : v_pool + pool_off(t - n_p);
  }
};

template <typename T>
__global__ void __launch_bounds__(NW * 32)
flash_decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ table,
                          const int* __restrict__ q_pos,
                          const T* __restrict__ prefix_k,
                          const T* __restrict__ prefix_v, T* __restrict__ out,
                          int n_blocks, int bs_log2, int maxb, int n_p,
                          long long prefix_row_stride, int Hq, int Hkv, int D,
                          float scale) {
  __shared__ float Qs[GMAX * DP];
  __shared__ int qpos_s[GMAX];
  __shared__ AttnSmem<DP> sm;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int g = Hq / Hkv;
  const T* qg = q + ((long long)b * Hq + (long long)hk * g) * D;

  for (int idx = threadIdx.x; idx < g * D; idx += NW * 32) {
    const int r = idx / D, d = idx - r * D;
    Qs[r * DP + d] = to_f32(qg[(long long)r * D + d]);
  }
  if (threadIdx.x < g) qpos_s[threadIdx.x] = q_pos[b];
  __syncthreads();

  const long long kv_stride = (long long)Hkv * D;
  const long long pbase = (long long)b * prefix_row_stride + (long long)hk * D;
  PagedKV<T> kv;
  kv.pk = prefix_k + pbase;
  kv.pv = prefix_v + pbase;
  kv.k_pool = k_pool + (long long)hk * D;
  kv.v_pool = v_pool + (long long)hk * D;
  kv.table = table + (long long)b * maxb;
  kv.n_p = n_p;
  kv.bs_log2 = bs_log2;
  kv.n_blocks = n_blocks;
  kv.kv_stride = kv_stride;
  const int T_len = n_p + (maxb << bs_log2);
  float acc[RPW][NI];
  attend_tiles<T, NW, RPW>(Qs, qpos_s, g, nullptr, nullptr, 0, nullptr,
                           T_len, D, scale, /*causal=*/1, /*window=*/0, sm,
                           acc, kv);

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

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* table, const int* q_pos, const void* prefix_k,
                   const void* prefix_v, void* out, int B, int n_blocks,
                   int bs_log2, int maxb, int n_p, long long prefix_row_stride,
                   int Hq, int Hkv, int D, float scale, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  flash_decode_paged_kernel<T><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, q_pos,
      static_cast<const T*>(prefix_k), static_cast<const T*>(prefix_v),
      static_cast<T*>(out), n_blocks, bs_log2, maxb, n_p, prefix_row_stride,
      Hq, Hkv, D, scale);
  return cudaGetLastError();
}

}  // namespace

// f32 only (the bf16 calls take flash_decode_paged_bf16_launch): q (B, Hq,
// D); k_pool / v_pool (n_blocks, bs, Hkv, D); table (B, maxb) int32; q_pos
// (B,) int32; prefix_k / prefix_v (B, n_p, Hkv, D) with prefix_per_row = 1,
// or (n_p, Hkv, D) shared with prefix_per_row = 0, or null with n_p = 0;
// out (B, Hq, D). Contiguous. bs a power of two, D <= 128, Hq / Hkv <= 16.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    const int* q_pos, const void* prefix_k, const void* prefix_v, void* out,
    int B, int n_blocks, int bs, int maxb, int n_p, int prefix_per_row,
    int Hq, int Hkv, int D, float scale, int dtype, void* stream) {
  if (D > DP || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX ||
      bs <= 0 || (bs & (bs - 1)) != 0 || n_blocks <= 0 || n_p < 0 ||
      (n_p > 0 && (prefix_k == nullptr || prefix_v == nullptr)) ||
      dtype != DT_F32)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  int bs_log2 = 0;
  while ((1 << bs_log2) < bs) ++bs_log2;
  const long long row_stride =
      prefix_per_row ? (long long)n_p * Hkv * D : 0;
  return launch<float>(q, k_pool, v_pool, table, q_pos, prefix_k, prefix_v,
                       out, B, n_blocks, bs_log2, maxb, n_p, row_stride, Hq,
                       Hkv, D, scale, static_cast<cudaStream_t>(stream));
}

// A tensor map of the bf16 tile (decode_split::encode_map) into out's 128
// bytes: (D, H, rows, nbatch), box 64 x 1 x box_rows x 1.
extern "C" int flash_decode_paged_encode_map(void* out, const void* base,
                                             int D, int H, int rows,
                                             int nbatch, int box_rows) {
  return decode_split::encode_map(out, base, D, H, rows, nbatch, box_rows);
}

// bf16: q (B, Hq, D), out (B, Hq, D), contiguous; q_pos (B,), table
// (B, maxb) int32; maps (encode_map images) over the pools (n_blocks, bs,
// Hkv, D) with box min(bs, 64) rows, and the prefix bank (n_p, Hkv, D),
// or (B, n_p, Hkv, D) with prefix_per_row, or a stacked (n_slots, n_p,
// Hkv, D) bank with prefix_ids (B,) int32 naming each row's slot (any map
// when n_p == 0); work holds
// B * Hkv * n_splits * g * (D + 2) floats; counters B * Hkv ints, 0 (and
// left at 0). bs a power of two, D % 8 == 0, D <= 128, Hq / Hkv <= 16;
// tps and n_splits from flash_decode.py::split_plan, n_ent the most pool
// blocks a split spans.
extern "C" int flash_decode_paged_bf16_launch(
    const void* q, const int* q_pos, const int* table, void* out,
    const void* map_k, const void* map_v, const void* map_pk,
    const void* map_pv, const int* prefix_ids, void* work, int* counters,
    int B, int n_blocks, int bs, int maxb, int n_p, int prefix_per_row,
    int n_slots, int Hq, int Hkv, int D, float scale, int tps, int n_splits,
    int n_ent, void* stream) {
  if (D > DP || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > GMAX || bs <= 0 || (bs & (bs - 1)) != 0 || n_blocks <= 0 ||
      n_p < 0 || maxb < 0 || n_ent < 1 ||
      (prefix_ids != nullptr && n_slots < 1))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  int bs_log2 = 0;
  while ((1 << bs_log2) < bs) ++bs_log2;
  const int g = Hq / Hkv;
  decode_split::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.q_pos = q_pos;
  p.table = table;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part_o = static_cast<float*>(work);
  p.part_ml = p.part_o + (long long)B * Hkv * n_splits * g * D;
  p.counters = counters;
  p.T = maxb * bs;
  p.n_p = n_p;
  p.prefix_per_row = prefix_per_row;
  p.prefix_ids = prefix_ids;
  p.n_slots = n_slots;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.causal = 1;
  p.window = 0;
  p.bs = bs;
  p.bs_log2 = bs_log2;
  p.maxb = maxb;
  p.n_blocks = n_blocks;
  p.tps = tps;
  p.n_splits = n_splits;
  p.n_ent = n_ent;
  p.nkb = (D + 63) / 64;
  p.scale_log2 = scale * 1.4426950408889634f;
  const void* const maps[4] = {map_k, map_v, map_pk, map_pv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return decode_split::launch<64, true>(maps, p, B, st);
  return decode_split::launch<128, true>(maps, p, B, st);
}

DEFINE_ERROR_STRING(flash_decode_paged)
