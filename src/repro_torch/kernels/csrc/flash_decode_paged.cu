// Paged flash decode: one query token per row against a block-pool KV cache
// addressed through a per-row block table, with the layer's prefix-KV slots
// in front. The Hopper replacement of the TPU kernel
// repro/kernels/flash_decode.py::flash_decode_paged_pallas (body
// _paged_kernel), which the TPU route takes only without a prefix bank;
// this kernel takes the prefix bank itself, so a paged drain never gathers
// a row's cache into a dense copy.
//
// Keys, in order: the n_p prefix slots (position -1, always visible), then
// cache positions 0 .. maxb * bs - 1, position t living at
// pool[table[b, t / bs], t % bs] (an entry >= n_blocks is the sentinel and
// is clamped into the pool: such slots lie past q_pos and are masked).
// Visibility is causal only: t is visible iff t <= q_pos[b].
//
// What bounds it on an H100: bytes, as for flash_decode.cu: each step reads
// every visible key of every row once for 4 * D flops per (query head, key).
// Design: flash_decode.cu's grid, one block per (KV head, row), the g query
// heads of the group riding along, and attn_tile.cuh's 32-key tiles and
// online softmax; only the tile loader differs, resolving each key's row
// through the table (PagedKV, attend_tiles' accessor). So the tiles, the
// skipped tiles and every sum are those of flash_decode.cu over
// cat(prefix, pool[table]) with kv_pos cat(-1, 0 .. maxb*bs-1): the two
// kernels agree bit for bit.
//
// Known limits, left for later: every thread resolves the table once per
// key it loads (an L1 hit, but 32 lookups per thread per tile), and the
// grid is B x Hkv blocks (32 at the paged drain's 8 rows x 4 KV heads on
// 132 SMs), as in the dense kernel.
//
// Grid: (Hkv, B); 4 warps, query head j of the group on warp j % 4. Head
// dims up to 128 (attn_tile.cuh's DM = 128 instance); no model that the
// paged engine pages has a larger one (recurrentgemma's head dim 256 is
// all local attention, which keeps its dense rolling buffer).
#include "attn_tile.cuh"

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

// q (B, Hq, D); k_pool / v_pool (n_blocks, bs, Hkv, D); table (B, maxb)
// int32; q_pos (B,) int32; prefix_k / prefix_v (B, n_p, Hkv, D) with
// prefix_per_row = 1, or (n_p, Hkv, D) shared with prefix_per_row = 0, or
// null with n_p = 0; out (B, Hq, D). Contiguous, one float dtype.
// bs a power of two, D <= 128, Hq / Hkv <= 16.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    const int* q_pos, const void* prefix_k, const void* prefix_v, void* out,
    int B, int n_blocks, int bs, int maxb, int n_p, int prefix_per_row,
    int Hq, int Hkv, int D, float scale, int dtype, void* stream) {
  if (D > DP || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX ||
      bs <= 0 || (bs & (bs - 1)) != 0 || n_blocks <= 0 || n_p < 0 ||
      (n_p > 0 && (prefix_k == nullptr || prefix_v == nullptr)))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  int bs_log2 = 0;
  while ((1 << bs_log2) < bs) ++bs_log2;
  const long long row_stride =
      prefix_per_row ? (long long)n_p * Hkv * D : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(q, k_pool, v_pool, table, q_pos, prefix_k, prefix_v,
                         out, B, n_blocks, bs_log2, maxb, n_p, row_stride, Hq,
                         Hkv, D, scale, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, q_pos, prefix_k,
                                 prefix_v, out, B, n_blocks, bs_log2, maxb,
                                 n_p, row_stride, Hq, Hkv, D, scale, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(flash_decode_paged)
