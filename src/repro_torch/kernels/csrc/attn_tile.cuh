// Online-softmax attention over 32-key tiles, shared by flash_attention.cu
// (prefill) and flash_decode.cu (one query per row).
//
// A block holds up to NW * RPW query rows of one (batch, KV head) pair in
// shared memory (f32). Warp w owns rows w, w + NW, w + 2 NW, ...; lane i of
// the warp owns head dims i, i + 32, i + 64, i + 96 of the f32 accumulator,
// and, during a tile, the score of key i of the tile. So one warp scores 32
// keys at once (each lane a full dot product against the K tile, stored
// with a padded row so that the 32 lanes hit 32 banks), reduces max and sum
// with shuffles, and folds p @ V into its accumulator reading V rows that
// the 32 lanes read as consecutive words.
//
// Masking is position based (kernels/ref.py): a key is visible iff
// kv_pos < 0 (prefix slot) or (causal ? kv_pos <= q_pos : kv_pos < 1e8)
// and, with a window, q_pos - kv_pos < window. Differences are taken in
// 64-bit so the +1e9 sentinel cannot overflow. A masked score is -1e30
// (NEG_INF), as in the TPU kernel, so a row that sees nothing yet averages
// uniformly, exactly as the reference softmax does. A key past the end of
// the cache scores -inf and weighs exactly 0.
//
// A tile is skipped (neither loaded nor folded) when no row of the block
// sees any of its keys and every row has already seen a visible key: for
// such a row the tile's p is exp(-1e30 - m) == 0, so skipping is exact.
// This keeps the causal upper triangle out of the prefill loop, and the
// unwritten (sentinel) tail of a decode row's cache out of the decode
// loop, while the prefix slots at the front are always visited.
//
// Pipelining: the next needed tile's K/V are loaded into registers while
// the current tile is folded, so a block waits for memory about once per
// tile, not once per element. The decision to load the next tile reads
// each row's running max from before the current tile is folded; a stale
// max can only make that decision more conservative (m never decreases).
#pragma once

#include "common.cuh"

constexpr int KT = 32;              // keys per tile: one per lane
constexpr int DMAX = 128;           // largest head dim taken
constexpr int NI = DMAX / 32;       // accumulator dims per lane
constexpr int KSTRIDE = DMAX + 1;   // padded K row: conflict-free lane reads
constexpr float NEG_INF = -1e30f;

struct AttnSmem {
  float k[KT * KSTRIDE];
  float v[KT * DMAX];
  int kpos[2][KT];                  // double-buffered: current, next tile
  int kexists[2][KT];
};

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  long long q = qp, k = kp;
  bool vis = causal ? (k <= q) : (k < 100000000LL);
  if (window > 0) vis = vis && (q - k < window);
  return vis || (k < 0);
}

// Attend rows of Qs (f32, row stride DMAX, `nrows` valid) against the
// T keys at k_base / v_base (element stride `kv_stride` between keys)
// with positions kpos_base[0..T). Row r's query position is qpos_s[r].
// On return, each warp's lanes hold acc / max(l, 1e-30) for its rows in
// `out_acc[i][*]` (row w + NW * i).
template <typename T, int NW, int RPW>
__device__ void attend_tiles(const float* Qs, const int* qpos_s, int nrows,
                             const T* __restrict__ k_base,
                             const T* __restrict__ v_base,
                             long long kv_stride,
                             const int* __restrict__ kpos_base, int T_len,
                             int D, float scale, int causal, int window,
                             AttnSmem& sm, float (&out_acc)[RPW][NI]) {
  constexpr int NT = NW * 32;
  constexpr int LPT = KT * DMAX / NT;       // K (and V) elements per thread
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NI; ++j) out_acc[i][j] = 0.f;
  }

  // Stage tile t0's positions in buffer `buf` and decide, block-wide,
  // whether any row still needs the tile.
  auto tile_needed = [&](int t0, int buf) -> bool {
    if (tid < KT) {
      const int t = t0 + tid;
      sm.kexists[buf][tid] = t < T_len;
      sm.kpos[buf][tid] = t < T_len ? kpos_base[t] : 0;
    }
    __syncthreads();
    const bool kex = sm.kexists[buf][lane];
    const int kp = sm.kpos[buf][lane];
    int need = 0;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NW * i;
      if (r < nrows) {                          // warp-uniform
        const bool vis = kex && visible(qpos_s[r], kp, causal, window);
        if (__any_sync(FULL_MASK, vis) || m[i] <= -1e29f) need = 1;
      }
    }
    return __syncthreads_or(need) != 0;
  };

  // K/V of one tile into registers: all loads issue before any is used.
  T kr[LPT], vr[LPT];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int it = 0; it < LPT; ++it) {
      const int e = tid + NT * it;
      const int r = e / DMAX, d = e % DMAX;
      const int t = t0 + r;
      const bool ok = d < D && t < T_len;
      const long long off = (long long)t * kv_stride + d;
      kr[it] = ok ? k_base[off] : from_f32<T>(0.f);
      vr[it] = ok ? v_base[off] : from_f32<T>(0.f);
    }
  };

  int buf = 0;
  bool need = tile_needed(0, 0);
  if (need) load_tile(0);
  for (int t0 = 0; t0 < T_len; t0 += KT, buf ^= 1) {
    if (need) {
#pragma unroll
      for (int it = 0; it < LPT; ++it) {
        const int e = tid + NT * it;
        const int r = e / DMAX, d = e % DMAX;
        sm.k[r * KSTRIDE + d] = to_f32(kr[it]);
        sm.v[r * DMAX + d] = to_f32(vr[it]);
      }
    }
    __syncthreads();
    const bool kex = sm.kexists[buf][lane];
    const int kp = sm.kpos[buf][lane];
    const int t1 = t0 + KT;
    const bool need1 = t1 < T_len && tile_needed(t1, buf ^ 1);
    if (need1) load_tile(t1);                   // in flight while folding

    if (need) {
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + NW * i;
        if (r >= nrows) continue;               // warp-uniform
        const float* qrow = Qs + r * DMAX;
        const float* krow = sm.k + lane * KSTRIDE;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += qrow[d] * krow[d];
        s *= scale;
        if (!visible(qpos_s[r], kp, causal, window)) s = NEG_INF;
        if (!kex) s = -INFINITY;
        const float m_new = fmaxf(m[i], warp_max(s));
        const float alpha = expf(m[i] - m_new);
        const float p = expf(s - m_new);
        l[i] = l[i] * alpha + warp_sum(p);
#pragma unroll
        for (int j = 0; j < NI; ++j) out_acc[i][j] *= alpha;
#pragma unroll 8
        for (int kk = 0; kk < KT; ++kk) {
          const float pk = __shfl_sync(FULL_MASK, p, kk);
          const float* vrow = sm.v + kk * DMAX + lane;
#pragma unroll
          for (int j = 0; j < NI; ++j)
            if (lane + 32 * j < D) out_acc[i][j] += pk * vrow[32 * j];
        }
        m[i] = m_new;
      }
    }
    __syncthreads();                            // before the next tile store
    need = need1;
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NI; ++j) out_acc[i][j] /= denom;
  }
}
