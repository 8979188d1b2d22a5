// The bf16 decode tile of flash_decode.cu and flash_decode_paged.cu:
// split-KV decode attention on Hopper's tensor cores, after
// Flash-Decoding (Dao et al., 2023) with FlashAttention-2's warp tile.
//
// What bounds decode attention on an H100: bytes. One query token per row
// reads every key and value of its KV head once (4 D bytes a key in bf16)
// for 4 D flops per (query head, key), far below the ~295 flops a byte at
// which the tensor cores would become the limit. So the design has to fill
// the 132 SMs with blocks that stream K and V, move them in large
// transfers, and keep the arithmetic off the shared-memory load path.
//
// Keys. A row's keys are a lead, then the rest: the lead is the prefix
// bank (n_p slots at position -1, read in place from its own tensor); in a
// dense call without a prefix bank it is the cache's leading run of slots
// at negative positions (a prefix that the caller concatenated in front),
// found from kv_pos. The lead is cut into 64-key tiles of its own, the
// last one partial, and the rest into 64-key tiles from its first key. So
// paged, dense with the prefix in place and dense on the concatenated
// cache cut the same tiles, and no TMA box spans two tensors.
//
// Splits. A split is a run of `tps` consecutive tiles; block (split, KV
// head, row) folds its split. tps and the number of splits come from the
// head dim and the row's key count alone (flash_decode.py::split_plan), so
// a row's bits depend neither on the rows beside it in the batch nor on
// whether its keys come through a block table.
//
// Skipping. The g query heads of a block share one row and so one q_pos:
// a tile's visibility is one 64-bit mask (visible() per key, differences
// in 64-bit, +1e9 sentinels never, negative positions always). A tile
// with no visible key is neither loaded nor folded, and a split with none
// writes an empty partial (m = -inf, l = 0). This is exact: such a tile
// adds exp2(-1e30 - m) == 0 once a visible key has set m, and before that
// is wiped by alpha == 0. The one exception is a row that sees no key at
// all (dense, no lead, every slot masked; paged with no prefix and
// q_pos < 0): there every block folds every tile of its split with -1e30
// scores, which averages the row's keys uniformly after the combine, as
// the reference softmax does. In the partial mode (an lse output, for a
// cache split over ranks, where a rank's shard often holds no visible
// key) such a row folds nothing: every split is empty, and the combine
// gives O = 0 and lse = -inf, which add nothing to the ranks' merge.
//
// Loads. Thread 0 issues TMA tensor loads (128-byte swizzle, 64-column
// boxes) of each folded tile's K and V into a ring of STAGES stages, each
// with a full mbarrier (TMA's byte count) and an empty one (one arrival a
// warp). Dense K / V and the prefix are 4-D maps over (D, Hkv, rows,
// batch); the paged pool is a 4-D map over (D, Hkv, bs, n_blocks), one box
// of min(bs, 64) rows per pool block, its coordinate the table entry
// staged in shared memory once a split (clamped into the pool; a key past
// the table reads the last pool block and is masked). Rows past a tensor's
// end are zero-filled by TMA.
//
// Products: mma.sync.m16n8k16 bf16 -> f32. The 16 rows of A are the
// group's query heads (rows >= g zero), so no product wastes the 64-row
// minimum of wgmma. Warp w owns keys 16 w .. 16 w + 15 of each tile with
// its own (m, l, O): S (16 x 16) = Q Kᵀ from ldmatrix of Q and of the K
// tile; masks and the online softmax in base 2 (scores scaled by
// scale * log2 e, masked ones -1e30, keys past the end -inf, ex2.approx);
// P rounded to bf16 in registers as the A fragment of O += P V, V read
// with ldmatrix.trans. The ldmatrix addresses XOR the 16-byte chunk index
// with the row's index mod 8, TMA's 128-byte swizzle.
//
// Combine. At the end of its split a block merges its four warps' (m, l,
// O) in shared memory (in warp order), writes one partial (m, l,
// unnormalised O) per query head, __threadfence(), and takes a ticket on
// the (row, KV head)'s counter. The block that draws the last ticket
// combines the splits in split order (m = max m_s, weights exp2(m_s - m),
// 0 for an empty split, O / max(l, 1e-30)), writes the bf16 output (and,
// when asked, lse = m ln 2 + ln l in natural-log units beside it) and
// resets the counter to 0 for the next launch. One launch a call.
//
// Known limit: the time is a chain of latencies more than bytes. On an
// H100 at 700 W, globaltimer stamps of qwen2-7b's decode shape (8 rows,
// 1024 + 16 keys, 28/4 heads of 128; 288 blocks) show a block's first
// loads taking ~1.3 us, its first tile landing ~3.5 us later, folding
// ~3.3 us, the merge and partial ~1.3 us, and the last block's combine
// ~4 us: ~15 us against the ~3 us that the visible keys' bytes need
// (PERF.md). A K/V-granular ring, a combine that overlaps the last
// splits' loads, and persistent blocks are the next steps.
#pragma once

#include <limits.h>
#include <string.h>

#include "attn_tile.cuh"   // visible(), NEG_INF
#include "common.cuh"
#include "hopper.cuh"      // PTX: mbarriers, TMA, ldmatrix, mma.sync

namespace decode_split {

using namespace hopper;

constexpr int BN = 64;             // keys a tile
constexpr int NW = 4;              // warps a block: 16 keys of a tile each
constexpr int NT = NW * 32;
constexpr int ROWS = 16;           // query heads a block (the largest group)
constexpr int BOX = 128;           // bytes in a row of a 64-column box
constexpr int MAX_SPLITS = 32;     // splits a (row, KV head) at most

// Per head-dim instance: 64-column boxes a row, the ring's depth, bytes.
template <int DM>
struct Shape {
  static constexpr int NB = DM / 64;
  // a 4-stage ring at DM 64, 2 at 128, 1 at 256: about 64 KB either way,
  // so three blocks share an SM (at DM 256 all of a row's splits fit on
  // the card at once)
  static constexpr int STAGES = DM == 64 ? 4 : DM == 128 ? 2 : 1;
  static constexpr int KV_BOX = BN * BOX;           // one box of a tile
  static constexpr int KV_BYTES = NB * KV_BOX;      // the K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int Q_BOX = ROWS * BOX;
  static constexpr int Q_BYTES = NB * Q_BOX;
  // the warps' (m, l, O) at the end of a split, over Q and the ring: O
  // rows padded by 8 floats against bank conflicts
  static constexpr int OSTRIDE = DM + 8;
  static constexpr int MERGE_BYTES = NW * ROWS * (OSTRIDE + 2) * 4;
  static_assert(MERGE_BYTES <= Q_BYTES + RING,
                "the merge buffer must fit Q and the ring");
  static_assert(MAX_SPLITS * ROWS * 12 + ROWS * 4 <= Q_BYTES + RING,
                "the combine's (m, l) and weights must fit Q and the ring");
};

struct Params {
  const __nv_bfloat16* q;          // (B, Hq, D)
  const int* q_pos;                // (B,)
  const int* kv_pos;               // dense: (B, T); paged: unused
  const int* table;                // paged: (B, maxb); dense: unused
  __nv_bfloat16* out;              // (B, Hq, D)
  float* lse;                      // (B, Hq) or null: the partial mode
  float* part_o;                   // (B, Hkv, n_splits, g, D)
  float* part_ml;                  // (B, Hkv, n_splits, g, 2)
  int* counters;                   // (B, Hkv), 0 between launches
  int T;                           // cache slots a row (paged: maxb * bs)
  int n_p, prefix_per_row, Hq, Hkv, D, causal, window;
  // a stacked bank (n_slots, n_p, Hkv, D): row b reads slot prefix_ids[b]
  // (clamped into the bank); null: slot b with prefix_per_row, else 0
  const int* prefix_ids;
  int n_slots;
  int bs, bs_log2, maxb, n_blocks; // paged
  int tps, n_splits, n_ent;        // tiles a split; splits; table entries
  int nkb;                         // 64-column boxes that hold D
  float scale_log2;                // scale * log2(e)
};

// Dynamic shared memory of a block: alignment slack, Q, the ring, its
// barriers, the split's visibility words, table entries and scalars.
template <int DM>
__host__ __device__ constexpr long long smem_bytes(int tps, int n_ent) {
  using Sh = Shape<DM>;
  return 1024LL + Sh::Q_BYTES + Sh::RING + 16LL * Sh::STAGES + 8LL * tps +
         4LL * n_ent + 16;
}

struct Smem {
  uint32_t q, ring;                // shared addresses, 1024-aligned
  unsigned char* work;             // Q, then the ring, generic: Q's
                                   // stores, then the merge and combine
  uint64_t* full;                  // [STAGES]
  uint64_t* empty;                 // [STAGES]
  uint32_t* vis;                   // [2 tps]: a tile's 64-bit mask
  int* ent;                        // [n_ent]: the split's pool blocks
  int* scal;                       // [4]
};

// Carves the block's shared memory; thread 0 initialises the barriers.
template <int DM>
__device__ __forceinline__ Smem carve(int tps, int n_ent) {
  using Sh = Shape<DM>;
  extern __shared__ __align__(1024) unsigned char ds_smem[];
  const uint32_t raw = smem_addr(ds_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* ptr = ds_smem + (base - raw);
  Smem sm;
  sm.q = base;
  sm.ring = base + Sh::Q_BYTES;
  sm.work = ptr;
  sm.full = reinterpret_cast<uint64_t*>(ptr + Sh::Q_BYTES + Sh::RING);
  sm.empty = sm.full + Sh::STAGES;
  sm.vis = reinterpret_cast<uint32_t*>(sm.empty + Sh::STAGES);
  sm.ent = reinterpret_cast<int*>(sm.vis + 2 * tps);
  sm.scal = sm.ent + n_ent;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Sh::STAGES; ++s) {
      mbar_init(smem_addr(&sm.full[s]), 1);
      mbar_init(smem_addr(&sm.empty[s]), NW);      // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    sm.scal[0] = INT_MAX;
  }
  return sm;
}

// The group's g query rows of head dim D, 16 bytes a thread: load puts
// chunk tid + NT i of the ROWS x DM / 8 chunks in v[i] (rows >= g and
// columns >= D zeros; D % 8 == 0), store writes them into the swizzled Q
// boxes. Loaded into registers first, so that the loads are in flight
// beside the block's other first loads.
template <int DM>
struct QRegs {
  static constexpr int CH = DM / 8;                 // 16-byte chunks a row
  static constexpr int N = ROWS * CH / NT;
  uint4 v[N];

  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ qg,
                                       int g, int D) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + NT * i, r = idx / CH, c = idx % CH;
      v[i] = r < g && 8 * c < D
                 ? *reinterpret_cast<const uint4*>(qg + (long long)r * D +
                                                   8 * c)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(unsigned char* qs) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + NT * i, r = idx / CH, c = idx % CH;
      *reinterpret_cast<uint4*>(qs + (c / 8) * Shape<DM>::Q_BOX +
                                sw128_off(r, c % 8)) = v[i];
    }
  }
};

// ---------------------------------------------------------------------------
// a warp's share of a tile
// ---------------------------------------------------------------------------

// S (16 query heads x this warp's 16 keys) = Q Kᵀ over d16 16-column
// steps: s[j] holds keys 16 w + 8 j .. + 7 (the mma accumulator layout).
template <int DM>
__device__ __forceinline__ void warp_qk(float (&s)[2][4], uint32_t qs,
                                        uint32_t ks, int d16) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mi = lane / 8, rr = lane % 8;
  const int qrow = rr + 8 * (mi & 1), qhalf = mi >> 1;   // a0 a1 a2 a3
  const int key = 16 * warp + rr + 8 * (mi >> 1), khalf = mi & 1;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk) {
    if (kk < d16) {
      const int cq = 2 * kk + qhalf, ck = 2 * kk + khalf;
      uint32_t a[4], b[4];
      ldsm_x4(a, qs + (cq / 8) * Shape<DM>::Q_BOX + sw128_off(qrow, cq % 8));
      ldsm_x4(b, ks + (ck / 8) * Shape<DM>::KV_BOX + sw128_off(key, ck % 8));
      mma_bf16_16816(s[0], a, b[0], b[1]);
      mma_bf16_16816(s[1], a, b[2], b[3]);
    }
  }
}

// O (16 x DM, o[n] holds columns 8 n .. 8 n + 7) += P (16 x this warp's 16
// keys, the A fragment) V over d16 16-column steps.
template <int DM>
__device__ __forceinline__ void warp_pv(float (&o)[DM / 8][4],
                                        const uint32_t (&pa)[4], uint32_t vs,
                                        int d16) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mi = lane / 8, rr = lane % 8;
  const int key = 16 * warp + rr + 8 * (mi & 1), dhalf = mi >> 1;
#pragma unroll
  for (int jj = 0; jj < DM / 16; ++jj) {
    if (jj < d16) {
      const int cv = 2 * jj + dhalf;
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (cv / 8) * Shape<DM>::KV_BOX +
                           sw128_off(key, cv % 8));
      mma_bf16_16816(o[2 * jj], pa, b[0], b[1]);
      mma_bf16_16816(o[2 * jj + 1], pa, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x, flushing a subnormal result to zero (2^-inf is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Folds this warp's 16 keys of one tile into (m, l, o): thread (gid =
// lane / 4, t4 = lane % 4) holds rows gid and gid + 8. `vis` is the
// tile's mask, `nk` its keys that exist.
template <int DM>
__device__ __forceinline__ void fold_tile(float (&m)[2], float (&l)[2],
                                          float (&o)[DM / 8][4], uint32_t qs,
                                          uint32_t ks, uint32_t vs,
                                          uint64_t vis, int nk,
                                          float scale_log2, int d16) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float s[2][4];
  warp_qk<DM>(s, qs, ks, d16);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 16 * warp + 8 * j + 2 * (lane % 4) + (e & 1);
      float x = (vis >> key) & 1ull ? s[j][e] * scale_log2 : NEG_INF;
      if (key >= nk) x = -INFINITY;
      s[j][e] = x;
    }
  float mn[2], alpha[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = fmaxf(fmaxf(s[0][2 * hh], s[0][2 * hh + 1]),
                     fmaxf(s[1][2 * hh], s[1][2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
    mn[hh] = fmaxf(m[hh], mx);
    alpha[hh] = ex2(m[hh] - mn[hh]);
    m[hh] = mn[hh];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = ex2(s[j][e] - mn[e / 2]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l[hh] = l[hh] * alpha[hh] + ((s[0][2 * hh] + s[0][2 * hh + 1]) +
                                 (s[1][2 * hh] + s[1][2 * hh + 1]));
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
  const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                          pack_bf16(s[0][2], s[0][3]),
                          pack_bf16(s[1][0], s[1][1]),
                          pack_bf16(s[1][2], s[1][3])};
  warp_pv<DM>(o, pa, vs, d16);
}

// ---------------------------------------------------------------------------
// the block's keys
// ---------------------------------------------------------------------------

// The first slot of kp[0, T) at a position >= 0 (T if none): the length
// of a dense row's leading run of negative-position slots. Block-wide.
__device__ __forceinline__ int lead_run(const int* __restrict__ kp, int T,
                                        int* slot) {
  for (int t0 = 0; t0 < T; t0 += NT) {
    const int t = t0 + threadIdx.x;
    const bool found = t < T && kp[t] >= 0;
    if (__syncthreads_or(found)) {
      if (found) atomicMin(slot, t);
      __syncthreads();
      return *slot;
    }
  }
  return T;
}

// Whether the row at q_pos qp sees any slot of kp[0, T). Block-wide.
__device__ __forceinline__ bool any_visible(const int* __restrict__ kp,
                                            int T, int qp, int causal,
                                            int window) {
  for (int t0 = 0; t0 < T; t0 += NT) {
    const int t = t0 + threadIdx.x;
    if (__syncthreads_or(t < T && visible(qp, kp[t], causal, window)))
      return true;
  }
  return false;
}

// Where a block's keys lie: the lead [0, L) in n0 tiles, then the rest
// (n_keys - L keys, from cache row `off1`) in n1 tiles.
struct Keys {
  int L, n_keys, n0, n1, off1;
};

// Thread 0: the n-th folded tile (tile c of the row) into stage n % STAGES,
// which the block must be done with.
template <int DM, bool PAGED>
__device__ __forceinline__ void issue(const Smem& sm, const Params& p,
                                      const Keys& ks, const CUtensorMap* tmk,
                                      const CUtensorMap* tmv,
                                      const CUtensorMap* tmpk,
                                      const CUtensorMap* tmpv, int n, int c,
                                      int b, int hk, int blk0) {
  using Sh = Shape<DM>;
  const int st = n % Sh::STAGES;
  const uint32_t kst = sm.ring + st * Sh::STAGE_BYTES;
  const uint32_t vst = kst + Sh::KV_BYTES;
  const uint32_t bar = smem_addr(&sm.full[st]);
  mbar_expect_tx(bar, 2 * p.nkb * Sh::KV_BOX);
  if (c < ks.n0) {
    // the lead: the prefix bank, or a dense cache's leading slots
    const bool bank = p.n_p > 0;
    const CUtensorMap* mk = bank ? tmpk : tmk;
    const CUtensorMap* mv = bank ? tmpv : tmv;
    const int bb = !bank ? b
                   : p.prefix_ids
                       ? min(max(p.prefix_ids[b], 0), p.n_slots - 1)
                       : (p.prefix_per_row ? b : 0);
    for (int i = 0; i < p.nkb; ++i) {
      tma_load_4d(kst + i * Sh::KV_BOX, mk, bar, 64 * i, hk, BN * c, bb);
      tma_load_4d(vst + i * Sh::KV_BOX, mv, bar, 64 * i, hk, BN * c, bb);
    }
    return;
  }
  const int u0 = BN * (c - ks.n0);
  if constexpr (PAGED) {
    const int rows = min(p.bs, BN);
    for (int j = 0; j < BN; j += rows) {
      const int u = u0 + j;
      const int blk = sm.ent[(u >> p.bs_log2) - blk0];
      const int r0 = u & (p.bs - 1);
      for (int i = 0; i < p.nkb; ++i) {
        tma_load_4d(kst + i * Sh::KV_BOX + j * BOX, tmk, bar, 64 * i, hk,
                    r0, blk);
        tma_load_4d(vst + i * Sh::KV_BOX + j * BOX, tmv, bar, 64 * i, hk,
                    r0, blk);
      }
    }
  } else {
    for (int i = 0; i < p.nkb; ++i) {
      tma_load_4d(kst + i * Sh::KV_BOX, tmk, bar, 64 * i, hk, ks.off1 + u0,
                  b);
      tma_load_4d(vst + i * Sh::KV_BOX, tmv, bar, 64 * i, hk, ks.off1 + u0,
                  b);
    }
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Block (split, hk, b). Dense: tmk / tmv over the cache, tmpk / tmpv over
// the prefix bank (any map when n_p == 0). Paged: tmk / tmv over the pool.
template <int DM, bool PAGED>
__global__ void __launch_bounds__(NT)
split_kernel(const __grid_constant__ CUtensorMap tmk,
             const __grid_constant__ CUtensorMap tmv,
             const __grid_constant__ CUtensorMap tmpk,
             const __grid_constant__ CUtensorMap tmpv, const Params p) {
  using Sh = Shape<DM>;
  const Smem sm = carve<DM>(p.tps, p.n_ent);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = p.Hq / p.Hkv;
  // the loads that nothing waits for go first, together: q_pos, Q, the
  // split's first positions (dense) or pool blocks (paged)
  const int qp = p.q_pos[b];
  QRegs<DM> qr;
  qr.load(p.q + ((long long)b * p.Hq + (long long)hk * g) * p.D, g, p.D);

  // the row's tiles and this split's share of them
  const int* kp = PAGED ? nullptr : p.kv_pos + (long long)b * p.T;
  Keys ks;
  ks.L = p.n_p;
  if (!PAGED && p.n_p == 0) ks.L = lead_run(kp, p.T, &sm.scal[0]);
  ks.n_keys = p.n_p + p.T;
  ks.n0 = (ks.L + BN - 1) / BN;
  ks.n1 = (ks.n_keys - ks.L + BN - 1) / BN;
  ks.off1 = ks.L - p.n_p;
  const int c_begin = split * p.tps;
  const int nc = max(min(c_begin + p.tps, ks.n0 + ks.n1) - c_begin, 0);
  // key idx of the split: whether it exists (is not past the end of its
  // tile's segment), and its position
  auto exists = [&](int idx) -> bool {
    const int c = c_begin + idx / BN, j = idx % BN;
    return c < ks.n0 ? BN * c + j < ks.L
                     : BN * (c - ks.n0) + j < ks.n_keys - ks.L;
  };
  auto position = [&](int idx) -> int {
    const int c = c_begin + idx / BN, j = idx % BN;
    if (c < ks.n0) return p.n_p > 0 ? -1 : kp[BN * c + j];
    const int u = BN * (c - ks.n0) + j;
    return PAGED ? u : kp[ks.off1 + u];
  };
  const bool ex0 = tid < nc * BN && exists(tid);
  const int pos0 = ex0 ? position(tid) : 0;
  // the pool blocks of the split's cache tiles, once
  int blk0 = 0;
  if constexpr (PAGED) {
    const int cb = max(c_begin, ks.n0) - ks.n0;
    const int ce = c_begin + nc - ks.n0;
    if (ce > cb) {
      blk0 = (BN * cb) >> p.bs_log2;
      const int cnt = ((BN * ce - 1) >> p.bs_log2) - blk0 + 1;
      for (int i = tid; i < cnt; i += NT) {
        const int e = blk0 + i < p.maxb
                          ? p.table[(long long)b * p.maxb + blk0 + i]
                          : p.n_blocks - 1;
        sm.ent[i] = min(max(e, 0), p.n_blocks - 1);
      }
    }
  }
  qr.store(sm.work);

  // each tile's visibility, one bit a key
  bool any = false;
  for (int idx = tid; idx < nc * BN; idx += NT) {
    const bool ex = idx == tid ? ex0 : exists(idx);
    const bool vis =
        ex && visible(qp, idx == tid ? pos0 : position(idx), p.causal,
                      p.window);
    const unsigned word = __ballot_sync(FULL_MASK, vis);
    if (lane == 0) sm.vis[idx / 32] = word;
    any |= vis;
  }
  const bool split_any = __syncthreads_or(any);
  bool blind = false;              // the row sees no key at all
  if (!split_any && p.lse == nullptr) {
    bool row_any;
    if constexpr (PAGED)
      row_any = p.n_p > 0 || (p.T > 0 && qp >= 0);
    else
      row_any = ks.L > 0 || any_visible(kp, p.T, qp, p.causal, p.window);
    blind = !row_any;
  }
  auto folds = [&](int i) {
    return blind || (sm.vis[2 * i] | sm.vis[2 * i + 1]) != 0u;
  };
  int nf = 0;
  for (int i = 0; i < nc; ++i) nf += folds(i);

  // the folded tiles, through the ring
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DM / 8][4];
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const int d16 = (p.D + 15) / 16;
  int issued = 0, issue_i = 0;     // thread 0
  if (tid == 0)
    for (; issued < min(Sh::STAGES, nf); ++issued, ++issue_i) {
      while (!folds(issue_i)) ++issue_i;
      issue<DM, PAGED>(sm, p, ks, &tmk, &tmv, &tmpk, &tmpv, issued,
                       c_begin + issue_i, b, hk, blk0);
    }
  int fi = 0;
  for (int n = 0; n < nf; ++n, ++fi) {
    while (!folds(fi)) ++fi;
    const int c = c_begin + fi;
    const int st = n % Sh::STAGES;
    const int nk = c < ks.n0 ? min(BN, ks.L - BN * c)
                             : min(BN, ks.n_keys - ks.L - BN * (c - ks.n0));
    const uint64_t vis = (static_cast<uint64_t>(sm.vis[2 * fi + 1]) << 32) |
                         sm.vis[2 * fi];
    const uint32_t kst = sm.ring + st * Sh::STAGE_BYTES;
    mbar_wait(smem_addr(&sm.full[st]), (n / Sh::STAGES) & 1);
    fold_tile<DM>(m, l, o, sm.q, kst, kst + Sh::KV_BYTES, vis, nk,
                  p.scale_log2, d16);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&sm.empty[st]));
    if (tid == 0 && issued < nf) {
      mbar_wait(smem_addr(&sm.empty[st]), (n / Sh::STAGES) & 1);
      while (!folds(issue_i)) ++issue_i;
      issue<DM, PAGED>(sm, p, ks, &tmk, &tmv, &tmpk, &tmpv, issued,
                       c_begin + issue_i, b, hk, blk0);
      ++issued;
      ++issue_i;
    }
  }
  __syncthreads();                 // every warp is done with Q and the ring

  // merge the warps' (m, l, O) in warp order into the split's partial
  const long long rowbase = ((long long)b * p.Hkv + hk) * p.n_splits;
  float* ow = reinterpret_cast<float*>(sm.work);
  float* mw = ow + NW * ROWS * Sh::OSTRIDE;
  float* lw = mw + NW * ROWS;
  const int gid = lane / 4, t4 = lane % 4;
  if (nf > 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[hh];
      lt += __shfl_xor_sync(FULL_MASK, lt, 1);
      lt += __shfl_xor_sync(FULL_MASK, lt, 2);
      const int r = gid + 8 * hh;
      if (t4 == 0) {
        mw[warp * ROWS + r] = m[hh];
        lw[warp * ROWS + r] = lt;
      }
      float* orow = ow + (warp * ROWS + r) * Sh::OSTRIDE;
#pragma unroll
      for (int n = 0; n < DM / 8; ++n)
        if (n < 2 * d16)
          *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
              make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    }
    __syncthreads();
    const int D4 = p.D / 4;
    for (int idx = tid; idx < g * D4; idx += NT) {
      const int r = idx / D4, d = 4 * (idx % D4);
      float mx = mw[r];
#pragma unroll
      for (int w = 1; w < NW; ++w) mx = fmaxf(mx, mw[w * ROWS + r]);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float wt = ex2(mw[w * ROWS + r] - mx);
        const float4 x = *reinterpret_cast<const float4*>(
            ow + (w * ROWS + r) * Sh::OSTRIDE + d);
        acc.x += wt * x.x;
        acc.y += wt * x.y;
        acc.z += wt * x.z;
        acc.w += wt * x.w;
        lsum += wt * lw[w * ROWS + r];
      }
      *reinterpret_cast<float4*>(
          p.part_o + ((rowbase + split) * g + r) * p.D + d) = acc;
      if (d == 0)
        *reinterpret_cast<float2*>(p.part_ml + ((rowbase + split) * g + r) *
                                                   2) = make_float2(mx, lsum);
    }
  } else if (tid < g) {            // an empty split
    *reinterpret_cast<float2*>(p.part_ml + ((rowbase + split) * g + tid) *
                                               2) =
        make_float2(-INFINITY, 0.f);
  }

  // the ticket: the last block of this (row, KV head) combines
  __threadfence();
  __syncthreads();
  int* counter = p.counters + (long long)b * p.Hkv + hk;
  if (tid == 0)
    sm.scal[1] = atomicAdd(counter, 1) == p.n_splits - 1;
  __syncthreads();
  if (!sm.scal[1]) return;
  __threadfence();
  if (tid == 0) *counter = 0;      // for the next launch

  // every split's (m, l) into shared memory at once; each row's max over
  // the splits; the weights exp2(m_s - m), 0 for an empty split; and each
  // row's l, the weighted l_s summed in split order
  const int ns = p.n_splits, nsg = ns * g;
  float2* mls = reinterpret_cast<float2*>(sm.work);        // [ns][g]
  float* wts = reinterpret_cast<float*>(mls + MAX_SPLITS * ROWS);
  float* rowv = wts + MAX_SPLITS * ROWS;                    // [ROWS]
  const float2* ml = reinterpret_cast<const float2*>(p.part_ml) + rowbase * g;
  for (int i = tid; i < nsg; i += NT) mls[i] = __ldcg(ml + i);
  __syncthreads();
  if (tid < g) {
    float mx = -INFINITY;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, mls[s * g + tid].x);
    rowv[tid] = mx;
  }
  __syncthreads();
  for (int i = tid; i < nsg; i += NT) {
    const float m_s = mls[i].x;
    wts[i] = m_s == -INFINITY ? 0.f : ex2(m_s - rowv[i % g]);
  }
  __syncthreads();
  if (tid < g) {
    float lsum = 0.f;
    for (int s = 0; s < ns; ++s) lsum += wts[s * g + tid] * mls[s * g + tid].y;
    if (p.lse != nullptr)          // m is in log2 units: -inf when blind
      p.lse[(long long)b * p.Hq + (long long)hk * g + tid] =
          rowv[tid] * 0.6931471805599453f + logf(lsum);
    rowv[tid] = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();                 // each row's 1 / l
  // O: each thread 4 columns of a row, CB splits' partials in flight at
  // once, summed in split order; an empty split's O (never written) is
  // loaded but not added
  constexpr int CB = 16;
  const int D4 = p.D / 4;
  const long long step = (long long)g * p.D;      // floats between splits
  for (int idx = tid; idx < g * D4; idx += NT) {
    const int r = idx / D4, d = 4 * (idx % D4);
    const float* po = p.part_o + (rowbase * g + r) * p.D + d;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < ns; s0 += CB) {
      float4 x[CB];
#pragma unroll
      for (int j = 0; j < CB; ++j)
        x[j] = s0 + j < ns
                   ? __ldcg(reinterpret_cast<const float4*>(po +
                                                            (s0 + j) * step))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        const float wt = s0 + j < ns ? wts[(s0 + j) * g + r] : 0.f;
        if (wt != 0.f) {
          acc.x += wt * x[j].x;
          acc.y += wt * x[j].y;
          acc.z += wt * x[j].z;
          acc.w += wt * x[j].w;
        }
      }
    }
    const float iv = rowv[r];
    __nv_bfloat16* orow =
        p.out + ((long long)b * p.Hq + (long long)hk * g + r) * p.D + d;
    *reinterpret_cast<uint2*>(orow) =
        make_uint2(pack_bf16(acc.x * iv, acc.y * iv),
                   pack_bf16(acc.z * iv, acc.w * iv));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A bf16 map with the 128-byte swizzle over (D, H, rows, nbatch), D
// innermost and contiguous, box 64 x 1 x box_rows x 1, written as its 128
// bytes to `out`. D % 8 == 0 and a 16-byte base (TMA's rule for strides
// and addresses) are checked here, before anything launches.
inline cudaError_t encode_map(void* out, const void* base, int D, int H,
                              int rows, int nbatch, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (D % 8 != 0 || D <= 0 || D > 256 || H <= 0 || rows <= 0 ||
      nbatch <= 0 || box_rows <= 0 || box_rows > 256 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)nbatch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)rows * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  alignas(64) CUtensorMap map;
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  memcpy(out, &map, sizeof(map));
  return cudaSuccess;
}

// Launch over grid (n_splits, Hkv, B); maps are the 128-byte images that
// encode_map wrote. The limit is raised to the most a block may have once,
// and each launch asks for what its split needs.
template <int DM, bool PAGED>
cudaError_t launch(const void* const maps[4], const Params& p, int B,
                   cudaStream_t stream) {
  const long long smem = smem_bytes<DM>(p.tps, p.n_ent);
  if (smem > SMEM_OPTIN || p.n_splits < 1 || p.n_splits > MAX_SPLITS ||
      p.tps < 1 || p.Hkv > 65535 || B > 65535 ||
      p.nkb != (p.D + 63) / 64 || p.nkb > Shape<DM>::NB)
    return cudaErrorInvalidValue;
  cudaError_t e = raise_smem<split_kernel<DM, PAGED>, SMEM_OPTIN>();
  if (e != cudaSuccess) return e;
  CUtensorMap m[4];
  for (int i = 0; i < 4; ++i) memcpy(&m[i], maps[i], sizeof(CUtensorMap));
  const dim3 grid(p.n_splits, p.Hkv, B);
  split_kernel<DM, PAGED><<<grid, NT, static_cast<int>(smem), stream>>>(
      m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

}  // namespace decode_split
