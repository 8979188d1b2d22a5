// The bf16 prefill attention tile on Hopper's tensor cores
// (flash_attention.cu), after FlashAttention-3's forward (Shah et al.,
// 2024) in its simple form: no warp specialisation, no persistent grid,
// no fp8.
//
// A block is one consumer warpgroup (head dims up to 128; two blocks share
// an SM) or two (head dim 256; one block an SM), each warpgroup owning 64
// query rows of one (batch, query head). The block's Q tile comes to
// shared memory once, by TMA with the 128-byte swizzle, in DM / 64 boxes
// of 64 columns. K and V come through a ring of STAGES stages of BN = 64
// keys (K tile and V tile, DM / 64 boxes each); each stage has a full
// mbarrier (TMA's byte count) and an empty one (one arrival per
// warpgroup once its products on the stage are done), and thread 0
// issues every load, as in lora_wgmma.cuh, keeping up to STAGES tiles in
// flight and waiting for a stage only when the tile it is about to fold
// has not been issued yet. The tensor maps are 4-D over (D, heads, rows,
// B), so one map serves every (b, h) and a box never reads past its own
// sequence: TMA fills rows past S or T (and columns past D) with zeros.
//
// Per tile and warpgroup: S = Q Kᵀ by DM / 16 wgmma.m64n64k16, A = Q and
// B = the K tile read where it lies (K-major, no transpose flag); masks
// and the online softmax on the accumulator fragment; O += P V by BN / 16
// wgmma.m64n{DM}k16 with A = P from registers (bf16) and B = the V tile
// read where it lies (N-major, the transpose flag, as lora_wgmma.cuh's W).
// The accumulator of two 8-column groups of S is the A fragment of one
// k16 slice of P, so P needs no shuffle. Thread (warp w, lane) of a
// warpgroup holds rows 16 w + lane / 4 and that + 8, columns
// 8 j + 2 (lane % 4) + {0, 1}; a row's max and sum reduce across the 4
// lanes of a quad.
//
// The semantics are attn_tile.cuh's (and kernels/ref.py's): a key is
// visible iff visible() holds (differences in 64-bit); a masked score is
// NEG_INF = -1e30, so a row that has seen no visible key yet averages
// uniformly; a key past T scores -inf and weighs exactly 0; at the end O
// is divided by max(l, 1e-30) (a product with its reciprocal). The
// softmax runs in base 2 (scores scaled by scale * log2 e inside the
// exponent's fused multiply-add, ex2.approx.ftz), with the same -1e30
// sentinel, which keeps those three rules. l sums the f32 p; p rounded to
// bf16 for the P V product is the one rounding that the f32 plain version
// does not have. A tile that every row of the block sees whole (every key
// below T and visible to any q_pos in the rows' range) skips the masks.
//
// Tile skipping keeps attn_tile.cuh's rule at the block's rows: a
// tile is skipped only when no row sees any of its keys and every row's
// running max is already above -1e29, which is exact (such a row's p is
// exp(-1e30 - m) == 0 for every key of the tile). Here it is decided
// before the loads: a prologue marks, in a bitmask in shared memory, each
// tile holding a key that some row of the block may see (its position
// tested against the rows' least and greatest q_pos: the prefix slots,
// always; the causal upper triangle and the +1e9 sentinel tails, never),
// and the loop folds exactly the marked tiles, in order. A marked tile
// that no row sees adds exact zeros once each row has seen a visible key,
// and before that is wiped by alpha = 0 at the row's first visible key.
// If, after them, some row has still seen nothing (m <= -1e29), a second
// pass folds the unmarked tiles, so that such a row averages over every
// key, as the rule's visit-everything case does.
//
// Shapes TMA refuses (D not a multiple of 8, a base not 16-byte aligned)
// are padded by the wrapper (flash_attention.py); the launch checks them
// before anything runs. The bitmasks are sized from T (one bit per tile),
// after the ring in dynamic shared memory.
#pragma once

#include <limits.h>

#include "attn_tile.cuh"   // visible(), NEG_INF
#include "common.cuh"
#include "hopper.cuh"      // PTX: mbarriers, TMA, descriptors, wgmma sync

namespace attn_wgmma {

using namespace hopper;

constexpr int BN = 64;             // keys per tile
constexpr int BOX = 128;           // bytes in a row of a 64-column box

// Per head-dim instance: consumer warpgroups per block (64 query rows
// each), DM / 64 boxes per tile, and the ring's depth. At DM <= 128 a
// block is one warpgroup, and two blocks share an SM (registers and half
// the shared memory each), so that one block's softmax, prologue and
// epilogue overlap the other's products; at DM 256 Q and two stages fill
// the shared memory, and a block is two warpgroups that share each K / V
// tile.
template <int DM>
struct Shape {
  static constexpr int NWG = DM == 256 ? 2 : 1;
  static constexpr int NT = 128 * NWG;              // threads
  static constexpr int BM = 64 * NWG;               // query rows
  static constexpr int NB = DM / 64;
  static constexpr int STAGES = DM == 64 ? 4 : 2;
  static constexpr int Q_BOX = BM * BOX;            // one 64-column box
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BOX = BN * BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;      // the K (or V) tile
  // V as the N-major B operand: the leading byte offset steps between the
  // tile's 64-column boxes, the stride byte offset between groups of 8
  // keys (lora_wgmma.cuh's W layout)
  static constexpr uint32_t V_LBO = KV_BOX, V_SBO = 1024;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // slack to align to 1024 (the swizzle's period), Q, the ring, its
  // barriers and Q's, and the rows' q_pos range; the two bitmasks follow
  static constexpr int FIXED_BYTES = 1024 + Q_BYTES + STAGES * STAGE_BYTES +
                                     (2 * STAGES + 1) * 8 + 8;
};

// Words of a bitmask with one bit per tile of T keys.
__host__ __device__ constexpr int mask_words(long long T) {
  return static_cast<int>(((T + BN - 1) / BN + 31) / 32);
}

// The dynamic shared memory of a block for T keys.
template <int DM>
constexpr long long smem_bytes(long long T) {
  return Shape<DM>::FIXED_BYTES + 2LL * mask_words(T) * 4;
}

// K-major operands (Q, K): 8-row groups of 128-byte rows.
constexpr uint32_t KMAJ_LBO = 16, KMAJ_SBO = 1024;

struct Params {
  const int* q_pos;                // (S,)
  const int* kv_pos;               // (T,)
  __nv_bfloat16* out;              // (B, S, Hq, D)
  int S, T, Hq, Hkv, D, causal, window;
  float scale_log2;                // scale * log2(e)
};

// ---------------------------------------------------------------------------
// the products
// ---------------------------------------------------------------------------

// d (64 x 64, f32) = (scale_d ? d : 0) + A (64 x 16, K-major) B (16 x 64),
// B K-major (no transpose: the rows of the shared tile are B's columns).
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) B (16 x 64),
// B N-major (the transpose flag).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 pairs in registers) B (16 x 128),
// B N-major (the transpose flag).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16, bf16 pairs in registers) B (16 x 256),
// B N-major (the transpose flag).
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DM>
__device__ __forceinline__ void wgmma_pv(float (&d)[DM / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DM == 64) wgmma_rs_m64n64k16(d, a, db);
  else if constexpr (DM == 128) wgmma_rs_m64n128k16(d, a, db);
  else wgmma_rs_m64n256k16(d, a, db);
}

// Keeps the compiler from reusing P's registers before the products that
// read them are done.
__device__ __forceinline__ void fence_frag(uint32_t (&p)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(p[j][x])::"memory");
}

// S (64 x BN) = this warpgroup's 64 Q rows times the K tile at k.
template <int DM>
__device__ __forceinline__ void mma_qk(float (&s)[BN / 2], uint32_t q,
                                       uint32_t k, int wg) {
  using Sh = Shape<DM>;
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk) {
    const uint32_t qa = q + (kk / 4) * Sh::Q_BOX + wg * 64 * BOX +
                        (kk % 4) * 32;
    const uint32_t ka = k + (kk / 4) * Sh::KV_BOX + (kk % 4) * 32;
    wgmma_ss_m64n64k16(s, sw128_desc(qa, KMAJ_LBO, KMAJ_SBO),
                       sw128_desc(ka, KMAJ_LBO, KMAJ_SBO), kk > 0);
  }
}

// O (64 x DM) += P (64 x BN, registers) times the V tile at v.
template <int DM>
__device__ __forceinline__ void mma_pv(float (&o)[DM / 2],
                                       const uint32_t (&p)[BN / 16][4],
                                       uint32_t v) {
  using Sh = Shape<DM>;
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wgmma_pv<DM>(o, p[j],
                 sw128_desc(v + j * 16 * BOX, Sh::V_LBO, Sh::V_SBO));
}

// Accumulator element 4 i + 2 h + e of thread t of a warpgroup: row
// 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 i + 2 (t % 4) + e.
__device__ __forceinline__ int frag_row(int t, int h) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * h;
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return 8 * i + 2 * (t % 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// shared memory, loads, the tiles to visit
// ---------------------------------------------------------------------------

struct Smem {
  uint32_t q;                      // shared address of Q, 1024-aligned
  uint32_t kv;                     // stage 0 (K tile, then V tile)
  uint64_t* full;                  // [STAGES]
  uint64_t* empty;                 // [STAGES]
  uint64_t* qbar;
  int* qrange;                     // the block's least and greatest q_pos
  uint32_t* need;                  // [nwords]: tiles some row may see
  uint32_t* part;                  // [nwords]: tiles not every row sees
};

// Carves the block's shared memory (bitmasks of nwords words each);
// thread 0 initialises the barriers.
template <int DM>
__device__ __forceinline__ Smem smem_setup(int nwords) {
  using Sh = Shape<DM>;
  extern __shared__ __align__(1024) unsigned char attn_smem[];
  const uint32_t raw = smem_addr(attn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* ptr = attn_smem + (base - raw);
  Smem sm;
  sm.q = base;
  sm.kv = base + Sh::Q_BYTES;
  sm.full = reinterpret_cast<uint64_t*>(ptr + Sh::Q_BYTES +
                                        Sh::STAGES * Sh::STAGE_BYTES);
  sm.empty = sm.full + Sh::STAGES;
  sm.qbar = sm.empty + Sh::STAGES;
  sm.qrange = reinterpret_cast<int*>(sm.qbar + 1);
  sm.need = reinterpret_cast<uint32_t*>(sm.qrange + 2);
  sm.part = sm.need + nwords;
  for (int i = threadIdx.x; i < 2 * nwords; i += blockDim.x) sm.need[i] = 0u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Sh::STAGES; ++s) {
      mbar_init(smem_addr(&sm.full[s]), 1);
      mbar_init(smem_addr(&sm.empty[s]), Sh::NWG);   // one per warpgroup
    }
    mbar_init(smem_addr(sm.qbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    sm.qrange[0] = INT_MAX;
    sm.qrange[1] = INT_MIN;
  }
  __syncthreads();
  return sm;
}

// Thread 0: the block's Q rows [s0, s0 + 128) of head h, batch b.
template <int DM>
__device__ __forceinline__ void issue_q(const Smem& sm,
                                        const CUtensorMap* tmq, int h,
                                        int s0, int b) {
  using Sh = Shape<DM>;
  const uint32_t bar = smem_addr(sm.qbar);
  mbar_expect_tx(bar, Sh::Q_BYTES);
#pragma unroll
  for (int i = 0; i < Sh::NB; ++i)
    tma_load_4d(sm.q + i * Sh::Q_BOX, tmq, bar, 64 * i, h, s0, b);
}

// Thread 0: the n-th tile the block folds, keys [c * BN, +BN) of KV head
// hk, into stage n % STAGES, which the block must be done with (stage_free).
// TMA counts the whole boxes, zero-filled past T.
template <int DM>
__device__ __forceinline__ void issue_kv(const Smem& sm,
                                         const CUtensorMap* tmk,
                                         const CUtensorMap* tmv, int n,
                                         int c, int hk, int b) {
  using Sh = Shape<DM>;
  const int s = n % Sh::STAGES;
  const uint32_t ks = sm.kv + s * Sh::STAGE_BYTES, vs = ks + Sh::KV_BYTES;
  const uint32_t bar = smem_addr(&sm.full[s]);
  mbar_expect_tx(bar, Sh::STAGE_BYTES);
#pragma unroll
  for (int i = 0; i < Sh::NB; ++i)
    tma_load_4d(ks + i * Sh::KV_BOX, tmk, bar, 64 * i, hk, c * BN, b);
#pragma unroll
  for (int i = 0; i < Sh::NB; ++i)
    tma_load_4d(vs + i * Sh::KV_BOX, tmv, bar, 64 * i, hk, c * BN, b);
}

// Whether both warpgroups are done with the tile that the n-th tile's
// stage held (n - STAGES); with `wait`, spin until they are.
template <int DM>
__device__ __forceinline__ bool stage_free(const Smem& sm, int n,
                                           bool wait) {
  constexpr int ST = Shape<DM>::STAGES;
  if (n < ST) return true;
  const uint32_t bar = smem_addr(&sm.empty[n % ST]);
  const uint32_t parity = (n / ST - 1) & 1;
  if (wait) mbar_wait(bar, parity);
  return wait || mbar_test(bar, parity);
}

// The tiles of one pass, in order: those whose bit in `need` is set
// (pass 0) or clear (pass 1), below n_tiles.
struct TileIter {
  const uint32_t* words;
  int n_tiles, w;
  uint32_t flip, bits;

  __device__ __forceinline__ TileIter(const uint32_t* words_, int n,
                                      bool marked)
      : words(words_), n_tiles(n), w(0), flip(marked ? 0u : ~0u) {
    bits = load(0);
  }
  __device__ __forceinline__ uint32_t load(int i) const {
    const int left = n_tiles - 32 * i;
    if (left <= 0) return 0u;
    const uint32_t x = words[i] ^ flip;
    return left >= 32 ? x : x & ((1u << left) - 1u);
  }
  // The next tile, or -1.
  __device__ __forceinline__ int next() {
    while (bits == 0u) {
      if (32 * ++w >= n_tiles) return -1;
      bits = load(w);
    }
    const int c = 32 * w + __ffs(bits) - 1;
    bits &= bits - 1u;
    return c;
  }
};

// Could a row with q_pos in [qlo, qhi] see a key at kp? (A necessary
// condition for visible(); exact when the rows' positions are contiguous.)
__device__ __forceinline__ bool may_see(int qlo, int qhi, int kp, int causal,
                                        int window) {
  const long long k = kp;
  bool vis = causal ? (k <= qhi) : (k < 100000000LL);
  if (window > 0) vis = vis && ((long long)qlo - k < window);
  return vis || (k < 0);
}

// Does every row with q_pos in [qlo, qhi] see a key at kp? (A sufficient
// condition for visible() at each of them.)
__device__ __forceinline__ bool all_see(int qlo, int qhi, int kp, int causal,
                                        int window) {
  const long long k = kp;
  bool vis = causal ? (k <= qlo) : (k < 100000000LL);
  if (window > 0) vis = vis && ((long long)qhi - k < window);
  return vis || (k < 0);
}

// 2^x, flushing a subnormal result to zero (a weight below 2^-126 of the
// row's largest; 2^-inf is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Block (b * Hq + h, q tile): query rows [s0, s0 + 128) of head h, batch
// b, the q tiles issued heaviest (last) first for the causal triangle.
template <int DM>
__global__ void __launch_bounds__(Shape<DM>::NT, 2 / Shape<DM>::NWG)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv, const Params p) {
  using Sh = Shape<DM>;
  constexpr int NO = DM / 2;       // O accumulator registers
  constexpr int NS = BN / 2;       // S accumulator registers
  const int n_tiles = (p.T + BN - 1) / BN;
  const Smem sm = smem_setup<DM>(mask_words(p.T));
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128,
            lane = tid % 32;
  const int h = blockIdx.x % p.Hq, b = blockIdx.x / p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  constexpr int BM = Sh::BM, NT = Sh::NT;
  const int s0 = (gridDim.y - 1 - blockIdx.y) * BM;

  if (tid == 0) issue_q<DM>(sm, &tmq, h, s0, b);

  // this thread's two rows and their positions
  int qp[2];
  bool live[2];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = s0 + wg * 64 + frag_row(t, hh);
    live[hh] = r < p.S;
    qp[hh] = live[hh] ? p.q_pos[r] : 0;
    if (live[hh]) {
      lo = min(lo, qp[hh]);
      hi = max(hi, qp[hh]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL_MASK, lo, o));
    hi = max(hi, __shfl_xor_sync(FULL_MASK, hi, o));
  }
  if (lane == 0) {
    atomicMin(&sm.qrange[0], lo);
    atomicMax(&sm.qrange[1], hi);
  }
  __syncthreads();
  const int qlo = sm.qrange[0], qhi = sm.qrange[1];
  // mark the tiles some row may see, and those that not every row sees
  // whole (a key past T, or masked for some row): 32 keys of a warp lie in
  // one tile
  for (int k0 = 0; k0 < p.T; k0 += NT) {
    const int key = k0 + tid;
    const int kp = key < p.T ? p.kv_pos[key] : 0;
    const bool maybe = key < p.T && may_see(qlo, qhi, kp, p.causal,
                                            p.window);
    const bool whole = key < p.T && all_see(qlo, qhi, kp, p.causal,
                                            p.window);
    const unsigned any = __ballot_sync(FULL_MASK, maybe);
    const unsigned all = __ballot_sync(FULL_MASK, whole);
    const int c = key / BN;
    if (lane == 0 && any != 0u) atomicOr(&sm.need[c / 32], 1u << (c % 32));
    if (lane == 0 && all != FULL_MASK)
      atomicOr(&sm.part[c / 32], 1u << (c % 32));
  }
  __syncthreads();

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  int n = 0;                       // tiles folded: the ring's position
  int issued = 0;                  // tiles issued (thread 0)
  int ahead = -1;                  // the next tile to issue (thread 0)
  mbar_wait(smem_addr(sm.qbar), 0);

  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {               // a row that has seen nothing
      bool none = false;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) none |= live[hh] && m[hh] <= -1e29f;
      if (!__syncthreads_or(none)) break;
    }
    TileIter fold(sm.need, n_tiles, pass == 0), load = fold;
    if (tid == 0) ahead = load.next();
    for (int c = fold.next(); c >= 0; c = fold.next(), ++n) {
      // thread 0 keeps up to STAGES tiles in flight, waiting for a stage
      // only for tile n itself, so that one warpgroup can run ahead of
      // the other while their tiles are in the ring
      if (tid == 0)
        while (ahead >= 0 && issued < n + Sh::STAGES &&
               stage_free<DM>(sm, issued, issued == n)) {
          issue_kv<DM>(sm, &tmk, &tmv, issued++, ahead, hk, b);
          ahead = load.next();
        }
      const int s = n % Sh::STAGES;
      const uint32_t ks = sm.kv + s * Sh::STAGE_BYTES;
      const bool whole = !((sm.part[c / 32] >> (c % 32)) & 1u);
      mbar_wait(smem_addr(&sm.full[s]), (n / Sh::STAGES) & 1);
      float sc[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.f;
      wgmma_fence();
      mma_qk<DM>(sc, sm.q, ks, wg);
      wgmma_commit();
      const int t0 = c * BN;
      wgmma_wait<0>();
      fence_acc(sc);

      // scores in base 2 (kscale * score, in the exponent's multiply-add);
      // a tile that some row does not see whole is masked, scaled, first
      float kscale = p.scale_log2;
      if (!whole) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = t0 + frag_col(t, i) + e;
            const int kp = key < p.T ? p.kv_pos[key] : 0;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float x = visible(qp[hh], kp, p.causal, p.window)
                            ? sc[4 * i + 2 * hh + e] * p.scale_log2
                            : NEG_INF;
              if (key >= p.T) x = -INFINITY;
              sc[4 * i + 2 * hh + e] = x;
            }
          }
        kscale = 1.f;
      }
      // the rows' max, p and sum, the two rows interleaved and reduced as
      // trees (short dependency chains)
      float mx[2], mn[2], alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v[BN / 8];
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
          v[i] = fmaxf(sc[4 * i + 2 * hh], sc[4 * i + 2 * hh + 1]);
#pragma unroll
        for (int w = BN / 16; w > 0; w /= 2)
#pragma unroll
          for (int i = 0; i < w; ++i) v[i] = fmaxf(v[i], v[i + w]);
        mx[hh] = v[0];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL_MASK, mx[hh], 1));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL_MASK, mx[hh], 2));
        mn[hh] = fmaxf(m[hh], mx[hh] * kscale);
        alpha[hh] = ex2(m[hh] - mn[hh]);
        m[hh] = mn[hh];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i)
        sc[i] = ex2(fmaf(sc[i], kscale, -mn[(i / 2) % 2]));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v[BN / 8];
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
          v[i] = sc[4 * i + 2 * hh] + sc[4 * i + 2 * hh + 1];
#pragma unroll
        for (int w = BN / 16; w > 0; w /= 2)
#pragma unroll
          for (int i = 0; i < w; ++i) v[i] += v[i + w];
        l[hh] = l[hh] * alpha[hh] + v[0];
      }
      // O *= alpha, unless no row of the warp's max moved
      if (__any_sync(FULL_MASK, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
        for (int i = 0; i < DM / 8; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) o[4 * i + 2 * hh + e] *= alpha[hh];
      uint32_t pf[BN / 16][4];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pf[j][x] = pack_bf16(sc[8 * j + 2 * x], sc[8 * j + 2 * x + 1]);

      wgmma_fence();
      mma_pv<DM>(o, pf, ks + Sh::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      fence_frag(pf);
      if (t == 0) mbar_arrive(smem_addr(&sm.empty[s]));
    }
  }

  // O / max(l, 1e-30) (as a product with its reciprocal), one cast, rows
  // < S; D % 8 == 0, so a column pair is in or out together
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(FULL_MASK, lt, 1);
    lt += __shfl_xor_sync(FULL_MASK, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    if (!live[hh]) continue;
    const int r = s0 + wg * 64 + frag_row(t, hh);
    __nv_bfloat16* orow =
        p.out + (((long long)b * p.S + r) * p.Hq + h) * p.D;
#pragma unroll
    for (int i = 0; i < DM / 8; ++i) {
      const int col = frag_col(t, i);
      if (col < p.D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * i + 2 * hh] * inv, o[4 * i + 2 * hh + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// bf16 maps with the 128-byte swizzle over (D, heads, rows, B), D
// innermost: q (B, S, Hq, D), box 64 x 1 x 128 x 1; k and v (B, T, Hkv,
// D), box 64 x 1 x 64 x 1. D % 8 == 0 and 16-byte bases (TMA's rule for
// strides and addresses), checked here before anything launches.
template <int DM>
cudaError_t encode_maps(CUtensorMap* tmq, CUtensorMap* tmk,
                               CUtensorMap* tmv, const void* q,
                               const void* k, const void* v, int B, int S,
                               int T, int Hq, int Hkv, int D) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (D % 8 != 0 || D <= 0 || D > 256 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return cudaErrorInvalidValue;
  auto one = [&](CUtensorMap* map, const void* base, int rows, int H,
                 int box_rows) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H,
                                (cuuint64_t)rows, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                   (cuuint64_t)rows * H * D * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(base), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  const int Tm = T > 0 ? T : 1;    // T == 0 loads nothing
  constexpr int BM = Shape<DM>::BM;
  if (!one(tmq, q, S, Hq, BM) || !one(tmk, k, Tm, Hkv, BN) ||
      !one(tmv, v, Tm, Hkv, BN))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// q (B, S, Hq, D), k / v (B, T, Hkv, D), out (B, S, Hq, D), bf16,
// contiguous; q_pos (S,), kv_pos (T,) int32. DM / 2 < D <= DM (or DM 64),
// D % 8 == 0, 16-byte bases, Hq % Hkv == 0, and the bitmasks of T keys
// within the shared memory left beside the ring (8.9 M keys at DM 256).
// The limit is raised to the most a block may have once, and each launch
// asks for what its T needs.
template <int DM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int S, int T, int Hq, int Hkv, int D, float scale,
                   int causal, int window, cudaStream_t stream) {
  using Sh = Shape<DM>;
  constexpr int BM = Sh::BM;
  const long long smem = smem_bytes<DM>(T);
  if (smem > SMEM_OPTIN || (S + BM - 1) / BM > 65535 ||
      (long long)B * Hq > 2147483647LL)
    return cudaErrorInvalidValue;
  CUtensorMap tmq, tmk, tmv;
  cudaError_t e = encode_maps<DM>(&tmq, &tmk, &tmv, q, k, v, B, S, T, Hq,
                                  Hkv, D);
  if (e != cudaSuccess) return e;
  if ((e = raise_smem<attn_wgmma_kernel<DM>, SMEM_OPTIN>()) != cudaSuccess)
    return e;
  const Params p{q_pos, kv_pos, static_cast<__nv_bfloat16*>(out), S, T, Hq,
                 Hkv, D, causal, window, scale * 1.4426950408889634f};
  const dim3 grid(B * Hq, (S + BM - 1) / BM);
  attn_wgmma_kernel<DM><<<grid, Sh::NT, static_cast<int>(smem), stream>>>(
      tmq, tmk, tmv, p);
  return cudaGetLastError();
}

}  // namespace attn_wgmma
