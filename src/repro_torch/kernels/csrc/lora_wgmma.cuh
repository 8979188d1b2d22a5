// The bf16 tile of the three LoRA kernels on Hopper's tensor cores:
//
//   y[m, n] = acc[m, n] + s * sum_j u[m, j] B[slot(m)][j, n] (+ bias[n])
//
// where acc = x W comes from wgmma (bf16 operands, f32 accumulation) and
// u = x A[slot(m)] (f32, one row per warp) was written beforehand by the
// pass in lora_u.cuh. A bf16 x bf16 product is exact in f32, so this is
// the TPU kernel's f32 function with another order of summation.
//
// Shape: one 128 x 128 output tile per block of 256 threads, two
// warpgroups of 64 rows, each issuing wgmma.m64n128k16 four times per
// 64-deep K step. The operands come through a ring of 4 shared-memory
// stages (x 128 x 64 and W 64 x 128, 32 KB a stage, 128 KB in all)
// filled by TMA with the 128-byte swizzle: thread 0 keeps loads 3 steps
// ahead, a full barrier per stage counts the bytes in, and an empty
// barrier per stage takes one arrival from each warpgroup once
// wgmma.wait_group has shown that the products reading the stage are done;
// only then is it refilled. W (K, N) is read where it lies, as the
// N-major B operand (the transpose flag of wgmma): no copy of W is made.
// No warp specialisation, persistent grid, cluster or split-K.
//
// The bit contract. The three kernels run this one tile with the same
// instruction, K step and order for every M, and the epilogue's rank-r
// sum, scale, bias and cast are one fixed sequence per element, so a
// row's bits depend on its own x, its adapter and W only: not on M, on the
// rows beside it, or on its position in the tile (each wgmma output
// element is its own dot product).
#pragma once

#include "common.cuh"
#include "hopper.cuh"      // PTX: mbarriers, TMA, descriptors, wgmma sync
#include "lora_u.cuh"      // Slot

namespace lora_wgmma {

using namespace hopper;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4, NT = 256;
constexpr int RMAX = 32;                       // largest LoRA rank taken
constexpr int X_BYTES = BM * BK * 2, W_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
// the ring, its barriers, and slack to align the ring to 1024 bytes (the
// period of the 128-byte swizzle in shared address space)
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
// W's stage tile is two TMA boxes of 64 columns, each 64 K-rows of 128
// bytes. As wgmma's N-major B operand with the 128-byte swizzle: the
// leading byte offset steps between 64-column halves, the stride byte
// offset between groups of 8 K-rows (settled on the card by the one-tile
// probe, lora_matmul.cu; swapping the two gives wrong products).
constexpr uint32_t B_LBO = W_BYTES / 2, B_SBO = 1024;
constexpr uint32_t A_SBO = 1024;               // x: 8 rows of 128 bytes

struct Epilogue {
  const float* u;                  // (rows, r) f32, from lora_u.cuh
  const __nv_bfloat16* b;          // (n_slots, r, N); (r, N) for ONE
  const __nv_bfloat16* bias;       // (N,) or null
  const int* ids;                  // (groups,) PER_SEQ, (rows,) PER_ROW
  __nv_bfloat16* y;                // (rows, N)
  int G, N, K, r;                  // G: rows per group (S, or M)
  float scale;
};

// ---------------------------------------------------------------------------
// the product
// ---------------------------------------------------------------------------

// d (64 x 128, f32) += A (64 x 16, K-major) B (16 x 128, N-major).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// the ring
// ---------------------------------------------------------------------------

struct Ring {
  uint32_t base;                   // shared address of stage 0, 1024-aligned
  unsigned char* ptr;              // the same, generic
  uint64_t* full;                  // [STAGES]
  uint64_t* empty;                 // [STAGES]
};

__device__ __forceinline__ Ring ring_setup() {
  extern __shared__ __align__(1024) unsigned char lora_smem[];
  const uint32_t raw = smem_addr(lora_smem);
  Ring g;
  g.base = (raw + 1023u) & ~1023u;
  g.ptr = lora_smem + (g.base - raw);
  g.full = reinterpret_cast<uint64_t*>(g.ptr + STAGES * STAGE_BYTES);
  g.empty = g.full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&g.full[s]), 1);
      mbar_init(smem_addr(&g.empty[s]), NT / 128);  // one per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return g;
}

// Thread 0: K step kt into its stage. x's box is rows [r0, r0 + 128) of
// group z, columns [kt * 64, +64); W's two boxes are K-rows [kt * 64, +64)
// of columns [n0, +64) and [n0 + 64, +64). TMA fills what lies past the
// tensor's edge with zeros and still counts the whole box.
__device__ __forceinline__ void issue_stage(const Ring& g,
                                            const CUtensorMap* tmx,
                                            const CUtensorMap* tmw, int kt,
                                            int r0, int z, int n0) {
  const int s = kt % STAGES;
  const uint32_t xs = g.base + s * STAGE_BYTES, ws = xs + X_BYTES;
  const uint32_t bar = smem_addr(&g.full[s]);
  mbar_expect_tx(bar, STAGE_BYTES);
  tma_load_3d(xs, tmx, bar, kt * BK, r0, z);
  tma_load_2d(ws, tmw, bar, n0, kt * BK);
  tma_load_2d(ws + W_BYTES / 2, tmw, bar, n0 + BN / 2, kt * BK);
}

// This warpgroup's 64 rows of stage s times its whole W tile, 4 x k16.
__device__ __forceinline__ void mma_stage(float (&acc)[64], const Ring& g,
                                          int s, int wg) {
  const uint32_t xs = g.base + s * STAGE_BYTES + wg * (X_BYTES / 2);
  const uint32_t ws = g.base + s * STAGE_BYTES + X_BYTES;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n128k16(acc, sw128_desc(xs + kk * 32, 16, A_SBO),
                     sw128_desc(ws + kk * 16 * 128, B_LBO, B_SBO));
}

// acc[4 i + 2 h + e] of thread t of a warpgroup holds row
// 16 (t / 32) + (t % 32) / 4 + 8 h and column 8 i + 2 (t % 4) + e.
__device__ __forceinline__ int frag_row(int t, int h) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * h;
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return 8 * i + 2 * (t % 4);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Block (n tile, row tile, group z): rows [r0, r0 + 128) of group z, whose
// rows are G long (Slot::PER_SEQ: a sequence; else z = 0 and G = M).
template <Slot MODE>
__global__ void __launch_bounds__(NT, 1)
lora_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmw, Epilogue p) {
  const Ring g = ring_setup();
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * BM, z = blockIdx.z;
  const int nk = (p.K + BK - 1) / BK;

  if (tid == 0)
    for (int kt = 0; kt < nk && kt < STAGES - 1; ++kt)
      issue_stage(g, &tmx, &tmw, kt, r0, z, n0);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_addr(&g.full[s]), (kt / STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
    mma_stage(acc, g, s, wg);
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();                  // step kt - 1's products are done
    if (kt > 0 && t == 0)
      mbar_arrive(smem_addr(&g.empty[(kt - 1) % STAGES]));
    if (tid == 0) {
      const int nx = kt + STAGES - 1;   // refills step kt - 1's stage
      if (nx < nk) {
        if (nx >= STAGES)
          mbar_wait(smem_addr(&g.empty[nx % STAGES]), (nx / STAGES - 1) & 1);
        issue_stage(g, &tmx, &tmw, nx, r0, z, n0);
      }
    }
    __syncwarp();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  __syncthreads();                    // both warpgroups done: the ring is free

  // epilogue staging in the ring: u of the tile's rows, and B's (r x 128)
  // tile of the block's slot, or (Slot::PER_ROW) each row's slot
  float* Us = reinterpret_cast<float*>(g.ptr);                // [BM][RMAX+1]
  float* Bs = Us + BM * (RMAX + 1);                           // [RMAX][BN]
  int* slot_of = reinterpret_cast<int*>(Bs + RMAX * BN);      // [BM]
  const int r = p.r, N = p.N;
  const int rows = min(BM, p.G - r0);
  const long long row0 = (long long)z * p.G + r0;
  for (int i = tid; i < BM * r; i += NT) {
    const int m = i / r, j = i % r;
    Us[m * (RMAX + 1) + j] = m < rows ? p.u[(row0 + m) * r + j] : 0.f;
  }
  if constexpr (MODE == Slot::PER_ROW) {
    for (int i = tid; i < BM; i += NT)
      slot_of[i] = i < rows ? p.ids[row0 + i] : 0;
  } else {
    const long long slot = MODE == Slot::PER_SEQ ? p.ids[z] : 0;
    const __nv_bfloat16* bs = p.b + slot * r * N;
    for (int i = tid; i < r * BN; i += NT) {
      const int j = i / BN, c = i % BN, n = n0 + c;
      Bs[j * BN + c] = n < N ? to_f32(bs[(long long)j * N + n]) : 0.f;
    }
  }
  __syncthreads();

  // y = acc + s * (sum_j u B, j rising from 0) + bias, one cast; N % 8 == 0
  // (the wrapper pads), so a column pair is in or out together
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = wg * 64 + frag_row(t, h);
    if (rl >= rows) continue;
    const float* ur = Us + rl * (RMAX + 1);
    const __nv_bfloat16* br = MODE == Slot::PER_ROW
                                  ? p.b + (long long)slot_of[rl] * r * N
                                  : nullptr;
    __nv_bfloat16* yr = p.y + (row0 + rl) * N;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = frag_col(t, i), n = n0 + c;
      if (n >= N) continue;
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float lo = 0.f;
        for (int j = 0; j < r; ++j) {
          const float bv = MODE == Slot::PER_ROW
                               ? to_f32(br[(long long)j * N + n + e])
                               : Bs[j * BN + c + e];
          lo = __fmaf_rn(ur[j], bv, lo);
        }
        float out = __fmaf_rn(p.scale, lo, acc[4 * i + 2 * h + e]);
        if (p.bias != nullptr) out = __fadd_rn(out, to_f32(p.bias[n + e]));
        o[e] = out;
      }
      *reinterpret_cast<__nv_bfloat162*>(yr + n) =
          __floats2bfloat162_rn(o[0], o[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// bf16 maps with the 128-byte swizzle. x: (groups, rows, K), K innermost,
// box 64 x 128 x 1. w: (K, N), N innermost, box 64 x 64.
inline cudaError_t encode_maps(CUtensorMap* tmx, CUtensorMap* tmw,
                               const void* x, const void* w, int groups,
                               int rows, int N, int K) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (K % 8 != 0 || N % 8 != 0 || K == 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;    // TMA: 16-byte bases and row strides
  const cuuint32_t unit[3] = {1, 1, 1};
  const cuuint64_t xd[3] = {(cuuint64_t)K, (cuuint64_t)rows,
                            (cuuint64_t)groups};
  const cuuint64_t xs[2] = {(cuuint64_t)K * 2, (cuuint64_t)rows * K * 2};
  const cuuint32_t xb[3] = {BK, BM, 1};
  const cuuint64_t wd[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t ws[1] = {(cuuint64_t)N * 2};
  const cuuint32_t wb[2] = {BN / 2, BK};
  if (enc(tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), xd,
          xs, xb, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      enc(tmw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wd,
          ws, wb, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The bf16 projection of rows = groups * G rows: the u pass into u (rows,
// r) f32, then the tile into y (rows, N). x (groups, G, K), w (K, N), a
// (n_slots, K, r) (or (K, r)), b (n_slots, r, N) (or (r, N)), bias (N,)
// or null, ids per MODE. K % 8 == 0, N % 8 == 0, x and w 16-byte aligned
// (checked before anything launches), groups <= 65535.
template <Slot MODE>
cudaError_t launch(const void* x, const void* w, const void* a,
                   const void* b, const void* bias, const int* ids,
                   float* u, void* y, int groups, int G, int N, int K,
                   int r, float scale, cudaStream_t stream) {
  CUtensorMap tmx, tmw;
  cudaError_t e = encode_maps(&tmx, &tmw, x, w, groups, G, N, K);
  if (e != cudaSuccess) return e;
  if ((e = raise_smem<lora_wgmma_kernel<MODE>, SMEM_BYTES>()) !=
      cudaSuccess)
    return e;
  e = lora_u::launch<MODE>(x, a, ids, u, groups * G, K, r, G, stream);
  if (e != cudaSuccess) return e;
  const Epilogue p{u, static_cast<const __nv_bfloat16*>(b),
                   static_cast<const __nv_bfloat16*>(bias), ids,
                   static_cast<__nv_bfloat16*>(y), G, N, K, r, scale};
  const dim3 grid((N + BN - 1) / BN, (G + BM - 1) / BM, groups);
  lora_wgmma_kernel<MODE><<<grid, NT, SMEM_BYTES, stream>>>(tmx, tmw, p);
  return cudaGetLastError();
}

}  // namespace lora_wgmma
