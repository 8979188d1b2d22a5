// tracelint: kernel-op=lora_matmul oracle=lora_matmul_bwd
// Adapter gradients of the LoRA-fused projection y = x W + s (x A) B:
//   dA = s x^T (dy B^T)   (K, r) f32
//   dB = s (x A)^T dy     (r, N) f32
// the Hopper replacement of the TPU kernel
// repro/kernels/lora_matmul.py::lora_matmul_bwd_pallas (body _bwd_kernel).
// The frozen-weight gradient dW = x^T dy is never formed.
//
// What bounds it on an H100: the bytes of x (M, K) and dy (M, N), each
// read once (at M 1024, K N 3584, bf16: 14.7 MB, 4.4 us at 3.35 TB/s);
// the 4 M r (K + N) flops (235 MFLOP at r 8, ~3.5 us of f32 FMAs on the
// CUDA cores) come close. The TPU kernel sweeps M in sequence with K and N
// whole in VMEM and the two adapter-sized sums resident across grid steps.
// Blocks on the card run in no order and share nothing, so the sweep
// becomes two launches, back to back on one stream:
//
// 1. The rank pass: u[m] = x[m] A and g[m] = s dy[m] B^T (r values a row,
//    f32) into two (M, r) f32 scratch buffers.
//    - bf16, r <= 16, K and N multiples of 8: lora_bwd_ug_mma_kernel, on
//      the tensor cores (mma.sync m16n8k16: bf16 products summed exactly
//      into f32, so u and g are not rounded), 8 rows a block, the columns
//      dealt over the 16 warps, 16-byte streaming loads of x and dy that
//      bypass L1, A^T and B staged in shared memory (note at the kernel);
//    - otherwise (f32, r > 16, odd widths): lora_bwd_ug_kernel, on the
//      CUDA cores: 32 / RT rows a block of 256 threads (RT: the smallest
//      of 8, 16, 32 that holds r); thread t reads the 16-byte chunks t,
//      t + 256, ... of the block's rows, then each chunk's A rows or B row
//      pieces from L1; lane sums, a butterfly per warp, then the 8 warps in
//      order through shared memory.
//    A CUDA-core version of the bf16 pass (timed on an H100 at 700 W at
//    the q shape) spent ~10 of its 21 us on the A and B reads (a lane's 8
//    A rows lie 128 bytes from its neighbours', and the streaming x
//    evicted A from L1) and most of the rest waiting on one round of loads
//    at a time.
// 2. lora_bwd_split_kernel (the split sweep): a block per (column tile,
//    M split): TC = 512 / RT columns of dA (columns of x against g) or of
//    dB (columns of dy against u), over `rows` rows. Thread (row group
//    rg = tid / 8, chunk cc = tid % 8) reads CPT = 64 / RT columns as one
//    vector a row, rows rg, rg + 32, ... of the split, a batch's 8 rows'
//    loads (4 in f32 at r <= 8 and at r > 16) in flight before their
//    FMAs, so a thread holds CPT x RT = 64 sums at every r. The 4 row groups of a warp add by shuffles (xor 8, then 16),
//    the 8 warps in order through shared memory; the block writes its
//    (TC, RT) partial to a scratch buffer, takes a ticket (an integer
//    atomicAdd on the tile's counter), and the last block of the tile adds
//    the partials in split order, resets the counter for the next launch,
//    and writes the tile. The wrapper picks `rows` (lora_matmul.bwd_plan)
//    so that the grid is one wave of at most 2 blocks an SM: 112 tiles x 2
//    splits of 512 rows at the q shape (N 3584), 64 x 4 of 256 at the v
//    shape (N 512). A block takes its rows in batches of 256 (128 in f32
//    at r <= 8 and at r > 16), staging the batch's rows of g or u in shared
//    memory. Its second read of x and dy comes from the 50 MB L2, where
//    the rank pass left them.
//
// No float atomics: every output element is one fixed sequence of f32
// operations (and of tensor-core products), so repeated calls give the
// same bits. u and g stay f32, as the TPU kernel keeps them (the XLA route
// rounds them to the input dtype first); the sweep stays on the CUDA
// cores, where the tensor cores would round g and u to bf16.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int RMAX = 32;                      // largest LoRA rank taken
constexpr int NT = 256;                       // threads a block, both kernels
constexpr int NW = NT / 32;
constexpr int TPR = 8;                        // sweep: threads along a row
constexpr int RG = NT / TPR;                  // sweep: row groups

// 16 bytes of x or dy, read once by this pass: not kept in L1
__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// CNT values of T kept as raw 32-bit words until they are used, so a
// thread can hold several rows' loads in flight in few registers; at(i)
// is value i as a float.
template <typename T, int CNT>
struct Raw {
  static constexpr int WORDS = CNT * (int)sizeof(T) / 4;
  uint32_t w[WORDS];

  // one vector load where `vec` (the values whole and aligned to
  // min(16, their bytes)), else element by element, zeros past `avail`
  // (all zeros at avail <= 0)
  __device__ __forceinline__ void load(const T* __restrict__ p, int avail,
                                       bool vec) {
    if (vec) {
      if constexpr (WORDS >= 4) {
#pragma unroll
        for (int q = 0; q < WORDS / 4; ++q) {
          const uint4 v = reinterpret_cast<const uint4*>(p)[q];
          w[4 * q] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
      } else if constexpr (WORDS == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        w[0] = v.x;
        w[1] = v.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
      }
    } else {
#pragma unroll
      for (int q = 0; q < WORDS; ++q) w[q] = 0u;
#pragma unroll
      for (int i = 0; i < CNT; ++i)
        if (i < avail) set(i, p[i]);
    }
  }
  __device__ __forceinline__ void set(int i, float v) {
    w[i] = __float_as_uint(v);
  }
  __device__ __forceinline__ void set(int i, __nv_bfloat16 v) {
    const uint32_t h = __bfloat16_as_ushort(v);
    w[i / 2] |= i % 2 ? h << 16 : h;
  }
  __device__ __forceinline__ float at(int i) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[i]);
    else return __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u
                                      : w[i / 2] << 16);
  }
};

// u = x A and g = s dy B^T for the RPB = 32 / RT rows from
// blockIdx.x * RPB. Per (row, rank): thread t sums its chunks in rising
// order (within a chunk, rising k or n), a butterfly adds the lanes, and
// the warps' sums are added in warp order.
template <typename T, int RT>
__global__ void __launch_bounds__(NT, 2)
lora_bwd_ug_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ u, float* __restrict__ g, int M,
                   int N, int K, int r, float scale) {
  constexpr int VEC = 16 / (int)sizeof(T);    // elements a 16-byte chunk
  constexpr int RPB = 32 / RT;                // rows a block
  __shared__ float red[NW][2 * RPB * RT];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.x * RPB;
  const int nrows = min(RPB, M - m0);
  float au[RPB][RT], ag[RPB][RT];
#pragma unroll
  for (int p = 0; p < RPB; ++p)
#pragma unroll
    for (int j = 0; j < RT; ++j) au[p][j] = ag[p][j] = 0.f;

  // x A: a chunk of VEC columns of each row, then its VEC rows of A
  const bool xvec = K % VEC == 0 && aligned16(x);
  const bool avec = r == RT && aligned16(a);  // whole A rows as vectors
  for (int k0 = tid * VEC; k0 < K; k0 += NT * VEC) {
    Raw<T, VEC> xv[RPB];
#pragma unroll
    for (int p = 0; p < RPB; ++p)
      xv[p].load(x + (long long)(p < nrows ? m0 + p : 0) * K + k0,
                 p < nrows ? K - k0 : 0, xvec && p < nrows);
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      if (k0 + t < K) {
        Raw<T, RT> av;
        av.load(a + (long long)(k0 + t) * r, r, avec);
#pragma unroll
        for (int p = 0; p < RPB; ++p)
#pragma unroll
          for (int j = 0; j < RT; ++j)
            au[p][j] = __fmaf_rn(xv[p].at(t), av.at(j), au[p][j]);
      }
    }
  }
  // dy B^T: a chunk of VEC columns of each row against the same VEC
  // columns of each row of B
  const bool dvec = N % VEC == 0 && aligned16(dy);
  const bool bvec = N % VEC == 0 && aligned16(b);
  for (int n0 = tid * VEC; n0 < N; n0 += NT * VEC) {
    Raw<T, VEC> dv[RPB];
#pragma unroll
    for (int p = 0; p < RPB; ++p)
      dv[p].load(dy + (long long)(p < nrows ? m0 + p : 0) * N + n0,
                 p < nrows ? N - n0 : 0, dvec && p < nrows);
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      if (j < r) {
        Raw<T, VEC> bv;
        bv.load(b + (long long)j * N + n0, N - n0, bvec);
#pragma unroll
        for (int p = 0; p < RPB; ++p)
#pragma unroll
          for (int t = 0; t < VEC; ++t)
            ag[p][j] = __fmaf_rn(dv[p].at(t), bv.at(t), ag[p][j]);
      }
    }
  }

#pragma unroll
  for (int p = 0; p < RPB; ++p)
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const float su = warp_sum(au[p][j]), sg = warp_sum(ag[p][j]);
      if (lane == 0) {
        red[warp][p * RT + j] = su;
        red[warp][(RPB + p) * RT + j] = sg;
      }
    }
  __syncthreads();
  for (int e = tid; e < 2 * RPB * RT; e += NT) {
    const int which = e / (RPB * RT), p = e % (RPB * RT) / RT, j = e % RT;
    if (p >= nrows || j >= r) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[w][e];
    if (which == 0)
      u[(long long)(m0 + p) * r + j] = s;
    else
      g[(long long)(m0 + p) * r + j] = scale * s;
  }
}

// The bf16 rank pass on the tensor cores, for r <= 16 and K, N multiples
// of 8 (16-byte rows): u^T = A^T x^T and g^T = s B dy^T as
// mma.m16n8k16 products, the M side the (up to 16) ranks, the N side the
// block's 8 rows, the K side k (or n). A^T and B are staged in shared
// memory, rank-major, rows of ug_stride(K or N) elements (2 bytes each,
// 64 mod 128 bytes a row, so that a quarter-warp's 16-byte reads fall in
// distinct banks). The block's 32-column chunks of x, then of dy, are
// dealt to the 16 warps in turn (warp w takes chunks w, w + 16, ...): lane
// (gq = lane / 4, c = lane % 4) reads 16 bytes of its row m0 + gq at
// columns 8c .. 8c + 7 of the chunk, whose pairs are the k pairs of two
// products (the same permutation of k on both operands, so the sum is over
// the same terms). UG_U chunks a warp are in flight while the UG_U before
// them are multiplied (a double buffer in registers); the first are issued
// before the staging. The products sum bf16 x bf16 exactly into f32 (in
// the tensor core's order); the 16 warps' sums are added in warp order.
constexpr int UG_ROWS = 8;                    // rows a block (the mma's N)
constexpr int UG_U = 8;                       // chunks a warp in flight
constexpr int UG_NT = 512, UG_NW = UG_NT / 32; // threads, warps a block
constexpr int UG_SMEM = 200 * 1024;           // the most A^T and B may take

// a staged row's stride in elements for K (or N) columns (zero-padded)
__host__ __device__ constexpr int ug_stride(int K) {
  return (K + 63) / 64 * 64 + 32;
}

template <int RT>
__global__ void __launch_bounds__(UG_NT)
lora_bwd_ug_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ dy,
                       const __nv_bfloat16* __restrict__ a,
                       const __nv_bfloat16* __restrict__ b,
                       float* __restrict__ u, float* __restrict__ g, int M,
                       int N, int K, int r, float scale) {
  static_assert(RT == 8 || RT == 16, "one m16 tile of ranks");
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int ksk = ug_stride(K), ksn = ug_stride(N);
  bf16* at = reinterpret_cast<bf16*>(dyn);    // [RT][ksk]: A^T
  bf16* bt = at + RT * ksk;                   // [RT][ksn]: B
  __shared__ float red[UG_NW][2][16][UG_ROWS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane >> 2, c = lane & 3;
  const int m0 = blockIdx.x * UG_ROWS, row = m0 + gq;
  const bool rok = row < M;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const bf16 bzero = from_f32<bf16>(0.f);
  const bf16* xr = x + (long long)row * K;
  const bf16* yr = dy + (long long)row * N;
  const int nxc = (K + 31) / 32, nch = nxc + (N + 31) / 32;

  // chunk s of the block: x's chunk s, or dy's chunk s - nxc
  auto fetch = [&](int s) -> uint4 {
    if (!rok || s >= nch) return zero;
    if (s < nxc) {
      const int k = s * 32 + 8 * c;
      return k < K ? ldg_stream(xr + k) : zero;
    }
    const int n = (s - nxc) * 32 + 8 * c;
    return n < N ? ldg_stream(yr + n) : zero;
  };
  uint4 va[UG_U], vb[UG_U];
#pragma unroll
  for (int i = 0; i < UG_U; ++i) va[i] = fetch(warp + i * UG_NW);

  // A^T and B, zeros past K (N) and for ranks >= r: A's rows as 16-byte
  // loads where r fills RT (8 rows in flight a thread), else element by
  // element; B's rows as 16-byte pieces
  if (r == RT && aligned16(a)) {
    constexpr int Q = RT / 8;                 // 16-byte pieces an A row
    for (int k0 = tid; k0 < ksk; k0 += UG_NT * 8) {
      uint4 rows[8][Q];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + i * UG_NT;
#pragma unroll
        for (int q = 0; q < Q; ++q)
          rows[i][q] = k < K ? reinterpret_cast<const uint4*>(
                                   a + (long long)k * RT)[q]
                             : zero;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + i * UG_NT;
        if (k >= ksk) break;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const bf16* h = reinterpret_cast<const bf16*>(&rows[i][q]);
#pragma unroll
          for (int t = 0; t < 8; ++t) at[(8 * q + t) * ksk + k] = h[t];
        }
      }
    }
  } else {
    for (int e = tid; e < RT * ksk; e += UG_NT) {
      const int j = e / ksk, k = e % ksk;
      at[e] = j < r && k < K ? a[(long long)k * r + j] : bzero;
    }
  }
  const int pn = ksn / 8;                     // 16-byte pieces a B row
  for (int e0 = tid; e0 < RT * pn; e0 += UG_NT * 8) {
    uint4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + i * UG_NT, j = e / pn, n = e % pn * 8;
      v[i] = e < RT * pn && j < r && n < N
                 ? *reinterpret_cast<const uint4*>(b + (long long)j * N + n)
                 : zero;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + i * UG_NT;
      if (e < RT * pn) reinterpret_cast<uint4*>(bt)[e] = v[i];
    }
  }
  __syncthreads();

  float cu[4] = {0.f, 0.f, 0.f, 0.f}, cg[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = warp; s0 < nch; s0 += UG_NW * UG_U) {
#pragma unroll
    for (int i = 0; i < UG_U; ++i) vb[i] = fetch(s0 + (UG_U + i) * UG_NW);
#pragma unroll
    for (int i = 0; i < UG_U; ++i) {
      const int s = s0 + i * UG_NW;
      if (s >= nch) break;                    // uniform over the warp
      const bool on_x = s < nxc;
      const bf16* w = on_x ? at + gq * ksk + s * 32
                           : bt + gq * ksn + (s - nxc) * 32;
      const int ws = on_x ? ksk : ksn;
      const uint4 w0 = *reinterpret_cast<const uint4*>(w + 8 * c);
      const uint4 w1 = RT == 16
          ? *reinterpret_cast<const uint4*>(w + 8 * ws + 8 * c) : zero;
      const uint32_t a0[4] = {w0.x, w1.x, w0.y, w1.y};
      const uint32_t a1[4] = {w0.z, w1.z, w0.w, w1.w};
      if (on_x) {
        hopper::mma_bf16_16816(cu, a0, va[i].x, va[i].y);
        hopper::mma_bf16_16816(cu, a1, va[i].z, va[i].w);
      } else {
        hopper::mma_bf16_16816(cg, a0, va[i].x, va[i].y);
        hopper::mma_bf16_16816(cg, a1, va[i].z, va[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < UG_U; ++i) va[i] = vb[i];
  }
  // C fragments: (rank gq, rows 2c, 2c + 1), (rank gq + 8, the same rows)
  red[warp][0][gq][2 * c] = cu[0];
  red[warp][0][gq][2 * c + 1] = cu[1];
  red[warp][0][gq + 8][2 * c] = cu[2];
  red[warp][0][gq + 8][2 * c + 1] = cu[3];
  red[warp][1][gq][2 * c] = cg[0];
  red[warp][1][gq][2 * c + 1] = cg[1];
  red[warp][1][gq + 8][2 * c] = cg[2];
  red[warp][1][gq + 8][2 * c + 1] = cg[3];
  __syncthreads();
  for (int e = tid; e < 2 * 16 * UG_ROWS; e += UG_NT) {
    const int which = e / (16 * UG_ROWS), j = e / UG_ROWS % 16,
              rr = e % UG_ROWS;
    if (j >= r || m0 + rr >= M) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < UG_NW; ++w) sum += red[w][which][j][rr];
    if (which == 0)
      u[(long long)(m0 + rr) * r + j] = sum;
    else
      g[(long long)(m0 + rr) * r + j] = scale * sum;
  }
}

// Blocks (tile, split): tiles [0, nK) take TC columns of x against g into
// dA, tiles [nK, nK + nN) TC columns of dy against u into dB (times s);
// split s takes rows [s * rows, min(M, (s + 1) * rows)).
// part: (n_splits, nK + nN, TC * RT) f32 scratch; counters: nK + nN ints,
// zero before the launch and zero after it.
template <typename T, int RT>
__global__ void __launch_bounds__(NT, 2)
lora_bwd_split_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ u,
                      const float* __restrict__ g, float* __restrict__ da,
                      float* __restrict__ db, float* __restrict__ part,
                      int* __restrict__ counters, int M, int N, int K,
                      int r, float scale, int nK, int rows, int n_splits) {
  constexpr int CPT = 64 / RT;                // columns a thread
  constexpr int TC = TPR * CPT;               // columns a tile
  constexpr int TE = TC * RT;                 // partial sums a tile
  // rows a thread has in flight: 8, or 4 where a row's columns take 32
  // bytes (f32 at r <= 8), so that they fit in 32 registers, or where the
  // batch's rank rows would pass 16 KB (r > 16)
  constexpr int ROWB = Raw<T, CPT>::WORDS > 4 || RT > 16 ? 4 : 8;
  constexpr int RB = RG * ROWB;               // rows a batch
  __shared__ __align__(16) float rs[RB][RT];  // the batch's rank rows
  __shared__ float red[NW][TE];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x, split = blockIdx.y;
  const bool is_a = tile < nK;
  const T* src = is_a ? x : dy;
  const float* rk = is_a ? g : u;
  const int C = is_a ? K : N;
  const int c0 = (is_a ? tile : tile - nK) * TC;
  const int m_lo = split * rows, m_hi = min(M, m_lo + rows);
  const int rg = tid / TPR, cc = tid % TPR;
  const int c = c0 + cc * CPT;
  const bool vec = C % CPT == 0 && aligned16(src);

  float acc[CPT][RT];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;
  // batches of RB rows: each thread's rows of the batch (rg, rg + 32, ...)
  // in flight at once while the block stages the batch's rank rows
  for (int b0 = m_lo; b0 < m_hi; b0 += RB) {
    // rows past the split load as zeros, and their rank rows are zeros:
    // the FMAs below run unguarded and add exact zeros
    Raw<T, CPT> sv[ROWB];
#pragma unroll
    for (int i = 0; i < ROWB; ++i) {
      const int m = b0 + rg + i * RG;
      const bool on = c < C && m < m_hi;
      const T* row = src + (long long)(on ? m : 0) * C + c;
      if (vec)
        sv[i].load(row, on ? CPT : 0, on);
      else
        sv[i].load(row, on ? C - c : 0, false);
    }
    const int nb = min(RB, m_hi - b0);
    if (r == RT) {
      for (int e = tid; e < RB * RT / 4; e += NT)
        reinterpret_cast<float4*>(&rs[0][0])[e] =
            e < nb * RT / 4
                ? reinterpret_cast<const float4*>(rk + (long long)b0 * RT)[e]
                : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int e = tid; e < RB * RT; e += NT)
        rs[e / RT][e % RT] =
            e / RT < nb && e % RT < r
                ? rk[(long long)(b0 + e / RT) * r + e % RT] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWB; ++i) {
      const int m = rg + i * RG;
      float rv[RT];
#pragma unroll
      for (int q = 0; q < RT / 4; ++q) {
        const float4 v4 = reinterpret_cast<const float4*>(&rs[m][0])[q];
        rv[4 * q] = v4.x;
        rv[4 * q + 1] = v4.y;
        rv[4 * q + 2] = v4.z;
        rv[4 * q + 3] = v4.w;
      }
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        const float xv = sv[i].at(e);
#pragma unroll
        for (int j = 0; j < RT; ++j)
          acc[e][j] = __fmaf_rn(xv, rv[j], acc[e][j]);
      }
    }
    __syncthreads();                          // rs is refilled next batch
  }
  // the warp's 4 row groups: (rg0 + rg1) + (rg2 + rg3), lanes 0..7 keep it
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      float v = acc[i][j];
      v += __shfl_xor_sync(FULL_MASK, v, 8);
      v += __shfl_xor_sync(FULL_MASK, v, 16);
      acc[i][j] = v;
    }
  if (lane < TPR) {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) red[warp][(lane * CPT + i) * RT + j] =
          acc[i][j];
  }
  __syncthreads();
  // the block's partial, the warps added in order; element e is column
  // c0 + e / RT, rank e % RT
  const long long n_tiles = gridDim.x;
  float* mine = part + ((long long)split * n_tiles + tile) * TE;
  for (int e = tid; e < TE; e += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[w][e];
    mine[e] = s;
  }

  // the ticket: the last block of this tile adds the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + tile, 1) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) counters[tile] = 0;           // for the next launch
  for (int e = tid; e < TE; e += NT) {
    const int col = c0 + e / RT, j = e % RT;
    if (col >= C || j >= r) continue;
    float s = 0.f;
    for (int sp = 0; sp < n_splits; ++sp)
      s += __ldcg(part + ((long long)sp * n_tiles + tile) * TE + e);
    if (is_a)
      da[(long long)col * r + j] = s;
    else
      db[(long long)j * N + col] = scale * s;
  }
}

template <typename T, int RT>
cudaError_t launch_rt(const void* x, const void* dy, const void* a,
                      const void* b, float* u, float* g, float* da,
                      float* db, float* part, int* counters, int M, int N,
                      int K, int r, float scale, int rows, int n_splits,
                      cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  constexpr int RPB = 32 / RT, TC = TPR * 64 / RT;
  if (M > 0) {
    bool on_mma = false;
    if constexpr (std::is_same_v<T, __nv_bfloat16> && RT <= 16) {
      const long long smem = 2LL * RT * (ug_stride(K) + ug_stride(N));
      on_mma = K % 8 == 0 && N % 8 == 0 && smem <= UG_SMEM &&
               aligned16(x) && aligned16(dy) && aligned16(b);
      if (on_mma) {
        const cudaError_t e =
            hopper::raise_smem<lora_bwd_ug_mma_kernel<RT>, UG_SMEM>();
        if (e != cudaSuccess) return e;
        lora_bwd_ug_mma_kernel<RT>
            <<<(M + UG_ROWS - 1) / UG_ROWS, UG_NT, smem, stream>>>(
                xt, dyt, static_cast<const T*>(a), static_cast<const T*>(b),
                u, g, M, N, K, r, scale);
      }
    }
    if (!on_mma)
      lora_bwd_ug_kernel<T, RT><<<(M + RPB - 1) / RPB, NT, 0, stream>>>(
          xt, dyt, static_cast<const T*>(a), static_cast<const T*>(b), u, g,
          M, N, K, r, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int nK = (K + TC - 1) / TC, nN = (N + TC - 1) / TC;
  if (nK + nN == 0) return cudaSuccess;
  // with M == 0 the sweep writes zeros
  lora_bwd_split_kernel<T, RT><<<dim3(nK + nN, n_splits), NT, 0, stream>>>(
      xt, dyt, u, g, da, db, part, counters, M, N, K, r, scale, nK, rows,
      n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, const void* a,
                   const void* b, float* u, float* g, float* da, float* db,
                   float* part, int* counters, int M, int N, int K, int r,
                   float scale, int rows, int n_splits,
                   cudaStream_t stream) {
  if (r <= 8)
    return launch_rt<T, 8>(x, dy, a, b, u, g, da, db, part, counters, M, N,
                           K, r, scale, rows, n_splits, stream);
  if (r <= 16)
    return launch_rt<T, 16>(x, dy, a, b, u, g, da, db, part, counters, M,
                            N, K, r, scale, rows, n_splits, stream);
  return launch_rt<T, 32>(x, dy, a, b, u, g, da, db, part, counters, M, N,
                          K, r, scale, rows, n_splits, stream);
}

}  // namespace

// x (M, K), dy (M, N), a (K, r), b (r, N): contiguous, one dtype.
// u, g (M, r) f32 scratch; da (K, r), db (r, N) f32 outputs. part:
// n_splits x (nK + nN) x 512 f32 scratch, counters: nK + nN zeroed ints
// (the kernel leaves them zero), with nK, nN the column tiles of
// 512 / RT columns. Split s takes rows [s * rows, (s + 1) * rows); the
// splits must cover M. 1 <= r <= 32.
extern "C" int lora_matmul_bwd_launch(const void* x, const void* dy,
                                      const void* a, const void* b, void* u,
                                      void* g, void* da, void* db,
                                      void* part, void* counters, int M,
                                      int N, int K, int r, float scale,
                                      int rows, int n_splits, int dtype,
                                      void* stream) {
  if (r < 1 || r > RMAX || n_splits < 1 || rows < 1 ||
      (long long)rows * n_splits < M)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *uf = static_cast<float*>(u), *gf = static_cast<float*>(g);
  float *daf = static_cast<float*>(da), *dbf = static_cast<float*>(db);
  float* pf = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  if (dtype == DT_F32)
    return launch<float>(x, dy, a, b, uf, gf, daf, dbf, pf, cnt, M, N, K, r,
                         scale, rows, n_splits, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, dy, a, b, uf, gf, daf, dbf, pf, cnt, M,
                                 N, K, r, scale, rows, n_splits, st);
  return cudaErrorInvalidValue;
}

DEFINE_ERROR_STRING(lora_matmul_bwd)
