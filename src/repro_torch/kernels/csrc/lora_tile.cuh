// One (64 x 64) output tile of the LoRA-fused projection
// y = x W + s (x A) B (+ bias), shared by the three LoRA kernels:
//
// - lora_matmul.cu:    one adapter (A (K, r), B (r, N)) for every row;
// - lora_bgmv_seq.cu:  one adapter per block, the slot its sequence's id
//                      names in the stacks A (n_slots, K, r), B (n_slots,
//                      r, N);
// - lora_bgmv_rows.cu: each row its own slot (PER_ROW).
//
// Every output element goes through the same sequence of f32 operations in
// all three: the main product and u = x A summed over K in steps of BK, in
// the same order, u kept in f32 (never rounded to the input dtype), one
// cast at the end. A row's result therefore does not depend on the kernel,
// the tile or the rows beside it, which is what makes a mixed-domain wave
// equal single-tenant serving bit for bit.
//
// Tiles: one block per output tile, 256 threads, each thread 4 x 4 outputs
// at stride 16; K in steps of 32 through shared memory, the next step's
// tiles loading into registers while the current one computes (so a block
// waits for memory about once per step, not once per element). u for the
// block's 64 rows is recomputed per N tile, which costs 2 * 64 * r * K per
// block against 2 * 64 * 64 * K for the main product (1/8 at r = 8).
//
// With one adapter per block, A's K-step tile and B's (r x 64) tile are
// staged in shared memory. PER_ROW, the rows of a tile may name different
// slots, and staging every slot would take n_slots times the space; each
// row's u and rank-r epilogue read its own slot straight from device
// memory instead. The whole stack is n_slots * (K + N) * r elements
// (230 KB at 4 slots, K 3584, N 3584, r 8, bf16), so those reads hit L2.
#pragma once

#include "common.cuh"

namespace lora_tile {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int TX = 16, TY = 16, NT = TX * TY;
constexpr int RMAX = 32;                      // largest LoRA rank taken
constexpr int UPT = BM * RMAX / NT;           // u entries per thread
constexpr int XPT = BM * BK / NT, WPT = BK * BN / NT, APT = BK * RMAX / NT;

// Computes the tile at rows [m0, m0 + BM), columns [n0, n0 + BN) of
// y (M, N). x (M, K), w (K, N), bias (N,) or null. One adapter: a (K, r),
// b (r, N), ids unused. PER_ROW: a (n_slots, K, r), b (n_slots, r, N) and
// row m takes slot ids[m] (valid ids are the caller's contract).
template <typename T, bool PER_ROW>
__device__ __forceinline__ void tile(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ bias, const int* __restrict__ ids,
    T* __restrict__ y, int M, int N, int K, int r, float scale, int m0,
    int n0) {
  __shared__ float Xs[BK][BM + 1];            // transposed x tile
  __shared__ float Ws[BK][BN];
  __shared__ float As[PER_ROW ? 1 : BK][RMAX];
  __shared__ float Us[BM][RMAX + 1];
  __shared__ float Bs[PER_ROW ? 1 : RMAX][BN];
  __shared__ long long Aoff[PER_ROW ? BM : 1], Boff[PER_ROW ? BM : 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;

  if constexpr (PER_ROW) {                    // each row's slot offsets
    for (int i = tid; i < BM; i += NT) {
      const long long s = m0 + i < M ? ids[m0 + i] : 0;
      Aoff[i] = s * K * r;
      Boff[i] = s * r * N;
    }
  }

  float acc[4][4] = {};
  float u_acc[UPT] = {};

  T xr[XPT], wr[WPT], ar[APT];
  auto load = [&](int k0) {
#pragma unroll
    for (int it = 0; it < XPT; ++it) {
      const int e = tid + NT * it, rr = e / BK, c = e % BK;
      const int m = m0 + rr, kk = k0 + c;
      xr[it] = (m < M && kk < K) ? x[(long long)m * K + kk] : from_f32<T>(0.f);
    }
#pragma unroll
    for (int it = 0; it < WPT; ++it) {
      const int e = tid + NT * it, rr = e / BN, c = e % BN;
      const int kk = k0 + rr, n = n0 + c;
      wr[it] = (kk < K && n < N) ? w[(long long)kk * N + n] : from_f32<T>(0.f);
    }
    if constexpr (!PER_ROW) {
#pragma unroll
      for (int it = 0; it < APT; ++it) {
        const int e = tid + NT * it, rr = e / RMAX, j = e % RMAX;
        const int kk = k0 + rr;
        ar[it] = (kk < K && j < r) ? a[(long long)kk * r + j]
                                   : from_f32<T>(0.f);
      }
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int it = 0; it < XPT; ++it) {
      const int e = tid + NT * it;
      Xs[e % BK][e / BK] = to_f32(xr[it]);
    }
#pragma unroll
    for (int it = 0; it < WPT; ++it) {
      const int e = tid + NT * it;
      Ws[e / BN][e % BN] = to_f32(wr[it]);
    }
    if constexpr (!PER_ROW) {
#pragma unroll
      for (int it = 0; it < APT; ++it) {
        const int e = tid + NT * it;
        As[e / RMAX][e % RMAX] = to_f32(ar[it]);
      }
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * wv[j];
    }
#pragma unroll
    for (int e = 0; e < UPT; ++e) {
      const int p = tid + NT * e;
      if (p < BM * r) {
        const int m = p / r, j = p % r;
        float s = 0.f;
        if constexpr (PER_ROW) {
          if (m0 + m < M) {                   // rows past M are never written
            const T* am = a + Aoff[m] + (long long)k0 * r + j;
            for (int kk = 0; kk < BK; ++kk) {
              const float av = k0 + kk < K ? to_f32(am[(long long)kk * r])
                                           : 0.f;
              s += Xs[kk][m] * av;
            }
          }
        } else {
          for (int kk = 0; kk < BK; ++kk) s += Xs[kk][m] * As[kk][j];
        }
        u_acc[e] += s;
      }
    }
    __syncthreads();
  }

  // epilogue: y = acc + s * u B[:, tile] + bias, cast to the output dtype
#pragma unroll
  for (int e = 0; e < UPT; ++e) {
    const int p = tid + NT * e;
    if (p < BM * r) Us[p / r][p % r] = u_acc[e];
  }
  if constexpr (!PER_ROW) {
    for (int idx = tid; idx < r * BN; idx += NT) {
      const int j = idx / BN, c = idx % BN;
      const int n = n0 + c;
      Bs[j][c] = n < N ? to_f32(b[(long long)j * N + n]) : 0.f;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ml = ty + TY * i, m = m0 + ml;
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int nl = tx + TX * jj, n = n0 + nl;
      if (n >= N) continue;
      float lo = 0.f;
      if constexpr (PER_ROW) {
        const T* bm = b + Boff[ml] + n;
        for (int j = 0; j < r; ++j) lo += Us[ml][j] * to_f32(bm[(long long)j * N]);
      } else {
        for (int j = 0; j < r; ++j) lo += Us[ml][j] * Bs[j][nl];
      }
      float out = acc[i][jj] + scale * lo;
      if (bias != nullptr) out += to_f32(bias[n]);
      y[(long long)m * N + n] = from_f32<T>(out);
    }
  }
}

}  // namespace lora_tile
