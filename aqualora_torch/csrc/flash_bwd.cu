// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T * scale) V, recomputing P from the saved row logsumexp.
//
// Replaces the TPU kernels `_dq_kernel` (aqualora_tpu/ops/flash_attention.py:239)
// and `_dkv_kernel` (:269), launched by `_flash_backward`.  The same function
// and the same split into two kernels, so that no sum crosses blocks and the
// result is deterministic (no atomics; two calls on the same inputs give the
// same bits):
//
//   P  = exp(S * scale - L),  S = Q K^T,  L the forward's row logsumexp
//   dP = dO V^T,  delta = rowsum(dO o O) (a torch reduction in the wrapper,
//   as the JAX package computes it outside Pallas),  dS = P o (dP - delta)
//   dQ = dS K * scale          one block per (query tile, head, batch)
//   dK = dS^T Q * scale,  dV = P^T dO
//                              one block per (key tile, head, batch)
//
// The TPU kernels carry dQ (resp. dK, dV) in VMEM scratch across a
// sequential grid axis; here each block loops over the other sequence itself
// and keeps its sums in float32 registers.  The [Tq, Tk] S, P and dS never
// reach device memory.
//
// What bounds it on this card.  The least work is 10*B*H*Tq*Tk*D operations
// (S, dP, dQ, dK, dV; the dK/dV kernel recomputes S and dP, so the pair does
// 14) against about 4*(Tq+Tk)*D*2 bytes per (b, h): at the U-Net's
// self-attention shapes the tensor-core rate bounds it, at Tk = 77 the bytes.
//
// Which instance takes which path:
// - bfloat16 (the PPFT training path, phase 8 of chip_smoke.py): the
//   tensor-core kernels `flash_bwd_dq_tc_kernel` and
//   `flash_bwd_dkv_tc_kernel` below, and at d > 160 the d = 512 ones.
// - float32 at d > 160 (stage 1's default path, the VAE mid-block at d =
//   512): the d = 512 tensor-core kernels, their products in TF32 with the
//   3xTF32 split (each operand x = hi + lo, three products a_lo b_hi + a_hi
//   b_lo + a_hi b_hi), which keeps the float32 limit (1e-4 of the largest
//   gradient) where one TF32 product (about three decimal digits) would not.
// - float32 at d <= 160 (the tiny card-vs-CPU checks): the CUDA-core
//   kernels `flash_bwd_dq_kernel` and `flash_bwd_dkv_kernel`, float32 FMAs.
//
// Tensor-core design (bfloat16).
// - Products: `mma.sync.aligned.m16n8k16` bf16 x bf16 -> float32 with
//   `ldmatrix` (`.trans` where the operand is stored k-major), not `wgmma`:
//   it needs no shared-memory descriptors and lets a warp turn its float32
//   score accumulator into the A operand of the next product in registers.
//   wgmma with TMA is the larger next step.
// - Layout of the products.  A warp owns 16 or 32 rows of the block's tile
//   (query rows in the dQ kernel, key rows in the dK/dV kernel).  The dQ
//   kernel computes S = Q K^T and dP = dO V^T, forms dS in registers and uses
//   it as the A operand of dQ += dS K.  The dK/dV kernel computes S^T = K Q^T
//   and dP^T = V dO^T with its own keys as rows, so P^T and dS^T are already
//   the A operands of dV += P^T dO and dK += dS^T Q.  Neither P nor dS goes
//   through shared memory or shuffles; each is rounded to bf16 once, as an
//   operand, and every sum is float32.
// - Staging.  The block's own rows are copied once; the streamed tiles (K, V
//   in the dQ kernel; Q, dO, L, delta in the dK/dV kernel) go through a ring
//   of two stages in dynamic shared memory with 16-byte `cp.async` (4-byte
//   for L and delta), so the next tile's copy overlaps this tile's products.
//   Rows are padded by 16 bytes (DP + 8 elements), which puts the eight rows
//   an `ldmatrix` reads on eight different bank groups.
// - What bounds it in practice: the shared-memory reads of the operands and
//   the special-function unit.  At d = 40 a warp owns two m16 tiles, so each
//   B operand it reads feeds two products, and at d <= 80 it keeps the A
//   operands of its own rows in registers for the whole loop.  exp2 is one
//   `ex2.approx.ftz` instruction, not exp2f's longer sequence with its
//   subnormal handling.
// - Filling the card.  With 64-row tiles a short own sequence leaves the
//   card underfilled (Tk = 77 at B8 H8 gives 128 blocks for 132 SMs).  When
//   ceil(T / 64) * B * H is below two blocks per SM the block owns 16 rows
//   instead and its four warps split each streamed tile four ways; their
//   partial sums are added in shared memory in a fixed warp order at the end
//   (Tk = 77: 320 blocks).  No second launch, and the result is still
//   deterministic.
// - Tiles per head dim (DP = 48 for d <= 48, 80, 160; `Tc` below): own rows
//   128 / 64 / 64 (16 when narrow), streamed tiles of 64 rows (32 for the
//   64-row d = 160 kernels), and NC, the streamed rows a warp scores at
//   once, chosen so that the accumulators stay in registers (ptxas: at most
//   244 registers, no spills): at d = 160 the dK/dV kernel holds 160 float32
//   sums of dK and dV a thread and scores 16 queries at a time.
//
// Ragged shapes are masked, never padded in memory: head dims that are not a
// multiple of 16 (40) are zero-filled by the copy itself (cp.async with a
// source size of 0); keys past Tk get P = 0 in the dQ kernel and are not
// written by the dK/dV kernel; query rows past Tq have no defined L or
// delta, so the dK/dV kernel masks their P (and with it dS) to zero rather
// than only skipping their stores.  A head dim that is not a multiple of 8,
// or an input not 16-byte aligned, is staged by plain loads instead of
// cp.async.
//
// Head dims 161..512 (the VAE mid-block's single-head d = 512 attention,
// differentiated in stage 1 through the watermarked decode) have kernels of
// their own, one body for both types: `flash_bwd_dq_d512_tc_kernel<T>` and
// `flash_bwd_dkv_d512_tc_kernel<T>` (`bwd_d512_tc` below), each warp a
// 128-column quarter of the head dim, the partial S and dP added in shared
// memory in warp order, P and dS through shared memory once a tile (bf16
// m16n8k16 products; float32 m16n8k8 TF32 products, 3xTF32).  A float32
// head dim that is not a multiple of 4 (bf16: 8), or an input not 16-byte
// aligned, is staged by plain loads.  Head dims above 512 are refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

#include "tensor_core.cuh"

namespace {

using namespace aqualora_tc;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32, d <= 160: CUDA-core kernels
// ---------------------------------------------------------------------------

// Tile shape per padded head dim DP: G lanes per row group, TM rows per group,
// BN columns (rows of the other sequence) per inner tile.  Registers per
// thread: 2*TM*DP/G accumulators in the dK/dV kernel (TM*DP/G in the dQ
// kernel) and 2*TM*BN/G scores.  128 threads form row groups of G lanes (G
// divides 32); lane g scores columns g, g+G, ... of the tile and accumulates
// output columns g, g+G, ...; P and dS are passed across the group by
// shuffles.
template <int DP>
struct Cfg;
template <> struct Cfg<48>  { static constexpr int G = 8,  TM = 4, BN = 32; };
template <> struct Cfg<80>  { static constexpr int G = 8,  TM = 4, BN = 32; };
template <> struct Cfg<160> { static constexpr int G = 16, TM = 4, BN = 32; };

// Shared-memory row stride in floats: an odd number of 4-byte words.
template <int DP>
__host__ __device__ constexpr int row_stride() { return DP + 1; }

// Stage rows [r0, r0 + R) of a [n, D] matrix into a [R, LD] shared tile,
// zeros past n and past D.
template <int DP, int R>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int n, int D) {
  constexpr int LD = row_stride<DP>();
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (r0 + r < n && c < D) x = src[(size_t)(r0 + r) * D + c];
    dst[r * LD + c] = x;
  }
}

// Two dot products of TM own rows against NC columns of the tile, over the
// head dim: a[i][j] = rowA_i . colA_j and b[i][j] = rowB_i . colB_j.
template <int DP, int TM, int NC, int G>
__device__ __forceinline__ void dots(float (&a)[TM][NC], float (&b)[TM][NC],
                                     const float* rowA, const float* rowB,
                                     const float* colA, const float* colB,
                                     int row0, int g) {
  constexpr int LD = row_stride<DP>();
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) a[i][j] = b[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < DP; c += 2) {
    float2 ra[TM], rb[TM], ca[NC], cb[NC];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float* pa = rowA + (row0 + i) * LD + c;
      const float* pb = rowB + (row0 + i) * LD + c;
      ra[i] = make_float2(pa[0], pa[1]);
      rb[i] = make_float2(pb[0], pb[1]);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float* pa = colA + (g + G * j) * LD + c;
      const float* pb = colB + (g + G * j) * LD + c;
      ca[j] = make_float2(pa[0], pa[1]);
      cb[j] = make_float2(pb[0], pb[1]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        a[i][j] = fmaf(ra[i].x, ca[j].x, a[i][j]);
        a[i][j] = fmaf(ra[i].y, ca[j].y, a[i][j]);
        b[i][j] = fmaf(rb[i].x, cb[j].x, b[i][j]);
        b[i][j] = fmaf(rb[i].y, cb[j].y, b[i][j]);
      }
  }
}

// dQ: one block per (query tile, head, batch), looping over the key tiles.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Tq, int Tk, int D, float scale,
                    float scale_log2) {
  using C = Cfg<DP>;
  constexpr int G = C::G, TM = C::TM, BN = C::BN;
  constexpr int BQ = (kThreads / G) * TM;
  constexpr int NK = BN / G;   // keys per lane per tile
  constexpr int ND = DP / G;   // output columns per lane
  constexpr int LD = row_stride<DP>();
  static_assert(DP % 2 == 0 && BN % G == 0 && DP % G == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* do_s = q_s + BQ * LD;
  float* k_s = do_s + BQ * LD;
  float* v_s = k_s + BN * LD;

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int row0 = (tid / G) * TM;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;

  stage<DP, BQ>(q_s, q + bh * Tq * D, q0, Tq, D);
  stage<DP, BQ>(do_s, dout + bh * Tq * D, q0, Tq, D);

  // L in log2 units and delta of the own rows; rows past Tq are never
  // written, so any finite value will do
  float lrow[TM], drow[TM], acc[TM][ND];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + row0 + i;
    lrow[i] = r < Tq ? lse[bh * Tq + r] * kLog2e : 0.f;
    drow[i] = r < Tq ? delta[bh * Tq + r] : 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (Tk + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // Q, dO staged (t == 0) / previous K tile consumed
    stage<DP, BN>(k_s, kb, k0, Tk, D);
    stage<DP, BN>(v_s, vb, k0, Tk, D);
    __syncthreads();

    float s[TM][NK], dp[TM][NK];
    dots<DP, TM, NK, G>(s, dp, q_s, do_s, k_s, v_s, row0, g);

    // dS = P o (dP - delta), P = 0 for keys past Tk
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const bool valid = k0 + g + G * j < Tk;
        const float p = valid ? exp2f(s[i][j] * scale_log2 - lrow[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - drow[i]);
      }

    // dQ += dS K: dS of key (j*G + src) comes from lane src by shuffle
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int src = 0; src < G; ++src) {
        const float* krow = k_s + (j * G + src) * LD;
        float ds[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) ds[i] = __shfl_sync(kFull, s[i][j], src, G);
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) {
          const float kv = krow[g + G * jd];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][jd] = fmaf(ds[i], kv, acc[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + row0 + i;
    if (r < Tq) {
      float* row = dq + (bh * Tq + r) * D;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        const int c = g + G * jd;
        if (c < D) row[c] = acc[i][jd] * scale;
      }
    }
  }
}

// dK, dV: one block per (key tile, head, batch), looping over the query tiles.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Tq, int Tk, int D,
                     float scale, float scale_log2) {
  using C = Cfg<DP>;
  constexpr int G = C::G, TM = C::TM, BN = C::BN;
  constexpr int BK = (kThreads / G) * TM;
  constexpr int NQ = BN / G;   // queries per lane per tile
  constexpr int ND = DP / G;
  constexpr int LD = row_stride<DP>();
  static_assert(DP % 2 == 0 && BN % G == 0 && DP % G == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* l_s = reinterpret_cast<float*>(smem_raw);   // BN
  float* d_s = l_s + BN;                             // BN
  float* k_s = d_s + BN;
  float* v_s = k_s + BK * LD;
  float* q_s = v_s + BK * LD;
  float* do_s = q_s + BN * LD;

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int row0 = (tid / G) * TM;
  const int k0 = blockIdx.x * BK;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* qb = q + bh * Tq * D;
  const float* dob = dout + bh * Tq * D;

  stage<DP, BK>(k_s, k + bh * Tk * D, k0, Tk, D);
  stage<DP, BK>(v_s, v + bh * Tk * D, k0, Tk, D);

  float acc_k[TM][ND], acc_v[TM][ND];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_tiles = (Tq + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BN;
    __syncthreads();  // K, V staged (t == 0) / previous Q tile consumed
    stage<DP, BN>(q_s, qb, q0, Tq, D);
    stage<DP, BN>(do_s, dob, q0, Tq, D);
    for (int r = tid; r < BN; r += kThreads) {
      const bool valid = q0 + r < Tq;
      l_s[r] = valid ? lse[bh * Tq + q0 + r] * kLog2e : 0.f;
      d_s[r] = valid ? delta[bh * Tq + q0 + r] : 0.f;
    }
    __syncthreads();

    // s = K Q^T (rows: own keys, columns: the tile's queries), dp = V dO^T
    float s[TM][NQ], dp[TM][NQ];
    dots<DP, TM, NQ, G>(s, dp, k_s, v_s, q_s, do_s, row0, g);

    // P and dS; queries past Tq have no L or delta, so their P is masked
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c = g + G * j;
      const bool valid = q0 + c < Tq;
      const float lj = l_s[c], dj = d_s[c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float p = valid ? exp2f(s[i][j] * scale_log2 - lj) : 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dj);
      }
    }

    // dV += P^T dO, dK += dS^T Q: P, dS of query (j*G + src) from lane src
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int src = 0; src < G; ++src) {
        const float* qrow = q_s + (j * G + src) * LD;
        const float* dorow = do_s + (j * G + src) * LD;
        float p[TM], ds[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          p[i] = __shfl_sync(kFull, s[i][j], src, G);
          ds[i] = __shfl_sync(kFull, dp[i][j], src, G);
        }
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) {
          const float qv = qrow[g + G * jd];
          const float ov = dorow[g + G * jd];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc_v[i][jd] = fmaf(p[i], ov, acc_v[i][jd]);
            acc_k[i][jd] = fmaf(ds[i], qv, acc_k[i][jd]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = k0 + row0 + i;
    if (r < Tk) {
      float* krow = dk + (bh * Tk + r) * D;
      float* vrow = dv + (bh * Tk + r) * D;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        const int c = g + G * jd;
        if (c < D) {
          krow[c] = acc_k[i][jd] * scale;
          vrow[c] = acc_v[i][jd];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernels: bfloat16, and float32 at d = 512
// ---------------------------------------------------------------------------

// cp.async staging (stage_tc), ldmatrix loads (load_rm, load_nk,
// load_a_tf32, load_nk_tf32) and the products (mma_bf16, mma_3xtf32) come
// from tensor_core.cuh.

// 4 bytes global -> shared, asynchronously (lse and delta rows).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// Tiles of the tensor-core kernels.  A block has 4 warps: WR along its own
// rows and WS = 4 / WR along the streamed tile of BN rows, of which each
// warp takes SPAN = BN / WS, NC at a time.  A warp owns MT m16 tiles (16 * MT
// rows), so each B operand it loads from shared memory feeds MT products.
// With AREG the warp keeps the A operands of its own rows (Q and dO, or K
// and V) in registers for the whole loop instead of reloading them.  LDS is
// the shared row stride in elements (16 bytes of padding), NB the head dim in
// 8-column blocks.  `dkv` picks the dK/dV kernel's NC: it holds two
// accumulators.
template <int DP, int WR, bool dkv>
struct Tc {
  static_assert(DP % 16 == 0 && (WR == 1 || WR == 4), "tile shape");
  static constexpr int WS = 4 / WR;
  static constexpr int MT = (WR == 4 && DP == 48) ? 2 : 1;
  static constexpr bool AREG = DP <= 80;
  static constexpr int BR = 16 * MT * WR;
  static constexpr int BN = (WR == 4 && DP == 160) ? 32 : 64;
  static constexpr int SPAN = BN / WS;
  static constexpr int NC_MAX = dkv ? (DP == 80 ? 32 : 16) : 32;
  static constexpr int NC = SPAN < NC_MAX ? SPAN : NC_MAX;
  static constexpr int LDS = DP + 8, NB = DP / 8;
  static_assert(SPAN % NC == 0 && NC % 16 == 0, "tile shape");
  static_assert(MT == 1 || WS == 1, "partial sums are added per m16 tile");
  // staged bf16 rows: own (2 x BR) and the two-stage ring (2 x 2 x BN)
  static constexpr size_t stage_bytes =
      (size_t)(2 * BR + 4 * BN) * LDS * sizeof(bf16) +
      (dkv ? 2 * 2 * BN * sizeof(float) : 0);
  // float32 partial sums of one accumulator per warp, when WS > 1
  static constexpr size_t reduce_bytes =
      WS > 1 ? (size_t)WS * NB * 4 * 32 * sizeof(float) : 0;
  static constexpr size_t smem_bytes =
      stage_bytes > reduce_bytes ? stage_bytes : reduce_bytes;
};

// The A operands of a warp's own rows (MT m16 tiles at own_row of tiles a
// and c) over the head dim, kept in registers when AREG; without AREG the
// arrays are one step long and unused.
template <int DP, int MT, bool AREG>
struct OwnFrags {
  static constexpr int KS = AREG ? DP / 16 : 1;
  unsigned a[MT][KS][4], c[MT][KS][4];

  __device__ __forceinline__ void load(const bf16* ta, const bf16* tc,
                                       int own_row, int lane) {
    if (AREG) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          load_rm<DP + 8, false>(a[m][ks], ta, own_row + 16 * m, 16 * ks,
                                 lane);
          load_rm<DP + 8, false>(c[m][ks], tc, own_row + 16 * m, 16 * ks,
                                 lane);
        }
    }
  }
};

// s += A_rows B^T and dp += C_rows D^T over the head dim, for the warp's
// MT x 16 own rows (at own_row of tiles a and c, or in `own`) against NC
// streamed rows (at n0 of tiles b and d).
template <int DP, int NC, int MT, bool AREG>
__device__ __forceinline__ void scores(float (&s)[MT][NC / 8][4],
                                       float (&dp)[MT][NC / 8][4],
                                       const OwnFrags<DP, MT, AREG>& own,
                                       const bf16* a, const bf16* c,
                                       int own_row, const bf16* b,
                                       const bf16* d, int n0, int lane) {
  constexpr int LDS = DP + 8;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[m][j][i] = dp[m][j][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    unsigned fa[MT][4], fc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (AREG) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fa[m][r] = own.a[m][AREG ? ks : 0][r];
          fc[m][r] = own.c[m][AREG ? ks : 0][r];
        }
      } else {
        load_rm<LDS, false>(fa[m], a, own_row + 16 * m, 16 * ks, lane);
        load_rm<LDS, false>(fc[m], c, own_row + 16 * m, 16 * ks, lane);
      }
    }
#pragma unroll
    for (int j = 0; j < NC / 16; ++j) {
      unsigned fb[4], fd[4];
      load_nk<LDS>(fb, b, n0 + 16 * j, 16 * ks, lane);
      load_nk<LDS>(fd, d, n0 + 16 * j, 16 * ks, lane);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(s[m][2 * j], fa[m], fb[0], fb[1]);
        mma_bf16(s[m][2 * j + 1], fa[m], fb[2], fb[3]);
        mma_bf16(dp[m][2 * j], fc[m], fd[0], fd[1]);
        mma_bf16(dp[m][2 * j + 1], fc[m], fd[2], fd[3]);
      }
    }
  }
}

// acc (MT x 16 x DP) += X (MT x 16 x NC, float32 accumulator layout,
// rounded to bf16 here) * Y (NC streamed rows at n0 of a k-major tile, x DP).
// The accumulator of 8-column blocks 2j and 2j+1 is the A operand of k
// step j.
template <int DP, int NC, int MT>
__device__ __forceinline__ void accumulate(float (&acc)[MT][DP / 8][4],
                                           const float (&x)[MT][NC / 8][4],
                                           const bf16* y, int n0, int lane) {
  constexpr int LDS = DP + 8;
#pragma unroll
  for (int j = 0; j < NC / 16; ++j) {
    unsigned a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      a[m][0] = pack_bf16(x[m][2 * j][0], x[m][2 * j][1]);
      a[m][1] = pack_bf16(x[m][2 * j][2], x[m][2 * j][3]);
      a[m][2] = pack_bf16(x[m][2 * j + 1][0], x[m][2 * j + 1][1]);
      a[m][3] = pack_bf16(x[m][2 * j + 1][2], x[m][2 * j + 1][3]);
    }
#pragma unroll
    for (int nd = 0; nd < DP / 16; ++nd) {
      unsigned b[4];
      load_rm<LDS, true>(b, y, n0 + 16 * j, 16 * nd, lane);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(acc[m][2 * nd], a[m], b[0], b[1]);
        mma_bf16(acc[m][2 * nd + 1], a[m], b[2], b[3]);
      }
    }
  }
}
// Write a warp's 16 x DP accumulator (rows row0.., times mult) as bf16 rows
// of `out` [Trows, D].  With WS > 1 the WS warps hold partial sums of the
// same rows: they are added through shared memory `red` in warp order, so
// the result does not depend on timing.
template <int DP, int WS>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 8][4],
                                           float* red, bf16* out, int row0,
                                           int Trows, int D, float mult,
                                           int ws, int lane) {
  constexpr int E = DP / 8 * 4 * 32;
  if (WS == 1) {
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + (lane >> 2) + (i >> 1) * 8;
        const int c = nb * 8 + 2 * (lane & 3) + (i & 1);
        if (r < Trows && c < D)
          out[(size_t)r * D + c] = __float2bfloat16(acc[nb][i] * mult);
      }
    return;
  }
  __syncthreads();  // every warp is done with the shared tiles / red
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[ws * E + (nb * 4 + i) * 32 + lane] = acc[nb][i];
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WS; ++w) sum += red[w * E + e];
    const int l = e & 31, i = (e >> 5) & 3, nb = e >> 7;
    const int r = row0 + (l >> 2) + (i >> 1) * 8;
    const int c = nb * 8 + 2 * (l & 3) + (i & 1);
    if (r < Trows && c < D) out[(size_t)r * D + c] = __float2bfloat16(sum * mult);
  }
}

// dQ: one block per (query tile of BR rows, head, batch), looping over the
// key tiles.
template <int DP, int WR>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int H, int Tq, int Tk, int D, float scale,
                       float scale_log2, int vec) {
  using C = Tc<DP, WR, false>;
  constexpr int BR = C::BR, BN = C::BN, NC = C::NC, LDS = C::LDS, MT = C::MT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BR * LDS;
  bf16* k_s = do_s + BR * LDS;          // [2][BN][LDS]
  bf16* v_s = k_s + 2 * BN * LDS;       // [2][BN][LDS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ws = warp % C::WS, own = (warp / C::WS) * 16 * MT;
  const int q0 = blockIdx.x * BR;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const bf16* kb = k + bh * Tk * D;
  const bf16* vb = v + bh * Tk * D;

  stage_tc<DP, BR>(q_s, q + bh * Tq * D, q0, Tq, D, vec);
  stage_tc<DP, BR>(do_s, dout + bh * Tq * D, q0, Tq, D, vec);
  stage_tc<DP, BN>(k_s, kb, 0, Tk, D, vec);
  stage_tc<DP, BN>(v_s, vb, 0, Tk, D, vec);
  cp_async_commit();

  // L (log2 units) and delta of rows g and g + 8 of each m16 tile; rows past
  // Tq are never written, so any finite value will do
  float lrow[MT][2], drow[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + own + 16 * m + (lane >> 2) + 8 * h;
      lrow[m][h] = r < Tq ? lse[bh * Tq + r] * kLog2e : 0.f;
      drow[m][h] = r < Tq ? delta[bh * Tq + r] : 0.f;
    }
  float acc[MT][DP / 8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  OwnFrags<DP, MT, C::AREG> frags;

  const int n_tiles = (Tk + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      stage_tc<DP, BN>(k_s + nxt * BN * LDS, kb, (t + 1) * BN, Tk, D, vec);
      stage_tc<DP, BN>(v_s + nxt * BN * LDS, vb, (t + 1) * BN, Tk, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) frags.load(q_s, do_s, own, lane);
    const bf16* kt = k_s + (t & 1) * BN * LDS;
    const bf16* vt = v_s + (t & 1) * BN * LDS;
#pragma unroll 1
    for (int n0 = ws * C::SPAN; n0 < (ws + 1) * C::SPAN; n0 += NC) {
      float s[MT][NC / 8][4], dp[MT][NC / 8][4];
      scores<DP, NC, MT, C::AREG>(s, dp, frags, q_s, do_s, own, kt, vt, n0,
                                  lane);
      // dS = P o (dP - delta), P = 0 for keys past Tk
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = t * BN + n0 + 8 * j + 2 * (lane & 3) + (i & 1);
            const float p = key < Tk
                ? exp2_ftz(s[m][j][i] * scale_log2 - lrow[m][i >> 1]) : 0.f;
            s[m][j][i] = p * (dp[m][j][i] - drow[m][i >> 1]);
          }
      accumulate<DP, NC, MT>(acc, s, kt, n0, lane);   // dQ += dS K
    }
    __syncthreads();  // the stage is refilled at t + 2
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    store_rows<DP, C::WS>(acc[m], reinterpret_cast<float*>(smem_raw),
                          dq + bh * Tq * D, q0 + own + 16 * m, Tq, D, scale,
                          ws, lane);
}

// dK, dV: one block per (key tile of BR rows, head, batch), looping over the
// query tiles.
template <int DP, int WR>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                        int Tq, int Tk, int D, float scale, float scale_log2,
                        int vec) {
  using C = Tc<DP, WR, true>;
  constexpr int BR = C::BR, BN = C::BN, NC = C::NC, LDS = C::LDS, MT = C::MT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + BR * LDS;
  bf16* q_s = v_s + BR * LDS;           // [2][BN][LDS]
  bf16* do_s = q_s + 2 * BN * LDS;      // [2][BN][LDS]
  float* l_s = reinterpret_cast<float*>(do_s + 2 * BN * LDS);   // [2][BN]
  float* d_s = l_s + 2 * BN;                                    // [2][BN]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ws = warp % C::WS, own = (warp / C::WS) * 16 * MT;
  const int k0 = blockIdx.x * BR;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const bf16* qb = q + bh * Tq * D;
  const bf16* dob = dout + bh * Tq * D;
  const float* lb = lse + bh * Tq;
  const float* db = delta + bh * Tq;

  // queries [q0, q0 + BN) into ring stage st: Q, dO, L and delta (zeros
  // past Tq)
  auto stage_q = [&](int st, int q0) {
    stage_tc<DP, BN>(q_s + st * BN * LDS, qb, q0, Tq, D, vec);
    stage_tc<DP, BN>(do_s + st * BN * LDS, dob, q0, Tq, D, vec);
    for (int r = threadIdx.x; r < BN; r += kThreads) {
      const bool ok = q0 + r < Tq;
      cp_async4(l_s + st * BN + r, ok ? lb + q0 + r : lb, ok ? 4 : 0);
      cp_async4(d_s + st * BN + r, ok ? db + q0 + r : db, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  stage_tc<DP, BR>(k_s, k + bh * Tk * D, k0, Tk, D, vec);
  stage_tc<DP, BR>(v_s, v + bh * Tk * D, k0, Tk, D, vec);
  stage_q(0, 0);

  float acc_k[MT][DP / 8][4], acc_v[MT][DP / 8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_k[m][j][i] = acc_v[m][j][i] = 0.f;
  OwnFrags<DP, MT, C::AREG> frags;

  const int n_tiles = (Tq + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage_q((t + 1) & 1, (t + 1) * BN);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) frags.load(k_s, v_s, own, lane);
    const int st = t & 1;
    const bf16* qt = q_s + st * BN * LDS;
    const bf16* dot = do_s + st * BN * LDS;
#pragma unroll 1
    for (int n0 = ws * C::SPAN; n0 < (ws + 1) * C::SPAN; n0 += NC) {
      // S^T = K Q^T and dP^T = V dO^T: own keys as rows, queries as columns
      float s[MT][NC / 8][4], dp[MT][NC / 8][4];
      scores<DP, NC, MT, C::AREG>(s, dp, frags, k_s, v_s, own, qt, dot, n0,
                                  lane);
      // P^T and dS^T; queries past Tq have no L or delta: P = 0
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + 8 * j + 2 * (lane & 3) + e;
          const bool ok = t * BN + c < Tq;
          const float lc = l_s[st * BN + c] * kLog2e, dc = d_s[st * BN + c];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 2 * h + e;
              const float p =
                  ok ? exp2_ftz(s[m][j][i] * scale_log2 - lc) : 0.f;
              s[m][j][i] = p;
              dp[m][j][i] = p * (dp[m][j][i] - dc);
            }
        }
      accumulate<DP, NC, MT>(acc_v, s, dot, n0, lane);   // dV += P^T dO
      accumulate<DP, NC, MT>(acc_k, dp, qt, n0, lane);   // dK += dS^T Q
    }
    __syncthreads();  // the stage is refilled at t + 2
  }
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    store_rows<DP, C::WS>(acc_k[m], red, dk + bh * Tk * D, k0 + own + 16 * m,
                          Tk, D, scale, ws, lane);
    store_rows<DP, C::WS>(acc_v[m], red, dv + bh * Tk * D, k0 + own + 16 * m,
                          Tk, D, 1.f, ws, lane);
  }
}

// The d = 512 kernels, one body for both types (`bwd_d512_tc<T, DKV>`).  A
// 16 x 512 float32 accumulator would take 256 registers a thread, so, as in
// flash_fwd.cu's d = 512 kernel, each of the four warps owns a 128-column
// quarter of the head dim: a quarter of the block's own rows (A, C) and of
// the streamed tiles (B, D) for the partial scores, and a quarter of each
// accumulator.  A block owns 16 rows (two accumulators of 16 x 128 take 128
// registers in the dK/dV kernel) and streams tiles of BN rows through a
// two-stage cp.async ring; one block per SM.  At the stage-1 shape (5, 1,
// 4096, 4096, 512) the tensor-core rate bounds the pair; with four warps an
// SM and two barriers a tile these kernels run far from it (their times are
// in PERF.md).
//
// Shared memory per block, by type:
//   bfloat16: own A, C 2 x 16 x 520 x 2 B (33 KB), ring 2 x 2 x 32 x 520 x 2
//     B (133 KB), partial S and dP 2 x 4 x 16 x 33 x 4 B (17 KB), P and dS
//     bf16 2 x 16 x 40 x 2 B: 186 KB.
//   float32: every tile doubles, so the ring streams 16 rows (BN = 16; 32
//     rows in one stage would also fit but lose the copy's overlap).  Own
//     A, C 2 x 16 x 516 x 4 B (66 KB), ring 2 x 2 x 16 x 516 x 4 B (132 KB),
//     partial S and dP 2 x 4 x 16 x 17 x 4 B (8.7 KB), P and dS float32 2 x
//     16 x 20 x 4 B (2.6 KB): 209 KB of the 227 KB a block may take.  The
//     row stride of 516 floats is an odd number of 16-byte units: the
//     ldmatrix reads of the n-major operands are free of bank conflicts, and
//     the plain reads of the k-major ones (below) conflict two ways (a
//     stride of 520 would do the reverse).
template <typename T>
struct B512 {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int DP = 512, LDS = lds<DP, T>(), BR = 16,
                       BN = F32 ? 16 : 32;
  static constexpr int QCOLS = DP / 4, NB = QCOLS / 8, LDR = BN + 1,
                       LDP = BN + 16 / (int)sizeof(T);
  // elements of the elementwise step a thread takes (BR x BN over 128)
  static constexpr int EPT = BR * BN / kThreads;
  // own rows (2 x BR) and the ring of the two streamed tiles (2 x 2 x BN)
  static constexpr size_t stage_bytes =
      (size_t)(2 * BR + 4 * BN) * LDS * sizeof(T);
  // the four warps' partial S and dP, float32, rows padded to BN + 1
  static constexpr size_t red_bytes = (size_t)2 * 4 * BR * LDR * sizeof(float);
  // P and dS of the tile in the element type, rows padded by 16 bytes for
  // ldmatrix
  static constexpr size_t p_bytes = (size_t)2 * BR * LDP * sizeof(T);
  static constexpr size_t smem_bytes = stage_bytes + red_bytes + p_bytes;
  static_assert(stage_bytes % 16 == 0 && red_bytes % 16 == 0,
                "16-byte aligned parts");
  static_assert(smem_bytes <= 232448, "one block per SM");
};

// One (b, h) of either d = 512 kernel.  Own rows [r0, r0 + 16) of A and C
// ([Town, D]); streamed rows of B and D ([Tst, D]); lse and delta are the
// [Tq] rows of this (b, h).
//   dQ    (DKV false): A = Q, C = dO, B = K, D = V; S = Q K^T, dP = dO V^T,
//         out0 = dQ = dS K * scale.
//   dK/dV (DKV true):  A = K, C = V, B = Q, D = dO; S^T = K Q^T,
//         dP^T = V dO^T, out0 = dK = dS^T Q * scale, out1 = dV = P^T dO.
// Per streamed tile: every warp computes its partial S and dP over its
// quarter of the head dim, writes them to shared memory, and after a
// barrier each thread adds the four partials of its elements in warp order,
// forms P = 2^(S * scale * log2 e - L) and dS = P o (dP - delta) and writes
// both in the element type; after a second barrier every warp reads them as
// the A operands of its quarter of the accumulators.  The streamed rows past
// Tst get P = 0: keys past Tk in the dQ kernel, and queries past Tq (which
// have no defined L or delta) in the dK/dV kernel.
//
// Products.  bfloat16: m16n8k16 with ldmatrix (`.trans` for the k-major B
// and D of acc0 += dS B, acc1 += P D); P and dS are rounded to bf16 once.
// float32: m16n8k8 TF32 with the 3xTF32 split (mma_3xtf32), so that every
// product keeps about float32 precision; P and dS stay float32 and are split
// where they are loaded.  The n-major operands come by ldmatrix (a float is
// two b16 halves, which is the TF32 fragment layout), the k-major B and D of
// acc0 and acc1 by plain shared loads, b0 = tile[k t][n g] and b1 =
// tile[k t + 4][n g]; each A fragment is split once a k step and reused
// across the n blocks.
template <typename T, bool DKV>
__device__ __forceinline__ void bwd_d512_tc(
    const T* __restrict__ a, const T* __restrict__ c,
    const T* __restrict__ b, const T* __restrict__ d,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ out0, T* __restrict__ out1, int Town, int Tst, int D,
    float scale, float scale_log2, int vec) {
  using W = B512<T>;
  constexpr int DP = W::DP, LDS = W::LDS, BR = W::BR, BN = W::BN;
  constexpr int LDR = W::LDR, LDP = W::LDP, NB = W::NB, EPT = W::EPT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);
  T* c_s = a_s + BR * LDS;
  T* b_s = c_s + BR * LDS;                         // [2][BN][LDS]
  T* d_s = b_s + 2 * BN * LDS;                     // [2][BN][LDS]
  float* red = reinterpret_cast<float*>(smem_raw + W::stage_bytes);
  T* p_s = reinterpret_cast<T*>(smem_raw + W::stage_bytes +
                                W::red_bytes);     // P, then dS
  T* ds_s = p_s + BR * LDP;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = warp * W::QCOLS;
  const int r0 = blockIdx.x * BR;
  // a thread's share of the elementwise step: row er, columns ec..ec+EPT-1
  const int er = threadIdx.x / (BN / EPT), ec = threadIdx.x % (BN / EPT) * EPT;

  stage_tc<DP, BR>(a_s, a, r0, Town, D, vec);
  stage_tc<DP, BR>(c_s, c, r0, Town, D, vec);
  stage_tc<DP, BN>(b_s, b, 0, Tst, D, vec);
  stage_tc<DP, BN>(d_s, d, 0, Tst, D, vec);
  cp_async_commit();

  // dQ: L (log2 units) and delta of the own row er; rows past Tq are never
  // written, so any finite value will do
  float l_own = 0.f, d_own = 0.f;
  if (!DKV && r0 + er < Town) {
    l_own = lse[r0 + er] * kLog2e;
    d_own = delta[r0 + er];
  }

  constexpr int NB1 = DKV ? NB : 1;
  float acc0[NB][4], acc1[NB1][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc0[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < NB1; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[j][i] = 0.f;

  const int n_tiles = (Tst + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      stage_tc<DP, BN>(b_s + nxt * BN * LDS, b, (t + 1) * BN, Tst, D, vec);
      stage_tc<DP, BN>(d_s + nxt * BN * LDS, d, (t + 1) * BN, Tst, D, vec);
      cp_async_commit();
    }
    const int nv = Tst - t * BN;   // valid streamed rows (may exceed BN)
    const T* bt = b_s + (t & 1) * BN * LDS;
    const T* dt = d_s + (t & 1) * BN * LDS;

    // partial S and dP over this warp's quarter of the head dim
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
    if constexpr (!W::F32) {
#pragma unroll 2
      for (int ks = 0; ks < W::QCOLS / 16; ++ks) {
        const int col = c0 + 16 * ks;
        unsigned fa[4], fc[4];
        load_rm<LDS, false>(fa, a_s, 0, col, lane);
        load_rm<LDS, false>(fc, c_s, 0, col, lane);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          if (16 * j < nv) {
            unsigned fb[4], fd[4];
            load_nk<LDS>(fb, bt, 16 * j, col, lane);
            load_nk<LDS>(fd, dt, 16 * j, col, lane);
            mma_bf16(s[2 * j], fa, fb[0], fb[1]);
            mma_bf16(s[2 * j + 1], fa, fb[2], fb[3]);
            mma_bf16(dp[2 * j], fc, fd[0], fd[1]);
            mma_bf16(dp[2 * j + 1], fc, fd[2], fd[3]);
          }
        }
      }
    } else {
#pragma unroll 2
      for (int ks = 0; ks < W::QCOLS / 8; ++ks) {
        const int col = c0 + 8 * ks;
        unsigned f[4], ah[4], al[4], ch[4], cl[4];
        load_a_tf32<LDS>(f, a_s, 0, col, lane);
        split_tf32(f, ah, al);
        load_a_tf32<LDS>(f, c_s, 0, col, lane);
        split_tf32(f, ch, cl);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          if (16 * j < nv) {
            unsigned bh[4], bl[4];
            load_nk_tf32<LDS>(f, bt, 16 * j, col, lane);
            split_tf32(f, bh, bl);
            mma_3xtf32(s[2 * j], ah, al, bh[0], bh[1], bl[0], bl[1]);
            mma_3xtf32(s[2 * j + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
            load_nk_tf32<LDS>(f, dt, 16 * j, col, lane);
            split_tf32(f, bh, bl);
            mma_3xtf32(dp[2 * j], ch, cl, bh[0], bh[1], bl[0], bl[1]);
            mma_3xtf32(dp[2 * j + 1], ch, cl, bh[2], bh[3], bl[2], bl[3]);
          }
        }
      }
    }
    float* rs = red + warp * BR * LDR;              // S partials [4][BR][LDR]
    float* rd = red + (4 + warp) * BR * LDR;        // dP partials
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = ((lane >> 2) + 8 * (i >> 1)) * LDR + 8 * j +
                      2 * (lane & 3) + (i & 1);
        rs[e] = s[j][i];
        rd[e] = dp[j][i];
      }
    __syncthreads();

    // P and dS of row er, columns ec.., the partials added in warp order
    float pv[EPT], dv[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int col = ec + e;
      const float* x = red + er * LDR + col;
      const float* y = x + 4 * BR * LDR;
      const float sv = ((x[0] + x[BR * LDR]) + x[2 * BR * LDR]) + x[3 * BR * LDR];
      const float dpv = ((y[0] + y[BR * LDR]) + y[2 * BR * LDR]) + y[3 * BR * LDR];
      float p = 0.f, dl = 0.f;
      if (col < nv) {
        const int n = t * BN + col;
        const float l = DKV ? lse[n] * kLog2e : l_own;
        dl = DKV ? delta[n] : d_own;
        p = exp2_ftz(sv * scale_log2 - l);
      }
      pv[e] = p;
      dv[e] = p * (dpv - dl);
    }
    if constexpr (W::F32) {
      *reinterpret_cast<float2*>(p_s + er * LDP + ec) =
          make_float2(pv[0], pv[1]);
      *reinterpret_cast<float2*>(ds_s + er * LDP + ec) =
          make_float2(dv[0], dv[1]);
    } else {
      *reinterpret_cast<uint2*>(p_s + er * LDP + ec) =
          make_uint2(pack_bf16(pv[0], pv[1]), pack_bf16(pv[2], pv[3]));
      *reinterpret_cast<uint2*>(ds_s + er * LDP + ec) =
          make_uint2(pack_bf16(dv[0], dv[1]), pack_bf16(dv[2], dv[3]));
    }
    __syncthreads();

    // acc0 += dS B, acc1 += P D over this warp's quarter of the columns
    if constexpr (!W::F32) {
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        if (16 * j < nv) {
          unsigned fds[4], fp[4];
          load_rm<LDP, false>(fds, ds_s, 0, 16 * j, lane);
          if (DKV) load_rm<LDP, false>(fp, p_s, 0, 16 * j, lane);
#pragma unroll
          for (int nd = 0; nd < W::QCOLS / 16; ++nd) {
            unsigned fb[4];
            load_rm<LDS, true>(fb, bt, 16 * j, c0 + 16 * nd, lane);
            mma_bf16(acc0[2 * nd], fds, fb[0], fb[1]);
            mma_bf16(acc0[2 * nd + 1], fds, fb[2], fb[3]);
            if (DKV) {
              unsigned fd[4];
              load_rm<LDS, true>(fd, dt, 16 * j, c0 + 16 * nd, lane);
              mma_bf16(acc1[2 * nd % NB1], fp, fd[0], fd[1]);
              mma_bf16(acc1[(2 * nd + 1) % NB1], fp, fd[2], fd[3]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        if (8 * kk < nv) {
          unsigned f[4], sh[4], sl[4], ph[4], pl[4];
          load_a_tf32<LDP>(f, ds_s, 0, 8 * kk, lane);
          split_tf32(f, sh, sl);
          if (DKV) {
            load_a_tf32<LDP>(f, p_s, 0, 8 * kk, lane);
            split_tf32(f, ph, pl);
          }
          // k rows 8 kk + t and + 4, head column c0 + 8 nd + g
          const int off = (8 * kk + (lane & 3)) * LDS + c0 + (lane >> 2);
          const unsigned* bu = reinterpret_cast<const unsigned*>(bt) + off;
          const unsigned* du = reinterpret_cast<const unsigned*>(dt) + off;
#pragma unroll
          for (int nd = 0; nd < NB; ++nd) {
            unsigned h0, l0, h1, l1;
            split_tf32(bu[8 * nd], h0, l0);
            split_tf32(bu[8 * nd + 4 * LDS], h1, l1);
            mma_3xtf32(acc0[nd], sh, sl, h0, h1, l0, l1);
            if (DKV) {
              split_tf32(du[8 * nd], h0, l0);
              split_tf32(du[8 * nd + 4 * LDS], h1, l1);
              mma_3xtf32(acc1[nd % NB1], ph, pl, h0, h1, l0, l1);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + (lane >> 2) + 8 * h;
    if (r >= Town) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = c0 + nb * 8 + 2 * (lane & 3);
      store_pair(out0 + (size_t)r * D, col, D, acc0[nb][2 * h] * scale,
                 acc0[nb][2 * h + 1] * scale, vec);
      if (DKV)
        store_pair(out1 + (size_t)r * D, col, D, acc1[nb % NB1][2 * h],
                   acc1[nb % NB1][2 * h + 1], vec);
    }
  }
}

// dQ at d = 512: one block per (16 query rows, head, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_d512_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int H, int Tq, int Tk, int D,
                            float scale, float scale_log2, int vec) {
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  bwd_d512_tc<T, false>(q + bh * Tq * D, dout + bh * Tq * D, k + bh * Tk * D,
                        v + bh * Tk * D, lse + bh * Tq, delta + bh * Tq,
                        dq + bh * Tq * D, nullptr, Tq, Tk, D, scale,
                        scale_log2, vec);
}

// dK, dV at d = 512: one block per (16 key rows, head, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_d512_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int H,
                             int Tq, int Tk, int D, float scale,
                             float scale_log2, int vec) {
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  bwd_d512_tc<T, true>(k + bh * Tk * D, v + bh * Tk * D, q + bh * Tq * D,
                       dout + bh * Tq * D, lse + bh * Tq, delta + bh * Tq,
                       dk + bh * Tk * D, dv + bh * Tk * D, Tk, Tq, D, scale,
                       scale_log2, vec);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  // set on every launch: the limit is per device and the call is cheap
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Tq, int Tk, int D,
                      float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  constexpr int BQ = (kThreads / C::G) * C::TM;
  const size_t smem =
      (size_t)(2 * BQ + 2 * C::BN) * row_stride<DP>() * sizeof(float);
  cudaError_t err = set_smem(flash_bwd_dq_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Tq, Tk, D, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Tq, int Tk,
                       int D, float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  constexpr int BK = (kThreads / C::G) * C::TM;
  const size_t smem = 2 * C::BN * sizeof(float) +
      (size_t)(2 * BK + 2 * C::BN) * row_stride<DP>() * sizeof(float);
  cudaError_t err = set_smem(flash_bwd_dkv_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, Tk, D, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

// 16-row own tiles when 64-row tiles would give fewer than two blocks per SM.
bool narrow_tiles(int B, int H, int rows) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (long)((rows + 63) / 64) * B * H < 2L * sms;
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <int DP, int WR>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int B, int H, int Tq, int Tk, int D,
                         float scale, int vec, cudaStream_t stream) {
  using C = Tc<DP, WR, false>;
  cudaError_t err = set_smem(flash_bwd_dq_tc_kernel<DP, WR>, C::smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + C::BR - 1) / C::BR, H, B);
  flash_bwd_dq_tc_kernel<DP, WR><<<grid, kThreads, C::smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, Tq, Tk, D, scale, scale * kLog2e, vec);
  return cudaGetLastError();
}

template <int DP, int WR>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int B, int H,
                          int Tq, int Tk, int D, float scale, int vec,
                          cudaStream_t stream) {
  using C = Tc<DP, WR, true>;
  cudaError_t err = set_smem(flash_bwd_dkv_tc_kernel<DP, WR>, C::smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + C::BR - 1) / C::BR, H, B);
  flash_bwd_dkv_tc_kernel<DP, WR><<<grid, kThreads, C::smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Tq, Tk, D, scale,
      scale * kLog2e, vec);
  return cudaGetLastError();
}

// The d = 512 kernels of element type T; `dkv` picks dK/dV.
template <typename T>
cudaError_t launch_d512(bool dkv, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* out0, void* out1, int B, int H, int Tq, int Tk,
                        int D, float scale, int vec, cudaStream_t stream) {
  const size_t smem = B512<T>::smem_bytes;
  const float sl = scale * kLog2e;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(dout);
  const float *lb = static_cast<const float*>(lse),
              *db = static_cast<const float*>(delta);
  cudaError_t err;
  if (dkv) {
    err = set_smem(flash_bwd_dkv_d512_tc_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Tk + B512<T>::BR - 1) / B512<T>::BR, H, B);
    flash_bwd_dkv_d512_tc_kernel<T><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, ot, lb, db, static_cast<T*>(out0), static_cast<T*>(out1),
        H, Tq, Tk, D, scale, sl, vec);
  } else {
    err = set_smem(flash_bwd_dq_d512_tc_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Tq + B512<T>::BR - 1) / B512<T>::BR, H, B);
    flash_bwd_dq_d512_tc_kernel<T><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, ot, lb, db, static_cast<T*>(out0), H, Tq, Tk, D, scale,
        sl, vec);
  }
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Tq, int Tk, int D) {
  return B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || D > 512 ||
         H > 65535 || B > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, dout, dq are contiguous [B, H, Tq, D];
// k, v, dk, dv [B, H, Tk, D]; lse and delta float32 [B, H, Tq].  Each returns
// the cudaError_t of its launch.
extern "C" int aqualora_flash_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int B, int H, int Tq, int Tk,
                                     int D, float scale, int dtype,
                                     void* stream) {
  if (bad_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D > 160)
      return (int)launch_d512<float>(
          false, q, k, v, dout, lse, delta, dq, nullptr, B, H, Tq, Tk, D,
          scale, D % 4 == 0 && aligned16({q, k, v, dout, dq}), s);
#define DQ(DP) launch_dq<DP>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, D, \
                             scale, s)
    return (int)(D <= 48 ? DQ(48) : D <= 80 ? DQ(80) : DQ(160));
#undef DQ
  }
  if (dtype == 1) {
    const int vec = D % 8 == 0 && aligned16({q, k, v, dout, dq});
    if (D > 160)
      return (int)launch_d512<bf16>(false, q, k, v, dout, lse, delta, dq,
                                    nullptr, B, H, Tq, Tk, D, scale, vec, s);
    const bool narrow = narrow_tiles(B, H, Tq);
#define DQ(DP) (narrow ? launch_dq_tc<DP, 1>(q, k, v, dout, lse, delta, dq, B, \
                                             H, Tq, Tk, D, scale, vec, s)     \
                       : launch_dq_tc<DP, 4>(q, k, v, dout, lse, delta, dq, B, \
                                             H, Tq, Tk, D, scale, vec, s))
    return (int)(D <= 48 ? DQ(48) : D <= 80 ? DQ(80) : DQ(160));
#undef DQ
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int aqualora_flash_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int B, int H,
                                      int Tq, int Tk, int D, float scale,
                                      int dtype, void* stream) {
  if (bad_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D > 160)
      return (int)launch_d512<float>(
          true, q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D, scale,
          D % 4 == 0 && aligned16({q, k, v, dout, dk, dv}), s);
#define DKV(DP) launch_dkv<DP>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, \
                               Tk, D, scale, s)
    return (int)(D <= 48 ? DKV(48) : D <= 80 ? DKV(80) : DKV(160));
#undef DKV
  }
  if (dtype == 1) {
    const int vec = D % 8 == 0 && aligned16({q, k, v, dout, dk, dv});
    if (D > 160)
      return (int)launch_d512<bf16>(true, q, k, v, dout, lse, delta, dk, dv,
                                    B, H, Tq, Tk, D, scale, vec, s);
    const bool narrow = narrow_tiles(B, H, Tk);
#define DKV(DP) (narrow ? launch_dkv_tc<DP, 1>(q, k, v, dout, lse, delta, dk, \
                                               dv, B, H, Tq, Tk, D, scale,    \
                                               vec, s)                        \
                        : launch_dkv_tc<DP, 4>(q, k, v, dout, lse, delta, dk, \
                                               dv, B, H, Tq, Tk, D, scale,    \
                                               vec, s))
    return (int)(D <= 48 ? DKV(48) : D <= 80 ? DKV(80) : DKV(160));
#undef DKV
  }
  return (int)cudaErrorInvalidValue;
}
