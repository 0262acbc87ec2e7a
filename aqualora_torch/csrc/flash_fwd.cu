// Flash-attention forward for Hopper (sm_90a): softmax(Q K^T * scale) V.
//
// Replaces the TPU kernel `_fwd_kernel` (aqualora_tpu/ops/flash_attention.py:147,
// launched by `_flash_forward`).  It computes the same function: unmasked
// attention over [B, H, T, D] with an online softmax and float32 sums,
// returning O in the input type and the per-row logsumexp L = m + log(l) in
// float32 as [B, H, Tq], which the backward (flash_bwd.cu) reads.  The TPU
// kernel's trailing 8 lanes of L were a layout artifact and are dropped.
// Every call is one launch; no atomics, so two calls give the same bits.
//
// What bounds it on this card.  The work is 4*B*H*Tq*Tk*D operations against
// 2*(Tq+Tk)*D*2 bytes per (b, h): at the U-Net's self-attention shapes the
// arithmetic intensity is about Tk/2 operations per byte, above the H100's
// ~295 (bf16) from T = 1024 up, so the bound is the tensor-core rate; the
// 77-key cross-attention and the small self-attentions are bound by the
// bytes of Q and O.  The [Tq, Tk] logits never reach device memory, K and V
// are read once per query tile, Q and O once.
//
// Which instance takes which path.  Each type goes to one design per head
// dim, as in flash_bwd.cu:
// - bfloat16 (serving, PPFT, stage 1 under --mixed_precision bf16): the
//   tensor-core kernels `flash_fwd_tc_kernel` (head dims up to 160) and
//   `flash_fwd_d512_tc_kernel<bf16>` (the VAE mid-block's d = 512).
// - float32 at d = 512 (stage 1's default type, the VAE encode and both
//   decodes at full width): `flash_fwd_d512_tc_kernel<float>`, TF32
//   tensor-core products split three ways (3xTF32), which keep the float32
//   limit (1e-4) where one TF32 product would not.
// - float32 at d <= 160 (stage 3 in float32 at 512^2 and 768^2; DreamSim's
//   ViTs at d = 64 and 80, T = 50-257; the card-vs-CPU checks of the tiny
//   configurations): `flash_fwd_kernel`, float32 FMAs on the CUDA cores.
//
// Tensor-core design (bfloat16, d <= 160).
// - Products: `mma.sync.aligned.m16n8k16` bf16 x bf16 -> float32 with
//   `ldmatrix`.  A warp owns 32 query rows (two m16 tiles, so each K and V
//   operand it reads from shared memory feeds two products; 16 at d = 160).
//   S = Q K^T: K is row-major [Tk, d], which is the B operand as it stands.
//   O += P V: V is read with `ldmatrix.trans`.  d = 40 has a tile of its
//   own, 40 wide and not padded to 48: the last 8 columns of Q K^T take one
//   m16n8k8 product and the last 8 columns of O one x2 `ldmatrix`, a sixth
//   less work than a 48-wide tile.
// - Online softmax in log2 units.  The row max is taken on the raw scores
//   (the interface requires scale > 0), so P = 2^(S * scale * log2(e) - m)
//   is one FFMA and one `ex2.approx.ftz`; the key mask is applied only in a
//   tile that ends past Tk.  In the m16n8 accumulator layout a row's values
//   sit in one quad of lanes, so the row max takes two `__shfl_xor`s; each
//   lane keeps a partial row sum, and the quad adds them once at the end.
//   The sum l is taken from the unrounded P: the lse the backward reads
//   must hold to 1e-4.
// - P stays in registers: its float32 C fragments are packed into the bf16 A
//   fragments of O += P V.  That rounding is the one this design adds (the
//   TPU kernel keeps P in float32); tests/test_torch_port_flash.py
//   emulates it tile by tile and holds it within the bf16 O limit.
// - Staging.  Q is copied once per block; at d = 40 each warp then keeps
//   its A fragments in registers.  K and V tiles (64 keys at d = 40, 32 at
//   d >= 80) go through a two-stage ring in dynamic shared memory with
//   16-byte `cp.async`, one barrier a tile: the copy of tile t + 1 is issued
//   right after the barrier that ends tile t - 1, so it overlaps tile t's
//   products.  Rows are padded to an odd number of 16-byte units, which puts
//   the eight rows an `ldmatrix` reads on eight different bank groups.
// - What bounds it in practice: shared-memory reads of the K and V operands
//   (hence two m16 tiles a warp), the special-function unit (one ex2 per
//   score, about 256 tensor-core operations' worth) and latency; at d = 40
//   ptxas is held to three blocks (12 warps) per SM.
// - Filling the card.  Query tiles of 128 rows (d <= 80) or 64.  When those
//   give fewer than two blocks per SM (the 8^2 shapes; 16^2 at B8) a block
//   owns 16 rows instead and its four warps split each key tile four ways,
//   each with its own (m, l, O); they are merged through shared memory in a
//   fixed warp order at the end.  Still one launch, still deterministic.
//   `aqualora_flash_fwd_tc_rows` says which tiling a shape gets.
//
// Tensor-core design (d = 512, both types).  A 16 x 512 float32 accumulator
// would take 256 registers a thread, so a block of four warps owns 32 query
// rows and each warp a 128-column quarter of O (128 registers).  For each
// key tile every warp computes a partial S over its quarter of the head
// dim; the four partials are added in shared memory in warp order, four
// threads a row take the online softmax and write P to shared memory once,
// and every warp then reads P as its A operand for its quarter of O += P V.
// bfloat16 streams 32-key tiles (186 KB of shared memory) and rounds P to
// bf16; float32 streams 16-key tiles (209 KB), keeps P in float32 and runs
// every product as three TF32 products (D512 and the kernel have the
// details).  Three barriers a tile: the ring, the partial S, P.
//
// Ragged shapes are masked in the kernel, never padded in memory: a head dim
// below its tile's width is zero-filled by the copy itself (cp.async with a
// source size of 0) and only columns below D are stored; keys past Tk get
// -inf scores and zero V rows, and 16-key steps wholly past Tk are skipped
// (Tk = 77 computes 80 keys); query rows past Tq compute on zeros and are
// not written.  A head dim that is not a multiple of the 16-byte chunk (8
// bf16, 4 floats), or an input not 16-byte aligned, is staged by plain loads
// instead of cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

#include "tensor_core.cuh"

namespace {

using namespace aqualora_tc;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

// Tile shape per padded head dim DP: G lanes per row group, TM query rows per
// group, BK keys per tile.  Registers per thread: TM*DP/G accumulators and
// TM*BK/G scores.
template <int DP>
struct Cfg;
template <> struct Cfg<48>  { static constexpr int G = 8,  TM = 8, BK = 32; };
template <> struct Cfg<80>  { static constexpr int G = 8,  TM = 8, BK = 32; };
template <> struct Cfg<160> { static constexpr int G = 16, TM = 8, BK = 32; };

// Shared-memory row stride in floats: an odd number of 4-byte words, so the
// rows the lanes of a group read at once start in different banks.
template <int DP>
__host__ __device__ constexpr int row_stride() { return DP + 1; }

// One block of 128 threads per (query tile, head, batch).  The threads form
// row groups of G lanes; inside a group lane g scores keys g, g+G, ... of
// the key tile and accumulates output columns g, g+G, ...; the row max and
// sum are reduced by shuffles and P is passed across the group by shuffles.
// K and then V of each key tile share one shared buffer.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 float scale_log2) {
  using C = Cfg<DP>;
  constexpr int G = C::G, TM = C::TM, BK = C::BK;
  constexpr int BQ = (kThreads / G) * TM;
  constexpr int NK = BK / G;   // keys per lane per tile
  constexpr int ND = DP / G;   // output columns per lane
  constexpr int LD = row_stride<DP>();
  static_assert(DP % 2 == 0 && BK % G == 0 && DP % G == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* kv_s = q_s + BQ * LD;

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int row0 = (tid / G) * TM;          // first row of this group in the tile
  const int q0 = blockIdx.x * BQ;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* qb = q + bh * Tq * D;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;

  for (int i = tid; i < BQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    q_s[r * LD + c] = q0 + r < Tq && c < D ? qb[(size_t)(q0 + r) * D + c] : 0.f;
  }

  float m[TM], l[TM], acc[TM][ND];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (Tk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Q staged (t == 0) / previous V tile consumed
    for (int i = tid; i < BK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      kv_s[r * LD + c] = k0 + r < Tk && c < D ? kb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    float s[TM][NK];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 2) {
      float2 qv[TM], kv[NK];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float* p = q_s + (row0 + i) * LD + c;
        qv[i] = make_float2(p[0], p[1]);
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float* p = kv_s + (g + G * j) * LD + c;
        kv[j] = make_float2(p[0], p[1]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        }
    }

    // online softmax in log2 units; keys past Tk are -inf
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const bool valid = k0 + g + G * j < Tk;
        s[i][j] = valid ? s[i][j] * scale_log2 : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off, G));
      // every tile holds at least one valid key, so m_new is finite
      const float m_new = fmaxf(m[i], mt);
      const float alpha = exp2f(m[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        ls += s[i][j];
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        ls += __shfl_xor_sync(kFull, ls, off, G);
      m[i] = m_new;
      l[i] = l[i] * alpha + ls;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every lane is done with the K tile
    for (int i = tid; i < BK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      kv_s[r * LD + c] = k0 + r < Tk && c < D ? vb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int src = 0; src < G; ++src) {
        const float* vrow = kv_s + (j * G + src) * LD;
        float p[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) p[i] = __shfl_sync(kFull, s[i][j], src, G);
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) {
          const float vv = vrow[g + G * jd];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][jd] = fmaf(p[i], vv, acc[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + row0 + i;
    if (r < Tq) {
      const float inv = 1.f / l[i];
      float* orow = o + (bh * Tq + r) * D;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        const int c = g + G * jd;
        if (c < D) orow[c] = acc[i][jd] * inv;
      }
      if (g == 0) lse[bh * Tq + r] = m[i] * kLn2 + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernels: bfloat16, and float32 at d = 512
// ---------------------------------------------------------------------------

// cp.async staging (stage_tc), ldmatrix loads (load_rm, load_nk) and the
// m16n8k16 product (mma_bf16) come from tensor_core.cuh.

// Two 8x8 b16 matrices at (row0, col0) and (row0 + 8, col0) of a [.., LDS]
// tile (lanes 0-15 give the addresses): the A operand of an m16n8k8 product
// (rows), the B operands of two 8-column blocks of one (n-major tile), or,
// with TRANS, the B operand of one 8-column block of an m16n8k16 product
// (k-major tile).
template <int LDS, bool TRANS>
__device__ __forceinline__ void load_x2(unsigned (&r)[2], const bf16* tile,
                                        int row0, int col0, int lane) {
  const unsigned a =
      smem_addr(tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + col0);
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(a) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(a) : "memory");
}

// c (16x8, float32) += a (16x8, bf16) * b (8x8, bf16): a[0] = row g, k
// 2t..2t+1; a[1] = row g + 8; b = k 2t..2t+1, column g.
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4],
                                            const unsigned (&a)[2],
                                            unsigned b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Tiles of the d <= 160 kernel.  A block has 4 warps: WR along its query
// rows and WS = 4 / WR along the key tile of BN keys, of which each warp
// takes SPAN.  A warp owns MT m16 tiles (16 * MT rows), so that each K and V
// operand it reads from shared memory feeds MT products.  With AREG the
// warp keeps the A operands of its query rows in registers for the whole
// loop.  MINB is the blocks per SM that ptxas must make room for.  LDS is
// the shared row stride in elements, NB the head dim in 8-column blocks
// (odd at DP = 40: the last block and the last 8 columns of Q K^T take
// the k8 / x2 forms).
template <int DP, int WR>
struct Tc {
  static_assert(DP % 8 == 0 && (WR == 1 || WR == 4), "tile shape");
  static constexpr int WS = 4 / WR;
  static constexpr int MT = (WR == 4 && DP <= 80) ? 2 : 1;
  static constexpr bool AREG = DP <= 40;
  static constexpr int BR = 16 * MT * WR;
  static constexpr int BN = (WR == 4 && DP >= 80) ? 32 : 64;
  static constexpr int MINB = (WR == 4 && DP == 40) ? 3 : 1;
  static constexpr int SPAN = BN / WS;
  static constexpr int LDS = lds<DP>(), NB = DP / 8;
  static_assert(SPAN % 16 == 0, "tile shape");
  static_assert(MT == 1 || WS == 1, "warps are merged per m16 tile");
  // staged bf16 rows: Q (BR) and the two-stage K, V ring (2 x 2 x BN)
  static constexpr size_t stage_bytes =
      (size_t)(BR + 4 * BN) * LDS * sizeof(bf16);
  // each warp's float32 O, row max and row sum, when WS > 1
  static constexpr int E = NB * 4 * 32;
  static constexpr size_t merge_bytes =
      WS > 1 ? (size_t)WS * (E + 2 * 16) * sizeof(float) : 0;
  static constexpr size_t smem_bytes =
      stage_bytes > merge_bytes ? stage_bytes : merge_bytes;
};

// The A operands of a warp's MT m16 query tiles over the head dim (the
// 16-column steps, and the last 8 columns when DP % 16 == 8), kept in
// registers when AREG; without it the arrays are one step long and unused.
template <int DP, int MT, bool AREG>
struct QFrags {
  static constexpr int KS = AREG ? DP / 16 : 1;
  unsigned a[MT][KS][4], tail[MT][2];

  __device__ __forceinline__ void load(const bf16* q_s, int own, int lane) {
    if (AREG) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          load_rm<lds<DP>(), false>(a[m][ks], q_s, own + 16 * m, 16 * ks,
                                    lane);
        if (DP % 16)
          load_x2<lds<DP>(), false>(tail[m], q_s, own + 16 * m, DP - 8, lane);
      }
    }
  }
};

// S = Q K^T for the warp's MT m16 query tiles (at `own` of q_s, or in `qf`)
// against the keys n0.. of the K tile `kt`, skipping 16-key steps at or
// past `kv` (the keys of the tile from n0 on).
template <typename C, int DP>
__device__ __forceinline__ void tile_scores(
    float (&s)[C::MT][C::SPAN / 8][4],
    const QFrags<DP, C::MT, C::AREG>& qf, const bf16* q_s, const bf16* kt,
    int own, int n0, int kv, int lane) {
  constexpr int MT = C::MT, NJ = C::SPAN / 16, LDS = C::LDS;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[m][j][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    unsigned fa[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (C::AREG) {
#pragma unroll
        for (int r = 0; r < 4; ++r) fa[m][r] = qf.a[m][C::AREG ? ks : 0][r];
      } else {
        load_rm<LDS, false>(fa[m], q_s, own + 16 * m, 16 * ks, lane);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (16 * j < kv) {
        unsigned fb[4];
        load_nk<LDS>(fb, kt, n0 + 16 * j, 16 * ks, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(s[m][2 * j], fa[m], fb[0], fb[1]);
          mma_bf16(s[m][2 * j + 1], fa[m], fb[2], fb[3]);
        }
      }
    }
  }
  if (DP % 16) {   // the last 8 columns of the head dim
    unsigned fa[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (C::AREG) {
        fa[m][0] = qf.tail[m][0];
        fa[m][1] = qf.tail[m][1];
      } else {
        load_x2<LDS, false>(fa[m], q_s, own + 16 * m, DP - 8, lane);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (16 * j < kv) {
        unsigned fb[2];
        load_x2<LDS, false>(fb, kt, n0 + 16 * j, DP - 8, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16_k8(s[m][2 * j], fa[m], fb[0]);
          mma_bf16_k8(s[m][2 * j + 1], fa[m], fb[1]);
        }
      }
    }
  }
}

// The online-softmax step of one tile, then O += P V with the V tile `vt`.
// Keys past Tk (only in a tile that ends past it: kv < SPAN) are -inf.
// scale > 0, so the row max of the raw scores times scale_log2 is the
// scaled max, and P = 2^(S * scale_log2 - m) is one FFMA and one ex2.  A
// row that has seen no valid key yet (a narrow warp) keeps m = -inf: exp2
// is taken against 0 then, so its P and alpha are 0 and not NaN.
template <typename C, int DP>
__device__ __forceinline__ void tile_update(
    float (&s)[C::MT][C::SPAN / 8][4], float (&m_run)[C::MT][2],
    float (&l_run)[C::MT][2], float (&acc)[C::MT][DP / 8][4],
    const bf16* vt, int n0, int kv, float scale_log2, int lane) {
  constexpr int MT = C::MT, NJ = C::SPAN / 16, LDS = C::LDS, NB = DP / 8;
  if (kv < C::SPAN) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (8 * j + 2 * (lane & 3) + (i & 1) >= kv) s[m][j][i] = -INFINITY;
  }
  unsigned p[MT][NJ][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * NJ; ++j)
        mx = fmaxf(mx, fmaxf(s[m][j][2 * h], s[m][j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m_run[m][h], mx * scale_log2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2_ftz(m_run[m][h] - m_use);
      m_run[m][h] = m_new;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x =
              exp2_ftz(fmaf(s[m][j][2 * h + e], scale_log2, -m_use));
          s[m][j][2 * h + e] = x;
          ls += x;
        }
      l_run[m][h] = l_run[m][h] * alpha + ls;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        acc[m][nb][2 * h] *= alpha;
        acc[m][nb][2 * h + 1] *= alpha;
      }
    }
    // P as the A operand of k step j: accumulator blocks 2j and 2j + 1
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      p[m][j][0] = pack_bf16(s[m][2 * j][0], s[m][2 * j][1]);
      p[m][j][1] = pack_bf16(s[m][2 * j][2], s[m][2 * j][3]);
      p[m][j][2] = pack_bf16(s[m][2 * j + 1][0], s[m][2 * j + 1][1]);
      p[m][j][3] = pack_bf16(s[m][2 * j + 1][2], s[m][2 * j + 1][3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (16 * j < kv) {
#pragma unroll
      for (int nd = 0; nd < DP / 16; ++nd) {
        unsigned b[4];
        load_rm<LDS, true>(b, vt, n0 + 16 * j, 16 * nd, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * nd], p[m][j], b[0], b[1]);
          mma_bf16(acc[m][2 * nd + 1], p[m][j], b[2], b[3]);
        }
      }
      if (NB % 2) {   // the last 8 columns of O
        unsigned b[2];
        load_x2<LDS, true>(b, vt, n0 + 16 * j, DP - 8, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][NB - 1], p[m][j], b[0], b[1]);
      }
    }
  }
}

// One block per (query tile of BR rows, head, batch), looping over the key
// tiles.  `kv` counts the keys of a tile from the warp's first; the warp
// skips 16-key steps at or past it.
template <int DP, int WR>
__global__ void __launch_bounds__(kThreads, Tc<DP, WR>::MINB)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int H, int Tq, int Tk, int D,
                    float scale_log2, int vec) {
  using C = Tc<DP, WR>;
  constexpr int BR = C::BR, BN = C::BN, LDS = C::LDS, MT = C::MT, NB = C::NB;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BR * LDS;          // [2][BN][LDS]
  bf16* v_s = k_s + 2 * BN * LDS;      // [2][BN][LDS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ws = warp % C::WS, own = (warp / C::WS) * 16 * MT;
  const int n0 = ws * C::SPAN;
  const int q0 = blockIdx.x * BR;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const bf16* kb = k + bh * Tk * D;
  const bf16* vb = v + bh * Tk * D;
  // K and V rows of key tile t into ring stage t % 2
  auto stage_kv = [&](int t) {
    const int st = t & 1;
    stage_tc<DP, BN>(k_s + st * BN * LDS, kb, t * BN, Tk, D, vec);
    stage_tc<DP, BN>(v_s + st * BN * LDS, vb, t * BN, Tk, D, vec);
    cp_async_commit();
  };

  stage_tc<DP, BR>(q_s, q + bh * Tq * D, q0, Tq, D, vec);
  stage_kv(0);

  // rows g and g + 8 of each m16 tile: running max (log2 units), this lane's
  // part of the row sum, and O
  float m_run[MT][2], l_run[MT][2], acc[MT][NB][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[m][h] = -INFINITY;
      l_run[m][h] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  }
  QFrags<DP, MT, C::AREG> qf;

  const int n_tiles = (Tk + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < n_tiles) stage_kv(t + 1);
    if (t == 0) qf.load(q_s, own, lane);
    const int kv = Tk - t * BN - n0;
    if (kv <= 0) continue;            // a narrow block's warp past Tk
    float s_t[MT][C::SPAN / 8][4];
    tile_scores<C, DP>(s_t, qf, q_s, k_s + (t & 1) * BN * LDS, own, n0, kv,
                       lane);
    tile_update<C, DP>(s_t, m_run, l_run, acc, v_s + (t & 1) * BN * LDS, n0,
                       kv, scale_log2, lane);
  }

  // the quad's parts of each row sum, added in a fixed order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[m][h] += __shfl_xor_sync(kFull, l_run[m][h], 1);
      l_run[m][h] += __shfl_xor_sync(kFull, l_run[m][h], 2);
    }
  bf16* ob = o + bh * Tq * D;
  float* lb = lse + bh * Tq;

  if (C::WS == 1) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + own + 16 * m + (lane >> 2) + 8 * h;
        if (r >= Tq) continue;
        const float inv = 1.f / l_run[m][h];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          store_pair(ob + (size_t)r * D, nb * 8 + 2 * (lane & 3), D,
                     acc[m][nb][2 * h] * inv, acc[m][nb][2 * h + 1] * inv,
                     vec);
        if ((lane & 3) == 0) lb[r] = m_run[m][h] * kLn2 + logf(l_run[m][h]);
      }
    return;
  }

  // narrow tiles: the four warps hold (m, l, O) of the same 16 rows over
  // their own keys; merge them in warp order
  constexpr int E = C::E;
  float* red = reinterpret_cast<float*>(smem_raw);   // [WS][E]
  float* m_s = red + C::WS * E;                      // [WS][16]
  float* l_s = m_s + C::WS * 16;                     // [WS][16]
  __syncthreads();  // every warp is done with the staged tiles
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[ws * E + (nb * 4 + i) * 32 + lane] = acc[0][nb][i];
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_s[ws * 16 + (lane >> 2) + 8 * h] = m_run[0][h];
      l_s[ws * 16 + (lane >> 2) + 8 * h] = l_run[0][h];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const int ln = e & 31, i = (e >> 5) & 3, nb = e >> 7;
    const int row = (ln >> 2) + (i >> 1) * 8;
    const int c = nb * 8 + 2 * (ln & 3) + (i & 1);
    const int r = q0 + row;
    if (r >= Tq || c >= D) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < C::WS; ++w) mx = fmaxf(mx, m_s[w * 16 + row]);
    float sum_l = 0.f, sum_o = 0.f;
#pragma unroll
    for (int w = 0; w < C::WS; ++w) {
      const float f = exp2_ftz(m_s[w * 16 + row] - mx);
      sum_l += l_s[w * 16 + row] * f;
      sum_o += red[w * E + e] * f;
    }
    ob[(size_t)r * D + c] = __float2bfloat16(sum_o / sum_l);
  }
  if (threadIdx.x < 16 && q0 + (int)threadIdx.x < Tq) {
    const int row = threadIdx.x;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < C::WS; ++w) mx = fmaxf(mx, m_s[w * 16 + row]);
    float sum_l = 0.f;
#pragma unroll
    for (int w = 0; w < C::WS; ++w)
      sum_l += l_s[w * 16 + row] * exp2_ftz(m_s[w * 16 + row] - mx);
    lb[q0 + row] = mx * kLn2 + logf(sum_l);
  }
}

// The d = 512 kernel's tiles, one body for both types.  32 query rows, each
// warp a 128-column quarter of O.  Shared memory: Q, the two-stage K and V
// ring, the four warps' partial S (float32, rows padded to BN + 1), P in the
// element type (rows padded by 16 bytes for ldmatrix), and per row alpha and
// the final sum.
//   bfloat16: 32-key tiles; Q 32 x 520 x 2 B (33 KB), ring 2 x 2 x 32 x 520
//     x 2 B (133 KB), partial S 4 x 32 x 33 x 4 B (17 KB), P 32 x 40 x 2 B:
//     186 KB.
//   float32: every tile doubles, so keys stream in tiles of 16 (32-key tiles
//     would need 264 KB for the ring alone).  Q 32 x 516 x 4 B (66 KB), ring
//     2 x 2 x 16 x 516 x 4 B (132 KB), partial S 4 x 32 x 17 x 4 B (8.7 KB),
//     P 32 x 20 x 4 B (2.6 KB): 209 KB of the 227 KB a block may take, one
//     block per SM.  The row stride of 516 floats is an odd number of
//     16-byte units: the ldmatrix reads of Q, K and P are free of bank
//     conflicts, the plain reads of V conflict two ways (flash_bwd.cu's
//     B512 has the same layout).
template <typename T>
struct D512 {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int DP = 512, LDS = lds<DP, T>(), BR = 32,
                       BN = F32 ? 16 : 32;
  static constexpr int QCOLS = DP / 4, NB = QCOLS / 8, LDR = BN + 1,
                       LDP = BN + 16 / (int)sizeof(T);
  // the softmax's elements a thread takes (BR x BN over 128): a row's four
  // threads are one quad of lanes
  static constexpr int EPT = BR * BN / kThreads;
  static constexpr size_t stage_bytes =
      (size_t)(BR + 4 * BN) * LDS * sizeof(T);
  static constexpr size_t red_bytes = (size_t)4 * BR * LDR * sizeof(float);
  static constexpr size_t p_bytes = (size_t)BR * LDP * sizeof(T);
  static constexpr size_t smem_bytes =
      stage_bytes + red_bytes + p_bytes + 2 * BR * sizeof(float);
  static_assert(stage_bytes % 16 == 0 && red_bytes % 16 == 0 &&
                p_bytes % 16 == 0, "16-byte aligned parts");
  static_assert(BN / EPT == 4, "a row's softmax is one quad");
  static_assert(smem_bytes <= 232448, "one block per SM");
};

// One block per (32 query rows, head, batch).  Per key tile every warp
// computes a partial S over its quarter of the head dim; the four partials
// are added in shared memory in warp order, four threads a row take the
// online softmax and write P once, and every warp then reads P as its A
// operand for its quarter of O = alpha O + P V.
//
// Products.  bfloat16: m16n8k16 with ldmatrix (`.trans` for V); P is rounded
// to bf16 once.  float32: m16n8k8 TF32 with the 3xTF32 split (mma_3xtf32), so
// that every product keeps about float32 precision, as the d = 512 backward
// does.  Q, K and P come by ldmatrix (a float is two b16 halves, which is the
// TF32 fragment layout); V, the k-major B of P V, by plain shared loads, b0
// = V[key t][column g] and b1 = V[key t + 4][column g].  Each A fragment is
// split once a k step and reused across the n blocks; P stays float32, and l
// is summed from the same P.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_d512_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int H, int Tq, int Tk, int D,
                         float scale_log2, int vec) {
  using W = D512<T>;
  constexpr int DP = W::DP, LDS = W::LDS, BR = W::BR, BN = W::BN;
  constexpr int LDR = W::LDR, LDP = W::LDP, NB = W::NB, EPT = W::EPT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + BR * LDS;                            // [2][BN][LDS]
  T* v_s = k_s + 2 * BN * LDS;                        // [2][BN][LDS]
  float* red = reinterpret_cast<float*>(smem_raw + W::stage_bytes);  // [4][BR][LDR]
  T* p_s = reinterpret_cast<T*>(smem_raw + W::stage_bytes + W::red_bytes);
  float* a_s = reinterpret_cast<float*>(smem_raw + W::stage_bytes +
                                        W::red_bytes + W::p_bytes);   // [BR]
  float* l_s = a_s + BR;                                              // [BR]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = warp * W::QCOLS;
  const int q0 = blockIdx.x * BR;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  // the softmax's share of a thread: row sr, columns sc..sc+EPT-1 of the tile
  const int sr = threadIdx.x >> 2, sc = (threadIdx.x & 3) * EPT;

  stage_tc<DP, BR>(q_s, q + bh * Tq * D, q0, Tq, D, vec);
  stage_tc<DP, BN>(k_s, kb, 0, Tk, D, vec);
  stage_tc<DP, BN>(v_s, vb, 0, Tk, D, vec);
  cp_async_commit();

  float acc[2][NB][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  const int n_tiles = (Tk + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      stage_tc<DP, BN>(k_s + nxt * BN * LDS, kb, (t + 1) * BN, Tk, D, vec);
      stage_tc<DP, BN>(v_s + nxt * BN * LDS, vb, (t + 1) * BN, Tk, D, vec);
      cp_async_commit();
    }
    const int kv = Tk - t * BN;   // valid keys of the tile (may exceed BN)
    const T* kt = k_s + (t & 1) * BN * LDS;
    const T* vt = v_s + (t & 1) * BN * LDS;

    // partial S over this warp's quarter of the head dim
    float s[2][BN / 8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[m][j][i] = 0.f;
    if constexpr (!W::F32) {
#pragma unroll 2
      for (int ks = 0; ks < W::QCOLS / 16; ++ks) {
        const int col = c0 + 16 * ks;
        unsigned fa[2][4];
        load_rm<LDS, false>(fa[0], q_s, 0, col, lane);
        load_rm<LDS, false>(fa[1], q_s, 16, col, lane);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          if (16 * j < kv) {
            unsigned fb[4];
            load_nk<LDS>(fb, kt, 16 * j, col, lane);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma_bf16(s[m][2 * j], fa[m], fb[0], fb[1]);
              mma_bf16(s[m][2 * j + 1], fa[m], fb[2], fb[3]);
            }
          }
        }
      }
    } else {
#pragma unroll 2
      for (int ks = 0; ks < W::QCOLS / 8; ++ks) {
        const int col = c0 + 8 * ks;
        unsigned f[4], ah[2][4], al[2][4];
        load_a_tf32<LDS>(f, q_s, 0, col, lane);
        split_tf32(f, ah[0], al[0]);
        load_a_tf32<LDS>(f, q_s, 16, col, lane);
        split_tf32(f, ah[1], al[1]);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          if (16 * j < kv) {
            unsigned bh[4], bl[4];
            load_nk_tf32<LDS>(f, kt, 16 * j, col, lane);
            split_tf32(f, bh, bl);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma_3xtf32(s[m][2 * j], ah[m], al[m], bh[0], bh[1], bl[0], bl[1]);
              mma_3xtf32(s[m][2 * j + 1], ah[m], al[m], bh[2], bh[3], bl[2],
                         bl[3]);
            }
          }
        }
      }
    }
    float* rw = red + warp * BR * LDR;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rw[(16 * m + (lane >> 2) + 8 * (i >> 1)) * LDR + 8 * j +
             2 * (lane & 3) + (i & 1)] = s[m][j][i];
    __syncthreads();

    // online softmax of row sr over columns sc..sc+EPT-1, the partials added
    // in warp order; the row's four threads are one quad of lanes
    float x[EPT], mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < EPT; ++c) {
      const float* e = red + sr * LDR + sc + c;
      const float sum = ((e[0] + e[BR * LDR]) + e[2 * BR * LDR]) + e[3 * BR * LDR];
      x[c] = sc + c < kv ? sum * scale_log2 : -INFINITY;
      mx = fmaxf(mx, x[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m_run, mx);   // finite: the tile has a valid key
    const float alpha = exp2_ftz(m_run - m_new);
    m_run = m_new;
    float ls = 0.f;
#pragma unroll
    for (int c = 0; c < EPT; ++c) {
      x[c] = exp2_ftz(x[c] - m_new);
      ls += x[c];
    }
    l_run = l_run * alpha + ls;
    if constexpr (W::F32) {
      *reinterpret_cast<float4*>(p_s + sr * LDP + sc) =
          make_float4(x[0], x[1], x[2], x[3]);
    } else {
      *reinterpret_cast<uint4*>(p_s + sr * LDP + sc) =
          make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                     pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
    }
    if ((threadIdx.x & 3) == 0) a_s[sr] = alpha;
    __syncthreads();

    // O = alpha O + P V over this warp's quarter of the columns
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a = a_s[16 * m + (lane >> 2) + 8 * h];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          acc[m][nb][2 * h] *= a;
          acc[m][nb][2 * h + 1] *= a;
        }
      }
    if constexpr (!W::F32) {
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        if (16 * j < kv) {
          unsigned pa[2][4];
          load_rm<LDP, false>(pa[0], p_s, 0, 16 * j, lane);
          load_rm<LDP, false>(pa[1], p_s, 16, 16 * j, lane);
#pragma unroll
          for (int nd = 0; nd < W::QCOLS / 16; ++nd) {
            unsigned b[4];
            load_rm<LDS, true>(b, vt, 16 * j, c0 + 16 * nd, lane);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma_bf16(acc[m][2 * nd], pa[m], b[0], b[1]);
              mma_bf16(acc[m][2 * nd + 1], pa[m], b[2], b[3]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        if (8 * kk < kv) {
          unsigned f[4], ph[2][4], pl[2][4];
          load_a_tf32<LDP>(f, p_s, 0, 8 * kk, lane);
          split_tf32(f, ph[0], pl[0]);
          load_a_tf32<LDP>(f, p_s, 16, 8 * kk, lane);
          split_tf32(f, ph[1], pl[1]);
          // keys 8 kk + t and + 4, head column c0 + 8 nd + g
          const unsigned* vu = reinterpret_cast<const unsigned*>(vt) +
                               (8 * kk + (lane & 3)) * LDS + c0 + (lane >> 2);
#pragma unroll
          for (int nd = 0; nd < NB; ++nd) {
            unsigned h0, l0, h1, l1;
            split_tf32(vu[8 * nd], h0, l0);
            split_tf32(vu[8 * nd + 4 * LDS], h1, l1);
#pragma unroll
            for (int m = 0; m < 2; ++m)
              mma_3xtf32(acc[m][nd], ph[m], pl[m], h0, h1, l0, l1);
          }
        }
      }
    }
  }

  l_run += __shfl_xor_sync(kFull, l_run, 1);
  l_run += __shfl_xor_sync(kFull, l_run, 2);
  if ((threadIdx.x & 3) == 0) {
    l_s[sr] = l_run;
    if (q0 + sr < Tq) lse[bh * Tq + q0 + sr] = m_run * kLn2 + logf(l_run);
  }
  __syncthreads();
  T* ob = o + bh * Tq * D;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * m + (lane >> 2) + 8 * h;
      if (q0 + row >= Tq) continue;
      const float inv = 1.f / l_s[row];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        store_pair(ob + (size_t)(q0 + row) * D, c0 + nb * 8 + 2 * (lane & 3),
                   D, acc[m][nb][2 * h] * inv, acc[m][nb][2 * h + 1] * inv,
                   vec);
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory limit once per device (`done` is
// the kernel's own flags): the attribute persists, and setting it on every
// launch costs host time that the small shapes would pay on each call.
template <typename K>
cudaError_t set_smem_once(K kernel, size_t smem,
                          std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Tq, int Tk, int D,
                       float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  constexpr int BQ = (kThreads / C::G) * C::TM;
  constexpr size_t smem = (size_t)(BQ + C::BK) * row_stride<DP>() * sizeof(float);
  static std::atomic<bool> done[kMaxDevices];
  cudaError_t err = set_smem_once(flash_fwd_kernel<DP>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Tq, Tk, D, scale * kLog2e);
  return cudaGetLastError();
}

// The SM count of the current device, read once per device.
int sm_count() {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess) return sms;
  if (dev < kMaxDevices && cached[dev].load(std::memory_order_relaxed))
    return cached[dev].load(std::memory_order_relaxed);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < kMaxDevices) cached[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <int DP, int WR>
cudaError_t launch_tc_rows(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int H, int Tq, int Tk,
                           int D, float scale, int vec, cudaStream_t stream) {
  using C = Tc<DP, WR>;
  static std::atomic<bool> done[kMaxDevices];
  cudaError_t err = set_smem_once(flash_fwd_tc_kernel<DP, WR>, C::smem_bytes,
                                  done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + C::BR - 1) / C::BR, H, B);
  flash_fwd_tc_kernel<DP, WR><<<grid, kThreads, C::smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Tq, Tk, D, scale * kLog2e, vec);
  return cudaGetLastError();
}

// Wide query tiles unless they would give fewer than two blocks per SM;
// then 16-row tiles whose warps split the keys.
template <int DP>
bool wide_tiles(int B, int H, int Tq) {
  constexpr int BR = Tc<DP, 4>::BR;
  return (long)((Tq + BR - 1) / BR) * B * H >= 2L * sm_count();
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int Tq, int Tk, int D,
                      float scale, int vec, cudaStream_t s) {
  if (wide_tiles<DP>(B, H, Tq))
    return launch_tc_rows<DP, 4>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, vec, s);
  return launch_tc_rows<DP, 1>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, vec, s);
}

template <int DP>
int tc_rows(int B, int H, int Tq) {
  return wide_tiles<DP>(B, H, Tq) ? Tc<DP, 4>::BR : Tc<DP, 1>::BR;
}

// The d = 512 kernel of element type T.
template <typename T>
cudaError_t launch_d512(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int H, int Tq, int Tk, int D,
                        float scale, int vec, cudaStream_t stream) {
  using W = D512<T>;
  static std::atomic<bool> done[kMaxDevices];
  cudaError_t err = set_smem_once(flash_fwd_d512_tc_kernel<T>, W::smem_bytes,
                                  done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + W::BR - 1) / W::BR, H, B);
  flash_fwd_d512_tc_kernel<T><<<grid, kThreads, W::smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Tq, Tk, D, scale * kLog2e, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Tensors are contiguous [B, H, T, D];
// lse is float32 [B, H, Tq]; scale > 0.  Returns the cudaError_t of the
// launch.
extern "C" int aqualora_flash_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int H, int Tq,
                                  int Tk, int D, float scale, int dtype,
                                  void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || D > 512 || H > 65535 ||
      B > 65535 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D > 160)
      return (int)launch_d512<float>(q, k, v, o, lse, B, H, Tq, Tk, D, scale,
                                     D % 4 == 0 && aligned16({q, k, v, o}),
                                     s);
#define F32(DP) launch_f32<DP>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, s)
    return (int)(D <= 48 ? F32(48) : D <= 80 ? F32(80) : F32(160));
#undef F32
  }
  if (dtype == 1) {
    const int vec = D % 8 == 0 && aligned16({q, k, v, o});
#define TC(DP) launch_tc<DP>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, vec, s)
    return (int)(D <= 40 ? TC(40) : D <= 80 ? TC(80) : D <= 160
                     ? TC(160)
                     : launch_d512<bf16>(q, k, v, o, lse, B, H, Tq, Tk, D,
                                         scale, vec, s));
#undef TC
  }
  return (int)cudaErrorInvalidValue;
}

// The query rows per block of the bfloat16 instance that aqualora_flash_fwd
// launches on the current device at this shape: 128 (d <= 80) or 64 (d =
// 160) for wide tiles, 16 for tiles whose warps split the keys, 32 for d >
// 160.  0 for a shape the forward refuses.
extern "C" int aqualora_flash_fwd_tc_rows(int B, int H, int Tq, int D) {
  if (B < 1 || H < 1 || Tq < 1 || D < 1 || D > 512) return 0;
  return D <= 40 ? tc_rows<40>(B, H, Tq) : D <= 80 ? tc_rows<80>(B, H, Tq)
       : D <= 160 ? tc_rows<160>(B, H, Tq) : D512<bf16>::BR;
}
