// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T * scale) V, recomputing P from the saved row logsumexp.
//
// Replaces the TPU kernels `_dq_kernel` (aqualora_tpu/ops/flash_attention.py:239)
// and `_dkv_kernel` (:269), launched by `_flash_backward`.  The same function
// and the same split into two kernels, so that no sum crosses blocks and the
// result is deterministic (no atomics):
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
// and keeps its sums in float32 registers.
//
// What bounds it on this card.  The work is 10*B*H*Tq*Tk*D operations (five
// products of 2*Tq*Tk*D each: S, dP and dQ in the first kernel, S, dP, dV and
// dK again in the second, less the recomputed S and dP) against about
// 4*(Tq+Tk)*D*2 bytes per (b, h): at the U-Net's self-attention shapes it
// is bound by the tensor-core rate, at Tk = 77 it is close to the bytes.
// This first version is deliberately simple, like the forward: every product
// runs as float32 FMAs on the CUDA cores (67 TFLOP/s peak, far below the bf16
// tensor-core bound), so it sits well above its bound at the self-attention
// shapes.  What the design gets right is the memory side: the [Tq, Tk] P and
// dS never reach device memory, Q, dO, K and V are read once per tile pair,
// and each gradient is written once.  Tensor cores are later work.
//
// Design.  Both kernels use the forward's layout.  128 threads form row
// groups of G lanes (G divides 32, so a group never spans two warps); a group
// owns TM rows of the block's tile (query rows in the dQ kernel, key rows in
// the dK/dV kernel).  Lane g computes the scores of columns g, g+G, ... of the
// current tile of the other sequence and accumulates output columns g, g+G,
// ... of the head dim; P and dS are passed across the group by shuffles for
// the products that consume them.  The block's own rows stay in shared memory
// for the whole loop; each tile of the other sequence is staged once.
//
// Ragged shapes are masked, never padded in memory: head dims that are not a
// tile width (40, 80) load as zeros past D; keys past Tk get P = 0 in the dQ
// kernel and are not written by the dK/dV kernel; query rows past Tq have no
// defined L or delta, so the dK/dV kernel masks their P (and with it dS) to
// zero rather than only skipping their stores.  Head dims above 160 are
// refused: no differentiated attention of the port has one (the VAE's d = 512
// attention runs without gradients in training).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
  // float rows have an odd stride, so no vector load here
  static __device__ __forceinline__ float2 load2(const float* p) {
    return make_float2(p[0], p[1]);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16(0.f);
  }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
  // bf16 rows have an even stride: element pairs are 4-byte aligned
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// Tile shape per padded head dim DP: G lanes per row group, TM rows per group,
// BN columns (rows of the other sequence) per inner tile.  Registers per
// thread: 2*TM*DP/G accumulators in the dK/dV kernel (TM*DP/G in the dQ
// kernel) and 2*TM*BN/G scores.  One tile per head dim of the training path
// (40, 80, 160); any other D up to 160 takes the next larger tile.
template <int DP>
struct Cfg;
template <> struct Cfg<48>  { static constexpr int G = 8,  TM = 4, BN = 32; };
template <> struct Cfg<80>  { static constexpr int G = 8,  TM = 4, BN = 32; };
template <> struct Cfg<160> { static constexpr int G = 16, TM = 4, BN = 32; };

// Shared-memory row stride in elements: an odd number of 4-byte words.
template <typename T, int DP>
__host__ __device__ constexpr int row_stride() {
  return sizeof(T) == 4 ? DP + 1 : DP + 2;
}

// Stage rows [r0, r0 + R) of a [n, D] matrix into a [R, LD] shared tile,
// zeros past n and past D.
template <typename T, int DP, int R>
__device__ __forceinline__ void stage(T* dst, const T* src, int r0, int n,
                                      int D) {
  constexpr int LD = row_stride<T, DP>();
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    T x = Elem<T>::zero();
    if (r0 + r < n && c < D) x = src[(size_t)(r0 + r) * D + c];
    dst[r * LD + c] = x;
  }
}

// Two dot products of TM own rows against NC columns of the tile, over the
// head dim: a[i][j] = rowA_i . colA_j and b[i][j] = rowB_i . colB_j.
template <typename T, int DP, int TM, int NC, int G>
__device__ __forceinline__ void dots(float (&a)[TM][NC], float (&b)[TM][NC],
                                     const T* rowA, const T* rowB,
                                     const T* colA, const T* colB, int row0,
                                     int g) {
  constexpr int LD = row_stride<T, DP>();
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) a[i][j] = b[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < DP; c += 2) {
    float2 ra[TM], rb[TM], ca[NC], cb[NC];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      ra[i] = Elem<T>::load2(rowA + (row0 + i) * LD + c);
      rb[i] = Elem<T>::load2(rowB + (row0 + i) * LD + c);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      ca[j] = Elem<T>::load2(colA + (g + G * j) * LD + c);
      cb[j] = Elem<T>::load2(colB + (g + G * j) * LD + c);
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
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Tq, int Tk, int D, float scale,
                    float scale_log2) {
  using C = Cfg<DP>;
  constexpr int G = C::G, TM = C::TM, BN = C::BN;
  constexpr int BQ = (kThreads / G) * TM;
  constexpr int NK = BN / G;   // keys per lane per tile
  constexpr int ND = DP / G;   // output columns per lane
  constexpr int LD = row_stride<T, DP>();
  static_assert(DP % 2 == 0 && BN % G == 0 && DP % G == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + BQ * LD;
  T* k_s = do_s + BQ * LD;
  T* v_s = k_s + BN * LD;

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int row0 = (tid / G) * TM;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;

  stage<T, DP, BQ>(q_s, q + bh * Tq * D, q0, Tq, D);
  stage<T, DP, BQ>(do_s, dout + bh * Tq * D, q0, Tq, D);

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
    stage<T, DP, BN>(k_s, kb, k0, Tk, D);
    stage<T, DP, BN>(v_s, vb, k0, Tk, D);
    __syncthreads();

    float s[TM][NK], dp[TM][NK];
    dots<T, DP, TM, NK, G>(s, dp, q_s, do_s, k_s, v_s, row0, g);

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
        const T* krow = k_s + (j * G + src) * LD;
        float ds[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) ds[i] = __shfl_sync(kFull, s[i][j], src, G);
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) {
          const float kv = Elem<T>::to_f(krow[g + G * jd]);
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
      T* row = dq + (bh * Tq + r) * D;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        const int c = g + G * jd;
        if (c < D) row[c] = Elem<T>::from_f(acc[i][jd] * scale);
      }
    }
  }
}

// dK, dV: one block per (key tile, head, batch), looping over the query tiles.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, int D,
                     float scale, float scale_log2) {
  using C = Cfg<DP>;
  constexpr int G = C::G, TM = C::TM, BN = C::BN;
  constexpr int BK = (kThreads / G) * TM;
  constexpr int NQ = BN / G;   // queries per lane per tile
  constexpr int ND = DP / G;
  constexpr int LD = row_stride<T, DP>();
  static_assert(DP % 2 == 0 && BN % G == 0 && DP % G == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* l_s = reinterpret_cast<float*>(smem_raw);   // BN
  float* d_s = l_s + BN;                             // BN
  T* k_s = reinterpret_cast<T*>(d_s + BN);
  T* v_s = k_s + BK * LD;
  T* q_s = v_s + BK * LD;
  T* do_s = q_s + BN * LD;

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int row0 = (tid / G) * TM;
  const int k0 = blockIdx.x * BK;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* qb = q + bh * Tq * D;
  const T* dob = dout + bh * Tq * D;

  stage<T, DP, BK>(k_s, k + bh * Tk * D, k0, Tk, D);
  stage<T, DP, BK>(v_s, v + bh * Tk * D, k0, Tk, D);

  float acc_k[TM][ND], acc_v[TM][ND];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_tiles = (Tq + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BN;
    __syncthreads();  // K, V staged (t == 0) / previous Q tile consumed
    stage<T, DP, BN>(q_s, qb, q0, Tq, D);
    stage<T, DP, BN>(do_s, dob, q0, Tq, D);
    for (int r = tid; r < BN; r += kThreads) {
      const bool valid = q0 + r < Tq;
      l_s[r] = valid ? lse[bh * Tq + q0 + r] * kLog2e : 0.f;
      d_s[r] = valid ? delta[bh * Tq + q0 + r] : 0.f;
    }
    __syncthreads();

    // s = K Q^T (rows: own keys, columns: the tile's queries), dp = V dO^T
    float s[TM][NQ], dp[TM][NQ];
    dots<T, DP, TM, NQ, G>(s, dp, k_s, v_s, q_s, do_s, row0, g);

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
        const T* qrow = q_s + (j * G + src) * LD;
        const T* dorow = do_s + (j * G + src) * LD;
        float p[TM], ds[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          p[i] = __shfl_sync(kFull, s[i][j], src, G);
          ds[i] = __shfl_sync(kFull, dp[i][j], src, G);
        }
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) {
          const float qv = Elem<T>::to_f(qrow[g + G * jd]);
          const float ov = Elem<T>::to_f(dorow[g + G * jd]);
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
      T* krow = dk + (bh * Tk + r) * D;
      T* vrow = dv + (bh * Tk + r) * D;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        const int c = g + G * jd;
        if (c < D) {
          krow[c] = Elem<T>::from_f(acc_k[i][jd] * scale);
          vrow[c] = Elem<T>::from_f(acc_v[i][jd]);
        }
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Tq, int Tk, int D,
                      float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  constexpr int BQ = (kThreads / C::G) * C::TM;
  const size_t smem =
      (size_t)(2 * BQ + 2 * C::BN) * row_stride<T, DP>() * sizeof(T);
  // set on every launch: the limit is per device and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Tq, Tk, D, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Tq, int Tk,
                       int D, float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  constexpr int BK = (kThreads / C::G) * C::TM;
  const size_t smem = 2 * C::BN * sizeof(float) +
      (size_t)(2 * BK + 2 * C::BN) * row_stride<T, DP>() * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, D, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Tq, int Tk, int D) {
  return B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || D > 160 ||
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
#define DQ(T, DP) launch_dq<T, DP>(q, k, v, dout, lse, delta, dq, B, H, Tq, \
                                   Tk, D, scale, s)
  if (dtype == 0)
    return (int)(D <= 48 ? DQ(float, 48) : D <= 80 ? DQ(float, 80)
                                                   : DQ(float, 160));
  if (dtype == 1)
    return (int)(D <= 48 ? DQ(__nv_bfloat16, 48)
                 : D <= 80 ? DQ(__nv_bfloat16, 80) : DQ(__nv_bfloat16, 160));
#undef DQ
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
#define DKV(T, DP) launch_dkv<T, DP>(q, k, v, dout, lse, delta, dk, dv, B, H, \
                                     Tq, Tk, D, scale, s)
  if (dtype == 0)
    return (int)(D <= 48 ? DKV(float, 48) : D <= 80 ? DKV(float, 80)
                                                    : DKV(float, 160));
  if (dtype == 1)
    return (int)(D <= 48 ? DKV(__nv_bfloat16, 48)
                 : D <= 80 ? DKV(__nv_bfloat16, 80) : DKV(__nv_bfloat16, 160));
#undef DKV
  return (int)cudaErrorInvalidValue;
}
