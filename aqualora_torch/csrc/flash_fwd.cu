// Flash-attention forward for Hopper (sm_90a): softmax(Q K^T * scale) V.
//
// Replaces the TPU kernel `_fwd_kernel` (aqualora_tpu/ops/flash_attention.py:147,
// launched by `_flash_forward`).  It computes the same function: unmasked
// attention over [B, H, T, D] with an online softmax and float32
// accumulation, returning O in the input type and the per-row logsumexp
// L = m + log(l) in float32 as [B, H, Tq] (the TPU kernel's trailing 8 lanes
// were a layout artifact and are dropped).
//
// What bounds it on this card.  At the U-Net's self-attention shapes the work
// is 4*B*H*Tq*Tk*D operations against 2*(Tq+Tk)*D*2 bytes per (b, h): the
// arithmetic intensity is about Tk/2 operations per byte, far above the
// H100's ~295 (bf16), so the bound is the tensor-core rate.  Cross-attention
// (Tk = 77) sits near 77 operations per byte and is bound by the bytes of Q
// and O.  This first version is deliberately simple: both products run as
// float32 FMAs on the CUDA cores (67 TFLOP/s peak, well below the bf16
// tensor-core bound), so it is far from the bound at the self-attention
// shapes.  What the design does get right is the memory side: the [Tq, Tk]
// logits never reach device memory, K and V are read once per query tile,
// and Q, O are read and written once.  Moving the two products onto
// mma/wgmma with TMA-fed tiles is later work.
//
// Design.  One block of 128 threads per (query tile, head, batch).  The
// threads form row groups of G lanes (G divides 32, so a group never spans two
// warps); each group owns TM query rows.  Inside a group, lane g computes the
// scores of keys g, g+G, ... of the current key tile and accumulates the
// output columns g, g+G, ... of the head dim, so the running max, the
// normalizer and the float32 accumulator live in registers.  Row max and row
// sum are reduced across the group with shuffles, and P is passed across the
// group by shuffles for the P*V product.  Q stays in shared memory for the
// whole block; K and then V of each key tile share one shared buffer.
//
// Ragged shapes are masked, never padded in memory: head dims that are not a
// tile width (40, 80, 160) load as zeros past D; query rows past Tq compute on
// zeros and are not written; keys past Tk (the 77-token cross-attention) get
// -inf scores and zero V rows.  Shared-memory rows carry one (float) or two
// (bf16) elements of padding, so the rows that the lanes of a group read at
// once start in different banks.  The d = 512 tile (VAE mid-block) needs more
// than 48 KB of shared memory in float32, so every launch sets the dynamic
// shared-memory limit first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// Tile shape per padded head dim DP: G lanes per row group, TM query rows per
// group, BK keys per tile.  Registers per thread: TM*DP/G accumulators and
// TM*BK/G scores.  There is one tile per head dim of the main path (40, 80,
// 160, 512); any other D takes the next larger tile.
template <int DP>
struct Cfg;
template <> struct Cfg<48>  { static constexpr int G = 8,  TM = 8, BK = 32; };
template <> struct Cfg<80>  { static constexpr int G = 8,  TM = 8, BK = 32; };
template <> struct Cfg<160> { static constexpr int G = 16, TM = 8, BK = 32; };
template <> struct Cfg<512> { static constexpr int G = 32, TM = 4, BK = 32; };

// Shared-memory row stride in elements: an odd number of 4-byte words.
template <typename T, int DP>
__host__ __device__ constexpr int row_stride() {
  return sizeof(T) == 4 ? DP + 1 : DP + 2;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 float scale_log2) {
  using C = Cfg<DP>;
  constexpr int G = C::G, TM = C::TM, BK = C::BK;
  constexpr int BQ = (kThreads / G) * TM;
  constexpr int NK = BK / G;   // keys per lane per tile
  constexpr int ND = DP / G;   // output columns per lane
  constexpr int LD = row_stride<T, DP>();
  static_assert(DP % 2 == 0 && BK % G == 0 && DP % G == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* kv_s = q_s + BQ * LD;

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int row0 = (tid / G) * TM;          // first row of this group in the tile
  const int q0 = blockIdx.x * BQ;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* qb = q + bh * Tq * D;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;

  for (int i = tid; i < BQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    T x = Elem<T>::zero();
    if (q0 + r < Tq && c < D) x = qb[(size_t)(q0 + r) * D + c];
    q_s[r * LD + c] = x;
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
      T x = Elem<T>::zero();
      if (k0 + r < Tk && c < D) x = kb[(size_t)(k0 + r) * D + c];
      kv_s[r * LD + c] = x;
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
      for (int i = 0; i < TM; ++i) qv[i] = Elem<T>::load2(q_s + (row0 + i) * LD + c);
#pragma unroll
      for (int j = 0; j < NK; ++j) kv[j] = Elem<T>::load2(kv_s + (g + G * j) * LD + c);
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
      T x = Elem<T>::zero();
      if (k0 + r < Tk && c < D) x = vb[(size_t)(k0 + r) * D + c];
      kv_s[r * LD + c] = x;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int src = 0; src < G; ++src) {
        const T* vrow = kv_s + (j * G + src) * LD;
        float p[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) p[i] = __shfl_sync(kFull, s[i][j], src, G);
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) {
          const float vv = Elem<T>::to_f(vrow[g + G * jd]);
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
      T* orow = o + (bh * Tq + r) * D;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        const int c = g + G * jd;
        if (c < D) orow[c] = Elem<T>::from_f(acc[i][jd] * inv);
      }
      if (g == 0) lse[bh * Tq + r] = m[i] * kLn2 + logf(l[i]);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Tq, int Tk, int D,
                   float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  constexpr int BQ = (kThreads / C::G) * C::TM;
  const size_t smem = (size_t)(BQ + C::BK) * row_stride<T, DP>() * sizeof(T);
  // set on every launch: the limit is per device and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Tq, Tk, D, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int Tq, int Tk, int D,
                         float scale, cudaStream_t s) {
  if (D <= 48) return launch<T, 48>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, s);
  if (D <= 80) return launch<T, 80>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, s);
  if (D <= 160) return launch<T, 160>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, s);
  return launch<T, 512>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Tensors are contiguous [B, H, T, D];
// lse is float32 [B, H, Tq].  Returns the cudaError_t of the launch.
extern "C" int aqualora_flash_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int H, int Tq,
                                  int Tk, int D, float scale, int dtype,
                                  void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || D > 512 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dim<float>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, s);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, B, H, Tq, Tk, D,
                                            scale, s);
  return (int)cudaErrorInvalidValue;
}
