// int8 implicit-GEMM convolution for Hopper (sm_90a): the w8a8 serving
// path's product of int8 activation codes and int8 weight codes, with the
// dequantizing epilogue fused,
//
//   acc[m, n] = sum_k A[m, k] * Wt[n, k]                         (int32, exact)
//   out[b, n, oy, ox] = T(float(acc) * xs[b] * ws[n]) + bias[n]   (T = out type)
//
// where m = (b, oy, ox) runs over M = B * Ho * Wo output pixels, n over N =
// Cout, k = (ky, kx, ci) over K = kh * kw * Cin, A[m, k] is the NHWC code
// x[b, oy * stride - pad + ky, ox * stride - pad + kx, ci] (0 in the
// padding), and Wt[n, k] the weight codes stored O x kh x kw x I (torch's
// channels-last OIHW).  The products are (float(acc) * xs) * ws in that
// order, rounded to the output type (float32 or bfloat16), and the bias is
// added in that type, as `int8_conv` and `layers.Conv2D` compute them
// (aqualora_tpu/ops/quant.py:84-85, models/layers.py:62-69): since the
// int32 sum is exact in any order, the result equals the plain version's
// (a float64 convolution of the codes) bit for bit.  Cases: 3x3 with stride
// 1 or 2 and padding 1, and 1x1 (a dense layer is the 1x1 case over [rows,
// in, 1, 1]: one activation scale a row, Ho * Wo = 1).  Ragged M, N and K
// are masked, never padded.
//
// It replaces no TPU kernel: JAX's int8 convolution is XLA's
// `conv_general_dilated` on int8 operands (quant.py:79-83), outside any
// Pallas kernel, and torch has no int8 convolution on CUDA.  What bounds it
// on this card: the int8 tensor-core rate (1979 TOPS dense) at the U-Net's
// 3x3 shapes, e.g. 64^2 320 -> 320 at B16: 2 * 65536 * 320 * 2880 = 121
// GOP, 0.061 ms, against 28 MB of codes and output (0.008 ms); the bytes at
// its small 1x1 and 8^2 shapes.
//
// Design: a simple tensor-core kernel, right first (wgmma and TMA are for a
// later PR).  A block of 256 threads (8 warps, 2 x 4) computes a 128 x 128
// tile of out; each warp a 64 x 32 tile as 4 x 4 mma.sync.m16n8k32 s8 x s8
// -> s32 products per 32 of K.  K is walked in 64-byte tiles, double
// buffered in shared memory by cp.async (16 bytes a copy; zero-filled in
// the padding and past M, N, K) when Cin is a multiple of 16, so that a
// 16-byte chunk of K lies in one tap and one pixel; otherwise by byte loads
// (the tiny test configs).  Operands come from shared memory by ldmatrix:
// the s8 m16n8k32 fragments have the byte layout of the bf16 m16n8k16 ones.
// Rows of 64 bytes put every other row on the same banks, so 16-byte chunk
// c of row r is stored at chunk c ^ ((r / 2) % 4): the eight rows an
// ldmatrix phase reads land on eight different bank groups.  The epilogue
// writes NCHW directly from the fragments (eight consecutive pixels a
// store per column).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

using aqualora_tc::cp_async16;
using aqualora_tc::cp_async_commit;
using aqualora_tc::cp_async_wait;
using aqualora_tc::ldmatrix_x4;

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 64;   // BK in int8 elements (bytes)

struct Conv {
  const int8_t* x;      // [B, H, W, Cin]
  const int8_t* w;      // [N, kh, kw, Cin]
  const float* xs;      // [B]
  const float* ws;      // [N]
  const void* bias;     // [N] of the output type, or null
  void* out;            // [B, N, Ho, Wo]
  int H, W, Cin, N, kw, stride, pad, Ho, Wo, M, K;
};

// Byte offset of 16-byte chunk c of row r in a [rows][BK] tile.
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One output pixel row of the A tile this thread stages.
struct Row {
  const int8_t* base;   // image b's codes
  int iy0, ix0;         // input position of tap (0, 0)
  bool ok;              // m < M
};

__device__ __forceinline__ Row make_row(const Conv& p, int m) {
  Row r;
  r.ok = m < p.M;
  const int hw = p.Ho * p.Wo;
  const int mm = r.ok ? m : 0;
  const int b = mm / hw, q = mm - b * hw;
  const int oy = q / p.Wo, ox = q - oy * p.Wo;
  r.iy0 = oy * p.stride - p.pad;
  r.ix0 = ox * p.stride - p.pad;
  r.base = p.x + (long long)b * p.H * p.W * p.Cin;
  return r;
}

// Source of A[m, k] (k a multiple of 16 when VEC); null in the padding or
// past K.
__device__ __forceinline__ const int8_t* a_src(const Conv& p, const Row& r,
                                               int k) {
  if (!r.ok || k >= p.K) return nullptr;
  const int tap = k / p.Cin, ci = k - tap * p.Cin;
  const int ky = tap / p.kw, kx = tap - ky * p.kw;
  const int iy = r.iy0 + ky, ix = r.ix0 + kx;
  if (iy < 0 || iy >= p.H || ix < 0 || ix >= p.W) return nullptr;
  return r.base + ((long long)iy * p.W + ix) * p.Cin + ci;
}

// Stage K tile kt of A (rows r0, r0 + 64 of the block, chunk c) and of Wt.
template <bool VEC>
__device__ __forceinline__ void stage(const Conv& p, const Row (&rows)[2],
                                      int8_t* As, int8_t* Bs, int kt, int m_r0,
                                      int n0, int c) {
  const int k = kt * BK + c * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m_r0 + h * 64;
    int8_t* da = As + swz(r, c);
    int8_t* db = Bs + swz(r, c);
    const int n = n0 + r;
    if (VEC) {
      const int8_t* sa = a_src(p, rows[h], k);
      cp_async16(da, sa ? sa : p.x, sa ? 16 : 0);
      const bool bok = n < p.N && k < p.K;
      cp_async16(db, bok ? p.w + (long long)n * p.K + k : p.w, bok ? 16 : 0);
    } else {
#pragma unroll 1
      for (int e = 0; e < 16; ++e) {
        const int8_t* sa = a_src(p, rows[h], k + e);
        da[e] = sa ? *sa : (int8_t)0;
        db[e] = n < p.N && k + e < p.K ? p.w[(long long)n * p.K + k + e]
                                       : (int8_t)0;
      }
    }
  }
}

// out = T(((float(acc) * xs) * ws)) + bias in T: the sum of two T values in
// float32, rounded to T (torch's and XLA's bfloat16 add).
template <typename T>
__device__ __forceinline__ void store(const Conv& p, int m, int n, int acc) {
  if (m >= p.M || n >= p.N) return;
  const int hw = p.Ho * p.Wo;
  const int b = m / hw, q = m - b * hw;
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), p.xs[b]), p.ws[n]);
  T* o = static_cast<T*>(p.out) + ((long long)b * p.N + n) * hw + q;
  if constexpr (std::is_same<T, float>::value) {
    if (p.bias) v = __fadd_rn(v, static_cast<const float*>(p.bias)[n]);
    *o = v;
  } else {
    T y = __float2bfloat16_rn(v);
    if (p.bias)
      y = __float2bfloat16_rn(__fadd_rn(
          __bfloat162float(y), __bfloat162float(static_cast<const T*>(
                                   p.bias)[n])));
    *o = y;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const Conv p) {
  __shared__ __align__(128) int8_t As[2][BM * BK];
  __shared__ __align__(128) int8_t Bs[2][BN * BK];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int m_r0 = tid >> 2, c = tid & 3;     // staged rows m_r0, m_r0 + 64
  const Row rows[2] = {make_row(p, m0 + m_r0), make_row(p, m0 + m_r0 + 64)};
  const int kt_n = (p.K + BK - 1) / BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  stage<VEC>(p, rows, As[0], Bs[0], 0, m_r0, n0, c);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    if (kt + 1 < kt_n)
      stage<VEC>(p, rows, As[(kt + 1) & 1], Bs[(kt + 1) & 1], kt + 1, m_r0,
                 n0, c);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int8_t* A = As[kt & 1];
    const int8_t* B = Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4<false>(a[i], A + swz(r, ks * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = wn + j * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4<false>(b[j], B + swz(r, ks * 2 + ((lane >> 3) & 1)));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
                 b[j >> 1][(j & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + wm + i * 16 + g, n = n0 + wn + j * 8 + t * 2;
      store<T>(p, m, n, acc[i][j][0]);
      store<T>(p, m, n + 1, acc[i][j][1]);
      store<T>(p, m + 8, n, acc[i][j][2]);
      store<T>(p, m + 8, n + 1, acc[i][j][3]);
    }
}

template <typename T>
cudaError_t launch(const Conv& p, bool vec, cudaStream_t stream) {
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  if (vec)
    int8_conv_kernel<T, true><<<grid, kThreads, 0, stream>>>(p);
  else
    int8_conv_kernel<T, false><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, Cin] int8 (NHWC), w [Cout, k, k, Cin] int8, xs [B] and ws
// [Cout] float32, bias [Cout] of the output type or null, out [B, Cout, Ho,
// Wo] float32 (out_bf16 = 0) or bfloat16 (1).  k = 3 with stride 1 or 2 and
// pad 1, or k = 1 with stride 1 and pad 0.  Returns the launch's
// cudaError_t.
extern "C" int aqualora_int8_conv(const int8_t* x, const int8_t* w,
                                  const float* xs, const float* ws,
                                  const void* bias, void* out, int B, int H,
                                  int W, int Cin, int Cout, int k, int stride,
                                  int pad, int out_bf16, cudaStream_t stream) {
  const bool shape_ok = (k == 3 && pad == 1 && (stride == 1 || stride == 2)) ||
                        (k == 1 && pad == 0 && stride == 1);
  if (!shape_ok || B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  Conv p;
  p.x = x; p.w = w; p.xs = xs; p.ws = ws; p.bias = bias; p.out = out;
  p.H = H; p.W = W; p.Cin = Cin; p.N = Cout; p.kw = k; p.stride = stride;
  p.pad = pad;
  p.Ho = (H + 2 * pad - k) / stride + 1;
  p.Wo = (W + 2 * pad - k) / stride + 1;
  const long long m = (long long)B * p.Ho * p.Wo;
  const long long kk = (long long)k * k * Cin;
  if (p.Ho <= 0 || p.Wo <= 0 || m >= (1ll << 31) || kk >= (1ll << 31) ||
      (Cout + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  p.M = (int)m;
  p.K = (int)kk;
  const bool vec = Cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return (int)(out_bf16 ? launch<__nv_bfloat16>(p, vec, stream)
                        : launch<float>(p, vec, stream));
}
