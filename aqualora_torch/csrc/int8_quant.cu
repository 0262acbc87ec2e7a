// Dynamic int8 activation quantizer for Hopper (sm_90a): the w8a8 serving
// path's per-image (convolution) or per-row (dense layer) quantization,
//
//   s[g]             = max(max_i |x[g, i]|, 1e-12) / 127        (float32)
//   q[g, p, c]       = clip(rint(x[g, c, p] / s[g]), -127, 127)  (int8)
//
// over x [G, C, HW] (NCHW, float32 or bfloat16, HW = H * W; a dense layer's
// rows are G = rows, C = in, HW = 1).  The codes are written transposed, [G,
// HW, C] (NHWC, channels-last), the layout csrc/int8_conv.cu reads, so the
// transposition costs no pass of its own.  The arithmetic is the JAX
// package's `_quantize_activations` (aqualora_tpu/ops/quant.py:54) bit for
// bit: the absmax of float32 values is exact, the two divisions are IEEE
// round-to-nearest (`__fdiv_rn`; the build passes no --use_fast_math) and
// `__float2int_rn` rounds half to even, as `jnp.round` does.
//
// It replaces no TPU kernel: JAX computes this in XLA ops around its int8
// `conv_general_dilated` (torch has no int8 convolution on CUDA, so the
// port's convolution is a kernel of its own, and its operand comes from
// here).  What bounds it on this card: bytes.  At the serving U-Net's
// largest input (B16 x 320 x 64 x 64 bf16, 42 MB) it must read x once and
// write a quarter of its bytes in codes, about 16 us at 3.35 TB/s; this
// design reads x twice (once to reduce, once to quantize: an image of 2.6
// MB does not stay in one SM), about 31 us at the rate.
//
// Design.  Launch 1: a grid of (group, chunk of QUANT_CHUNK elements)
// blocks, each reducing its chunk's |x| to one float in partial[g, chunk]
// (no atomics, no zeroed scratch, so no memset launch; max is exact in any
// order).  Launch 2: a grid of (group, 64-channel tile, 64-pixel tile)
// blocks; each block first reduces its group's partials (a few hundred
// floats) to the absmax and the scale, then reads its 64 x 64 tile along
// pixels (coalesced NCHW rows), quantizes into shared memory, and writes it
// along channels (coalesced NHWC rows).  The first block of a group writes
// s[g].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Max over the block's threads (every thread gets it).
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// partial[g * chunks + c] = max |x| over elements [c * chunk, (c + 1) *
// chunk) of group g (n elements a group).  grid (G, chunks).
template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                      long long n, int chunk) {
  __shared__ float red[kThreads / 32];
  const int g = blockIdx.x, c = blockIdx.y;
  const T* xg = x + (long long)g * n;
  const long long start = (long long)c * chunk;
  const long long end = min(start + chunk, n);
  float m = 0.f;
  for (long long i = start + threadIdx.x; i < end; i += kThreads)
    m = fmaxf(m, fabsf(to_f(xg[i])));
  m = block_max(m, red);
  if (threadIdx.x == 0) partial[(long long)g * gridDim.y + c] = m;
}

// grid (G, ceil(C / 64), ceil(HW / 64)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                int chunks, int8_t* __restrict__ q, float* __restrict__ scale,
                int C, int HW) {
  __shared__ float red[kThreads / 32];
  __shared__ int8_t tile[kTile][kTile + 4];   // [pixel][channel]
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * kTile, p0 = blockIdx.z * kTile;

  float m = 0.f;
  for (int i = threadIdx.x; i < chunks; i += kThreads)
    m = fmaxf(m, partial[(long long)g * chunks + i]);
  m = block_max(m, red);
  const float s = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
  if (blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) scale[g] = s;

  const T* xg = x + (long long)g * C * HW;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int cl = i / kTile, pl = i % kTile;
    const int c = c0 + cl, p = p0 + pl;
    if (c < C && p < HW) {
      const int r = __float2int_rn(__fdiv_rn(to_f(xg[(long long)c * HW + p]),
                                             s));
      tile[pl][cl] = (int8_t)max(-127, min(127, r));
    }
  }
  __syncthreads();
  int8_t* qg = q + (long long)g * HW * C;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int pl = i / kTile, cl = i % kTile;
    const int c = c0 + cl, p = p0 + pl;
    if (c < C && p < HW) qg[(long long)p * C + c] = tile[pl][cl];
  }
}

template <typename T>
cudaError_t launch(const void* x, float* partial, int8_t* q, float* scale,
                   int G, int C, int HW, int chunks, int chunk,
                   cudaStream_t stream) {
  const long long n = (long long)C * HW;
  absmax_partial_kernel<T><<<dim3(G, chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), partial, n, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(G, (C + kTile - 1) / kTile, (HW + kTile - 1) / kTile);
  quantize_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), partial, chunks, q, scale, C, HW);
  return cudaGetLastError();
}

}  // namespace

// x [G, C, HW] float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous;
// partial [G * chunks] float32 scratch with chunks = ceil(C * HW / chunk);
// q [G, HW, C] int8; scale [G] float32.  Returns the launches' cudaError_t.
extern "C" int aqualora_int8_quant(const void* x, float* partial, int8_t* q,
                                   float* scale, int bf16, int G, int C,
                                   int HW, int chunks, int chunk,
                                   cudaStream_t stream) {
  if (G <= 0 || C <= 0 || HW <= 0 || chunk <= 0 ||
      chunks != (int)(((long long)C * HW + chunk - 1) / chunk) ||
      chunks > 65535 || (C + kTile - 1) / kTile > 65535 ||
      (HW + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)(bf16 ? launch<__nv_bfloat16>(x, partial, q, scale, G, C, HW,
                                            chunks, chunk, stream)
                    : launch<float>(x, partial, q, scale, G, C, HW, chunks,
                                    chunk, stream));
}
