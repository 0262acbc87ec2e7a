// Fused secret injection for Hopper (sm_90a): the last step of the
// SecretEncoder added to a VAE latent,
//
//   out[b, c, y, x] = latent[b, c, y, x] + bias[c]
//                     + sum_{dy, dx} grid[b, y + dy, x + dx] * k1[c, dy, dx]
//
// where `grid` is the zero-padded, nearest-x2 upsampled silu(msg W + b)
// [B, H+2, W+2] and k1 = sum over input channels of the 3x3 conv kernel
// [C, 3, 3] (the encoder repeats one grid over its input channels, so the
// conv of the repeat is a single-channel conv with the summed kernel).
//
// Replaces the TPU kernel `_kernel` (aqualora_tpu/ops/secret_inject.py:47,
// launched by `_pallas_inject`).  The dense layer, SiLU, the upsample and the
// pad stay outside, as they stay outside Pallas.  Latents are NCHW here.
//
// What bounds it on this card: bytes.  Per output element it reads one latent
// element and nine grid values that neighbouring threads share through L1, and
// writes one element: at B8 x 4 x 64 x 64 that is about 0.66 MB in bf16
// (1.2 MB in float32), 0.2-0.4 us at 3.35 TB/s, so a launch costs more than
// the work.  The design does the simple right thing: one thread per output
// element, consecutive threads on consecutive x (coalesced latent and output
// rows), float32 arithmetic, the output in the latent's type.  The launch
// overhead is recorded, not fought (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
secret_inject_kernel(const T* __restrict__ latent,
                     const float* __restrict__ grid,
                     const float* __restrict__ k1,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int B, int C, int H, int W) {
  const size_t n = (size_t)B * C * H * W;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int c = (int)((i / ((size_t)W * H)) % C);
  const size_t b = i / ((size_t)W * H * C);
  const int GW = W + 2;
  const float* g = grid + b * (size_t)(H + 2) * GW + (size_t)y * GW + x;
  const float* kc = k1 + c * 9;
  float acc = to_f(latent[i]) + bias[c];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      acc = fmaf(g[dy * GW + dx], kc[dy * 3 + dx], acc);
  out[i] = from_f<T>(acc);
}

template <typename T>
cudaError_t launch(const void* latent, const void* grid, const void* k1,
                   const void* bias, void* out, int B, int C, int H, int W,
                   cudaStream_t stream) {
  const size_t n = (size_t)B * C * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  secret_inject_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(latent), static_cast<const float*>(grid),
      static_cast<const float*>(k1), static_cast<const float*>(bias),
      static_cast<T*>(out), B, C, H, W);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (latent and out).  latent, out contiguous
// [B, C, H, W]; grid float32 [B, H+2, W+2]; k1 float32 [C, 3, 3]; bias
// float32 [C].  Returns the cudaError_t of the launch.
extern "C" int aqualora_secret_inject(const void* latent, const void* grid,
                                      const void* k1, const void* bias,
                                      void* out, int B, int C, int H, int W,
                                      int dtype, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 ||
      (size_t)B * C * H * W > (size_t)kThreads * 0x7fffffffu)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(latent, grid, k1, bias, out, B, C, H, W, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(latent, grid, k1, bias, out, B, C, H,
                                      W, s);
  return (int)cudaErrorInvalidValue;
}
