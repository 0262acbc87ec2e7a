// Fused secret injection for Hopper (sm_90a): the SecretEncoder's watermark
// of a message added to a VAE latent, the whole function in one launch,
//
//   u[b, i, j]      = silu(sum_n msg[b, n] * Wd[i * base + j, n]
//                          + bd[i * base + j])
//   out[b, c, y, x] = latent[b, c, y, x] + bias[c]
//                     + sum_{dy, dx} grid[b, y + dy - 1, x + dx - 1]
//                                    * k1[c, dy, dx]
//
// where grid[b, y, x] = u[b, y / 2, x / 2] inside [0, H) x [0, W) and 0
// outside it (the nearest-x2 upsample and the zero pad, as index
// arithmetic), and k1 is the 3x3 conv kernel [C, Cin, 3, 3] summed over its
// input channels (the encoder repeats one grid over its input channels, so
// the conv of the repeat is a single-channel conv with the summed kernel).
//
// Replaces the TPU kernel `_kernel` (aqualora_tpu/ops/secret_inject.py:47,
// launched by `_pallas_inject`) together with the XLA ops around it: the
// dense layer, SiLU, the upsample, the pad and the channel sum, which Mosaic
// could not take into the Pallas kernel, are in this one.  Latents are NCHW.
//
// What bounds it on this card: the launch.  At the PPFT shape (B8 x 4 x 64 x
// 64 in bf16, 48 bits, bf16 weights) it reads the latent (256 KB) and the
// dense weight (96 KB) and writes 256 KB, about 0.2 us at 3.35 TB/s; its 3.4
// MFLOP (the 48-term dense sums and the stencil) take less.  So the design
// spends no launch on anything else: a stencil-only kernel, as the Pallas one
// is, needs about ten device ops around it (weight casts, the dense product,
// SiLU, two repeats, the pad, the channel sum, copies); this is one launch,
// and no intermediate reaches device memory.
//
// Design.  One block of 256 threads per (band of 8 output rows, batch item):
// 64 blocks at B8, where one block per item would fill 8 of 132 SMs.  A band
// reads the grid from the row above it to the row below it, which is base
// rows y0 / 2 - 1 .. y0 / 2 + 4.  The block
//   1. loads msg[b], the conv bias and k1 (the input channels added in
//      order) into shared memory;
//   2. computes u on those 6 base rows (192 cells at base 32), one thread a
//      cell, a float32 sum over the bits in order, then SiLU, into shared
//      memory.  Neighbouring bands both compute the two halo rows: half again
//      the dense work of a band's own 4 rows, for eight times the blocks;
//   3. writes latent + bias + the 9-tap stencil for every output of the band,
//      consecutive threads on consecutive x (coalesced latent and output
//      rows), in the latent's type.
// Every input is read in its own type (float32 or bfloat16: the PPFT trainer
// keeps the SecretEncoder in bf16) and converted to float32 where it is
// loaded, as the plain version's `.float()` casts; the arithmetic is float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 8;                   // output rows a block
constexpr int kBaseRows = kBand / 2 + 2;   // base rows of u a band reads

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

// Element i of an input that is bfloat16 if `bf`, else float32, as float32.
__device__ __forceinline__ float load(const void* p, bool bf, size_t i) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

// bf16: bit i set = the i-th input after the latent is bfloat16 (0 msg,
// 1 dense_w, 2 dense_b, 3 conv_w, 4 conv_b).  Layouts: msg [B, bits],
// dense_w [base^2, bits], dense_b [base^2], conv_w [C, Cin, 3, 3], conv_b
// [C]; latent and out [B, C, 2 base, 2 base] of T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
secret_inject_kernel(const T* __restrict__ latent,
                     const void* __restrict__ msg,
                     const void* __restrict__ dense_w,
                     const void* __restrict__ dense_b,
                     const void* __restrict__ conv_w,
                     const void* __restrict__ conv_b, T* __restrict__ out,
                     int C, int Cin, int base, int bits, int bf16) {
  extern __shared__ float smem[];
  float* msg_s = smem;                 // [bits]
  float* k1_s = msg_s + bits;          // [C][9]
  float* cb_s = k1_s + 9 * C;          // [C]
  float* u_s = cb_s + C;               // [kBaseRows][base]
  const int b = blockIdx.y, H = 2 * base, W = 2 * base;
  const int y0 = blockIdx.x * kBand;
  const int r0 = y0 / 2 - 1;           // the base row of u_s's first row
  const int tid = threadIdx.x;

  for (int i = tid; i < bits; i += kThreads)
    msg_s[i] = load(msg, bf16 & 1, (size_t)b * bits + i);
  for (int i = tid; i < 9 * C; i += kThreads) {
    const int c = i / 9, tap = i % 9;
    float sum = 0.f;
    for (int ci = 0; ci < Cin; ++ci)
      sum += load(conv_w, bf16 & 8, ((size_t)c * Cin + ci) * 9 + tap);
    k1_s[i] = sum;
  }
  for (int i = tid; i < C; i += kThreads) cb_s[i] = load(conv_b, bf16 & 16, i);
  __syncthreads();

  for (int i = tid; i < kBaseRows * base; i += kThreads) {
    const int r = r0 + i / base;
    float u = 0.f;                     // rows outside the grid are not read
    if (r >= 0 && r < base) {
      const size_t cell = (size_t)r * base + i % base;
      float acc = 0.f;
      for (int n = 0; n < bits; ++n)
        acc = fmaf(msg_s[n], load(dense_w, bf16 & 2, cell * bits + n), acc);
      acc += load(dense_b, bf16 & 4, cell);
      u = acc / (1.f + expf(-acc));
    }
    u_s[i] = u;
  }
  __syncthreads();

  const int rows = min(kBand, H - y0);
  for (int i = tid; i < C * rows * W; i += kThreads) {
    const int x = i % W, y = y0 + (i / W) % rows, c = i / (W * rows);
    const size_t idx = (((size_t)b * C + c) * H + y) * W + x;
    const float* kc = k1_s + 9 * c;
    float acc = to_f(latent[idx]) + cb_s[c];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int gy = y + dy - 1;
      if (gy < 0 || gy >= H) continue;
      const float* ur = u_s + (gy / 2 - r0) * base;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int gx = x + dx - 1;
        if (gx < 0 || gx >= W) continue;
        acc = fmaf(ur[gx / 2], kc[dy * 3 + dx], acc);
      }
    }
    out[idx] = from_f<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* latent, const void* msg, const void* dense_w,
                   const void* dense_b, const void* conv_w,
                   const void* conv_b, void* out, int B, int C, int Cin,
                   int base, int bits, int bf16, size_t smem,
                   cudaStream_t stream) {
  const dim3 grid((2 * base + kBand - 1) / kBand, B);
  secret_inject_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(latent), msg, dense_w, dense_b, conv_w, conv_b,
      static_cast<T*>(out), C, Cin, base, bits, bf16);
  return cudaGetLastError();
}

}  // namespace

// dtypes: bit i set = the i-th input (0 latent and out, 1 msg, 2 dense_w,
// 3 dense_b, 4 conv_w, 5 conv_b) is bfloat16, else float32.  Every tensor
// is contiguous in the layouts above, latent [B, C, 2 base, 2 base].
// Returns the cudaError_t of the launch.
extern "C" int aqualora_secret_inject(const void* latent, const void* msg,
                                      const void* dense_w,
                                      const void* dense_b,
                                      const void* conv_w,
                                      const void* conv_b, void* out, int B,
                                      int C, int Cin, int base, int bits,
                                      int dtypes, void* stream) {
  const size_t smem =
      (size_t)(bits + 10 * (size_t)C + kBaseRows * (size_t)base) *
      sizeof(float);
  if (B < 1 || C < 1 || Cin < 1 || base < 1 || bits < 1 || B > 65535 ||
      base > 32768 || dtypes < 0 || dtypes > 63 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtypes & 1)
    return (int)launch<__nv_bfloat16>(latent, msg, dense_w, dense_b, conv_w,
                                      conv_b, out, B, C, Cin, base, bits,
                                      dtypes >> 1, smem, s);
  return (int)launch<float>(latent, msg, dense_w, dense_b, conv_w, conv_b,
                            out, B, C, Cin, base, bits, dtypes >> 1, smem, s);
}
