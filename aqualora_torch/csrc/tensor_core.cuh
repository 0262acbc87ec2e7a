// Tensor-core helpers shared by the attention kernels (flash_fwd.cu,
// flash_bwd.cu): 16-byte cp.async staging of bf16 or float32 rows into
// padded shared tiles, ldmatrix operand loads, the mma.sync.m16n8k16 bf16
// product, the m16n8k8 TF32 product with its 3xTF32 split, and paired
// stores.
//
// ops/_build.py names a built library by the hash of its source and of the
// csrc headers it includes, so an edit here rebuilds both kernels.

#pragma once

#include <cuda_bf16.h>

namespace aqualora_tc {

// Every kernel of the attention sources runs blocks of 128 threads.
constexpr int kThreads = 128;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; the bytes past `src_bytes` (all
// 16 when it is 0) are written as zeros and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and gets, of each matrix m, reg m = (row l / 4, columns 2(l % 4),
// 2(l % 4) + 1), or of its transpose with TRANS.  Read from a float32 tile
// (without TRANS), a matrix is 8 rows x 4 floats and lane l gets float
// (row l / 4, column l % 4).  `.trans` moves 16-bit elements, so it cannot
// transpose float32 tiles.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)) : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)) : "memory");
}

// c (16x8, float32) += a (16x16, bf16, row-major) * b (16x8, bf16).  Lane l,
// g = l / 4, t = l % 4: c[0..1] = row g, columns 2t, 2t+1; c[2..3] = row
// g + 8; a[0] = row g, k 2t..2t+1; a[1] = row g+8; a[2], a[3] the same at
// k + 8; b0 = k 2t..2t+1, column g; b1 = k + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16x8, float32) += a (16x8, TF32, row-major) * b (8x8, TF32).  Lane l,
// g = l / 4, t = l % 4: a[0] = (row g, k t), a[1] = (g + 8, t), a[2] = (g,
// t + 4), a[3] = (g + 8, t + 4); b0 = (k t, column g), b1 = (k t + 4,
// column g); c as in mma_bf16.  The tensor core reads 10 of an operand's 23
// mantissa bits.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x (the bits of a float32) = hi + lo to about 21 mantissa bits: hi is x
// rounded to TF32 (cvt.rna: to nearest, ties away from zero, 10 mantissa
// bits), lo the rest x - hi rounded the same way.
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(__uint_as_float(x)));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(lo) : "f"(__uint_as_float(x) - __uint_as_float(hi)));
}

// split_tf32 of the four registers of an operand fragment.
__device__ __forceinline__ void split_tf32(const unsigned (&x)[4],
                                           unsigned (&hi)[4],
                                           unsigned (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// c += a b to about float32 precision from three TF32 products (3xTF32),
// the small terms first: a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo,
// about 2^-22 of |a b|, is dropped).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// 2^x on the special-function unit, flushing subnormal results to zero (a
// P below 2^-126 is zero after its bf16 rounding in any case); 2^-inf = 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Shared row stride in elements of T for a head-dim tile of DP (a multiple
// of the 16-byte unit E = 16 / sizeof(T): 8 bf16, 4 floats): an odd number
// of 16-byte units, which puts the eight rows an `ldmatrix` reads on eight
// different bank groups.
template <int DP, typename T = bf16>
__host__ __device__ constexpr int lds() {
  constexpr int E = 16 / sizeof(T);
  return DP / E % 2 ? DP + 2 * E : DP + E;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }

// Copy rows [r0, r0 + R) of a [n, D] matrix of T (bf16 or float32) into a
// [R, lds<DP, T>()] shared tile in 16-byte chunks, zeros past n and past D.
// `vec`: D is a multiple of the chunk (8 bf16, 4 floats) and the rows are
// 16-byte aligned, so each chunk is one cp.async; otherwise plain loads and
// stores.
template <int DP, int R, typename T>
__device__ __forceinline__ void stage_tc(T* dst, const T* src, int r0, int n,
                                         int D, bool vec) {
  constexpr int E = 16 / sizeof(T), LDS = lds<DP, T>(), CH = DP / E;
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * E;
    T* d = dst + r * LDS + c;
    const bool row_ok = r0 + r < n;
    const T* s = src + (size_t)(row_ok ? r0 + r : 0) * D + c;
    if (vec) {
      const bool ok = row_ok && c < D;
      cp_async16(d, ok ? s : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = row_ok && c + e < D ? s[e] : zero<T>();
    }
  }
}

// Store a value pair at columns c, c + 1 of a bf16 row (c even): one 4-byte
// store when `vec` (D % 8 == 0 and 16-byte aligned rows), else one or two
// 2-byte stores below D.
__device__ __forceinline__ void store_pair(bf16* row, int c, int D, float x,
                                           float y, bool vec) {
  if (vec) {
    if (c < D)
      *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x, y);
  } else {
    if (c < D) row[c] = __float2bfloat16(x);
    if (c + 1 < D) row[c + 1] = __float2bfloat16(y);
  }
}

// Store a value pair at columns c, c + 1 of a float32 row (c even): one
// 8-byte store when `vec` (D % 4 == 0 and 16-byte aligned rows), else one
// or two 4-byte stores below D.
__device__ __forceinline__ void store_pair(float* row, int c, int D, float x,
                                           float y, bool vec) {
  if (vec) {
    if (c < D) *reinterpret_cast<float2*>(row + c) = make_float2(x, y);
  } else {
    if (c < D) row[c] = x;
    if (c + 1 < D) row[c + 1] = y;
  }
}

// The 16x16 A operand at (row0, col0) of a row-major [.., LDS] tile, or the
// two 8-column B operands (k 16 rows at row0, n 16 columns at col0) of a
// tile stored k-major (TRANS).  Matrices: 0 = rows +0, cols +0; 1 = rows +8,
// cols +0; 2 = rows +0, cols +8; 3 = rows +8, cols +8.
template <int LDS, bool TRANS>
__device__ __forceinline__ void load_rm(unsigned (&r)[4], const bf16* tile,
                                        int row0, int col0, int lane) {
  const int m = lane >> 3;
  ldmatrix_x4<TRANS>(r, tile + (row0 + (lane & 7) + (m & 1) * 8) * LDS +
                            col0 + (m >> 1) * 8);
}

// The B operands of two 8-column blocks (n rows n0..n0+15 of a tile stored
// n-major, k columns k0..k0+15): r[0], r[1] for rows n0..n0+7, r[2], r[3]
// for n0+8..n0+15.
template <int LDS>
__device__ __forceinline__ void load_nk(unsigned (&r)[4], const bf16* tile,
                                        int n0, int k0, int lane) {
  const int m = lane >> 3;
  ldmatrix_x4<false>(r, tile + (n0 + (lane & 7) + (m >> 1) * 8) * LDS + k0 +
                            (m & 1) * 8);
}

// The 16x8 TF32 A operand at (row0, col0) of a row-major float32 [.., LDS]
// tile (see ldmatrix_x4).  Matrices: 0 = rows +0, cols +0; 1 = rows +8,
// cols +0; 2 = rows +0, cols +4; 3 = rows +8, cols +4.
template <int LDS>
__device__ __forceinline__ void load_a_tf32(unsigned (&r)[4],
                                            const float* tile, int row0,
                                            int col0, int lane) {
  const int m = lane >> 3;
  ldmatrix_x4<false>(r, tile + (row0 + (lane & 7) + (m & 1) * 8) * LDS +
                            col0 + (m >> 1) * 4);
}

// The TF32 B operands of two 8-column blocks (n rows n0..n0+15 of a float32
// tile stored n-major, k columns k0..k0+7): r[0], r[1] for rows n0..n0+7,
// r[2], r[3] for n0+8..n0+15.  A k-major float32 operand has no ldmatrix
// form (no 32-bit .trans): it is read by plain shared loads.
template <int LDS>
__device__ __forceinline__ void load_nk_tf32(unsigned (&r)[4],
                                             const float* tile, int n0,
                                             int k0, int lane) {
  const int m = lane >> 3;
  ldmatrix_x4<false>(r, tile + (n0 + (lane & 7) + (m >> 1) * 8) * LDS + k0 +
                            (m & 1) * 4);
}

}  // namespace aqualora_tc
