// Tensor-core helpers shared by the bfloat16 attention kernels
// (flash_fwd.cu, flash_bwd.cu): 16-byte cp.async staging into padded shared
// tiles, ldmatrix operand loads, the mma.sync.m16n8k16 bf16 product and
// paired bf16 stores.
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
// 2(l % 4) + 1), or of its transpose with TRANS.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
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

// Shared row stride in elements for a head-dim tile of DP (a multiple of
// 8): an odd number of 16-byte units, which puts the eight rows an
// `ldmatrix` reads on eight different bank groups.
template <int DP>
__host__ __device__ constexpr int lds() { return DP % 16 ? DP + 16 : DP + 8; }

// Copy rows [r0, r0 + R) of a [n, D] bf16 matrix into a [R, lds<DP>()]
// shared tile in 16-byte chunks, zeros past n and past D.  `vec`: D % 8 ==
// 0 and the rows are 16-byte aligned, so each chunk is one cp.async;
// otherwise plain loads and stores.
template <int DP, int R>
__device__ __forceinline__ void stage_tc(bf16* dst, const bf16* src, int r0,
                                         int n, int D, bool vec) {
  constexpr int LDS = lds<DP>(), CH = DP / 8;
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    bf16* d = dst + r * LDS + c;
    const bool row_ok = r0 + r < n;
    const bf16* s = src + (size_t)(row_ok ? r0 + r : 0) * D + c;
    if (vec) {
      const bool ok = row_ok && c < D;
      cp_async16(d, ok ? s : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = row_ok && c + e < D ? s[e] : __float2bfloat16(0.f);
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

}  // namespace aqualora_tc
