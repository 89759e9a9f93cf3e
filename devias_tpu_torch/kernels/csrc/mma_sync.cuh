// Device helpers of the mma.sync kernels (slot_attention.cu, patch_embed.cu):
// 64 x 64 bf16 tiles in swizzled shared memory, cp.async loads, ldmatrix
// fragment loads and the m16n8k16 bf16 tensor-core product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace k1 {

constexpr int kD = 64;          // head dim
constexpr int kBlock = 64;      // rows (q) or keys per tile
constexpr int kThreads = 128;   // four warps, 16 rows each
constexpr int kTile = 64 * kD;  // elements of one 64 x 64 tile

// Element offset of 16-byte chunk `chunk` (8 bf16) of row `row` in a
// 64 x 64 tile; the XOR swizzle keeps ldmatrix free of bank conflicts.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kD + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; copies zeros when `valid` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [row0, row0 + 64) of one head's 64 columns; rows >= n read as zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int n, int stride) {
#pragma unroll
  for (int it = 0; it < 64 * 8 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i >> 3, c = i & 7;
    const bool valid = row0 + r < n;
    const __nv_bfloat16* g = src + (valid ? (row0 + r) * stride : 0) + c * 8;
    cp_async16(dst + swz(r, c), g, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// d += a * b for one 16 x 8 x 16 tile, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// A fragments of this warp's 16 rows of a 64 x 64 tile, 4 chunks of 16 columns.
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[4][4], const __nv_bfloat16* tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    ldsm_x4(f[kc], tile + swz(warp * 16 + (lane & 15), kc * 2 + (lane >> 4)));
}

// acc[16 x 64] += A[16 x 64] . T^T, T a [64 n][64 k] tile (the B operand
// read row by row: S = Q K^T with T = K).
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const __nv_bfloat16* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      const int n = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldsm_x4(b, tile + swz(n, kc * 2 + ((lane >> 3) & 1)));
      mma16816(acc[2 * np], a[kc], b[0], b[1]);
      mma16816(acc[2 * np + 1], a[kc], b[2], b[3]);
    }
  }
}

// acc[16 x 64] += A[16 x 64] . T, T a [64 k][64 n] tile (the B operand
// read transposed: O = P V with T = V).
__device__ __forceinline__ void mma_ab(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       const __nv_bfloat16* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      const int k = kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
      ldsm_x4_trans(b, tile + swz(k, dp * 2 + (lane >> 4)));
      mma16816(acc[2 * dp], a[kc], b[0], b[1]);
      mma16816(acc[2 * dp + 1], a[kc], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// Pack f32 accumulators of a 16 x 64 tile as bf16 A fragments: the
// accumulator layout of tiles 2kc, 2kc+1 is the A layout of chunk kc.
__device__ __forceinline__ void pack_a(uint32_t (&f)[4][4], const float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    f[i >> 1][(i & 1) * 2] = as_u32(__floats2bfloat162_rn(acc[i][0], acc[i][1]));
    f[i >> 1][(i & 1) * 2 + 1] = as_u32(__floats2bfloat162_rn(acc[i][2], acc[i][3]));
  }
}

}  // namespace k1
