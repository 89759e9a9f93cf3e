// Hopper (sm_90a) building blocks of the attention kernels: TMA tensor maps
// encoded on the host, mbarrier rings, the warpgroup tensor-core product
// (wgmma) on 128-byte-swizzled bf16 tiles, and register hand-over between
// warpgroups (setmaxnreg).
//
// Tiles. Every operand tile in shared memory is [rows][64] bf16, one 128-byte
// row per token, written by TMA with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte
// chunk c of row r lies at chunk c ^ (r & 7) of that row, and every tile
// starts on a 1024-byte boundary (8 rows, one swizzle atom). A wgmma
// descriptor of layout B128 with a stride byte offset (SBO) of 1024 reads
// such a tile as
//   K-major (the product sums along the 64 contiguous columns): step k of 16
//     columns starts 32 bytes further;
//   MN-major (the product sums along the rows; the instruction's transpose
//     bit): step k of 16 rows starts 2048 bytes further.
//
// Register layouts. The f32 accumulator of an m64nN product is, per warp w
// of the warpgroup, rows 16w + g and 16w + g + 8 (g = lane / 4) and columns
// 8i + 2t, 8i + 2t + 1 (t = lane % 4): d[4i + 0, 1] on row g, d[4i + 2, 3] on
// row g + 8. The bf16 A operand of an m64nNk16 product from registers has
// the same per-warp layout as mma.sync's m16n8k16 A, so accumulator columns
// 16k .. 16k + 15 pack into the four A registers of step k (`pack_a`).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kD = 64;                  // head dim: one 128-byte row
constexpr int kRowBytes = kD * 2;
constexpr int kWarpgroup = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------------ host: TMA

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime
// (cudaGetDriverEntryPoint), so the library needs no -lcuda; nullptr if it
// is not found.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D map over a bf16 operand whose element d of row n of head h of batch
// entry b lies at base + b * batch + h * head + n * row + d (elements), read
// in boxes of `box_rows` rows of one head: dims (d, h, n, b) for the
// token-major layouts, (d, n, h, b) for the head-major one. The row extent
// is `rows`, and the batch its own dimension, so the rows of a box past
// `rows` come back as zeros, never as the next batch entry's rows. Returns
// false if the map cannot be encoded.
inline bool make_map(CUtensorMap* map, const void* base, int64_t batch, int head, int row, int rows, int heads,
                     int batches, int box_rows, bool token_major) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(kD), cuuint64_t(token_major ? heads : rows),
                              cuuint64_t(token_major ? rows : heads), cuuint64_t(batches)};
  const cuuint64_t strides[3] = {cuuint64_t(token_major ? head : row) * 2, cuuint64_t(token_major ? row : head) * 2,
                                 cuuint64_t(batch) * 2};
  const cuuint32_t box[4] = {cuuint32_t(kD), cuuint32_t(token_major ? 1 : box_rows),
                             cuuint32_t(token_major ? box_rows : 1), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


// A 2-D map over a row-major bf16 matrix [rows][cols] (row stride `ld`
// elements, a multiple of 8), read in boxes of `box_rows` rows x 64
// columns (one 128-byte swizzled row each). Columns past `cols` and rows
// past `rows` come back as zeros. Returns false if the map cannot be
// encoded. (K5's weights.)
inline bool make_map_2d(CUtensorMap* map, const void* base, int64_t cols, int64_t rows, int64_t ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(ld) * 2};
  const cuuint32_t box[2] = {cuuint32_t(kD), cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------------ device: shared memory, mbarriers, TMA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA);
// follow it with __syncthreads().
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spins until the phase of parity `parity` has completed. On a barrier just
// initialised, parity 1 counts as completed (the ring's empty slots).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` at coordinates (0, c1, c2, c3) into `dst`; completes
// its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c1, int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// Row n of head h of batch entry b through a map from `make_map`.
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, bool token_major, int n, int h,
                                              int b, uint64_t* bar) {
  if (token_major)
    tma_load(dst, map, h, n, b, bar);
  else
    tma_load(dst, map, n, h, b, bar);
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) into `dst`; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One box of a 2-D map (`make_map_2d`) at column c0, row c1 into `dst`;
// completes its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// 16 bytes from global to shared memory by cp.async; zeros when `valid` is
// false (nothing is read then).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Arrives on `bar` once every cp.async this thread has issued so far has
// landed; the arrival counts towards the barrier's expected count.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Named barriers 1..15 (0 is __syncthreads'): `sync` waits until `threads`
// threads have reached barrier `id` by sync or arrive; `arrive` does not wait.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ device: wgmma

// Descriptor of a 128-byte-swizzled tile at `p` (1024-byte aligned): start
// address, leading byte offset 16 (unused by these layouts), stride byte
// offset 1024, layout type 1 (B128).
__device__ __forceinline__ uint64_t desc_b128(const void* p) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// `desc_b128` with a leading byte offset: the distance between the 64-column
// blocks of an MN-major operand wider than 64 (B of an m64n256 product
// stored as four [K][64] swizzled blocks).
__device__ __forceinline__ uint64_t desc_b128_lbo(const void* p, uint32_t lbo_bytes) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// Step k of a descriptor: K-major advances 32 bytes, MN-major 16 rows.
__device__ __forceinline__ uint64_t desc_k(uint64_t desc, int k) { return desc + uint64_t(k * 2); }
__device__ __forceinline__ uint64_t desc_mn(uint64_t desc, int k) { return desc + uint64_t(k * 128); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma.wait_group or wgmma.fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define HOPPER_F8(d, i)                                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define HOPPER_F32(d) HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24)
#define HOPPER_F64(d) HOPPER_F32(d), HOPPER_F8(d, 32), HOPPER_F8(d, 40), HOPPER_F8(d, 48), HOPPER_F8(d, 56)
#define HOPPER_R32                                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_R64                                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "    \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both from shared memory; kTransB
// reads B MN-major. `accumulate` 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32 ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOPPER_F32(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB)
      : "memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], both from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64 ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : HOPPER_F64(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB)
      : "memory");
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A from registers (`pack_a`).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB)
      : "memory");
}


// d[64 x 256] (+)= A[64 x 16] . B[16 x 256], A from registers (`pack_a`
// layout), B from shared memory through `desc_b128_lbo` (K5).
#define HOPPER_F128(d) HOPPER_F64(d), HOPPER_F8(d, 64), HOPPER_F8(d, 72), HOPPER_F8(d, 80), HOPPER_F8(d, 88), \
      HOPPER_F8(d, 96), HOPPER_F8(d, 104), HOPPER_F8(d, 112), HOPPER_F8(d, 120)
#define HOPPER_R128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n256_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HOPPER_R128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : HOPPER_F128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB)
      : "memory");
}
#undef HOPPER_F128
#undef HOPPER_R128

#undef HOPPER_F8
#undef HOPPER_F32
#undef HOPPER_F64
#undef HOPPER_R32
#undef HOPPER_R64

// ------------------------------------------------------------------ device: registers

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit, subnormal results flushed to zero.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Accumulator columns of an m64nN product, rounded to bf16, as the A
// operand of the next product: step k takes columns 16k .. 16k + 15.
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K][4], const float (&d)[8 * K]) {
#pragma unroll
  for (int i = 0; i < 2 * K; ++i) {
    a[i >> 1][(i & 1) * 2] = pack_bf16(d[4 * i], d[4 * i + 1]);
    a[i >> 1][(i & 1) * 2 + 1] = pack_bf16(d[4 * i + 2], d[4 * i + 3]);
  }
}

// 1024-byte aligned start of dynamic shared memory (allocated with 1024
// bytes to spare).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

}  // namespace hopper
