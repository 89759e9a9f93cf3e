// K5: patchify + tubelet embedding GEMM (replaces
// `scripts/retest_patchify_pallas.py::embed`, Pallas body `kern`).
//
// out[b, t, i*w + j, n] = sum_k patch[b, t, i, j][k] * kernel[k, n], where
// the patch of token (t, i, j) is x[b, 2t:2t+2, 16i:16i+16, 16j:16j+16, :]
// flattened in (tb, ph, pw, c) order (K = 2*16*16*3 = 1536). x is f32
// [B, T, H, W, 3], rounded to bf16 as it is read; kernel is bf16 [K, Dout];
// f32 accumulation; out bf16 [B, T/2, (H/16)(W/16), Dout].
//
// What bounds it on an H100 at the flagship shape (x [12, 16, 224, 224, 3],
// Dout = 768): 2 * 18816 * 1536 * 768 = 44.4 GFLOP (0.0449 ms at 989
// TFLOP/s) against 115.6 MB of x, 2.4 MB of kernel and 28.9 MB out
// (0.0438 ms at 3.35 TB/s): nearly at balance, bound by operations.
//
// Design: an implicit-im2col GEMM. Each CTA (8 warps) owns 128 tokens x 128
// output columns. The K loop walks the 32 (tb, ph) patch rows: for each,
// a token's 48 inputs (pw, c) are contiguous in x (192 bytes, 16-byte
// aligned), so the A loader reads 12 float4 per token, converts them to
// bf16 in registers and stores them to shared memory; the matching 48
// kernel rows stream in by cp.async. mma.sync m16n8k16 bf16 -> f32, each
// warp 16 tokens x 128 columns. The relayout the TPU's Mosaic compiler
// could not lower ([TB, h, P, w, P, C] -> [196, 1536] in VMEM) is only an
// address computation here. Tokens past the last one are read as zeros and
// not written.
#include "mma_sync.cuh"

namespace k5 {

using namespace k1;
using bf16 = __nv_bfloat16;

constexpr int kP = 16;             // patch side
constexpr int kTB = 2;             // tubelet
constexpr int kC = 3;              // channels
constexpr int kRow = kP * kC;      // 48 contiguous inputs per (tb, ph)
constexpr int kM = 128;            // tokens per CTA
constexpr int kN = 128;            // output columns per CTA
constexpr int kWarps = 8;
constexpr int kThreads5 = kWarps * 32;
constexpr int kAStride = 56;       // padded row (112 B): conflict-free ldmatrix
constexpr int kBStride = kN + 8;   // padded row (272 B)

__global__ void __launch_bounds__(kThreads5) patch_embed_kernel(
    const float* __restrict__ x, const bf16* __restrict__ kernel, bf16* __restrict__ out,
    int M, int T, int H, int W, int Dout) {
  __shared__ __align__(16) bf16 a_s[kM * kAStride];
  __shared__ __align__(16) bf16 b_s[kRow * kBStride];

  const int m0 = blockIdx.x * kM, n0 = blockIdx.y * kN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = H / kP, w = W / kP, t2 = T / kTB;
  const int per_frame = h * w;

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int kr = 0; kr < kTB * kP; ++kr) {  // (tb, ph)
    const int tb = kr / kP, ph = kr % kP;
    // A: 128 tokens x 12 float4
    for (int i = threadIdx.x; i < kM * (kRow / 4); i += kThreads5) {
      const int r = i / (kRow / 4), f4 = i % (kRow / 4);
      const int m = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M) {
        const int b = m / (t2 * per_frame);
        const int rem = m % (t2 * per_frame);
        const int t = rem / per_frame, ij = rem % per_frame;
        const int pi = ij / w, pj = ij % w;
        const int64_t off = (((int64_t(b) * T + t * kTB + tb) * H + pi * kP + ph) * W + pj * kP) * kC;
        v = reinterpret_cast<const float4*>(x + off)[f4];
      }
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed = make_uint2(as_u32(lo), as_u32(hi));
      *reinterpret_cast<uint2*>(a_s + r * kAStride + f4 * 4) = packed;
    }
    // B: kernel rows kr*48 .. +48, columns n0 .. n0+128
    for (int i = threadIdx.x; i < kRow * (kN / 8); i += kThreads5) {
      const int r = i / (kN / 8), c = i % (kN / 8);
      const bool valid = n0 + c * 8 < Dout;
      const bf16* g = kernel + int64_t(kr * kRow + r) * Dout + (valid ? n0 + c * 8 : 0);
      cp_async16(b_s + r * kBStride + c * 8, g, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kRow / 16; ++kc) {
      uint32_t a[4];
      ldsm_x4(a, a_s + (warp * 16 + (lane & 15)) * kAStride + kc * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < kN / 16; ++dp) {
        uint32_t bfr[4];
        const int k = kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4_trans(bfr, b_s + k * kBStride + dp * 16 + (lane >> 4) * 8);
        mma16816(acc[2 * dp], a, bfr[0], bfr[1]);
        mma16816(acc[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();
  }

  const int row0 = m0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = n0 + nt * 8 + (lane & 3) * 2;
    if (col >= Dout) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = row0 + half * 8;
      if (m < M)
        *reinterpret_cast<__nv_bfloat162*>(out + int64_t(m) * Dout + col) =
            __floats2bfloat162_rn(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

}  // namespace k5

// x f32 [B, T, H, W, 3] (16-byte aligned, contiguous), kernel bf16
// [1536, Dout] (Dout a multiple of 8), out bf16 [B, T/2, (H/16)(W/16), Dout].
// T even, H and W multiples of 16 (the wrapper checks). Returns the CUDA
// error of the launch (0 on success).
extern "C" int devias_patch_embed(const void* x, const void* kernel, void* out, int B, int T, int H, int W, int Dout,
                                  void* stream) {
  using namespace k5;
  if (T % kTB || H % kP || W % kP || Dout % 8 || B < 1) return int(cudaErrorInvalidValue);
  const int64_t M = int64_t(B) * (T / kTB) * (H / kP) * (W / kP);
  if (M >= (int64_t(1) << 31)) return int(cudaErrorInvalidValue);
  dim3 grid(unsigned((M + kM - 1) / kM), unsigned((Dout + kN - 1) / kN));
  patch_embed_kernel<<<grid, kThreads5, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const bf16*>(kernel), static_cast<bf16*>(out), int(M), T, H, W,
      Dout);
  return int(cudaGetLastError());
}
