// K5: patchify + tubelet embedding GEMM (replaces
// `scripts/retest_patchify_pallas.py::embed`, Pallas body `kern`).
//
// out[b, t, i*w + j, n] = sum_k bf16(patch[b, t, i, j][k]) * kernel[k, n],
// where the patch of token (t, i, j) is x[b, 2t:2t+2, 16i:16i+16,
// 16j:16j+16, :] flattened in (tb, ph, pw, c) order (K = 2*16*16*3 = 1536).
// x is f32 [B, T, H, W, 3], rounded to bf16 (to nearest) once as it is
// read; kernel is bf16 [K, Dout]; f32 sums; out bf16 [B, T/2, (H/16)(W/16),
// Dout].
//
// What bounds it on an H100 at the flagship shape (x [12, 16, 224, 224, 3],
// Dout = 768): 2 * 18816 * 1536 * 768 = 44.4 GFLOP (0.0449 ms at 989
// TFLOP/s) against 115.6 MB of x, 2.4 MB of kernel and 28.9 MB out
// (0.0438 ms at 3.35 TB/s): nearly at balance, bound by operations.
//
// Design: an implicit-im2col GEMM on wgmma, warp-specialised.
// - A CTA owns 128 tokens x 256 output columns. The grid runs the column
//   tiles fastest (blockIdx.x), so the Dout/256 CTAs of one token tile run
//   side by side and x comes from HBM once; its re-reads hit L2.
// - The K loop walks the 32 (tb, ph) patch rows: for each, a token's 48
//   inputs (pw, c) are 192 contiguous bytes of x. A 4-stage ring holds,
//   per stage, those 48 f32 inputs of all 128 tokens (rows padded to 56
//   floats, so the consumers' 8-byte reads are free of bank conflicts) and
//   the matching 48 kernel rows x 256 columns, as four 128-byte-swizzled
//   [48][64] bf16 blocks.
// - A producer warpgroup fills the ring: each thread keeps the x offsets
//   of its 12 16-byte chunks of the tile (computed once per tile, so a
//   token tile may cross patch rows, frame pairs and clips) and issues them
//   by cp.async, zero-filled for tokens past the last; one thread loads the
//   kernel blocks by TMA. Every stage completes on a full mbarrier (the
//   cp.asyncs' arrivals and the TMA's bytes) and is handed back on an empty
//   one; no thread waits on a __syncthreads in the loop.
// - Two consumer warpgroups, 64 tokens each, read their A fragments from
//   the f32 stage, round them to bf16 in registers (the only rounding of
//   x) and issue m64n256k16 wgmma with A from registers and B read
//   MN-major from the swizzled blocks (the leading byte offset steps
//   between the 64-column blocks). The f32 accumulator (128 registers a
//   thread) stays in registers; stage k's products run while stage k + 1's
//   fragments are converted, and stage k - 1 is released once they are
//   done. Tokens past the last one are never written.
#include "hopper.cuh"

namespace k5 {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kP = 16;         // patch side
constexpr int kTB = 2;         // tubelet
constexpr int kC = 3;          // channels
constexpr int kRow = kP * kC;  // 48 contiguous inputs per (tb, ph): K of one stage
constexpr int kKRows = kTB * kP;  // 32 stages of K per tile
constexpr int kChunks = kRow / 4;  // 16-byte chunks of one token's row
constexpr int kM = 128;        // tokens per CTA
constexpr int kN = 256;        // output columns per CTA
constexpr int kConsumers = kM / 64;
constexpr int kThreads = (kConsumers + 1) * kWarpgroup;
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;  // 128 * 56 + 256 * 224 = 64512 of the SM's 65536
constexpr int kStages = 4;
constexpr int kAStride = 56;  // floats per token row in a stage: 224 bytes, 8 mod 32 words
constexpr int kAStageBytes = kM * kAStride * 4;  // 28672
constexpr int kBBlockBytes = kRow * kRowBytes;   // one [48][64] bf16 block: 6144
constexpr int kBStageBytes = (kN / kD) * kBBlockBytes;
constexpr int kSmemBytes = 1024 + kStages * (kAStageBytes + kBStageBytes) + 2 * kStages * 8;
static_assert(kAStageBytes % 1024 == 0 && kBBlockBytes % 1024 == 0, "stages must keep 1024-byte alignment");
static_assert(kM * kChunks % kWarpgroup == 0, "the producer's chunks must divide evenly");
constexpr int kPerThread = kM * kChunks / kWarpgroup;  // 12 chunks per producer thread and stage

__global__ void __launch_bounds__(kThreads, 1)
patch_embed_kernel(const __grid_constant__ CUtensorMap map_w, const float* __restrict__ x, bf16* __restrict__ out,
                   int M, int T, int H, int W, int Dout) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = align1024(smem_raw);
  unsigned char* sB = sA + kStages * kAStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + kStages * kBStageBytes);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * kN, m0 = blockIdx.y * kM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kWarpgroup + 1);  // every producer thread's cp.async arrival + the TMA thread's
      mbar_init(&empty[s], kConsumers * kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    const int p = threadIdx.x;
    const int w = W / kP, hw = (H / kP) * w, t2 = T / kTB;
    // chunk i = p + 128 k of the tile's [128 tokens][12 chunks]: its token's
    // offset in x at (tb, ph) = (0, 0), or -1 past the last token
    int off[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = p + kWarpgroup * k;
      const int m = m0 + i / kChunks;
      if (m < M) {
        const int b = m / (t2 * hw), rem = m % (t2 * hw);
        const int t = rem / hw, ij = rem % hw;
        off[k] = (((b * T + t * kTB) * H + (ij / w) * kP) * W + (ij % w) * kP) * kC + (i % kChunks) * 4;
      } else {
        off[k] = -1;
      }
    }
    const int frame = H * W * kC, row = W * kC;
    for (int kr = 0; kr < kKRows; ++kr) {
      const int s = kr % kStages;
      mbar_wait(&empty[s], ((kr / kStages) & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(&full[s], kBStageBytes);
#pragma unroll
        for (int blk = 0; blk < kN / kD; ++blk)
          tma_load_2d(sB + s * kBStageBytes + blk * kBBlockBytes, &map_w, n0 + blk * kD, kr * kRow, &full[s]);
      }
      const int shift = (kr / kP) * frame + (kr % kP) * row;
      float* a = reinterpret_cast<float*>(sA + s * kAStageBytes);
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int i = p + kWarpgroup * k;
        cp_async16_zfill(a + (i / kChunks) * kAStride + (i % kChunks) * 4, x + (off[k] < 0 ? 0 : off[k] + shift),
                         off[k] >= 0);
      }
      cp_async_mbar_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;  // tokens 64c .. 64c + 63 of the tile
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * c + 16 * warp + g;  // this thread's accumulator rows r0 and r0 + 8

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t a_even[kRow / 16][4] = {}, a_odd[kRow / 16][4] = {};

  // stage kr: wait for it, convert this thread's A fragments to bf16, issue
  // its three products, then release stage kr - 1 once its products are done
  auto step = [&](int kr, uint32_t(&a)[kRow / 16][4], uint32_t(&a_prev)[kRow / 16][4]) {
    const int s = kr % kStages;
    mbar_wait(&full[s], (kr / kStages) & 1);
    const float* as = reinterpret_cast<const float*>(sA + s * kAStageBytes);
#pragma unroll
    for (int kk = 0; kk < kRow / 16; ++kk) {
      const float* p0 = as + r0 * kAStride + 16 * kk + 2 * t;
      const float* p1 = p0 + 8 * kAStride;
      const float2 v00 = *reinterpret_cast<const float2*>(p0), v10 = *reinterpret_cast<const float2*>(p1);
      const float2 v01 = *reinterpret_cast<const float2*>(p0 + 8), v11 = *reinterpret_cast<const float2*>(p1 + 8);
      a[kk][0] = pack_bf16(v00.x, v00.y);
      a[kk][1] = pack_bf16(v10.x, v10.y);
      a[kk][2] = pack_bf16(v01.x, v01.y);
      a[kk][3] = pack_bf16(v11.x, v11.y);
    }
    const uint64_t b_desc = desc_b128_lbo(sB + s * kBStageBytes, kBBlockBytes);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kRow / 16; ++kk) wgmma_m64n256_rs<1>(acc, a[kk], desc_mn(b_desc, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(a_prev);  // stage kr - 1's products read a_prev until here
    if (kr > 0) mbar_arrive(&empty[(kr + kStages - 1) % kStages]);
  };
  for (int kr = 0; kr < kKRows; kr += 2) {
    step(kr, a_even, a_odd);
    step(kr + 1, a_odd, a_even);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a_odd);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + r0 + 8 * half;
    if (m >= M) continue;
    bf16* orow = out + int64_t(m) * Dout + n0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * i + 2 * t;
      if (n0 + col < Dout)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
    }
  }
}

}  // namespace k5

// x f32 [B, T, H, W, 3] (16-byte aligned, contiguous, fewer than 2^31
// elements), kernel bf16 [1536, Dout] (Dout a multiple of 8, 16-byte
// aligned), out bf16 [B, T/2, (H/16)(W/16), Dout]. T even, H and W
// multiples of 16 (the wrapper checks). Launches on `stream`, allocates
// nothing; returns the CUDA error of the launch (0 on success).
extern "C" int devias_patch_embed(const void* x, const void* kernel, void* out, int B, int T, int H, int W, int Dout,
                                  void* stream) {
  using namespace k5;
  if (T % kTB || H % kP || W % kP || Dout % 8 || Dout < 8 || B < 1 || T < 1 || H < 1 || W < 1)
    return int(cudaErrorInvalidValue);
  const int64_t M = int64_t(B) * (T / kTB) * (H / kP) * (W / kP);
  if (int64_t(B) * T * H * W * kC >= (int64_t(1) << 31)) return int(cudaErrorInvalidValue);
  // A runtime call before the tensor map is encoded makes the device's
  // context current in this thread.
  const cudaError_t attr =
      cudaFuncSetAttribute(patch_embed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return int(attr);
  CUtensorMap map_w;
  if (!make_map_2d(&map_w, kernel, Dout, kKRows * kRow, Dout, kRow)) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned((Dout + kN - 1) / kN), unsigned((M + kM - 1) / kM));
  patch_embed_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_w, static_cast<const float*>(x), static_cast<bf16*>(out), int(M), T, H, W, Dout);
  return int(cudaGetLastError());
}
