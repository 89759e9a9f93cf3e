// K4: one fused slot cross-attention round, forward (replaces
// `devias_tpu/kernels/slot_attention.py::_fused_fwd`, Pallas body `_kernel`).
//
// Per batch entry b and head h, with x [S, D] the normed slots and ctx
// [N, D] the normed context (bf16), weights wq, wk, wv [D, heads*dh] and wo
// [heads*dh, D], bo [D] (bf16, the flax Dense layout [in, out]):
//   q = x wq_h, k = ctx wk_h, v = ctx wv_h             (f32 from bf16 operands)
//   a[s, n] = softmax over s of (q k^T)[s, n] * dh^-0.5, 0 for n >= N
//   sim[b, h] = a                                        (f32, the output map)
//   o_h = (a v) / (sum_n a + 1e-7)                       (rounded to bf16)
//   out = sum_h o_h wo_h + bo                            (f32 sum, bf16 out)
//
// What bounds it on an H100 at the flagship shape (B=12, S=2, N=1568,
// D=768, 4 heads x 512): the K and V projections, 2 * 2*B*N*D*heads*dh =
// 118.4 GFLOP of bf16 products (0.120 ms at 989 TFLOP/s), against 42 MB of
// ctx, weights and sim (0.013 ms at 3.35 TB/s): bound by operations.
//
// Design. The TPU kernel walked (b, head, key block) in order on one core
// and carried num, den and the output in VMEM scratch from one grid step to
// the next. A CUDA grid runs in no order, so the sums across key tiles and
// across heads get their own passes, and there are no atomics: the result
// is deterministic.
//   1. q_proj: q = x wq in f32, one thread per output.
//   2. tile: one CTA (4 warps) per (64-key tile, head, b). The tile's ctx
//      rows [64, D] stay in shared memory (12 swizzled 64 x 64 bf16 tiles at
//      D=768, 96 KB); wk_h and then wv_h stream through in 64 x 64 tiles.
//      For each 64-column chunk of dh, mma.sync (m16n8k16, bf16 -> f32)
//      gives k (or v) for 64 keys x 64 columns in registers; k is folded
//      into the S x 64 logits at once (q . k over the chunk, f32), so no
//      64 x 512 f32 tile is ever held (128 KB). After the k pass, the slot
//      softmax per key in f32, ragged keys (n >= N, read as zero rows) set
//      to 0, sim written. The v pass folds each v chunk into this tile's
//      partial num [S, dh] with a; num and den partials go to an f32
//      workspace.
//   3. reduce_o: o = (sum over tiles of num) / (sum over tiles of den +
//      1e-7), tiles summed in order, rounded to bf16 (`_kernel`'s cast to
//      the weights' dtype).
//   4. out_proj: out = o wo + bo, an f32 sum over all heads' columns, one
//      thread per output.
// The TPU padded ctx to a multiple of 256 keys for its 128-lane sim blocks;
// here the last tile's keys past N are masked instead.
#include "mma_sync.cuh"

namespace k4 {

using namespace k1;
using bf16 = __nv_bfloat16;

constexpr int kMaxS = 8;  // slots a CTA holds logits for
constexpr int kMaxD = 1024;

__global__ void q_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq, float* __restrict__ q,
                              int D, int inner) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;  // b * S + s
  if (j >= inner) return;
  const bf16* xr = x + int64_t(r) * D;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(__bfloat162float(xr[d]), __bfloat162float(wq[int64_t(d) * inner + j]), acc);
  q[int64_t(r) * inner + j] = acc;
}

// dynamic shared memory: D/64 ctx tiles, one weight tile, q chunk, a, the
// warps' num partials
__global__ void __launch_bounds__(kThreads) tile_kernel(
    const bf16* __restrict__ ctx, const bf16* __restrict__ wk, const bf16* __restrict__ wv,
    const float* __restrict__ q, float* __restrict__ sim, float* __restrict__ num_ws, float* __restrict__ den_ws,
    int S, int N, int D, int heads, int dh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nD = D / 64;
  bf16* ctx_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* w_s = ctx_s + nD * kTile;
  float* q_s = reinterpret_cast<float*>(w_s + kTile);  // [kMaxS][64]
  float* a_s = q_s + kMaxS * 64;                        // [kMaxS][64]
  float* red_s = a_s + kMaxS * 64;                      // [4][kMaxS][64]

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = gridDim.x;
  const int key0 = tile * kBlock;
  const int inner = heads * dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;  // this thread's two key rows in the tile

  const bf16* ctx_b = ctx + int64_t(b) * N * D;
  for (int kk = 0; kk < nD; ++kk) load_tile(ctx_s + kk * kTile, ctx_b + kk * 64, key0, N, D);
  cp_async_commit();

  float logit[kMaxS][2];
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) logit[s][0] = logit[s][1] = 0.f;

  const int64_t bh = int64_t(b) * heads + h;
  for (int pass = 0; pass < 2; ++pass) {
    const bf16* w = (pass == 0 ? wk : wv) + h * dh;
    for (int c = 0; c < dh / 64; ++c) {
      float acc[8][4];
      zero(acc);
      for (int kk = 0; kk < nD; ++kk) {
        load_tile(w_s, w + c * 64, kk * 64, D, inner);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        uint32_t a[4][4];
        load_a_frags(a, ctx_s + kk * kTile);
        mma_ab(acc, a, w_s);
        __syncthreads();
      }
      if (pass == 0) {
        // logits += q[:, chunk] . k[rows, chunk]^T
        for (int i = threadIdx.x; i < S * 64; i += kThreads)
          q_s[i] = q[(int64_t(b) * S + i / 64) * inner + h * dh + c * 64 + (i & 63)];
        __syncthreads();
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) {
          if (s >= S) break;
          float p0 = 0.f, p1 = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = nt * 8 + (lane & 3) * 2;
            const float q0 = q_s[s * 64 + col], q1 = q_s[s * 64 + col + 1];
            p0 = fmaf(q0, acc[nt][0], fmaf(q1, acc[nt][1], p0));
            p1 = fmaf(q0, acc[nt][2], fmaf(q1, acc[nt][3], p1));
          }
          p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
          p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
          p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
          p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
          logit[s][0] += p0;
          logit[s][1] += p1;
        }
        __syncthreads();
      } else {
        // num[:, chunk] = a[:, rows] . v[rows, chunk], over this warp's
        // 16 rows by shuffles, then over the 4 warps in order
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) {
          if (s >= S) break;
          const float a0 = a_s[s * 64 + r0], a1 = a_s[s * 64 + r1];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            float v0 = fmaf(a0, acc[nt][0], a1 * acc[nt][2]);
            float v1 = fmaf(a0, acc[nt][1], a1 * acc[nt][3]);
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {
              v0 += __shfl_xor_sync(0xffffffffu, v0, m);
              v1 += __shfl_xor_sync(0xffffffffu, v1, m);
            }
            if (lane < 4) {
              const int col = nt * 8 + lane * 2;
              red_s[(warp * kMaxS + s) * 64 + col] = v0;
              red_s[(warp * kMaxS + s) * 64 + col + 1] = v1;
            }
          }
        }
        __syncthreads();
        for (int i = threadIdx.x; i < S * 64; i += kThreads) {
          const int s = i / 64, col = i & 63;
          const float v = ((red_s[(0 * kMaxS + s) * 64 + col] + red_s[(1 * kMaxS + s) * 64 + col]) +
                           red_s[(2 * kMaxS + s) * 64 + col]) + red_s[(3 * kMaxS + s) * 64 + col];
          num_ws[((bh * n_tiles + tile) * S + s) * dh + c * 64 + col] = v;
        }
        __syncthreads();
      }
    }
    if (pass == 0) {
      // the slot softmax per key, f32; keys past N get 0
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r == 0 ? r0 : r1;
        const int key = key0 + row;
        float m = -INFINITY;
#pragma unroll
        for (int s = 0; s < kMaxS; ++s)
          if (s < S) m = fmaxf(m, logit[s][r] * scale);
        float e[kMaxS], sum = 0.f;
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) {
          e[s] = s < S ? expf(logit[s][r] * scale - m) : 0.f;
          sum += e[s];
        }
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) {
          if (s >= S) break;
          const float p = key < N ? e[s] / sum : 0.f;
          if ((lane & 3) == 0) {
            a_s[s * 64 + row] = p;
            if (key < N) sim[(bh * S + s) * N + key] = p;
          }
        }
      }
      __syncthreads();
      if (threadIdx.x < S) {
        float d = 0.f;
        for (int i = 0; i < 64; ++i) d += a_s[threadIdx.x * 64 + i];
        den_ws[(bh * n_tiles + tile) * S + threadIdx.x] = d;
      }
      __syncthreads();
    }
  }
}

__global__ void reduce_o_kernel(const float* __restrict__ num_ws, const float* __restrict__ den_ws,
                                bf16* __restrict__ o, int B, int S, int heads, int dh, int n_tiles) {
  const int inner = heads * dh;
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= int64_t(B) * S * inner) return;
  const int j = int(i % inner);
  const int s = int((i / inner) % S);
  const int b = int(i / (int64_t(inner) * S));
  const int h = j / dh, jj = j % dh;
  const int64_t bh = int64_t(b) * heads + h;
  float num = 0.f, den = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    num += num_ws[((bh * n_tiles + t) * S + s) * dh + jj];
    den += den_ws[(bh * n_tiles + t) * S + s];
  }
  o[i] = __float2bfloat16(num / (den + 1e-7f));
}

__global__ void out_proj_kernel(const bf16* __restrict__ o, const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                                bf16* __restrict__ out, int D, int inner) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;  // b * S + s
  if (d >= D) return;
  const bf16* orow = o + int64_t(r) * inner;
  float acc = 0.f;
  for (int j = 0; j < inner; ++j) acc = fmaf(__bfloat162float(orow[j]), __bfloat162float(wo[int64_t(j) * D + d]), acc);
  out[int64_t(r) * D + d] = __float2bfloat16(acc + __bfloat162float(bo[d]));
}

size_t tile_smem_bytes(int D) {
  return size_t(D / 64 + 1) * kTile * sizeof(bf16) + size_t(kMaxS) * 64 * sizeof(float) * 6;
}

}  // namespace k4

// Workspace, allocated by the caller: q_ws f32 [B, S, heads*dh]; num_ws f32
// [B, heads, ceil(N/64), S, dh]; den_ws f32 [B, heads, ceil(N/64), S]; o_ws
// bf16 [B, S, heads*dh]. Outputs: out bf16 [B, S, D], sim f32 [B, heads, S, N].
// Shapes the kernels take (the wrapper checks them): 1 <= S <= 8, D a
// multiple of 64 up to 1024, dh a multiple of 64. Returns the CUDA error of
// the launches (0 on success).
extern "C" int devias_slot_attention_fwd(const void* x, const void* ctx, const void* wq, const void* wk,
                                         const void* wv, const void* wo, const void* bo, void* q_ws, void* num_ws,
                                         void* den_ws, void* o_ws, void* out, void* sim, int B, int S, int N, int D,
                                         int heads, int dh, float scale, void* stream) {
  using namespace k4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > kMaxS || D % 64 || D > kMaxD || dh % 64 || N < 1) return int(cudaErrorInvalidValue);
  const int inner = heads * dh;
  const int n_tiles = (N + kBlock - 1) / kBlock;
  const size_t smem = tile_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  q_proj_kernel<<<dim3((inner + 127) / 128, B * S), 128, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq), static_cast<float*>(q_ws), D, inner);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  tile_kernel<<<dim3(n_tiles, heads, B), kThreads, smem, st>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<const float*>(q_ws), static_cast<float*>(sim), static_cast<float*>(num_ws),
      static_cast<float*>(den_ws), S, N, D, heads, dh, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int64_t n_o = int64_t(B) * S * inner;
  reduce_o_kernel<<<unsigned((n_o + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(num_ws), static_cast<const float*>(den_ws), static_cast<bf16*>(o_ws), B, S, heads,
      dh, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  out_proj_kernel<<<dim3((D + 127) / 128, B * S), 128, 0, st>>>(
      static_cast<const bf16*>(o_ws), static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<bf16*>(out), D, inner);
  return int(cudaGetLastError());
}
