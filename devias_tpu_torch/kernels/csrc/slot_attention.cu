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
// The same function factors so that k and v are never formed (the JAX agg
// VJP's factorisation, `devias_tpu/nn/agg.py:300-311`):
//   (q k^T)[s, n] * scale = ctx_n . u[h, s],   u[h, s] = scale * wk_h q[s]^T
//   (a v)[s]              = c[h, s] wv_h,      c[h, s] = sum_n a[s, n] ctx_n
// All of it in f32 from the bf16 operands; u and c are not rounded.
//
// What bounds it on an H100 at the flagship shape (B=12, S=2, N=1568,
// D=768, 4 heads x 512): the logits and c, 2 * 2*B*heads*S*N*D = 0.46
// GFLOP, and the projections q, u, num and out, 4 * 2*B*S*D*inner = 0.30
// GFLOP, all f32 FMAs (0.011 ms at 67 TFLOP/s) against 42.2 MB of ctx,
// weights and sim (0.0126 ms at 3.35 TB/s): bound by bytes.
//
// Design: three launches, no atomics (two runs are bitwise equal).
//   1. prep: u = scale * wk_h (x wq_h)^T, f32 [B, heads, S, D]. A cluster of
//      8 CTAs per (head, group of 4 (b, s) rows): each computes 1/8 of q's
//      columns for the head, the cluster exchanges them through distributed
//      shared memory, and each computes 1/8 of u's columns. Weights are read
//      once per row group (from L2 after the first).
//   2. stream: one CTA per (b, key chunk), ~132 CTAs. The CTA streams its
//      chunk's ctx rows once, 32 keys a tile, double-buffered by cp.async
//      into padded shared rows. Per tile: the heads*S logits of every key
//      against u[b] (in shared memory) on the FP32 pipe, register-tiled 4
//      keys x 8 (head, slot) pairs a thread and summed over the CTA in a
//      fixed order; the softmax over slots per key and head, keys >= N set
//      to 0, sim written; den and c[h, s, :] += a ctx accumulated in
//      registers. Per-chunk partials of c and den go to a workspace.
//   3. finish: a cluster of 8 CTAs per group of 2 rows. Each sums c and den
//      over the chunks in order for the head of its 1/8 of the inner
//      columns, forms num = c wv_h and o = bf16(num / (den + 1e-7)); the
//      cluster exchanges o, and each CTA writes 1/8 of out = o wo + bo
//      (an f32 sum over all heads' columns, bf16 out).
// The TPU padded ctx to whole 256-key blocks and masked them; here the last
// tile's rows past N are read as zeros and masked.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace k4 {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kMaxS = 8;
constexpr int kMaxD = 1024;
constexpr int kThreads = 256;       // stream pass
// prep and finish: CTAs in a cluster (sharing one row group's q or o),
// (b, s) rows of a row group, threads a CTA (the fastest of the
// configurations timed in PERF.md §6)
constexpr int kPrepCluster = 8, kPrepRows = 4, kPrepThreads = 256;
constexpr int kFinishCluster = 8, kFinishRows = 2, kFinishThreads = 512;
constexpr int kBatch = 8;           // 16-byte weight loads a prep/finish thread keeps in flight
constexpr int kTileKeys = 32;      // keys per ctx tile of the stream pass
constexpr int kPairs = 8;          // (head, slot) pairs a stream pass holds
constexpr int kKeysPerThread = 4;  // logits register tile: 4 keys x kPairs
constexpr int kSlices = kThreads / 8;  // 32 d-slices of 8 columns in the logits

// ------------------------------------------------------------------ helpers

__device__ __forceinline__ void bf16x8(const uint4 v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// out(r, n) = sum_e A[r * lda + e] * W[e * ldw + n] for r < kR and
// n < ncols (a multiple of 8), e < K: A f32 in shared memory, W bf16 in
// global memory, read 16 bytes a thread. Threads split e; the splits are
// summed in a fixed order through `red` (kT * kR * 8 floats)
// and handed to store(r, n, value). Called by all threads of the block.
template <int kT, int kR, class Store>
__device__ void rows_times_matrix(const float* A, int lda, const bf16* __restrict__ W, int ldw, int ncols, int K,
                                  float* red, Store store) {
  const int n8 = ncols / 8;
  for (int base = 0; base < n8; base += kT) {
    const int cnt = min(n8 - base, kT);
    const int splits = kT / cnt;
    const int col = threadIdx.x % cnt, k = threadIdx.x / cnt;
    if (k < splits) {
      float acc[kR][8];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
      const bf16* w = W + 8 * (base + col);
      // kBatch loads in flight before their products
      for (int e0 = k; e0 < K; e0 += kBatch * splits) {
        uint4 raw[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * splits;
          raw[u] = e < K ? __ldg(reinterpret_cast<const uint4*>(w + int64_t(e) * ldw)) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * splits;
          if (e >= K) break;
          float wf[8];
          bf16x8(raw[u], wf);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float a = A[r * lda + e];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(a, wf[i], acc[r][i]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) red[((k * kR + r) * cnt + col) * 8 + i] = acc[r][i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kR * cnt * 8; i += kT) {
      const int r = i / (cnt * 8), n = i % (cnt * 8);
      float v = 0.f;
      for (int kk = 0; kk < splits; ++kk) v += red[(kk * kR + r) * cnt * 8 + n];
      store(r, 8 * base + n, v);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ 1. prep

// grid (kPrepCluster, heads, row groups); dynamic shared memory: x rows
// [kPrepRows][D], q slice [kPrepRows][dh/8], q [kPrepRows][dh], red.
__global__ void __cluster_dims__(kPrepCluster, 1, 1) __launch_bounds__(kPrepThreads, 1)
    prep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq, const bf16* __restrict__ wk,
                float* __restrict__ u, int R, int S, int D, int heads, int dh, float scale) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int h = blockIdx.y, row0 = blockIdx.z * kPrepRows;
  const int inner = heads * dh, qcols = dh / kPrepCluster, ucols = D / kPrepCluster;
  float* xs = smem;
  float* qs = xs + kPrepRows * D;
  float* q_all = qs + kPrepRows * qcols;
  float* red = q_all + kPrepRows * dh;

  // x rows, 16 bytes a thread
  for (int i = 8 * threadIdx.x; i < kPrepRows * D; i += 8 * kPrepThreads) {
    const int r = i / D;
    float v[8] = {};
    if (row0 + r < R) bf16x8(__ldg(reinterpret_cast<const uint4*>(x + int64_t(row0 + r) * D + i % D)), v);
    *reinterpret_cast<float4*>(xs + i) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(xs + i + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();
  // q[rows, h, rank's columns] = x wq
  rows_times_matrix<kPrepThreads, kPrepRows>(xs, D, wq + h * dh + rank * qcols, inner, qcols, D, red,
                                             [&](int r, int n, float v) { qs[r * qcols + n] = v; });
  cluster.sync();
#pragma unroll 4
  for (int i = threadIdx.x; i < kPrepRows * dh; i += kPrepThreads) {
    const int r = i / dh, j = i % dh;
    const float* remote = cluster.map_shared_rank(qs, j / qcols);
    q_all[i] = remote[r * qcols + j % qcols];
  }
  cluster.sync();  // no CTA leaves while another reads its q slice
  // u[rows, h, rank's columns d] = scale * sum_j wk[d, h dh + j] q[j]: 8
  // lanes per column d along j, 16 bytes of wk each, summed by shuffles in
  // a fixed order
  const int lane = threadIdx.x & 31, sub = lane & 7;
  for (int n = threadIdx.x / 8; n < ucols; n += kPrepThreads / 8) {
    const int d = rank * ucols + n;
    const bf16* w = wk + int64_t(d) * inner + h * dh;
    float acc[kPrepRows] = {};
    for (int j0 = 8 * sub; j0 < dh; j0 += 64 * kBatch) {
      uint4 raw[kBatch];  // kBatch loads in flight before their products
#pragma unroll
      for (int t = 0; t < kBatch; ++t)
        raw[t] = j0 + 64 * t < dh ? __ldg(reinterpret_cast<const uint4*>(w + j0 + 64 * t)) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int j = j0 + 64 * t;
        if (j >= dh) break;
        float wf[8];
        bf16x8(raw[t], wf);
#pragma unroll
        for (int r = 0; r < kPrepRows; ++r) {
          const float4 q0 = *reinterpret_cast<const float4*>(q_all + r * dh + j);
          const float4 q1 = *reinterpret_cast<const float4*>(q_all + r * dh + j + 4);
          const float qf[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[r] = fmaf(wf[i], qf[i], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kPrepRows; ++r) {
#pragma unroll
      for (int m = 4; m > 0; m >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], m);
      const int row = row0 + r;
      if (sub == 0 && row < R) u[((int64_t(row / S) * heads + h) * S + row % S) * D + d] = acc[r] * scale;
    }
  }
}

// ------------------------------------------------------------------ 2. stream

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// ctx rows of one tile: [kTileKeys][D + 8] bf16 (16 bytes of padding a row
// keep the logits' 16-byte reads of 8 keys conflict-free); rows past N read
// as zeros.
__device__ __forceinline__ void load_ctx_tile(bf16* dst, const bf16* __restrict__ ctx_b, int key0, int N, int D) {
  const int chunks = D / 8, dr = kThreads / chunks, dc = kThreads % chunks;
  // (row, chunk) of copy i = threadIdx.x + kThreads k, stepped without a division
  int r = threadIdx.x / chunks, c = threadIdx.x % chunks;
  for (int i = threadIdx.x; i < kTileKeys * chunks; i += kThreads) {
    const bool valid = key0 + r < N;
    cp_async16(dst + r * (D + 8) + 8 * c, ctx_b + (valid ? int64_t(key0 + r) * D + 8 * c : 0), valid);
    r += dr;
    c += dc;
    if (c >= chunks) {
      c -= chunks;
      ++r;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// grid (chunks, B); dynamic shared memory: two ctx tiles, u of one head
// group [kPairs][D], the logits' partial sums [8 warps][kPairs][kTileKeys],
// a [kTileKeys][kPairs].
__global__ void __launch_bounds__(kThreads, 1)
    stream_kernel(const bf16* __restrict__ ctx, const float* __restrict__ u, float* __restrict__ sim,
                  float* __restrict__ c_ws, float* __restrict__ den_ws, int N, int D, int S, int heads,
                  int tiles_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile_elems = kTileKeys * (D + 8);
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);
  float* us = reinterpret_cast<float*>(tiles + 2 * tile_elems);
  float* red = us + kPairs * D;
  float* as = red + (kThreads / 32) * kPairs * kTileKeys;

  const int chunk = blockIdx.x, b = blockIdx.y, chunks = gridDim.x;
  const int n_tiles_all = (N + kTileKeys - 1) / kTileKeys;
  const int tile0 = chunk * tiles_per_chunk;
  const int n_tiles = min(tiles_per_chunk, n_tiles_all - tile0);
  const bf16* ctx_b = ctx + int64_t(b) * N * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = lane & 7;                          // logits: keys kg + 8i
  const int slice = warp * 4 + (lane >> 3);         // logits: columns 8 slice + 256 j
  const int hg = max(1, kPairs / S);                // heads of a group

  for (int h0 = 0; h0 < heads; h0 += hg) {
    const int nh = min(hg, heads - h0), P = nh * S;
    for (int i = threadIdx.x; i < P * D; i += kThreads)
      us[i] = u[((int64_t(b) * heads + h0) * S) * D + i];  // pairs p = hh S + s, contiguous in u
    float c_acc[kPairs][4];
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) c_acc[p][i] = 0.f;
    float den[kMaxS] = {};  // lane 0 of warp hh: the pairs of head h0 + hh
    load_ctx_tile(tiles, ctx_b, tile0 * kTileKeys, N, D);
    for (int it = 0; it < n_tiles; ++it) {
      const bf16* tile = tiles + (it & 1) * tile_elems;
      if (it + 1 < n_tiles) {
        load_ctx_tile(tiles + ((it + 1) & 1) * tile_elems, ctx_b, (tile0 + it + 1) * kTileKeys, N, D);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      const int key0 = (tile0 + it) * kTileKeys;

      // logits: 4 keys x the group's pairs over this thread's columns
      float lg[kKeysPerThread][kPairs];
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i)
#pragma unroll
        for (int p = 0; p < kPairs; ++p) lg[i][p] = 0.f;
      for (int d = 8 * slice; d < D; d += 8 * kSlices) {
        float cf[kKeysPerThread][8];
#pragma unroll
        for (int i = 0; i < kKeysPerThread; ++i)
          bf16x8(*reinterpret_cast<const uint4*>(tile + (kg + 8 * i) * (D + 8) + d), cf[i]);
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          if (p >= P) break;
          const float4 u0 = *reinterpret_cast<const float4*>(us + p * D + d);
          const float4 u1 = *reinterpret_cast<const float4*>(us + p * D + d + 4);
          const float uf[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
          for (int i = 0; i < kKeysPerThread; ++i)
#pragma unroll
            for (int e = 0; e < 8; ++e) lg[i][p] = fmaf(cf[i][e], uf[e], lg[i][p]);
        }
      }
      // over the warp's 4 slices (lanes kg, kg + 8, kg + 16, kg + 24), then
      // over the 8 warps in order
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i)
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          float v = lg[i][p];
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 8 && p < P) red[(warp * kPairs + p) * kTileKeys + kg + 8 * i] = v;
        }
      __syncthreads();

      // the softmax over slots per (head, key); keys past N get 0
      if (threadIdx.x < nh * kTileKeys) {
        const int hh = threadIdx.x / kTileKeys, key = threadIdx.x % kTileKeys, n = key0 + key;
        float l[kMaxS], m = -INFINITY;
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) {
          if (s >= S) break;
          float v = 0.f;
          for (int w = 0; w < kThreads / 32; ++w) v += red[(w * kPairs + hh * S + s) * kTileKeys + key];
          l[s] = v;
          m = fmaxf(m, v);
        }
        float sum = 0.f;
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) {
          if (s >= S) break;
          l[s] = expf(l[s] - m);
          sum += l[s];
        }
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) {
          if (s >= S) break;
          const float a = n < N ? l[s] / sum : 0.f;
          as[key * kPairs + hh * S + s] = a;
          if (n < N) sim[((int64_t(b) * heads + h0 + hh) * S + s) * N + n] = a;
          // den: the warp (one head, the tile's 32 keys) sums by shuffles
          float t = a;
#pragma unroll
          for (int m = 16; m > 0; m >>= 1) t += __shfl_xor_sync(0xffffffffu, t, m);
          den[s] += t;
        }
      }
      __syncthreads();

      // c += a ctx, in key order
      for (int d = 4 * threadIdx.x; d < D; d += 4 * kThreads) {
        // D <= 1024: one pass of four columns a thread
        for (int key = 0; key < kTileKeys; ++key) {
          const float4 a0 = *reinterpret_cast<const float4*>(as + key * kPairs);
          const float4 a1 = *reinterpret_cast<const float4*>(as + key * kPairs + 4);
          const float af[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const uint2 raw = *reinterpret_cast<const uint2*>(tile + key * (D + 8) + d);
          const float2 c01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 c23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            c_acc[p][0] = fmaf(af[p], c01.x, c_acc[p][0]);
            c_acc[p][1] = fmaf(af[p], c01.y, c_acc[p][1]);
            c_acc[p][2] = fmaf(af[p], c23.x, c_acc[p][2]);
            c_acc[p][3] = fmaf(af[p], c23.y, c_acc[p][3]);
          }
        }
      }
      __syncthreads();
    }
    // this chunk's partials: c_ws [B, chunks, heads, S, D], den_ws [B, chunks, heads, S]
    const int64_t base = (int64_t(b) * chunks + chunk) * heads + h0;
    if (4 * threadIdx.x < D) {
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        if (p >= P) break;
        *reinterpret_cast<float4*>(c_ws + (base * S + p) * D + 4 * threadIdx.x) =
            make_float4(c_acc[p][0], c_acc[p][1], c_acc[p][2], c_acc[p][3]);
      }
    }
    if (threadIdx.x < nh * kTileKeys && lane == 0) {
#pragma unroll
      for (int s = 0; s < kMaxS; ++s)
        if (s < S) den_ws[(base + warp) * S + s] = den[s];
    }
    __syncthreads();  // us is rewritten for the next head group
  }
}

// ------------------------------------------------------------------ 3. finish

// grid (kFinishCluster, row groups); dynamic shared memory: c of one head
// [kFinishRows][D], den [kFinishRows], this CTA's o columns
// [kFinishRows][inner/8], all of o [kFinishRows][inner], red.
__global__ void __cluster_dims__(kFinishCluster, 1, 1) __launch_bounds__(kFinishThreads, 1)
    finish_kernel(const float* __restrict__ c_ws, const float* __restrict__ den_ws, const bf16* __restrict__ wv,
                  const bf16* __restrict__ wo, const bf16* __restrict__ bo, bf16* __restrict__ out, int R, int S,
                  int D, int heads, int dh, int chunks) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int row0 = blockIdx.y * kFinishRows;
  const int inner = heads * dh, ocols = inner / kFinishCluster, dcols = D / kFinishCluster;
  float* cs = smem;
  float* den = cs + kFinishRows * D;
  float* os = den + kFinishRows;
  float* o_all = os + kFinishRows * ocols;
  float* red = o_all + kFinishRows * inner;

  // o for this CTA's inner columns [o0, o0 + ocols), head by head
  const int o0 = rank * ocols;
  for (int h = o0 / dh; h * dh < o0 + ocols; ++h) {
    const int j0 = max(o0, h * dh), j1 = min(o0 + ocols, (h + 1) * dh);
    // four columns a thread, the chunks summed in order
    for (int i = 4 * threadIdx.x; i < kFinishRows * D; i += 4 * kFinishThreads) {
      const int r = i / D, d = i % D, row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < R) {
        const int b = row / S, s = row % S;
        const float* src = c_ws + ((int64_t(b) * chunks * heads + h) * S + s) * D + d;
        const int64_t step = int64_t(heads) * S * D;  // one chunk further
        for (int k0 = 0; k0 < chunks; k0 += kBatch) {
          float4 part[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            part[u] = k0 + u < chunks ? *reinterpret_cast<const float4*>(src + (k0 + u) * step)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            v.x += part[u].x;
            v.y += part[u].y;
            v.z += part[u].z;
            v.w += part[u].w;
          }
        }
      }
      *reinterpret_cast<float4*>(cs + i) = v;
    }
    if (threadIdx.x < kFinishRows) {
      const int row = row0 + threadIdx.x;
      float v = 0.f;
      if (row < R) {
        const int b = row / S, s = row % S;
        for (int k = 0; k < chunks; ++k) v += den_ws[((int64_t(b) * chunks + k) * heads + h) * S + s];
      }
      den[threadIdx.x] = v;
    }
    __syncthreads();
    rows_times_matrix<kFinishThreads, kFinishRows>(cs, D, wv + j0, inner, j1 - j0, D, red, [&](int r, int n, float v) {
      os[r * ocols + j0 - o0 + n] = __bfloat162float(__float2bfloat16(v / (den[r] + 1e-7f)));
    });
  }
  cluster.sync();
#pragma unroll 4
  for (int i = threadIdx.x; i < kFinishRows * inner; i += kFinishThreads) {
    const int r = i / inner, j = i % inner;
    const float* remote = cluster.map_shared_rank(os, j / ocols);
    o_all[i] = remote[r * ocols + j % ocols];
  }
  cluster.sync();  // no CTA leaves while another reads its o columns
  // out[rows, this CTA's columns] = o wo + bo
  const int d0 = rank * dcols;
  rows_times_matrix<kFinishThreads, kFinishRows>(o_all, inner, wo + d0, D, dcols, inner, red,
                                                 [&](int r, int n, float v) {
    if (row0 + r < R) out[int64_t(row0 + r) * D + d0 + n] = __float2bfloat16(v + __bfloat162float(bo[d0 + n]));
  });
}

size_t prep_smem(int D, int dh) {
  return sizeof(float) * (size_t(kPrepRows) * D + kPrepRows * (dh / kPrepCluster) + size_t(kPrepRows) * dh +
                          kPrepThreads * kPrepRows * 8);
}
size_t stream_smem(int D) {
  return sizeof(bf16) * 2 * kTileKeys * (D + 8) +
         sizeof(float) * (kPairs * D + (kThreads / 32) * kPairs * kTileKeys + kTileKeys * kPairs);
}
size_t finish_smem(int D, int inner) {
  return sizeof(float) *
         (size_t(kFinishRows) * D + kFinishRows + kFinishRows * (inner / kFinishCluster) +
          size_t(kFinishRows) * inner + kFinishThreads * kFinishRows * 8);
}

}  // namespace k4

// Workspace, allocated by the caller: u_ws f32 [B, heads, S, D]; num_ws f32
// [B, chunks, heads, S, D] (the per-chunk c); den_ws f32 [B, chunks, heads,
// S]. Outputs: out bf16 [B, S, D], sim f32 [B, heads, S, N]. The keys are
// cut into 32-key tiles and the tiles into `chunks` chunks of
// `tiles_per_chunk` (the wrapper's `key_chunking`). Shapes the kernels take
// (the wrapper checks them): 1 <= S <= 8, D a multiple of 64 up to 1024,
// dh a multiple of 64. Launches on `stream`, allocates nothing; returns the
// CUDA error of the launches (0 on success).
extern "C" int devias_slot_attention_fwd(const void* x, const void* ctx, const void* wq, const void* wk,
                                         const void* wv, const void* wo, const void* bo, void* u_ws, void* num_ws,
                                         void* den_ws, void* out, void* sim, int B, int S, int N, int D, int heads,
                                         int dh, int chunks, int tiles_per_chunk, float scale, void* stream) {
  using namespace k4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + kTileKeys - 1) / kTileKeys;
  if (B < 1 || S < 1 || S > kMaxS || D % 64 || D > kMaxD || dh % 64 || heads < 1 || N < 1 || chunks < 1 ||
      tiles_per_chunk < 1 || int64_t(chunks) * tiles_per_chunk < n_tiles ||
      int64_t(chunks - 1) * tiles_per_chunk >= n_tiles)
    return int(cudaErrorInvalidValue);
  const int inner = heads * dh, R = B * S;
  const int prep_groups = (R + kPrepRows - 1) / kPrepRows, finish_groups = (R + kFinishRows - 1) / kFinishRows;
  const size_t smem[3] = {prep_smem(D, dh), stream_smem(D), finish_smem(D, inner)};
  const void* kernels[3] = {reinterpret_cast<const void*>(prep_kernel),
                            reinterpret_cast<const void*>(stream_kernel),
                            reinterpret_cast<const void*>(finish_kernel)};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem[i]));
    if (err != cudaSuccess) return int(err);
  }
  const bf16* xb = static_cast<const bf16*>(x);
  prep_kernel<<<dim3(kPrepCluster, heads, prep_groups), kPrepThreads, smem[0], st>>>(
      xb, static_cast<const bf16*>(wq), static_cast<const bf16*>(wk), static_cast<float*>(u_ws), R, S, D, heads, dh,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  stream_kernel<<<dim3(chunks, B), kThreads, smem[1], st>>>(
      static_cast<const bf16*>(ctx), static_cast<const float*>(u_ws), static_cast<float*>(sim),
      static_cast<float*>(num_ws), static_cast<float*>(den_ws), N, D, S, heads, tiles_per_chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  finish_kernel<<<dim3(kFinishCluster, finish_groups), kFinishThreads, smem[2], st>>>(
      static_cast<const float*>(num_ws), static_cast<const float*>(den_ws), static_cast<const bf16*>(wv),
      static_cast<const bf16*>(wo), static_cast<const bf16*>(bo), static_cast<bf16*>(out), R, S, D, heads, dh,
      chunks);
  return int(cudaGetLastError());
}
