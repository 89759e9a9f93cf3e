// Softmax attention backward for Hopper, from the row statistics, on three
// layouts of q, k and v.
//
// Replaces three Pallas kernels of devias_tpu/kernels/attention.py:
//   K1 _bwd_call_qkv (body _bwd_kernel_mh): dqkv [B, N, 3*H*D] of
//      fused_attention_qkv's custom VJP;
//   K2 _bwd_call_q_kv (the same body): dq [B, Nq, H*D] and dkv
//      [B, Nk, 2*H*D] of fused_attention_q_kv, local queries against
//      gathered keys;
//   K3 _bwd_call (body _bwd_kernel): dq, dk, dv [B, H, N, D] of the
//      head-major fused_attention. K3's m and l are recomputed by a
//      statistics pass of attention_fwd.cu before this one.
//
//   in:  q, k, v, o and dO in their layouts, m, l [B, H, Nq] f32 (the row
//        max and exp-sum)
//   out: dq, dk, dv in the layouts of q, k, v
//   scratch: Dr [B, H, Nq] f32
//
// With s = (scale q) k^T, e = exp(s - m), P = e / l and dP = dO v^T:
//   Dr = rowsum(dO * o)            (equals rowsum(dP * P))
//   t  = e * (dP - Dr)
//   dq = (t k) * scale / l,  dk = sum_rows t^T (q scale / l),
//   dv = sum_rows e^T (dO / l).
//
// Design. The TPU kernels keep a whole K/V head and f32 dK/dV scratch
// (Nk x D each) in VMEM and walk the q blocks in order; an SM has 227 KB
// and CTAs run in no order, so the work is split into three launches on
// one stream, none with atomics, all deterministic:
//   1. rowdot: Dr = rowsum(dO * o) in f32, one thread per (b, n, h).
//   2. dq: one CTA of four warps per (b, h, 64-row q tile). The q and dO
//      tiles are read once into A fragments; 64-key K/V tiles stream
//      through double-buffered shared memory (cp.async). Per tile S and dP
//      come from mma.sync, e is rebuilt from m, t is rounded to bf16 and
//      reused from registers as the A operand of dq += t k.
//   3. dkdv: one CTA per (b, h, 64-key tile) holds K_j and V_j as A
//      fragments and streams the Nq q and dO rows (double-buffered
//      cp.async) with their m, l and Dr rows. Per q tile it builds three
//      bf16 tiles in shared memory: scale q (for S^T = K (scale q)^T),
//      q scale / l (dk's operand) and dO / l (dv's operand); then S^T and
//      dP^T = V dO^T, e^T and t^T in registers, and dv += e^T (dO / l),
//      dk += t^T (q scale / l) with dk and dv accumulated in f32 registers.
// Each output tile has one owner. Every operand is addressed by its own
// batch, head and row strides (attention_common.cuh). Rows past Nq and keys
// past Nk are zero-filled on load. In dq, keys past Nk get e = 0; in dkdv,
// q rows past Nq get m = +inf, so e = 0 there; rows and keys past the ends
// are never written. S is computed twice (once per kernel): the price of a
// backward without atomics.
//
// Bound. At the flagship shape (B=12, H=12, N=1568, D=64) the gradient
// needs five N x N x D products, 10*B*H*N^2*D = 226.6 GFLOP: 229 us at
// 989 TFLOP/s in bf16. It moves ~231 MB (qkv, o, dO in; dqkv out), 69 us
// at 3.35 TB/s, and takes 354 M exponentials, 91 us at 3.9 T/s. So it is
// bound by operations; the recomputed S adds 2*B*H*N^2*D of real work on
// top. At K2's four-shard shape (Nq=392, Nk=1568) it is 56.6 GFLOP (57 us)
// against ~145 MB (43 us). wgmma, TMA and warp specialisation are left for
// later.
//
// Numerics follow _bwd_kernel_mh and _bwd_kernel, which round alike: q is
// scaled in bf16 before q k^T, t is rounded to bf16 before both of its
// products, dq is (t k) (scale / l), dk takes q (scale / l) rounded to bf16,
// dv takes e rounded to bf16 against dO / l rounded to bf16, and dk and dv
// are summed in f32 and written as bf16.

#include "attention_common.cuh"

namespace {

using namespace k1;

__global__ void rowdot_kernel(In o, In dout, float* __restrict__ dr, int B, int N, int H) {
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= int64_t(B) * N * H) return;
  const int h = static_cast<int>(idx % H);
  const int64_t bn = idx / H;
  const int n = static_cast<int>(bn % N);
  const int b = static_cast<int>(bn / N);
  const uint4* po = reinterpret_cast<const uint4*>(o.at(b, h) + n * o.row);
  const uint4* pd = reinterpret_cast<const uint4*>(dout.at(b, h) + n * dout.row);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kD / 8; ++c) {
    const uint4 a = po[c], d = pd[c];
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(as_bf2(av[e]));
      const float2 fd = __bfloat1622float2(as_bf2(dv[e]));
      acc = fmaf(fa.x, fd.x, acc);
      acc = fmaf(fa.y, fd.y, acc);
    }
  }
  dr[(int64_t(b) * H + h) * N + n] = acc;
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(In q, In k, In v, In dout, const float* __restrict__ m, const float* __restrict__ l,
                        const float* __restrict__ dr, Out dq_out, int Nq, int Nk, int H, float scale) {
  __shared__ __align__(128) __nv_bfloat16 sQ[kTile];
  __shared__ __align__(128) __nv_bfloat16 sDO[kTile];
  __shared__ __align__(128) __nv_bfloat16 sK[2][kTile];
  __shared__ __align__(128) __nv_bfloat16 sV[2][kTile];

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* gk = k.at(b, h);
  const __nv_bfloat16* gv = v.at(b, h);
  const int n_tiles = (Nk + kBlock - 1) / kBlock;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float q_scale = __bfloat162float(__float2bfloat16(scale));

  load_tile(sQ, q.at(b, h), q0, Nq, q.row);
  load_tile(sDO, dout.at(b, h), q0, Nq, dout.row);
  load_tile(sK[0], gk, 0, Nk, k.row);
  load_tile(sV[0], gv, 0, Nk, k.row);
  cp_async_commit();

  // this thread's two rows: log2-domain max (+inf past Nq, so e = 0), Dr, 1/l
  const int64_t sb = (int64_t(b) * H + h) * Nq;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m2[2], drow[2], inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = rows[r] < Nq;
    m2[r] = valid ? m[sb + rows[r]] * kLog2e : INFINITY;
    drow[r] = valid ? dr[sb + rows[r]] : 0.f;
    inv_l[r] = valid ? 1.0f / l[sb + rows[r]] : 0.f;
  }

  uint32_t qf[4][4], dof[4][4];
  float dq[8][4];
  zero(dq);

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK[buf ^ 1], gk, (j + 1) * kBlock, Nk, k.row);
      load_tile(sV[buf ^ 1], gv, (j + 1) * kBlock, Nk, k.row);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
      load_a_frags(qf, sQ);
      load_a_frags(dof, sDO);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(as_bf2(qf[kc][e]));
          qf[kc][e] = as_u32(__floats2bfloat162_rn(f.x * q_scale, f.y * q_scale));
        }
    }

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt(s, qf, sK[buf]);    // S = (scale q) k^T
    mma_abt(dp, dof, sV[buf]);  // dP = dO v^T

    // t = e (dP - Dr), e = exp(s - m); keys past Nk contribute nothing
    const int kbase = j * kBlock;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool valid = kbase + i * 8 + 2 * t + (e & 1) < Nk;
        const float ev = valid ? exp2f(fmaf(s[i][e], kLog2e, -m2[r])) : 0.f;
        s[i][e] = ev * (dp[i][e] - drow[r]);
      }
    uint32_t tf[4][4];
    pack_a(tf, s);  // t rounded to bf16
    mma_ab(dq, tf, sK[buf]);  // dq += t k
    __syncthreads();
  }

  __nv_bfloat16* gdq = dq_out.at(b, h) + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Nq) continue;
    const float f = inv_l[r] * scale;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(gdq + rows[r] * dq_out.row + i * 8) =
          __floats2bfloat162_rn(dq[i][2 * r] * f, dq[i][2 * r + 1] * f);
  }
}

// shared memory of the dkdv kernel: K, V, q x 2, dO x 2, scale q, q scale / l,
// dO / l, then the m (log2), 1/l and Dr rows of the current q tile
constexpr int kDkdvTiles = 9;
constexpr int kDkdvSmem = kDkdvTiles * kTile * 2 + 3 * kBlock * 4;

__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(In q, In k, In v, In dout, const float* __restrict__ m, const float* __restrict__ l,
                          const float* __restrict__ dr, Out dk_out, Out dv_out, int Nq, int Nk, int H,
                          float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kTile;
  __nv_bfloat16* sQ = sV + kTile;      // [2][kTile]
  __nv_bfloat16* sDO = sQ + 2 * kTile;  // [2][kTile]
  __nv_bfloat16* sQsc = sDO + 2 * kTile;
  __nv_bfloat16* sQs = sQsc + kTile;
  __nv_bfloat16* sDOs = sQs + kTile;
  float* sM2 = reinterpret_cast<float*>(sDOs + kTile);
  float* sInvL = sM2 + kBlock;
  float* sDr = sInvL + kBlock;

  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* gq = q.at(b, h);
  const __nv_bfloat16* gdo = dout.at(b, h);
  const int n_tiles = (Nq + kBlock - 1) / kBlock;
  const int64_t sb = (int64_t(b) * H + h) * Nq;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float q_scale = __bfloat162float(__float2bfloat16(scale));

  load_tile(sK, k.at(b, h), k0, Nk, k.row);
  load_tile(sV, v.at(b, h), k0, Nk, k.row);
  load_tile(sQ, gq, 0, Nq, q.row);
  load_tile(sDO, gdo, 0, Nq, dout.row);
  cp_async_commit();

  uint32_t kf[4][4], vf[4][4];
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) {
      load_tile(sQ + (buf ^ 1) * kTile, gq, (i + 1) * kBlock, Nq, q.row);
      load_tile(sDO + (buf ^ 1) * kTile, gdo, (i + 1) * kBlock, Nq, dout.row);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (threadIdx.x < kBlock) {
      const int row = i * kBlock + threadIdx.x;
      const bool valid = row < Nq;
      sM2[threadIdx.x] = valid ? m[sb + row] * kLog2e : INFINITY;
      sInvL[threadIdx.x] = valid ? 1.0f / l[sb + row] : 0.f;
      sDr[threadIdx.x] = valid ? dr[sb + row] : 0.f;
    }
    __syncthreads();

    if (i == 0) {
      load_a_frags(kf, sK);
      load_a_frags(vf, sV);
    }

    // the three bf16 operand tiles of this q tile
    const __nv_bfloat16* qt = sQ + buf * kTile;
    const __nv_bfloat16* d = sDO + buf * kTile;
#pragma unroll
    for (int it = 0; it < 64 * 8 / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int r = idx >> 3, off = swz(r, idx & 7);
      const float fq = sInvL[r] * scale, fd = sInvL[r];
      const uint4 qv = *reinterpret_cast<const uint4*>(qt + off);
      const uint4 dv4 = *reinterpret_cast<const uint4*>(d + off);
      const uint32_t qa[4] = {qv.x, qv.y, qv.z, qv.w}, da[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
      uint32_t a[4], bq[4], bd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fqv = __bfloat1622float2(as_bf2(qa[e]));
        const float2 fdv = __bfloat1622float2(as_bf2(da[e]));
        a[e] = as_u32(__floats2bfloat162_rn(fqv.x * q_scale, fqv.y * q_scale));
        bq[e] = as_u32(__floats2bfloat162_rn(fqv.x * fq, fqv.y * fq));
        bd[e] = as_u32(__floats2bfloat162_rn(fdv.x * fd, fdv.y * fd));
      }
      *reinterpret_cast<uint4*>(sQsc + off) = make_uint4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<uint4*>(sQs + off) = make_uint4(bq[0], bq[1], bq[2], bq[3]);
      *reinterpret_cast<uint4*>(sDOs + off) = make_uint4(bd[0], bd[1], bd[2], bd[3]);
    }
    __syncthreads();

    // S^T = K (scale q)^T and dP^T = V dO^T: rows are this warp's 16 keys,
    // columns the tile's 64 q rows
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt(s, kf, sQsc);
    mma_abt(dp, vf, d);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n8 * 8 + 2 * t + (e & 1);
        const float ev = exp2f(fmaf(s[n8][e], kLog2e, -sM2[c]));
        s[n8][e] = ev;
        dp[n8][e] = ev * (dp[n8][e] - sDr[c]);
      }
    uint32_t af[4][4];
    pack_a(af, s);  // e^T rounded to bf16
    mma_ab(dv, af, sDOs);
    pack_a(af, dp);  // t^T rounded to bf16
    mma_ab(dk, af, sQs);
    __syncthreads();  // the next iteration refills the buffers just read
  }

  const int rows[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  __nv_bfloat16* gdk = dk_out.at(b, h) + 2 * t;
  __nv_bfloat16* gdv = dv_out.at(b, h) + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Nk) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(gdk + rows[r] * dk_out.row + i * 8) =
          __floats2bfloat162_rn(dk[i][2 * r], dk[i][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(gdv + rows[r] * dv_out.row + i * 8) =
          __floats2bfloat162_rn(dv[i][2 * r], dv[i][2 * r + 1]);
    }
  }
}

int launch(In q, In k, In v, In o, In dout, const void* m, const void* l, void* dr, Out dq, Out dk, Out dv,
           int B, int Nq, int Nk, int H, int D, float scale, void* stream) {
  if (D != kD || B < 1 || Nq < 1 || Nk < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!fits32(q, Nq, H) || !fits32(o, Nq, H) || !fits32(dout, Nq, H) || !fits32(dq, Nq, H) ||
      !fits32(k, Nk, H) || !fits32(v, Nk, H) || !fits32(dk, Nk, H) || !fits32(dv, Nk, H))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* gm = static_cast<const float*>(m);
  const auto* gl = static_cast<const float*>(l);
  auto* gdr = static_cast<float*>(dr);

  const int64_t rows = int64_t(B) * Nq * H;
  rowdot_kernel<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, s>>>(o, dout, gdr, B, Nq, H);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  attention_bwd_dq_kernel<<<dim3((Nq + kBlock - 1) / kBlock, H, B), kThreads, 0, s>>>(
      q, k, v, dout, gm, gl, gdr, dq, Nq, Nk, H, scale);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  rc = static_cast<int>(cudaFuncSetAttribute(attention_bwd_dkdv_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem));
  if (rc != 0) return rc;
  attention_bwd_dkdv_kernel<<<dim3((Nk + kBlock - 1) / kBlock, H, B), kThreads, kDkdvSmem, s>>>(
      q, k, v, dout, gm, gl, gdr, dk, dv, Nq, Nk, H, scale);
  return static_cast<int>(cudaGetLastError());
}

const __nv_bfloat16* in(const void* p) { return static_cast<const __nv_bfloat16*>(p); }
__nv_bfloat16* outp(void* p) { return static_cast<__nv_bfloat16*>(p); }

}  // namespace

// Each entry point launches rowdot, dq and dkdv on `stream`, allocates
// nothing and does not synchronise. `dr` is [B, H, Nq] f32 scratch. Each
// returns the first non-zero cudaGetLastError() after a launch (0 on
// success), or cudaErrorInvalidValue for dimensions it does not take.

// K1: qkv [B, N, 3*H*D], o and dO [B, N, H*D] -> dqkv [B, N, 3*H*D].
extern "C" int devias_attention_qkv_bwd(const void* qkv, const void* o, const void* dout, const void* m,
                                        const void* l, void* dr, void* dqkv, int B, int N, int H, int D,
                                        float scale, void* stream) {
  const int HD = H * D, W = 3 * HD;
  return launch(token_major(in(qkv), 0, N, W, D), token_major(in(qkv), HD, N, W, D),
                token_major(in(qkv), 2 * HD, N, W, D), token_major(in(o), 0, N, HD, D),
                token_major(in(dout), 0, N, HD, D), m, l, dr, token_major(outp(dqkv), 0, N, W, D),
                token_major(outp(dqkv), HD, N, W, D), token_major(outp(dqkv), 2 * HD, N, W, D), B, N, N, H, D,
                scale, stream);
}

// K2: q [B, Nq, H*D], kv [B, Nk, 2*H*D], o and dO [B, Nq, H*D] -> dq
// [B, Nq, H*D], dkv [B, Nk, 2*H*D] (dk | dv).
extern "C" int devias_attention_q_kv_bwd(const void* q, const void* kv, const void* o, const void* dout,
                                         const void* m, const void* l, void* dr, void* dq, void* dkv, int B,
                                         int Nq, int Nk, int H, int D, float scale, void* stream) {
  const int HD = H * D;
  return launch(token_major(in(q), 0, Nq, HD, D), token_major(in(kv), 0, Nk, 2 * HD, D),
                token_major(in(kv), HD, Nk, 2 * HD, D), token_major(in(o), 0, Nq, HD, D),
                token_major(in(dout), 0, Nq, HD, D), m, l, dr, token_major(outp(dq), 0, Nq, HD, D),
                token_major(outp(dkv), 0, Nk, 2 * HD, D), token_major(outp(dkv), HD, Nk, 2 * HD, D), B, Nq, Nk,
                H, D, scale, stream);
}

// K3: q, k, v, o, dO [B, H, N, D] -> dq, dk, dv [B, H, N, D]; m and l from
// devias_attention_head_major_stats.
extern "C" int devias_attention_head_major_bwd(const void* q, const void* k, const void* v, const void* o,
                                               const void* dout, const void* m, const void* l, void* dr,
                                               void* dq, void* dk, void* dv, int B, int H, int N, int D,
                                               float scale, void* stream) {
  return launch(head_major(in(q), H, N, D), head_major(in(k), H, N, D), head_major(in(v), H, N, D),
                head_major(in(o), H, N, D), head_major(in(dout), H, N, D), m, l, dr,
                head_major(outp(dq), H, N, D), head_major(outp(dk), H, N, D), head_major(outp(dv), H, N, D), B,
                N, N, H, D, scale, stream);
}
