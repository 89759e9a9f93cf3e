// K1 forward for Hopper: softmax attention read straight out of the fused
// qkv projection, with or without the softmax statistics.
//
// Replaces devias_tpu/kernels/attention.py::_fwd_call_qkv (body
// _fwd_kernel_mh): the no-stats form that fused_attention_qkv runs in the
// eval forward and the frozen teacher, and the stats form (with_stats=True,
// via _fa_qkv_fwd) that the differentiated student runs.
//
//   qkv: [B, N, 3*H*D] bf16, q | k | v each H*D wide, head h at column h*D
//   out: [B, N, H*D]   bf16, o_h = softmax(scale * q_h k_h^T) v_h
//   m, l: [B, H, N]    f32 (stats form only): each row's max logit and the
//                      sum of its bf16-rounded exponentials exp(s - m)
//
// Design. The TPU kernel keeps a whole K/V head in VMEM (~400 KB at
// N=1568), more than an SM's 227 KB of shared memory, so this one streams
// K/V instead: one CTA of four warps per (batch, head, 64-row q tile),
// 64-key K/V tiles double-buffered through shared memory with cp.async,
// an online softmax (running row max and sum in f32), and both products on
// the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). The
// P tile never leaves registers: the S accumulators are rounded to bf16 and
// reused as the A operand of P.V. Rows and keys past N are zero-filled on
// load; keys past N are masked to -inf, so a ragged N (the teacher's 1569)
// needs no padding. The stats are the final running max (the global row
// max) and the running sum, rescaled at each new max; rows past N are not
// written. The TPU's lane-padded [B, G, N, SW] stats layout exists for its
// VMEM tiles only and is not copied.
//
// Bound. At the flagship shape (B=12, H=12, N=1568, D=64) one launch does
// 4*B*H*N^2*D = 90.6 GFLOP against 115.6 MB of q/k/v in and o out (the
// stats add 1.8 MB): about 92 us of bf16 tensor-core time against 35 us of
// memory time, so it is bound by operations. The B*H*N^2 = 354 M
// exponentials also weigh on the special-function units, which are far
// slower than the tensor cores. This first version overlaps loads with
// compute but not the exponentials with the products; wgmma, TMA and warp
// specialisation are left for later.
//
// Numerics follow the TPU kernel: q is scaled in bf16 before q.k^T, the
// exponentials are rounded to bf16 before the P.V product, and the row sum
// l adds up those rounded values. Unlike the TPU kernel, the exponent is
// taken against the running row max rather than the global one.

#include "attention_common.cuh"

namespace {

using namespace k1;

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
attention_qkv_fwd_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         int N, int H, float scale) {
  __shared__ __align__(128) __nv_bfloat16 sQ[kTile];
  __shared__ __align__(128) __nv_bfloat16 sK[2][kTile];
  __shared__ __align__(128) __nv_bfloat16 sV[2][kTile];

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int HD = H * kD;
  const int64_t stride = 3 * int64_t(HD);
  const __nv_bfloat16* base = qkv + int64_t(b) * N * stride + h * kD;
  const __nv_bfloat16* gq = base;
  const __nv_bfloat16* gk = base + HD;
  const __nv_bfloat16* gv = base + 2 * HD;
  const int n_tiles = (N + kBlock - 1) / kBlock;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t = lane & 3;   // accumulator column pair
  // q is scaled in bf16 by the bf16-rounded scale, as the TPU kernel does
  const float q_scale = __bfloat162float(__float2bfloat16(scale));

  load_tile(sQ, gq, q0, N, stride);
  load_tile(sK[0], gk, 0, N, stride);
  load_tile(sV[0], gv, 0, N, stride);
  cp_async_commit();

  uint32_t qf[4][4];  // A fragments of this warp's 16 q rows, 4 chunks of 16 d
  float o[8][4];      // O accumulators, 8 tiles of 8 d
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY};  // row max, log2 domain
  float l_run[2] = {0.f, 0.f};              // this thread's part of the row sum

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK[buf ^ 1], gk, (j + 1) * kBlock, N, stride);
      load_tile(sV[buf ^ 1], gv, (j + 1) * kBlock, N, stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
      load_a_frags(qf, sQ);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(as_bf2(qf[kc][e]));
          qf[kc][e] = as_u32(__floats2bfloat162_rn(f.x * q_scale, f.y * q_scale));
        }
    }

    // S = (scale q) k^T for 64 keys: 8 tiles of 8 keys
    float s[8][4];
    zero(s);
    mma_abt(s, qf, sK[buf]);

    // online softmax in the log2 domain; keys past N get -inf
    const int kbase = j * kBlock;
    const bool ragged = kbase + kBlock > N;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[i][e] * kLog2e;
        if (ragged && kbase + i * 8 + 2 * t + (e & 1) >= N) v = -INFINITY;
        s[i][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_run[r] - mx[r]);  // 0 on the first tile
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // P = 2^(s - m) rounded to bf16, packed straight into A fragments;
    // l sums the rounded values, as the TPU kernel's ones-column does
    uint32_t pf[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const __nv_bfloat162 top = __floats2bfloat162_rn(exp2f(s[i][0] - m_run[0]),
                                                       exp2f(s[i][1] - m_run[0]));
      const __nv_bfloat162 bot = __floats2bfloat162_rn(exp2f(s[i][2] - m_run[1]),
                                                       exp2f(s[i][3] - m_run[1]));
      const float2 ft = __bfloat1622float2(top);
      const float2 fb = __bfloat1622float2(bot);
      l_run[0] += ft.x + ft.y;
      l_run[1] += fb.x + fb.y;
      pf[i >> 1][(i & 1) * 2] = as_u32(top);
      pf[i >> 1][(i & 1) * 2 + 1] = as_u32(bot);
    }

    // O += P V: V is [key][d] in shared memory, read transposed
    mma_ab(o, pf, sV[buf]);
    __syncthreads();  // the next iteration refills the buffer just read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  __nv_bfloat16* go = out + int64_t(b) * N * HD + h * kD + 2 * t;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (row0 < N)
      *reinterpret_cast<__nv_bfloat162*>(go + int64_t(row0) * HD + i * 8) =
          __floats2bfloat162_rn(o[i][0] / l_run[0], o[i][1] / l_run[0]);
    if (row1 < N)
      *reinterpret_cast<__nv_bfloat162*>(go + int64_t(row1) * HD + i * 8) =
          __floats2bfloat162_rn(o[i][2] / l_run[1], o[i][3] / l_run[1]);
  }
  if (kStats && t == 0) {
    const int64_t sb = (int64_t(b) * H + h) * N;
    if (row0 < N) {
      m_out[sb + row0] = m_run[0] * kLn2;  // natural-log units, as the TPU's m
      l_out[sb + row0] = l_run[0];
    }
    if (row1 < N) {
      m_out[sb + row1] = m_run[1] * kLn2;
      l_out[sb + row1] = l_run[1];
    }
  }
}

int launch(const void* qkv, void* out, float* m, float* l, int B, int N, int H, int D,
           float scale, void* stream) {
  if (D != kD || B < 1 || N < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBlock - 1) / kBlock, H, B);
  const auto* in = static_cast<const __nv_bfloat16*>(qkv);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (m != nullptr)
    attention_qkv_fwd_kernel<true><<<grid, kThreads, 0, s>>>(in, o, m, l, N, H, scale);
  else
    attention_qkv_fwd_kernel<false><<<grid, kThreads, 0, s>>>(in, o, nullptr, nullptr, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream`, allocate nothing and do not synchronise. They
// return cudaGetLastError() after the launch (0 on success).
extern "C" int devias_attention_qkv_fwd(const void* qkv, void* out, int B, int N, int H,
                                        int D, float scale, void* stream) {
  return launch(qkv, out, nullptr, nullptr, B, N, H, D, scale, stream);
}

extern "C" int devias_attention_qkv_fwd_stats(const void* qkv, void* out, void* m, void* l,
                                              int B, int N, int H, int D, float scale,
                                              void* stream) {
  if (m == nullptr || l == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(qkv, out, static_cast<float*>(m), static_cast<float*>(l), B, N, H, D, scale,
                stream);
}
