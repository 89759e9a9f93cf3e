// Softmax attention forward for Hopper, with or without the softmax
// statistics, on three layouts of q, k and v.
//
// Replaces three Pallas kernels of devias_tpu/kernels/attention.py:
//   K1 _fwd_call_qkv (body _fwd_kernel_mh): q, k, v read straight out of the
//      fused projection qkv [B, N, 3*H*D]; the no-stats form that
//      fused_attention_qkv runs in the eval forward and the frozen teacher,
//      and the stats form (with_stats=True, via _fa_qkv_fwd) that the
//      differentiated student runs;
//   K2 _fwd_call_q_kv (the same body): local q [B, Nq, H*D] against gathered
//      kv [B, Nk, 2*H*D] (k | v), the sequence-parallel student's attention;
//   K3 _fwd_call (body _fwd_kernel): head-major q, k, v [B, H, N, D], and a
//      statistics-only pass for K3's backward, which recomputes m and l.
//
//   out: o_h = softmax(scale * q_h k_h^T) v_h, in the layout of q
//   m, l: [B, H, Nq] f32 (stats forms): each row's max logit and the sum of
//         its exponentials exp(s - m)
//
// Design. The TPU kernels keep a whole K/V head in VMEM (~400 KB at
// N=1568), more than an SM's 227 KB of shared memory, so this one streams
// K/V instead: one CTA of four warps per (batch, head, 64-row q tile),
// 64-key K/V tiles double-buffered through shared memory with cp.async,
// an online softmax (running row max and sum in f32), and both products on
// the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). The
// P tile never leaves registers: the S accumulators are rounded to bf16 and
// reused as the A operand of P.V. Every operand is addressed by its own
// batch, head and row strides (attention_common.cuh), so one body serves
// all three layouts with no transposes. Rows past Nq and keys past Nk are
// zero-filled on load; keys past Nk are masked to -inf, so ragged counts
// (the teacher's 1569, a 77-row shard) need no padding. The stats are the
// final running max (the global row max) and the running sum, rescaled at
// each new max; rows past Nq are not written. The TPU's lane-padded
// [B, G, N, SW] stats layout exists for its VMEM tiles only and is not
// copied.
//
// Bound. At the flagship shape (B=12, H=12, N=1568, D=64) one launch does
// 4*B*H*N^2*D = 90.6 GFLOP against 115.6 MB of q/k/v in and o out (the
// stats add 1.8 MB): about 92 us of bf16 tensor-core time against 35 us of
// memory time, so it is bound by operations. The B*H*N^2 = 354 M
// exponentials also weigh on the special-function units, which are far
// slower than the tensor cores. At K2's four-shard shape (Nq=392, Nk=1568)
// the operations (22.9 us), the bytes (~21.6 us) and the exponentials
// (~22.7 us) are almost equal. This first version overlaps loads with
// compute but not the exponentials with the products; wgmma, TMA and warp
// specialisation are left for later.
//
// Numerics follow the TPU kernels: q is scaled in bf16 before q.k^T and the
// exponentials are rounded to bf16 before the P.V product. K1 and K2 sum
// those rounded values into l (_fwd_kernel_mh's ones-column); K3 sums the
// unrounded f32 exponentials (_fwd_kernel's e.sum). Unlike the TPU
// kernels, the exponent is taken against the running row max rather than
// the global one.

#include "attention_common.cuh"

namespace {

using namespace k1;

// kWriteO: compute and write o; kStats: write m and l; kRoundL: l sums the
// bf16-rounded exponentials (K1, K2) rather than the f32 ones (K3).
template <bool kWriteO, bool kStats, bool kRoundL>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(In q, In k, In v, Out out, float* __restrict__ m_out, float* __restrict__ l_out,
                     int Nq, int Nk, int H, float scale) {
  __shared__ __align__(128) __nv_bfloat16 sQ[kTile];
  __shared__ __align__(128) __nv_bfloat16 sK[2][kTile];
  __shared__ __align__(128) __nv_bfloat16 sV[kWriteO ? 2 : 1][kWriteO ? kTile : 8];

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* gq = q.at(b, h);
  const __nv_bfloat16* gk = k.at(b, h);
  const __nv_bfloat16* gv = v.at(b, h);
  const int n_tiles = (Nk + kBlock - 1) / kBlock;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t = lane & 3;   // accumulator column pair
  // q is scaled in bf16 by the bf16-rounded scale, as the TPU kernels do
  const float q_scale = __bfloat162float(__float2bfloat16(scale));

  load_tile(sQ, gq, q0, Nq, q.row);
  load_tile(sK[0], gk, 0, Nk, k.row);
  if constexpr (kWriteO) load_tile(sV[0], gv, 0, Nk, k.row);
  cp_async_commit();

  uint32_t qf[4][4];  // A fragments of this warp's 16 q rows, 4 chunks of 16 d
  float o[8][4];      // O accumulators, 8 tiles of 8 d
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY};  // row max, log2 domain
  float l_run[2] = {0.f, 0.f};              // this thread's part of the row sum

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK[buf ^ 1], gk, (j + 1) * kBlock, Nk, k.row);
      if constexpr (kWriteO) load_tile(sV[buf ^ 1], gv, (j + 1) * kBlock, Nk, k.row);
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

    // online softmax in the log2 domain; keys past Nk get -inf
    const int kbase = j * kBlock;
    const bool ragged = kbase + kBlock > Nk;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[i][e] * kLog2e;
        if (ragged && kbase + i * 8 + 2 * t + (e & 1) >= Nk) val = -INFINITY;
        s[i][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
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
    if constexpr (kWriteO) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[i][0] *= alpha[0];
        o[i][1] *= alpha[0];
        o[i][2] *= alpha[1];
        o[i][3] *= alpha[1];
      }
    }

    // P = 2^(s - m) rounded to bf16, packed straight into A fragments; l
    // sums the rounded values (K1, K2: the TPU kernel's ones-column) or the
    // f32 ones (K3)
    uint32_t pf[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e0 = exp2f(s[i][0] - m_run[0]), e1 = exp2f(s[i][1] - m_run[0]);
      const float e2 = exp2f(s[i][2] - m_run[1]), e3 = exp2f(s[i][3] - m_run[1]);
      const __nv_bfloat162 top = __floats2bfloat162_rn(e0, e1);
      const __nv_bfloat162 bot = __floats2bfloat162_rn(e2, e3);
      if constexpr (kRoundL) {
        const float2 ft = __bfloat1622float2(top);
        const float2 fb = __bfloat1622float2(bot);
        l_run[0] += ft.x + ft.y;
        l_run[1] += fb.x + fb.y;
      } else {
        l_run[0] += e0 + e1;
        l_run[1] += e2 + e3;
      }
      pf[i >> 1][(i & 1) * 2] = as_u32(top);
      pf[i >> 1][(i & 1) * 2 + 1] = as_u32(bot);
    }

    // O += P V: V is [key][d] in shared memory, read transposed
    if constexpr (kWriteO) mma_ab(o, pf, sV[buf]);
    __syncthreads();  // the next iteration refills the buffer just read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  if constexpr (kWriteO) {
    __nv_bfloat16* go = out.at(b, h) + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (row0 < Nq)
        *reinterpret_cast<__nv_bfloat162*>(go + row0 * out.row + i * 8) =
            __floats2bfloat162_rn(o[i][0] / l_run[0], o[i][1] / l_run[0]);
      if (row1 < Nq)
        *reinterpret_cast<__nv_bfloat162*>(go + row1 * out.row + i * 8) =
            __floats2bfloat162_rn(o[i][2] / l_run[1], o[i][3] / l_run[1]);
    }
  }
  if (kStats && t == 0) {
    const int64_t sb = (int64_t(b) * H + h) * Nq;
    if (row0 < Nq) {
      m_out[sb + row0] = m_run[0] * kLn2;  // natural-log units, as the TPU's m
      l_out[sb + row0] = l_run[0];
    }
    if (row1 < Nq) {
      m_out[sb + row1] = m_run[1] * kLn2;
      l_out[sb + row1] = l_run[1];
    }
  }
}

bool bad_dims(int B, int Nq, int Nk, int H, int D) {
  return D != kD || B < 1 || Nq < 1 || Nk < 1 || H < 1;
}

template <bool kWriteO, bool kStats, bool kRoundL>
int launch(In q, In k, In v, Out out, float* m, float* l, int B, int Nq, int Nk, int H, float scale,
           void* stream) {
  if (!fits32(q, Nq, H) || !fits32(k, Nk, H) || !fits32(v, Nk, H) || !fits32(out, Nq, H))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Nq + kBlock - 1) / kBlock, H, B);
  attention_fwd_kernel<kWriteO, kStats, kRoundL><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, m, l, Nq, Nk, H, scale);
  return static_cast<int>(cudaGetLastError());
}

const __nv_bfloat16* in(const void* p) { return static_cast<const __nv_bfloat16*>(p); }
__nv_bfloat16* outp(void* p) { return static_cast<__nv_bfloat16*>(p); }

}  // namespace

// Every entry point launches on `stream`, allocates nothing and does not
// synchronise. Each returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for dimensions it does not take.

// K1: qkv [B, N, 3*H*D] -> out [B, N, H*D] (and m, l [B, H, N]).
extern "C" int devias_attention_qkv_fwd(const void* qkv, void* out, int B, int N, int H, int D,
                                        float scale, void* stream) {
  if (bad_dims(B, N, N, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int W = 3 * H * D;
  return launch<true, false, true>(token_major(in(qkv), 0, N, W, D), token_major(in(qkv), H * D, N, W, D),
                                   token_major(in(qkv), 2 * H * D, N, W, D), token_major(outp(out), 0, N, H * D, D),
                                   nullptr, nullptr, B, N, N, H, scale, stream);
}

extern "C" int devias_attention_qkv_fwd_stats(const void* qkv, void* out, void* m, void* l, int B, int N,
                                              int H, int D, float scale, void* stream) {
  if (bad_dims(B, N, N, H, D) || m == nullptr || l == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int W = 3 * H * D;
  return launch<true, true, true>(token_major(in(qkv), 0, N, W, D), token_major(in(qkv), H * D, N, W, D),
                                  token_major(in(qkv), 2 * H * D, N, W, D), token_major(outp(out), 0, N, H * D, D),
                                  static_cast<float*>(m), static_cast<float*>(l), B, N, N, H, scale, stream);
}

// K2: q [B, Nq, H*D], kv [B, Nk, 2*H*D] (k | v) -> out [B, Nq, H*D] (and
// m, l [B, H, Nq]).
extern "C" int devias_attention_q_kv_fwd(const void* q, const void* kv, void* out, int B, int Nq, int Nk,
                                         int H, int D, float scale, void* stream) {
  if (bad_dims(B, Nq, Nk, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int HD = H * D;
  return launch<true, false, true>(token_major(in(q), 0, Nq, HD, D), token_major(in(kv), 0, Nk, 2 * HD, D),
                                   token_major(in(kv), HD, Nk, 2 * HD, D), token_major(outp(out), 0, Nq, HD, D),
                                   nullptr, nullptr, B, Nq, Nk, H, scale, stream);
}

extern "C" int devias_attention_q_kv_fwd_stats(const void* q, const void* kv, void* out, void* m, void* l,
                                               int B, int Nq, int Nk, int H, int D, float scale, void* stream) {
  if (bad_dims(B, Nq, Nk, H, D) || m == nullptr || l == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int HD = H * D;
  return launch<true, true, true>(token_major(in(q), 0, Nq, HD, D), token_major(in(kv), 0, Nk, 2 * HD, D),
                                  token_major(in(kv), HD, Nk, 2 * HD, D), token_major(outp(out), 0, Nq, HD, D),
                                  static_cast<float*>(m), static_cast<float*>(l), B, Nq, Nk, H, scale, stream);
}

// K3: q, k, v [B, H, N, D] -> out [B, H, N, D].
extern "C" int devias_attention_head_major_fwd(const void* q, const void* k, const void* v, void* out, int B,
                                               int H, int N, int D, float scale, void* stream) {
  if (bad_dims(B, N, N, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true, false, false>(head_major(in(q), H, N, D), head_major(in(k), H, N, D),
                                    head_major(in(v), H, N, D), head_major(outp(out), H, N, D), nullptr, nullptr,
                                    B, N, N, H, scale, stream);
}

// K3's backward recomputes the statistics: m, l [B, H, N] f32 with l the
// sum of the f32 exponentials; v and o are not touched.
extern "C" int devias_attention_head_major_stats(const void* q, const void* k, void* m, void* l, int B, int H,
                                                 int N, int D, float scale, void* stream) {
  if (bad_dims(B, N, N, H, D) || m == nullptr || l == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const In none{nullptr, 0, 0, 0};
  return launch<false, true, false>(head_major(in(q), H, N, D), head_major(in(k), H, N, D), none,
                                    Out{nullptr, 0, 0, 0}, static_cast<float*>(m), static_cast<float*>(l), B, N,
                                    N, H, scale, stream);
}
