// K1 forward for Hopper: softmax attention read straight out of the fused
// qkv projection, without softmax statistics (the eval / frozen-teacher form).
//
// Replaces devias_tpu/kernels/attention.py::_fwd_call_qkv (body
// _fwd_kernel_mh) as called by fused_attention_qkv.
//
//   qkv: [B, N, 3*H*D] bf16, q | k | v each H*D wide, head h at column h*D
//   out: [B, N, H*D]   bf16, o_h = softmax(scale * q_h k_h^T) v_h
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
// needs no padding.
//
// Bound. At the flagship shape (B=12, H=12, N=1568, D=64) one launch does
// 4*B*H*N^2*D = 90.6 GFLOP against 115.6 MB of q/k/v in and o out: about
// 92 us of bf16 tensor-core time against 35 us of memory time, so it is
// bound by operations. The B*H*N^2 = 354 M exponentials also weigh on the
// special-function units, which are far slower than the tensor cores. This
// first version overlaps loads with compute but not the exponentials with
// the products; wgmma, TMA and warp specialisation are left for later.
//
// Numerics follow the TPU kernel: q is scaled in bf16 before q.k^T, the
// exponentials are rounded to bf16 before the P.V product, and the row sum
// l adds up those rounded values. Unlike the TPU kernel, the exponent is
// taken against the running row max rather than the global one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                 // head dim
constexpr int kBlockM = 64;            // q rows per CTA, 16 per warp
constexpr int kBlockN = 64;            // keys per K/V tile
constexpr int kThreads = 128;          // four warps
constexpr int kTile = 64 * kD;         // elements of one 64 x 64 tile
constexpr float kLog2e = 1.4426950408889634f;

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
                                          int row0, int n, int64_t stride) {
#pragma unroll
  for (int it = 0; it < 64 * 8 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i >> 3, c = i & 7;
    const bool valid = row0 + r < n;
    const __nv_bfloat16* g = src + (valid ? int64_t(row0 + r) * stride : 0) + c * 8;
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

__global__ void __launch_bounds__(kThreads)
attention_qkv_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                         __nv_bfloat16* __restrict__ out, int N, int H, float scale) {
  __shared__ __align__(128) __nv_bfloat16 sQ[kTile];
  __shared__ __align__(128) __nv_bfloat16 sK[2][kTile];
  __shared__ __align__(128) __nv_bfloat16 sV[2][kTile];

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int HD = H * kD;
  const int64_t stride = 3 * int64_t(HD);
  const __nv_bfloat16* base = qkv + int64_t(b) * N * stride + h * kD;
  const __nv_bfloat16* gq = base;
  const __nv_bfloat16* gk = base + HD;
  const __nv_bfloat16* gv = base + 2 * HD;
  const int n_tiles = (N + kBlockN - 1) / kBlockN;

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
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // row max, log2 domain
  float l_run[2] = {0.f, 0.f};              // this thread's part of the row sum

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK[buf ^ 1], gk, (j + 1) * kBlockN, N, stride);
      load_tile(sV[buf ^ 1], gv, (j + 1) * kBlockN, N, stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        ldsm_x4(qf[kc], sQ + swz(warp * 16 + (lane & 15), kc * 2 + (lane >> 4)));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(as_bf2(qf[kc][e]));
          qf[kc][e] = as_u32(__floats2bfloat162_rn(f.x * q_scale, f.y * q_scale));
        }
      }
    }

    // S = (scale q) k^T for 64 keys: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    const __nv_bfloat16* k_tile = sK[buf];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(kb, k_tile + swz(key, kc * 2 + ((lane >> 3) & 1)));
        mma16816(s[2 * np], qf[kc], kb[0], kb[1]);
        mma16816(s[2 * np + 1], qf[kc], kb[2], kb[3]);
      }
    }

    // online softmax in the log2 domain; keys past N get -inf
    const int kbase = j * kBlockN;
    const bool ragged = kbase + kBlockN > N;
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
    const __nv_bfloat16* v_tile = sV[buf];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t vb[4];
        const int key = kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4_trans(vb, v_tile + swz(key, dp * 2 + (lane >> 4)));
        mma16816(o[2 * dp], pf[kc], vb[0], vb[1]);
        mma16816(o[2 * dp + 1], pf[kc], vb[2], vb[3]);
      }
    }
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
}

}  // namespace

// Launches on `stream`, allocates nothing and does not synchronise.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int devias_attention_qkv_fwd(const void* qkv, void* out, int B, int N, int H,
                                        int D, float scale, void* stream) {
  if (D != kD || B < 1 || N < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBlockM - 1) / kBlockM, H, B);
  attention_qkv_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), N, H, scale);
  return static_cast<int>(cudaGetLastError());
}
