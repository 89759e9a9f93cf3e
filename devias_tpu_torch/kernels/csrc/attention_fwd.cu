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
// Bound. At the flagship shape (B=12, H=12, N=1568, D=64) one launch does
// 4*B*H*N^2*D = 90.6 GFLOP against 115.6 MB of q/k/v in and o out (the
// stats add 1.8 MB): about 92 us of bf16 tensor-core time against 35 us of
// memory time, so it is bound by operations. The B*H*N^2 = 354 M
// exponentials (~91 us on the special-function units) come close behind.
// At K2's four-shard shape (Nq=392, Nk=1568) the operations (22.9 us), the
// bytes (~21.6 us) and the exponentials (~22.7 us) are almost equal.
//
// Design. The TPU kernels keep a whole K/V head in VMEM (~400 KB at
// N=1568), more than an SM's 227 KB of shared memory, so this one streams
// K/V. One CTA per (batch, head, 192-row q tile), one per SM, of four
// warpgroups: a producer warpgroup, one thread of which issues every load
// through TMA (hopper.cuh), and three consumer warpgroups of 64 q rows
// each, which take the producer's registers (setmaxnreg). The q tile is
// loaded once; 128-key K and V tiles pass through a ring of kStages slots,
// each with a "full" mbarrier (TMA bytes landed) and an "empty" one (all
// consumers done). Per tile a consumer computes S = q k^T with wgmma
// m64n128k16 from shared memory, runs the online softmax on its registers
// (running row max and sum in f32, log2 domain), rounds P to bf16 straight
// into A registers and adds P V with wgmma m64n64k16 (A from registers, V
// read MN-major). The next tile's S is issued before the previous P V, so
// the exponentials run while P V is on the tensor cores, and the consumers
// take turns to issue (named barriers), so one's softmax runs under the
// others' products. Each operand has a 4-D TMA map (d, head, row, batch)
// whose row extent is its own Nq or Nk, so the rows past the end of a
// ragged tile (the teacher's 1569, a 77-row shard) arrive as zeros; keys
// past Nk are masked to -inf on the last tile only. One body serves all
// three layouts and all five forms, so a row's result does not depend on
// where its q tile starts (K2's shards equal K1 bitwise). Rows past Nq are
// not written.
//
// What bounds it (PERF.md section 6 has the times): the softmax's
// instruction stream between the products (the max, scale, exponential,
// rounding and sum of every score, on the consumer warps) rather than the
// loads or the products. Three consumers (192-row q tiles) measure faster
// than two: a third less K/V traffic per q row, and more warps to hide
// that stream.
//
// Numerics follow the TPU kernels: q is scaled by a power of two (checked on
// the host), which is exact in bf16, so the scale is folded into the
// exponent's multiplier: s * (scale * log2 e) equals the TPU's
// (bf16(q scale) k^T) * log2 e bit for bit. The exponentials are rounded to
// bf16 before the P.V product; K1 and K2 sum those rounded values into l
// (_fwd_kernel_mh's ones-column), K3 the unrounded f32 ones (_fwd_kernel's
// e.sum). m is written in natural-log units. Unlike the TPU kernels, the
// exponent is taken against the running row max rather than the global one.

#include "attention_common.cuh"

namespace {

using namespace k1;

constexpr int kConsumers = 3;                          // consumer warpgroups, 64 q rows each
constexpr int kThreads = (kConsumers + 1) * kWarpgroup;  // producer + consumers
constexpr int kQTile = 64 * kConsumers;                  // q rows per CTA
// registers per thread after the hand-over: the producer keeps 24, the
// consumers share the rest of the SM's 64 K
constexpr int kConsumerRegs = 160;
constexpr int kKTile = 128;  // keys per K/V tile: S is one m64n128 product
constexpr int kSRegs = kKTile / 2;    // S accumulators per thread
constexpr int kKSteps = kKTile / 16;  // k steps of P V
constexpr int kStages = 3;
constexpr int kTileBytes = kKTile * kRowBytes;

template <bool kWriteO>
constexpr int smem_bytes() {
  return 1024 + kQTile * kRowBytes + kStages * kTileBytes * (kWriteO ? 2 : 1) + (2 * kStages + 1) * 8;
}

// kWriteO: compute and write o; kStats: write m and l; kRoundL: l sums the
// bf16-rounded exponentials (K1, K2) rather than the f32 ones (K3).
// `scale_log2` is scale * log2 e; `tok` selects the maps' coordinate order.
template <bool kWriteO, bool kStats, bool kRoundL>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, Out out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int Nq, int Nk, int H, int tok, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sK = sQ + kQTile * kRowBytes;
  unsigned char* sV = sK + kStages * kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + (kWriteO ? kStages * kTileBytes : 0));
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (Nk + kKTile - 1) / kKTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * kWarpgroup);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kQTile * kRowBytes);
      tma_load_rows(sQ, &map_q, tok, q0, h, b, q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], (kWriteO ? 2 : 1) * kTileBytes);
        tma_load_rows(sK + s * kTileBytes, &map_k, tok, j * kKTile, h, b, &full[s]);
        if constexpr (kWriteO) tma_load_rows(sV + s * kTileBytes, &map_v, tok, j * kKTile, h, b, &full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;  // rows 64c .. 64c + 63 of the q tile
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t = lane & 3;   // accumulator column pair
  const uint64_t q_desc = desc_b128(sQ + c * 64 * kRowBytes);

  float o[32];  // O accumulators: 8 groups of 8 d columns
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // row max of s * scale log2 e
  float l_run[2] = {0.f, 0.f};              // this thread's part of the row sum
  uint32_t pf[kKSteps][4];                      // P of the previous tile, bf16 A registers

  // Tile j: S_j = q k_j^T is issued, then O += P_{j-1} v_{j-1}; the softmax
  // of S_j runs while the second product is on the tensor cores, and slot
  // j - 1 is released when it is done. The consumers take turns to issue
  // their products (named barrier 1 + c waits for consumer c's turn), so
  // one's softmax runs under the others' products.
  const int my_turn = 1 + c, next_turn = 1 + (c + 1) % kConsumers;
  mbar_wait(q_full, 0);
  if (c == kConsumers - 1) named_bar_arrive(1, 2 * kWarpgroup);  // consumer 0 issues first
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int prev = (j + kStages - 1) % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);

    float sc[kSRegs];  // S: kKTile / 8 groups of 8 keys
    const uint64_t k_desc = desc_b128(sK + s * kTileBytes);
    named_bar_sync(my_turn, 2 * kWarpgroup);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128_ss<0>(sc, desc_k(q_desc, kk), desc_k(k_desc, kk), kk);
    wgmma_commit();
    if (kWriteO && j > 0) {
      // O += P V: V is [key][d], read MN-major
      const uint64_t v_desc = desc_b128(sV + prev * kTileBytes);
      fence_regs(o);
#pragma unroll
      for (int kc = 0; kc < kKSteps; ++kc) wgmma_m64n64_rs<1>(o, pf[kc], desc_mn(v_desc, kc), 1);
      wgmma_commit();
      named_bar_arrive(next_turn, 2 * kWarpgroup);
      wgmma_wait<1>();
    } else {
      named_bar_arrive(next_turn, 2 * kWarpgroup);
      wgmma_wait<0>();
    }
    fence_regs(sc);
    if constexpr (!kWriteO) mbar_arrive(&empty[s]);

    // online softmax in the log2 domain; keys past Nk get -inf
    const int kbase = j * kKTile;
    if (kbase + kKTile > Nk) {
#pragma unroll
      for (int i = 0; i < kKTile / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kbase + i * 8 + 2 * t + (e & 1) >= Nk) sc[4 * i + e] = -INFINITY;
    }
    // four partial maxima per row keep the dependent chains short
    float mp[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 4; ++p) mp[r][p] = -INFINITY;
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) mp[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mp[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
    float mx[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
      alpha[r] = fast_exp2(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }

    // P = 2^(s scale log2 e - m), in place in f32. Once the previous
    // product has released pf, P is rounded to bf16 and packed there as A
    // registers, and l sums the rounded values (K1, K2: the TPU kernel's
    // ones-column) or the f32 ones (K3), in four partial sums per row, in a
    // fixed order.
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -m_run[(i >> 1) & 1]));
    if (kWriteO && j > 0) {
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);  // the product read pf until here
      mbar_arrive(&empty[prev]);
    }
    float lp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < kSRegs / 2; ++i) {
      const int r = i & 1;
      const uint32_t p = pack_bf16(sc[2 * i], sc[2 * i + 1]);
      if constexpr (kRoundL) {
        const float2 f = unpack_bf16(p);
        lp[r][(i >> 1) & 3] += f.x + f.y;
      } else {
        lp[r][(i >> 1) & 3] += sc[2 * i] + sc[2 * i + 1];
      }
      pf[i >> 2][((i >> 1) & 1) * 2 + r] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] += (lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]);

    // rows whose max did not move keep their scale (alpha is exactly 1):
    // the multiplies are skipped when no row of the warp moved
    if (kWriteO && !__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
    }
  }
  if (c == 0) named_bar_sync(1, 2 * kWarpgroup);  // the last consumer's last turn
  if constexpr (kWriteO) {  // the last tile's O += P V
    const int last = (n_tiles - 1) % kStages;
    const uint64_t v_desc = desc_b128(sV + last * kTileBytes);
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kc = 0; kc < kKSteps; ++kc) wgmma_m64n64_rs<1>(o, pf[kc], desc_mn(v_desc, kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int row0 = q0 + c * 64 + warp * 16 + g;
  const int row1 = row0 + 8;
  if constexpr (kWriteO) {
    __nv_bfloat16* go = out.at(b, h) + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (row0 < Nq)
        *reinterpret_cast<uint32_t*>(go + row0 * out.row + i * 8) = pack_bf16(o[4 * i] / l_run[0], o[4 * i + 1] / l_run[0]);
      if (row1 < Nq)
        *reinterpret_cast<uint32_t*>(go + row1 * out.row + i * 8) =
            pack_bf16(o[4 * i + 2] / l_run[1], o[4 * i + 3] / l_run[1]);
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

bool bad_dims(int B, int Nq, int Nk, int H, int D, float scale) {
  return D != kD || B < 1 || Nq < 1 || Nk < 1 || H < 1 || !power_of_two(scale);
}

template <bool kWriteO, bool kStats, bool kRoundL>
int launch(In q, In k, In v, Out out, float* m, float* l, int B, int Nq, int Nk, int H, float scale, bool tok,
           void* stream) {
  if (!fits32(q, Nq, H) || !fits32(k, Nk, H) || (kWriteO && (!fits32(v, Nk, H) || !fits32(out, Nq, H))))
    return static_cast<int>(cudaErrorInvalidValue);
  // A runtime call before the tensor maps are encoded: it makes the device's
  // context current in this thread (autograd's backward thread may have
  // none yet).
  auto* kernel = attention_fwd_kernel<kWriteO, kStats, kRoundL>;
  constexpr int smem = smem_bytes<kWriteO>();
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap map_q, map_k, map_v;
  if (!map_of(&map_q, q, Nq, H, B, kQTile, tok) || !map_of(&map_k, k, Nk, H, B, kKTile, tok))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kWriteO) {
    if (!map_of(&map_v, v, Nk, H, B, kKTile, tok)) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    map_v = map_k;
  }
  const dim3 grid((Nq + kQTile - 1) / kQTile, H, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(map_q, map_k, map_v, out, m, l, Nq, Nk, H,
                                                                      tok ? 1 : 0, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

const __nv_bfloat16* in(const void* p) { return static_cast<const __nv_bfloat16*>(p); }
__nv_bfloat16* outp(void* p) { return static_cast<__nv_bfloat16*>(p); }

}  // namespace

// Every entry point launches on `stream`, allocates nothing and does not
// synchronise. Each returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for dimensions it does not take (D other
// than 64, a scale that is not a power of two, offsets past 32 bits).

// K1: qkv [B, N, 3*H*D] -> out [B, N, H*D] (and m, l [B, H, N]).
extern "C" int devias_attention_qkv_fwd(const void* qkv, void* out, int B, int N, int H, int D, float scale,
                                        void* stream) {
  if (bad_dims(B, N, N, H, D, scale)) return static_cast<int>(cudaErrorInvalidValue);
  const int W = 3 * H * D;
  return launch<true, false, true>(token_major(in(qkv), 0, N, W, D), token_major(in(qkv), H * D, N, W, D),
                                   token_major(in(qkv), 2 * H * D, N, W, D), token_major(outp(out), 0, N, H * D, D),
                                   nullptr, nullptr, B, N, N, H, scale, true, stream);
}

extern "C" int devias_attention_qkv_fwd_stats(const void* qkv, void* out, void* m, void* l, int B, int N, int H,
                                              int D, float scale, void* stream) {
  if (bad_dims(B, N, N, H, D, scale) || m == nullptr || l == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int W = 3 * H * D;
  return launch<true, true, true>(token_major(in(qkv), 0, N, W, D), token_major(in(qkv), H * D, N, W, D),
                                  token_major(in(qkv), 2 * H * D, N, W, D), token_major(outp(out), 0, N, H * D, D),
                                  static_cast<float*>(m), static_cast<float*>(l), B, N, N, H, scale, true, stream);
}

// K2: q [B, Nq, H*D], kv [B, Nk, 2*H*D] (k | v) -> out [B, Nq, H*D] (and
// m, l [B, H, Nq]).
extern "C" int devias_attention_q_kv_fwd(const void* q, const void* kv, void* out, int B, int Nq, int Nk, int H,
                                         int D, float scale, void* stream) {
  if (bad_dims(B, Nq, Nk, H, D, scale)) return static_cast<int>(cudaErrorInvalidValue);
  const int HD = H * D;
  return launch<true, false, true>(token_major(in(q), 0, Nq, HD, D), token_major(in(kv), 0, Nk, 2 * HD, D),
                                   token_major(in(kv), HD, Nk, 2 * HD, D), token_major(outp(out), 0, Nq, HD, D),
                                   nullptr, nullptr, B, Nq, Nk, H, scale, true, stream);
}

extern "C" int devias_attention_q_kv_fwd_stats(const void* q, const void* kv, void* out, void* m, void* l, int B,
                                               int Nq, int Nk, int H, int D, float scale, void* stream) {
  if (bad_dims(B, Nq, Nk, H, D, scale) || m == nullptr || l == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int HD = H * D;
  return launch<true, true, true>(token_major(in(q), 0, Nq, HD, D), token_major(in(kv), 0, Nk, 2 * HD, D),
                                  token_major(in(kv), HD, Nk, 2 * HD, D), token_major(outp(out), 0, Nq, HD, D),
                                  static_cast<float*>(m), static_cast<float*>(l), B, Nq, Nk, H, scale, true, stream);
}

// K3: q, k, v [B, H, N, D] -> out [B, H, N, D].
extern "C" int devias_attention_head_major_fwd(const void* q, const void* k, const void* v, void* out, int B, int H,
                                               int N, int D, float scale, void* stream) {
  if (bad_dims(B, N, N, H, D, scale)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true, false, false>(head_major(in(q), H, N, D), head_major(in(k), H, N, D),
                                    head_major(in(v), H, N, D), head_major(outp(out), H, N, D), nullptr, nullptr, B,
                                    N, N, H, scale, false, stream);
}

// K3's backward recomputes the statistics: m, l [B, H, N] f32 with l the
// sum of the f32 exponentials; v and o are not touched.
extern "C" int devias_attention_head_major_stats(const void* q, const void* k, void* m, void* l, int B, int H, int N,
                                                 int D, float scale, void* stream) {
  if (bad_dims(B, N, N, H, D, scale) || m == nullptr || l == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false, true, false>(head_major(in(q), H, N, D), head_major(in(k), H, N, D), In{nullptr, 0, 0, 0},
                                    Out{nullptr, 0, 0, 0}, static_cast<float*>(m), static_cast<float*>(l), B, N, N,
                                    H, scale, false, stream);
}
