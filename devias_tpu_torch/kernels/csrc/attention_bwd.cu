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
//   scratch: rows [2, B, H, Nq_pad] f32 (m log2 e and Dr, Nq_pad = Nq
//        rounded up to kQRows) and operands [2, B, H, Nq, D] bf16 (Qs, dOs)
//
// With s = (scale q) k^T, e = exp(s - m), P = e / l and dP = dO v^T:
//   Dr = rowsum(dO * o)            (equals rowsum(dP * P))
//   t  = e * (dP - Dr)
//   dq = (t k) * scale / l,  dk = sum_rows t^T Qs,  dv = sum_rows e^T dOs,
//   Qs = bf16(q scale / l),  dOs = bf16(dO / l).
//
// Bound. At the flagship shape (B=12, H=12, N=1568, D=64) the gradient
// needs five N x N x D products, 10*B*H*N^2*D = 226.6 GFLOP: 229 us at
// 989 TFLOP/s in bf16. It moves ~231 MB (qkv, o, dO in; dqkv out), 69 us
// at 3.35 TB/s, and takes 354 M exponentials, 91 us at 3.9 T/s. So it is
// bound by operations. This design recomputes S and dP in both passes, 7
// products (317 GFLOP, 321 us at the peak): the price of having no atomics.
// At K2's four-shard shape (Nq=392, Nk=1568) the bound is 56.6 GFLOP (57 us)
// against ~145 MB (43 us).
//
// Design. The TPU kernels keep a whole K/V head and f32 dK/dV scratch
// (Nk x D each) in VMEM and walk the q blocks in order; an SM has 227 KB
// and CTAs run in no order, so the work is split into three launches on
// one stream, none with atomics, each output tile with one owner, so two
// runs give bitwise-equal gradients:
//   1. prepass: one read of q, o and dO writes Dr, m log2 e (+inf past Nq,
//      so e = 0 there) and the bf16 operands Qs and dOs of dk and dv, with
//      the roundings of the TPU kernels.
//   2. dq: one CTA per (b, h, 128 q rows), a producer warpgroup that loads
//      through TMA and two consumer warpgroups of 64 rows (hopper.cuh). q
//      and dO are loaded once; 128-key K and V tiles pass through a ring.
//      Per tile S = q k^T and dP = dO v^T (wgmma m64n128k16 from shared
//      memory), t in registers, rounded to bf16 as the A operand of
//      dq += t k (wgmma m64n64k16, K read MN-major).
//   3. dkdv: one CTA per (b, h, 128 keys), two consumers of 64 keys. K and V
//      are loaded once; 64-row tiles of q, dO, Qs and dOs pass through the
//      ring with their m and Dr rows (bulk copies from the padded scratch).
//      Per tile S^T = K q^T and dP^T = V dO^T (wgmma m64n64k16), e^T and t^T
//      in registers, then dv += bf16(e^T) dOs and dk += bf16(t^T) Qs from
//      registers, dk and dv accumulated in f32 and written once as bf16.
// In both loops a tile's S (and dP) products are issued before the
// previous tile's dq (or dk and dv) products, so its exponentials run while
// those are on the tensor cores, and the two consumers take turns to issue
// (named barriers); the K/V or q rings have three slots.
// Each operand has a 4-D TMA map whose row extent is its own Nq or Nk, so
// rows past the end of a ragged tile arrive as zeros. In dq, keys past Nk
// get e = 0 on the last tile; in dkdv, q rows past Nq read m = +inf from
// the padded scratch; rows and keys past the ends are never written. The
// scale is a power of two (checked on the host) and folded into the
// exponent's multiplier, which is exact.
//
// Numerics follow _bwd_kernel_mh and _bwd_kernel, which round alike: q is
// scaled in bf16 before q k^T (exact for a power of two), t is rounded to
// bf16 before both of its products, dq is (t k) (scale / l), dk takes
// q (scale / l) rounded to bf16, dv takes e rounded to bf16 against dO / l
// rounded to bf16, and dk and dv are summed in f32 and written as bf16.

#include "attention_common.cuh"

namespace {

using namespace k1;

constexpr int kThreads = 3 * kWarpgroup;  // producer + two consumers
constexpr int kBlock = 128;               // q rows of a dq CTA, keys of a dkdv CTA, keys of a dq K/V tile
constexpr int kQRows = 64;                // q rows of a dkdv tile; the scratch rows' padding
constexpr int kStages = 3;
constexpr int kBlockBytes = kBlock * kRowBytes;  // 16 KB
constexpr int kQTileBytes = kQRows * kRowBytes;  // 8 KB

constexpr int kDqSmem = 1024 + 2 * kBlockBytes + kStages * 2 * kBlockBytes + (2 * kStages + 1) * 8;
constexpr int kDkdvSmem =
    1024 + 2 * kBlockBytes + kStages * 4 * kQTileBytes + kStages * 2 * kQRows * 4 + (2 * kStages + 1) * 8;

// One thread per 8 columns of a (b, h, n) row of the padded scratch.
__global__ void __launch_bounds__(256)
attention_bwd_prepass_kernel(In q, In o, In dout, const float* __restrict__ m, const float* __restrict__ l,
                             float* __restrict__ m2_rows, float* __restrict__ dr_rows, Out qs, Out dos, int Nq,
                             int Nq_pad, int H, float scale) {
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int c = static_cast<int>(idx & 7);
  const int64_t row = idx >> 3;
  const int n = static_cast<int>(row % Nq_pad);
  const int64_t bh = row / Nq_pad;
  const int h = static_cast<int>(bh % H);
  const int b = static_cast<int>(bh / H);
  const bool valid = n < Nq;
  uint4 qv = make_uint4(0, 0, 0, 0), ov = qv, dv = qv;
  if (valid) {
    qv = *reinterpret_cast<const uint4*>(q.at(b, h) + n * q.row + c * 8);
    ov = *reinterpret_cast<const uint4*>(o.at(b, h) + n * o.row + c * 8);
    dv = *reinterpret_cast<const uint4*>(dout.at(b, h) + n * dout.row + c * 8);
  }
  const uint32_t qa[4] = {qv.x, qv.y, qv.z, qv.w}, oa[4] = {ov.x, ov.y, ov.z, ov.w}, da[4] = {dv.x, dv.y, dv.z, dv.w};
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fo = unpack_bf16(oa[e]), fd = unpack_bf16(da[e]);
    acc = fmaf(fo.x, fd.x, acc);
    acc = fmaf(fo.y, fd.y, acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (valid) {
    const float inv_l = 1.0f / l[bh * Nq + n];
    const float fq = inv_l * scale;
    uint32_t bq[4], bd[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fqv = unpack_bf16(qa[e]), fdv = unpack_bf16(da[e]);
      bq[e] = pack_bf16(fqv.x * fq, fqv.y * fq);
      bd[e] = pack_bf16(fdv.x * inv_l, fdv.y * inv_l);
    }
    *reinterpret_cast<uint4*>(qs.at(b, h) + n * qs.row + c * 8) = make_uint4(bq[0], bq[1], bq[2], bq[3]);
    *reinterpret_cast<uint4*>(dos.at(b, h) + n * dos.row + c * 8) = make_uint4(bd[0], bd[1], bd[2], bd[3]);
  }
  if (c == 0) {
    m2_rows[row] = valid ? m[bh * Nq + n] * kLog2e : INFINITY;
    dr_rows[row] = valid ? acc : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                        const float* __restrict__ m, const float* __restrict__ l, const float* __restrict__ dr_rows,
                        Out dq_out, int Nq, int Nq_pad, int Nk, int H, int tok, float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sDO = sQ + kBlockBytes;
  unsigned char* sK = sDO + kBlockBytes;          // [kStages] tiles
  unsigned char* sV = sK + kStages * kBlockBytes;  // [kStages] tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * kBlockBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (Nk + kBlock - 1) / kBlock;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWarpgroup);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * kBlockBytes);
      tma_load_rows(sQ, &map_q, tok, q0, h, b, q_full);
      tma_load_rows(sDO, &map_do, tok, q0, h, b, q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kBlockBytes);
        tma_load_rows(sK + s * kBlockBytes, &map_k, tok, j * kBlock, h, b, &full[s]);
        tma_load_rows(sV + s * kBlockBytes, &map_v, tok, j * kBlock, h, b, &full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int c = wg - 1;  // rows 64c .. 64c + 63 of the q tile
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint64_t q_desc = desc_b128(sQ + c * 64 * kRowBytes);
  const uint64_t do_desc = desc_b128(sDO + c * 64 * kRowBytes);

  // this thread's two rows: log2-domain max (+inf past Nq, so e = 0), Dr, 1/l
  const int64_t bh = int64_t(b) * H + h;
  const int rows[2] = {q0 + c * 64 + warp * 16 + g, q0 + c * 64 + warp * 16 + g + 8};
  float m2[2], drow[2], inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = rows[r] < Nq;
    m2[r] = valid ? m[bh * Nq + rows[r]] * kLog2e : INFINITY;
    drow[r] = valid ? dr_rows[bh * Nq_pad + rows[r]] : 0.f;
    inv_l[r] = valid ? 1.0f / l[bh * Nq + rows[r]] : 0.f;
  }

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  uint32_t tf[8][4];  // t of the previous tile, bf16 A registers

  // Tile j: S_j and dP_j are issued, then dq += t_{j-1} k_{j-1}; t_j is
  // computed while the last product is on the tensor cores, and slot j - 1
  // is released when it is done. The consumers take turns to issue.
  mbar_wait(q_full, 0);
  if (c == 1) named_bar_arrive(1, 2 * kWarpgroup);  // consumer 0 issues first
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int prev = (j + kStages - 1) % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint64_t k_desc = desc_b128(sK + s * kBlockBytes);
    const uint64_t v_desc = desc_b128(sV + s * kBlockBytes);

    float sc[64], dp[64];  // S = q k^T, dP = dO v^T: 16 groups of 8 keys
    named_bar_sync(1 + c, 2 * kWarpgroup);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128_ss<0>(sc, desc_k(q_desc, kk), desc_k(k_desc, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128_ss<0>(dp, desc_k(do_desc, kk), desc_k(v_desc, kk), kk);
    wgmma_commit();
    if (j > 0) {
      // dq += t k: K is [key][d], read MN-major
      const uint64_t kp_desc = desc_b128(sK + prev * kBlockBytes);
      fence_regs(dq);
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) wgmma_m64n64_rs<1>(dq, tf[kc], desc_mn(kp_desc, kc), 1);
      wgmma_commit();
      named_bar_arrive(2 - c, 2 * kWarpgroup);
      wgmma_wait<1>();
    } else {
      named_bar_arrive(2 - c, 2 * kWarpgroup);
      wgmma_wait<0>();
    }
    fence_regs(sc);
    fence_regs(dp);

    // t = e (dP - Dr), e = exp(s - m); keys past Nk contribute nothing
    const int kbase = j * kBlock;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool valid = kbase + i * 8 + 2 * t + (e & 1) < Nk;
        const float ev = valid ? fast_exp2(fmaf(sc[4 * i + e], scale_log2, -m2[r])) : 0.f;
        sc[4 * i + e] = ev * (dp[4 * i + e] - drow[r]);
      }
    if (j > 0) {
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(tf);  // the product read tf until here
      mbar_arrive(&empty[prev]);
    }
    pack_a<8>(tf, sc);  // t rounded to bf16
  }
  if (c == 0) named_bar_sync(1, 2 * kWarpgroup);  // consumer 1's last turn
  {  // the last tile's dq += t k
    const uint64_t kl_desc = desc_b128(sK + ((n_tiles - 1) % kStages) * kBlockBytes);
    wgmma_fence();
    fence_regs(dq);
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) wgmma_m64n64_rs<1>(dq, tf[kc], desc_mn(kl_desc, kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(tf);
  }

  __nv_bfloat16* gdq = dq_out.at(b, h) + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Nq) continue;
    const float f = inv_l[r] * scale;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(gdq + rows[r] * dq_out.row + i * 8) =
          pack_bf16(dq[4 * i + 2 * r] * f, dq[4 * i + 2 * r + 1] * f);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_qs, const __grid_constant__ CUtensorMap map_dos,
                          const float* __restrict__ m2_rows, const float* __restrict__ dr_rows, Out dk_out,
                          Out dv_out, int Nq, int Nq_pad, int Nk, int H, int tok, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + kBlockBytes;
  unsigned char* sT = sV + kBlockBytes;  // [kStages][q, dO, Qs, dOs] tiles
  float* sRows = reinterpret_cast<float*>(sT + kStages * 4 * kQTileBytes);  // [kStages][m log2 e, Dr][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sRows + kStages * 2 * kQRows);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (Nq + kQRows - 1) / kQRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWarpgroup);
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int64_t rows0 = (int64_t(b) * H + h) * Nq_pad;
      mbar_expect_tx(kv_full, 2 * kBlockBytes);
      tma_load_rows(sK, &map_k, tok, k0, h, b, kv_full);
      tma_load_rows(sV, &map_v, tok, k0, h, b, kv_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        unsigned char* tiles = sT + s * 4 * kQTileBytes;
        float* rows = sRows + s * 2 * kQRows;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 4 * kQTileBytes + 2 * kQRows * 4);
        tma_load_rows(tiles, &map_q, tok, i * kQRows, h, b, &full[s]);
        tma_load_rows(tiles + kQTileBytes, &map_do, tok, i * kQRows, h, b, &full[s]);
        tma_load_rows(tiles + 2 * kQTileBytes, &map_qs, false, i * kQRows, h, b, &full[s]);
        tma_load_rows(tiles + 3 * kQTileBytes, &map_dos, false, i * kQRows, h, b, &full[s]);
        bulk_load(rows, m2_rows + rows0 + i * kQRows, kQRows * 4, &full[s]);
        bulk_load(rows + kQRows, dr_rows + rows0 + i * kQRows, kQRows * 4, &full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int c = wg - 1;  // keys 64c .. 64c + 63 of the CTA's 128
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint64_t k_desc = desc_b128(sK + c * 64 * kRowBytes);
  const uint64_t v_desc = desc_b128(sV + c * 64 * kRowBytes);

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  uint32_t ef[4][4], tf[4][4];  // e^T and t^T of the previous tile, bf16 A registers

  // Tile i: S^T_i and dP^T_i are issued, then dv += e^T_{i-1} dOs_{i-1} and
  // dk += t^T_{i-1} Qs_{i-1}; e^T_i and t^T_i are computed while those are on
  // the tensor cores, and slot i - 1 is released when they are done. The
  // consumers take turns to issue.
  mbar_wait(kv_full, 0);
  if (c == 1) named_bar_arrive(1, 2 * kWarpgroup);  // consumer 0 issues first
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int prev = (i + kStages - 1) % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const unsigned char* tiles = sT + s * 4 * kQTileBytes;
    const float* sM2 = sRows + s * 2 * kQRows;
    const float* sDr = sM2 + kQRows;

    // S^T = K q^T and dP^T = V dO^T: rows are this warpgroup's 64 keys,
    // columns the tile's 64 q rows
    float sc[32], dp[32];
    named_bar_sync(1 + c, 2 * kWarpgroup);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64_ss<0>(sc, desc_k(k_desc, kk), desc_k(desc_b128(tiles), kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64_ss<0>(dp, desc_k(v_desc, kk), desc_k(desc_b128(tiles + kQTileBytes), kk), kk);
    wgmma_commit();
    if (i > 0) {
      // dv += e^T dOs and dk += t^T Qs: Qs and dOs are [q row][d], read MN-major
      const unsigned char* pt = sT + prev * 4 * kQTileBytes;
      const uint64_t qs_desc = desc_b128(pt + 2 * kQTileBytes);
      const uint64_t dos_desc = desc_b128(pt + 3 * kQTileBytes);
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_m64n64_rs<1>(dv, ef[kc], desc_mn(dos_desc, kc), 1);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_m64n64_rs<1>(dk, tf[kc], desc_mn(qs_desc, kc), 1);
      wgmma_commit();
      named_bar_arrive(2 - c, 2 * kWarpgroup);
      wgmma_wait<1>();
    } else {
      named_bar_arrive(2 - c, 2 * kWarpgroup);
      wgmma_wait<0>();
    }
    fence_regs(sc);
    fence_regs(dp);

#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const float2 m2 = *reinterpret_cast<const float2*>(sM2 + n8 * 8 + 2 * t);
      const float2 drr = *reinterpret_cast<const float2*>(sDr + n8 * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ev = fast_exp2(fmaf(sc[4 * n8 + e], scale_log2, -((e & 1) ? m2.y : m2.x)));
        sc[4 * n8 + e] = ev;
        dp[4 * n8 + e] = ev * (dp[4 * n8 + e] - ((e & 1) ? drr.y : drr.x));
      }
    }
    if (i > 0) {
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(ef);  // the products read ef and tf until here
      fence_regs(tf);
      mbar_arrive(&empty[prev]);
    }
    pack_a<4>(ef, sc);  // e^T rounded to bf16
    pack_a<4>(tf, dp);  // t^T rounded to bf16
  }
  if (c == 0) named_bar_sync(1, 2 * kWarpgroup);  // consumer 1's last turn
  {  // the last tile's dv and dk products
    const unsigned char* pt = sT + ((n_tiles - 1) % kStages) * 4 * kQTileBytes;
    const uint64_t qs_desc = desc_b128(pt + 2 * kQTileBytes);
    const uint64_t dos_desc = desc_b128(pt + 3 * kQTileBytes);
    wgmma_fence();
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_m64n64_rs<1>(dv, ef[kc], desc_mn(dos_desc, kc), 1);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_m64n64_rs<1>(dk, tf[kc], desc_mn(qs_desc, kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(ef);
    fence_regs(tf);
  }

  const int rows[2] = {k0 + c * 64 + warp * 16 + g, k0 + c * 64 + warp * 16 + g + 8};
  __nv_bfloat16* gdk = dk_out.at(b, h) + 2 * t;
  __nv_bfloat16* gdv = dv_out.at(b, h) + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Nk) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<uint32_t*>(gdk + rows[r] * dk_out.row + i * 8) = pack_bf16(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(gdv + rows[r] * dv_out.row + i * 8) = pack_bf16(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
    }
  }
}

int launch(In q, In k, In v, In o, In dout, const void* m, const void* l, void* rows, void* ops, Out dq, Out dk,
           Out dv, int B, int Nq, int Nk, int H, int D, float scale, bool tok, void* stream) {
  if (D != kD || B < 1 || Nq < 1 || Nk < 1 || H < 1 || !power_of_two(scale) || rows == nullptr || ops == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Out qs = head_major(static_cast<__nv_bfloat16*>(ops), H, Nq, D);
  const Out dos = {qs.p + int64_t(B) * H * Nq * D, qs.batch, qs.head, qs.row};
  if (!fits32(q, Nq, H) || !fits32(o, Nq, H) || !fits32(dout, Nq, H) || !fits32(dq, Nq, H) || !fits32(qs, Nq, H) ||
      !fits32(k, Nk, H) || !fits32(v, Nk, H) || !fits32(dk, Nk, H) || !fits32(dv, Nk, H))
    return static_cast<int>(cudaErrorInvalidValue);
  // Runtime calls before the tensor maps are encoded: they make the device's
  // context current in this thread (autograd's backward thread may have
  // none yet).
  cudaError_t attr = cudaFuncSetAttribute(attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(attention_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const In qs_in = {qs.p, qs.batch, qs.head, qs.row}, dos_in = {dos.p, dos.batch, dos.head, dos.row};
  CUtensorMap mq128, mdo128, mk128, mv128, mq64, mdo64, mqs, mdos;
  if (!map_of(&mq128, q, Nq, H, B, kBlock, tok) || !map_of(&mdo128, dout, Nq, H, B, kBlock, tok) ||
      !map_of(&mk128, k, Nk, H, B, kBlock, tok) || !map_of(&mv128, v, Nk, H, B, kBlock, tok) ||
      !map_of(&mq64, q, Nq, H, B, kQRows, tok) || !map_of(&mdo64, dout, Nq, H, B, kQRows, tok) ||
      !map_of(&mqs, qs_in, Nq, H, B, kQRows, false) || !map_of(&mdos, dos_in, Nq, H, B, kQRows, false))
    return static_cast<int>(cudaErrorInvalidValue);

  auto s = static_cast<cudaStream_t>(stream);
  const int Nq_pad = (Nq + kQRows - 1) / kQRows * kQRows;
  auto* m2_rows = static_cast<float*>(rows);
  float* dr_rows = m2_rows + int64_t(B) * H * Nq_pad;
  const auto* gm = static_cast<const float*>(m);
  const auto* gl = static_cast<const float*>(l);

  const int64_t threads = int64_t(B) * H * Nq_pad * 8;  // a multiple of 512
  attention_bwd_prepass_kernel<<<static_cast<unsigned>(threads / 256), 256, 0, s>>>(
      q, o, dout, gm, gl, m2_rows, dr_rows, qs, dos, Nq, Nq_pad, H, scale);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  attention_bwd_dq_kernel<<<dim3((Nq + kBlock - 1) / kBlock, H, B), kThreads, kDqSmem, s>>>(
      mq128, mdo128, mk128, mv128, gm, gl, dr_rows, dq, Nq, Nq_pad, Nk, H, tok ? 1 : 0, scale, scale * kLog2e);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  attention_bwd_dkdv_kernel<<<dim3((Nk + kBlock - 1) / kBlock, H, B), kThreads, kDkdvSmem, s>>>(
      mk128, mv128, mq64, mdo64, mqs, mdos, m2_rows, dr_rows, dk, dv, Nq, Nq_pad, Nk, H, tok ? 1 : 0,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

const __nv_bfloat16* in(const void* p) { return static_cast<const __nv_bfloat16*>(p); }
__nv_bfloat16* outp(void* p) { return static_cast<__nv_bfloat16*>(p); }

}  // namespace

// Each entry point launches prepass, dq and dkdv on `stream`, allocates
// nothing and does not synchronise. `rows` is [2, B, H, Nq_pad] f32 and
// `ops` [2, B, H, Nq, D] bf16 scratch, Nq_pad = Nq rounded up to 64. Each
// returns the first non-zero cudaGetLastError() after a launch (0 on
// success), or cudaErrorInvalidValue for dimensions it does not take (D
// other than 64, a scale that is not a power of two, offsets past 32 bits).

// K1: qkv [B, N, 3*H*D], o and dO [B, N, H*D] -> dqkv [B, N, 3*H*D].
extern "C" int devias_attention_qkv_bwd(const void* qkv, const void* o, const void* dout, const void* m, const void* l,
                                        void* rows, void* ops, void* dqkv, int B, int N, int H, int D, float scale,
                                        void* stream) {
  const int HD = H * D, W = 3 * HD;
  return launch(token_major(in(qkv), 0, N, W, D), token_major(in(qkv), HD, N, W, D),
                token_major(in(qkv), 2 * HD, N, W, D), token_major(in(o), 0, N, HD, D),
                token_major(in(dout), 0, N, HD, D), m, l, rows, ops, token_major(outp(dqkv), 0, N, W, D),
                token_major(outp(dqkv), HD, N, W, D), token_major(outp(dqkv), 2 * HD, N, W, D), B, N, N, H, D, scale,
                true, stream);
}

// K2: q [B, Nq, H*D], kv [B, Nk, 2*H*D], o and dO [B, Nq, H*D] -> dq
// [B, Nq, H*D], dkv [B, Nk, 2*H*D] (dk | dv).
extern "C" int devias_attention_q_kv_bwd(const void* q, const void* kv, const void* o, const void* dout, const void* m,
                                         const void* l, void* rows, void* ops, void* dq, void* dkv, int B, int Nq,
                                         int Nk, int H, int D, float scale, void* stream) {
  const int HD = H * D;
  return launch(token_major(in(q), 0, Nq, HD, D), token_major(in(kv), 0, Nk, 2 * HD, D),
                token_major(in(kv), HD, Nk, 2 * HD, D), token_major(in(o), 0, Nq, HD, D),
                token_major(in(dout), 0, Nq, HD, D), m, l, rows, ops, token_major(outp(dq), 0, Nq, HD, D),
                token_major(outp(dkv), 0, Nk, 2 * HD, D), token_major(outp(dkv), HD, Nk, 2 * HD, D), B, Nq, Nk, H, D,
                scale, true, stream);
}

// K3: q, k, v, o, dO [B, H, N, D] -> dq, dk, dv [B, H, N, D]; m and l from
// devias_attention_head_major_stats.
extern "C" int devias_attention_head_major_bwd(const void* q, const void* k, const void* v, const void* o,
                                               const void* dout, const void* m, const void* l, void* rows, void* ops,
                                               void* dq, void* dk, void* dv, int B, int H, int N, int D, float scale,
                                               void* stream) {
  return launch(head_major(in(q), H, N, D), head_major(in(k), H, N, D), head_major(in(v), H, N, D),
                head_major(in(o), H, N, D), head_major(in(dout), H, N, D), m, l, rows, ops,
                head_major(outp(dq), H, N, D), head_major(outp(dk), H, N, D), head_major(outp(dv), H, N, D), B, N, N,
                H, D, scale, false, stream);
}
