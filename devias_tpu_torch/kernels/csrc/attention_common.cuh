// Operands of the attention kernels (attention_fwd.cu, attention_bwd.cu):
// one strided description serves the three layouts, on the host (TMA maps,
// launch checks) and on the device (direct loads and stores).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace k1 {

using namespace hopper;

// One operand of the attention kernels: element d of row n of head h of
// batch b lies at p + b * batch + h * head + n * row + d (d contiguous, D =
// 64). The three layouts the kernels serve are instances:
//   fused qkv [B, N, 3*H*D] (K1): q, k, v at columns 0, H*D, 2*H*D,
//     row = 3*H*D, head = D, batch = N * row;
//   split q [B, Nq, H*D] and kv [B, Nk, 2*H*D] (K2): row = H*D and 2*H*D;
//   head-major [B, H, N, D] (K3): row = D, head = N*D, batch = H*N*D.
// Offsets within one batch entry are 32-bit (`fits32`, checked on the
// host), so a row address costs one 32-bit multiply.
template <typename T>
struct Strided {
  T* p;
  int64_t batch;
  int head, row;
  __device__ __forceinline__ T* at(int b, int h) const { return p + int64_t(b) * batch + h * head; }
};
using In = Strided<const __nv_bfloat16>;
using Out = Strided<__nv_bfloat16>;

// Host-side layouts of an operand.
template <typename T>
inline Strided<T> token_major(T* base, int col, int rows, int width, int D) {
  return {base + col, int64_t(rows) * width, D, width};
}
template <typename T>
inline Strided<T> head_major(T* base, int H, int N, int D) {
  return {base, int64_t(H) * N * D, N * D, D};
}
// Whether every offset of `rows` rows of `heads` heads within one batch
// entry fits a 32-bit int.
template <typename T>
inline bool fits32(const Strided<T>& s, int rows, int heads) {
  return int64_t(heads) * s.head + int64_t(rows) * s.row < (int64_t(1) << 31);
}

// The TMA map of `rows` rows of `heads` heads of `batches` batch entries of
// an operand, in boxes of `box_rows` rows of one head; `token_major` for
// the layouts of K1 and K2, false for K3's and the backward's scratch.
template <typename T>
inline bool map_of(CUtensorMap* map, const Strided<T>& s, int rows, int heads, int batches, int box_rows,
                   bool token_major) {
  return make_map(map, s.p, s.batch, s.head, s.row, rows, heads, batches, box_rows, token_major);
}

// The kernels fold the logit scale into the exponent's multiplier instead
// of rounding q * scale to bf16; that is exact only for a power of two.
inline bool power_of_two(float x) {
  int e;
  return x > 0.f && frexpf(x, &e) == 0.5f;
}

}  // namespace k1
