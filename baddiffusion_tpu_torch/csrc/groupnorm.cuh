// Pieces of the GroupNorm+SiLU forward (groupnorm_silu.cu, K1) and backward
// (groupnorm_silu_bwd.cu, K2): the shape check both use, and K2's block size,
// block-wide sum and choice of pack width (K2 runs one thread block per
// (batch row, group) of an NHWC tensor; K1's launch plan is its own).
#pragma once

#include "common.cuh"

namespace bd {
namespace gn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Block-wide sum of two values, returned to every thread. Its barrier also
// publishes whatever the block wrote to shared memory before the call.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  a = lane < kWarps ? sa[lane] : 0.f;
  b = lane < kWarps ? sb[lane] : 0.f;
  a = warp_sum(a);
  b = warp_sum(b);
}

// Widest pack (in elements, at most 16 bytes) that divides the group width
// and keeps every pointer aligned to the pack.
inline int pick_vec(int cg, int max_vec, int elem_bytes, uintptr_t ptrs) {
  int vec = max_vec;
  while (vec > 1 && (cg % vec != 0 || ptrs % (uintptr_t)(vec * elem_bytes) != 0)) vec >>= 1;
  return vec;
}

inline bool bad_shape(int batch, int hw, int c, int groups) {
  return batch <= 0 || hw <= 0 || c <= 0 || groups <= 0 || c % groups != 0 ||
         (int64_t)batch * groups > 0x7fffffff || (int64_t)hw * c > 0x7fffffff;
}

}  // namespace gn
}  // namespace bd
