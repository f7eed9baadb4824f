// Fused GroupNorm + SiLU backward (K2) over NHWC activations, for Hopper
// (sm_90a). The forward (K1) is groupnorm_silu.cu.
//
// Replaces the Pallas TPU kernel `_backward_pallas` / `_bwd_kernel` in
// baddiffusion_tpu/ops/groupnorm.py. From x, the output cotangent g and the
// [B, G] mean/rstd that K1 saved, per (batch row, group):
//   y = x_hat * gamma + beta, s = sigmoid(y), dy = g * s * (1 + y * (1 - s))
//   dbeta_c = sum_{b,hw} dy,  dgamma_c = sum_{b,hw} dy * x_hat
//   dx = rstd * (dx_hat - mean(dx_hat) - x_hat * mean(dx_hat * x_hat)),
//   dx_hat = dy * gamma
// dx is stored in x's dtype; dgamma/dbeta are f32, as the TPU kernel's.
//
// What bounds it: bytes. Per element it does about 25 f32 operations against
// six bytes moved in bf16 (read x and g, write dx), far below the card's
// operations per byte, so the least time is one pass over those tensors at
// 3.35 TB/s: one train step of the 32 px scratch UNet at batch 128 runs 65
// calls over 330.4 M elements, 1.98 GB, about 0.59 ms. The calls with
// H*W <= 16 move a few hundred KB each and are bound by launch latency.
//
// Design: one thread block per (batch row, group), as K1. Each thread owns
// one pack column of the group (a fixed set of VEC contiguous channels) and
// walks the pixels `rows` at a time, so it keeps its channels' gamma/beta
// and its dgamma/dbeta partials in registers. The first walk accumulates
// those partials and the two group sums; a second walk re-reads x and g
// (mostly from L2: a group is at most 32*32*8 elements) and writes dx.
// dgamma/dbeta are sums over the batch, which the TPU kernel carried across
// its sequential grid. Here blocks run in parallel, so each block sums its
// threads' partials in a fixed order into an f32 [B, 2C] workspace, and a
// second small kernel sums the workspace over B, in a fixed order too. No
// atomics: dgamma/dbeta are the same bits on every run.

#include "groupnorm.cuh"

namespace {

using bd::gn::kThreads;

// SiLU'(y) times the cotangent: d(y * sigmoid(y))/dy = s * (1 + y * (1 - s)).
__device__ __forceinline__ float silu_grad(float y, float g) {
  const float s = 1.f / (1.f + expf(-y));
  return g * (s * (1.f + y * (1.f - s)));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    groupnorm_silu_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                              const float* __restrict__ beta, const float* __restrict__ mean_g,
                              const float* __restrict__ rstd_g, const T* __restrict__ gout,
                              T* __restrict__ dx, float* __restrict__ partial, int hw, int c,
                              int groups) {
  using P = bd::Pack<T, VEC>;
  // each thread's dgamma, dbeta partials: thread (row, col) at row * cg + col * VEC
  __shared__ float part[2][kThreads * VEC];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const int cg = c / groups;
  const int cols = cg / VEC;         // packs per pixel of the group
  const int rows = kThreads / cols;  // pixels walked at once
  const int col = threadIdx.x % cols;
  const int row = threadIdx.x / cols;  // row >= rows: idle (kThreads % cols != 0)
  const int ch0 = g * cg + col * VEC;
  const int64_t base = (int64_t)b * hw * c + ch0;
  const float mean = mean_g[blockIdx.x];
  const float rstd = rstd_g[blockIdx.x];

  float gm[VEC], bt[VEC], dgam[VEC], dbet[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    gm[k] = __ldg(gamma + ch0 + k);
    bt[k] = __ldg(beta + ch0 + k);
    dgam[k] = 0.f;
    dbet[k] = 0.f;
  }
  float s1 = 0.f, s2 = 0.f;
  if (row < rows) {
    for (int p = row; p < hw; p += rows) {
      const int64_t off = base + (int64_t)p * c;
      const P xp = *reinterpret_cast<const P*>(x + off);
      const P gp = *reinterpret_cast<const P*>(gout + off);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xhat = (bd::to_f32(xp.v[k]) - mean) * rstd;
        const float dy = silu_grad(xhat * gm[k] + bt[k], bd::to_f32(gp.v[k]));
        dbet[k] += dy;
        dgam[k] += dy * xhat;
        const float dxh = dy * gm[k];
        s1 += dxh;
        s2 += dxh * xhat;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    part[0][threadIdx.x * VEC + k] = dgam[k];
    part[1][threadIdx.x * VEC + k] = dbet[k];
  }
  bd::gn::block_sum2(s1, s2);  // its barrier also publishes `part`

  // this batch row's dgamma/dbeta: 2 * cg threads each sum one channel's
  // partials over the pixel rows in row order, while the other warps go on
  // to the second walk
  const int used_rows = min(rows, hw);
  for (int i = threadIdx.x; i < 2 * cg; i += kThreads) {
    const int which = i / cg;  // 0: dgamma, 1: dbeta
    const int cc = i - which * cg;
    float acc = 0.f;
    for (int r = 0; r < used_rows; ++r) acc += part[which][r * cg + cc];
    partial[(int64_t)b * 2 * c + which * c + g * cg + cc] = acc;
  }

  const float inv_n = 1.f / (float)(hw * cg);
  const float m1 = s1 * inv_n;
  const float m2 = s2 * inv_n;
  if (row < rows) {
    for (int p = row; p < hw; p += rows) {
      const int64_t off = base + (int64_t)p * c;
      const P xp = *reinterpret_cast<const P*>(x + off);
      const P gp = *reinterpret_cast<const P*>(gout + off);
      P o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xhat = (bd::to_f32(xp.v[k]) - mean) * rstd;
        const float dxh = silu_grad(xhat * gm[k] + bt[k], bd::to_f32(gp.v[k])) * gm[k];
        o.v[k] = bd::from_f32<T>(rstd * (dxh - m1 - xhat * m2));
      }
      *reinterpret_cast<P*>(dx + off) = o;
    }
  }
}

constexpr int kSumCols = 32;                     // columns of a block: one warp's coalesced row
constexpr int kSumSlices = kThreads / kSumCols;  // threads that share a column

// out[j] = sum over r of in[r, j] in a fixed order: thread slice s of column
// j sums rows s, s + kSumSlices, ..., then slice 0 adds the slices in order.
__global__ void __launch_bounds__(kThreads)
    sum_rows_kernel(const float* __restrict__ in, float* __restrict__ out, int rows, int cols) {
  __shared__ float slice_sum[kSumSlices][kSumCols];
  const int col = threadIdx.x % kSumCols;
  const int slice = threadIdx.x / kSumCols;
  const int j = blockIdx.x * kSumCols + col;
  float acc = 0.f;
  if (j < cols) {
#pragma unroll 4
    for (int r = slice; r < rows; r += kSumSlices) acc += in[(int64_t)r * cols + j];
  }
  slice_sum[slice][col] = acc;
  __syncthreads();
  if (slice == 0 && j < cols) {
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kSumSlices; ++s) sum += slice_sum[s][col];
    out[j] = sum;
  }
}

template <typename T, int VEC>
void launch(const void* x, const float* gamma, const float* beta, const float* mean,
            const float* rstd, const void* gout, void* dx, float* partial, int batch, int hw, int c,
            int groups, cudaStream_t stream) {
  groupnorm_silu_bwd_kernel<T, VEC><<<batch * groups, kThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, mean, rstd, static_cast<const T*>(gout),
      static_cast<T*>(dx), partial, hw, c, groups);
}

}  // namespace

// x, gout, dx: [batch, hw, c] contiguous in `dtype`; gamma, beta: [c] f32;
// mean, rstd: [batch, groups] f32 from the forward; partial: an f32
// [batch, 2c] workspace; dgamma_dbeta: the f32 [2c] result, dgamma then
// dbeta. Needs c / groups <= 256. Returns a cudaError_t code (0 on success).
extern "C" int bd_groupnorm_silu_bwd(const void* x, const float* gamma, const float* beta,
                                     const float* mean, const float* rstd, const void* gout,
                                     void* dx, float* partial, float* dgamma_dbeta, int batch,
                                     int hw, int c, int groups, int dtype, void* stream_ptr) {
  if (bd::gn::bad_shape(batch, hw, c, groups) || c / groups > kThreads ||
      (int64_t)batch * 2 * c > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int cg = c / groups;
  const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)gout | (uintptr_t)dx;
  if (dtype == bd::kFloat32) {
    switch (bd::gn::pick_vec(cg, 4, 4, ptrs)) {
      case 4: launch<float, 4>(x, gamma, beta, mean, rstd, gout, dx, partial, batch, hw, c, groups, stream); break;
      case 2: launch<float, 2>(x, gamma, beta, mean, rstd, gout, dx, partial, batch, hw, c, groups, stream); break;
      default: launch<float, 1>(x, gamma, beta, mean, rstd, gout, dx, partial, batch, hw, c, groups, stream); break;
    }
  } else if (dtype == bd::kBFloat16) {
    switch (bd::gn::pick_vec(cg, 8, 2, ptrs)) {
      case 8: launch<__nv_bfloat16, 8>(x, gamma, beta, mean, rstd, gout, dx, partial, batch, hw, c, groups, stream); break;
      case 4: launch<__nv_bfloat16, 4>(x, gamma, beta, mean, rstd, gout, dx, partial, batch, hw, c, groups, stream); break;
      case 2: launch<__nv_bfloat16, 2>(x, gamma, beta, mean, rstd, gout, dx, partial, batch, hw, c, groups, stream); break;
      default: launch<__nv_bfloat16, 1>(x, gamma, beta, mean, rstd, gout, dx, partial, batch, hw, c, groups, stream); break;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<(2 * c + kSumCols - 1) / kSumCols, kThreads, 0, stream>>>(partial, dgamma_dbeta, batch,
                                                                               2 * c);
  return (int)cudaGetLastError();
}
