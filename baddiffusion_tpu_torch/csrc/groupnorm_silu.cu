// Fused GroupNorm + SiLU forward (K1) over NHWC activations, for Hopper
// (sm_90a). The backward (K2) is groupnorm_silu_bwd.cu.
//
// Replaces the Pallas TPU kernel `_forward_pallas` / `_fwd_kernel` in
// baddiffusion_tpu/ops/groupnorm.py. Same math: per (batch row, group) the
// mean and rstd come from single-pass f32 sums, var = max(E[x^2] - E[x]^2, 0),
// rstd = rsqrt(var + eps); then y = x_hat * gamma + beta, out = y * sigmoid(y),
// stored in the input dtype. gamma and beta are f32 for both input dtypes, as
// the TPU kernel's are. When asked, it also writes the [B, G] f32 mean and
// rstd (the TPU kernel's `save_stats=True`), which K2 reads back.
//
// What bounds it: bytes. Per element it does about ten f32 operations against
// four bytes moved (bf16 read + write), far below the card's operations per
// byte, so the least time is one read and one write of the activation over
// device memory. One UNet forward of the 32 px scratch model at batch 128 in
// bf16 moves about 1.32 GB through its 65 calls (about 0.39 ms at 3.35 TB/s);
// the largest call, (32, 32, 256), about 134 MB (about 40 us). The 34 calls
// with H*W <= 16 move a few hundred KB each and are bound by launch latency.
//
// Design: one thread block per (batch row, group). A group of an NHWC tensor is
// C/G contiguous channels in each pixel with a stride of C between pixels; the
// block walks it in packs of VEC contiguous channels (up to 16 bytes per load),
// reduces sum and sum of squares with warp shuffles plus shared memory, then
// walks the group again to normalise and write. The second walk re-reads x,
// which at these sizes (the largest group is 32*32*8 elements, 16 KB in bf16)
// comes mostly from L2, so device memory sees about one read and one write.
// Neighbouring blocks are the groups of one pixel row, so the bytes of a
// sector that one group does not use are read by its neighbours from L2.
// Grid = B*G blocks (4096 at B = 128), enough to fill all 132 SMs.

#include "groupnorm.cuh"

namespace {

using bd::gn::kThreads;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    groupnorm_silu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                              const float* __restrict__ beta, T* __restrict__ out,
                              float* __restrict__ mean_out, float* __restrict__ rstd_out, int hw,
                              int c, int groups, float eps) {
  using P = bd::Pack<T, VEC>;
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const int cg = c / groups;
  const int packs_per_pixel = cg / VEC;
  const int n_packs = hw * packs_per_pixel;
  const int64_t base = (int64_t)b * hw * c + (int64_t)g * cg;

  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < n_packs; i += kThreads) {
    const int p = i / packs_per_pixel;
    const int j = (i - p * packs_per_pixel) * VEC;
    const P pk = *reinterpret_cast<const P*>(x + base + (int64_t)p * c + j);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = bd::to_f32(pk.v[k]);
      s += v;
      ss += v * v;
    }
  }
  bd::gn::block_sum2(s, ss);
  const float n = (float)(hw * cg);
  const float mean = s / n;
  const float var = fmaxf(ss / n - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  if (mean_out != nullptr && threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }

  const float* gm = gamma + g * cg;
  const float* bt = beta + g * cg;
  for (int i = threadIdx.x; i < n_packs; i += kThreads) {
    const int p = i / packs_per_pixel;
    const int j = (i - p * packs_per_pixel) * VEC;
    const int64_t off = base + (int64_t)p * c + j;
    const P pk = *reinterpret_cast<const P*>(x + off);
    P o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float xhat = (bd::to_f32(pk.v[k]) - mean) * rstd;
      const float y = xhat * __ldg(gm + j + k) + __ldg(bt + j + k);
      o.v[k] = bd::from_f32<T>(y / (1.f + expf(-y)));
    }
    *reinterpret_cast<P*>(out + off) = o;
  }
}

template <typename T, int VEC>
void launch(const void* x, const float* gamma, const float* beta, void* out, float* mean,
            float* rstd, int batch, int hw, int c, int groups, float eps, cudaStream_t stream) {
  groupnorm_silu_fwd_kernel<T, VEC><<<batch * groups, kThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(out), mean, rstd, hw, c, groups, eps);
}

}  // namespace

// x, out: [batch, hw, c] contiguous (NHWC with H*W flattened); gamma, beta:
// [c] f32; mean, rstd: [batch, groups] f32 outputs, or both null to skip
// them. Returns a cudaError_t code (0 on success).
extern "C" int bd_groupnorm_silu_fwd(const void* x, const float* gamma, const float* beta,
                                     void* out, float* mean, float* rstd, int batch, int hw, int c,
                                     int groups, float eps, int dtype, void* stream_ptr) {
  if (bd::gn::bad_shape(batch, hw, c, groups) || (mean == nullptr) != (rstd == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int cg = c / groups;
  const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)out;
  if (dtype == bd::kFloat32) {
    switch (bd::gn::pick_vec(cg, 4, 4, ptrs)) {
      case 4: launch<float, 4>(x, gamma, beta, out, mean, rstd, batch, hw, c, groups, eps, stream); break;
      case 2: launch<float, 2>(x, gamma, beta, out, mean, rstd, batch, hw, c, groups, eps, stream); break;
      default: launch<float, 1>(x, gamma, beta, out, mean, rstd, batch, hw, c, groups, eps, stream); break;
    }
  } else if (dtype == bd::kBFloat16) {
    switch (bd::gn::pick_vec(cg, 8, 2, ptrs)) {
      case 8: launch<__nv_bfloat16, 8>(x, gamma, beta, out, mean, rstd, batch, hw, c, groups, eps, stream); break;
      case 4: launch<__nv_bfloat16, 4>(x, gamma, beta, out, mean, rstd, batch, hw, c, groups, eps, stream); break;
      case 2: launch<__nv_bfloat16, 2>(x, gamma, beta, out, mean, rstd, batch, hw, c, groups, eps, stream); break;
      default: launch<__nv_bfloat16, 1>(x, gamma, beta, out, mean, rstd, batch, hw, c, groups, eps, stream); break;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
