// Self-attention forward, softmax(q k^T * scale) v over [B, H, T, D], for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_forward_pallas` / `_kernel` in
// baddiffusion_tpu/ops/attention.py. Scores, softmax and the weighted sum stay
// in f32; no [T, T] tensor is written to memory; the output is stored in the
// input dtype. Envelope as in the TPU module: T <= 1024, D a multiple of 8 in
// [8, 512].
//
// What bounds it: on the 32 px scratch UNet the calls are [B, 64, 4, 8] and
// [B, 64, 1, 8], about 2 MB of q, k, v and o per call at B = 128 in bf16:
// far too little work to fill the card, so launch latency bounds them. At the
// envelope's long end (T = 1024) the 4*T*T*D multiply-adds bound it.
//
// Design: the Pallas kernel held a whole [T, T] score block in VMEM; here a
// warp walks the keys with an online softmax (running max and running sum), so
// nothing of size T*T exists anywhere. L lanes own one query row (L = 8 for
// D = 8, 16 for D = 16, else 32), each holding E = ceil(D / L) of its q and
// output accumulators, so a warp serves 32 / L rows at once. A row's score is
// a partial dot product per lane, summed with xor shuffles inside its L-lane
// group. The warps of a block serve consecutive rows of one (b, h) and share
// tiles of K and V staged in shared memory as f32, so each key is read from
// device memory once per block rather than once per row.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 4;
constexpr int kSmemFloats = 8192;  // K and V tiles together: 32 KB

template <typename T, int L, int E>
__global__ void __launch_bounds__(kMaxWarps * 32)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int t_len, int d,
                         float scale, int tile) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + tile * d;
  constexpr int kRowsPerWarp = 32 / L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = lane % L;
  const int rows_per_block = (blockDim.x >> 5) * kRowsPerWarp;
  const int row = blockIdx.y * rows_per_block + warp * kRowsPerWarp + lane / L;
  const bool active = row < t_len;
  const int64_t head = (int64_t)blockIdx.x * t_len * d;

  float qv[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int dd = e * L + l;
    qv[e] = (active && dd < d) ? bd::to_f32(q[head + (int64_t)row * d + dd]) : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY;
  float lsum = 0.f;

  for (int k0 = 0; k0 < t_len; k0 += tile) {
    const int n = min(tile, t_len - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
      ks[i] = bd::to_f32(k[head + (int64_t)k0 * d + i]);
      vs[i] = bd::to_f32(v[head + (int64_t)k0 * d + i]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int dd = e * L + l;
        if (dd < d) s += qv[e] * ks[j * d + dd];
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);  // 0 on the first key, where m = -inf
      const float p = expf(s - m_new);
      lsum = lsum * corr + p;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int dd = e * L + l;
        if (dd < d) acc[e] = acc[e] * corr + p * vs[j * d + dd];
      }
      m = m_new;
    }
  }

  if (active) {
    const float inv = 1.f / lsum;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int dd = e * L + l;
      if (dd < d) o[head + (int64_t)row * d + dd] = bd::from_f32<T>(acc[e] * inv);
    }
  }
}

template <typename T, int L, int E>
void launch(const void* q, const void* k, const void* v, void* o, int bh, int t_len, int d,
            float scale, cudaStream_t stream) {
  constexpr int kRowsPerWarp = 32 / L;
  const int warps = min(kMaxWarps, (t_len + kRowsPerWarp - 1) / kRowsPerWarp);
  const int rows_per_block = warps * kRowsPerWarp;
  const int tile = min(t_len, kSmemFloats / (2 * d));
  const dim3 grid(bh, (t_len + rows_per_block - 1) / rows_per_block);
  const size_t smem = sizeof(float) * 2 * tile * d;
  attention_fwd_kernel<T, L, E><<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), t_len, d, scale, tile);
}

template <typename T>
void dispatch(const void* q, const void* k, const void* v, void* o, int bh, int t_len, int d,
              float scale, cudaStream_t stream) {
  if (d == 8) {
    launch<T, 8, 1>(q, k, v, o, bh, t_len, d, scale, stream);
  } else if (d == 16) {
    launch<T, 16, 1>(q, k, v, o, bh, t_len, d, scale, stream);
  } else {
    const int e = (d + 31) / 32;
    if (e <= 1) launch<T, 32, 1>(q, k, v, o, bh, t_len, d, scale, stream);
    else if (e <= 2) launch<T, 32, 2>(q, k, v, o, bh, t_len, d, scale, stream);
    else if (e <= 4) launch<T, 32, 4>(q, k, v, o, bh, t_len, d, scale, stream);
    else if (e <= 8) launch<T, 32, 8>(q, k, v, o, bh, t_len, d, scale, stream);
    else launch<T, 32, 16>(q, k, v, o, bh, t_len, d, scale, stream);
  }
}

}  // namespace

// q, k, v, o: [bh, t_len, d] contiguous, all one dtype. Returns a cudaError_t
// code (0 on success).
extern "C" int bd_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                                int t_len, int d, float scale, int dtype, void* stream_ptr) {
  if (bh <= 0 || t_len < 1 || t_len > 1024 || d < 8 || d > 512 || d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == bd::kFloat32) {
    dispatch<float>(q, k, v, o, bh, t_len, d, scale, stream);
  } else if (dtype == bd::kBFloat16) {
    dispatch<__nv_bfloat16>(q, k, v, o, bh, t_len, d, scale, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
