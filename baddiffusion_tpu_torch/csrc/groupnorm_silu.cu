// Fused GroupNorm + SiLU forward (K1) over NHWC activations, for Hopper
// (sm_90a). The backward (K2) is groupnorm_silu_bwd.cu.
//
// Replaces the Pallas TPU kernel `_forward_pallas` / `_fwd_kernel` in
// baddiffusion_tpu/ops/groupnorm.py. Same math, in the same order: per
// channel f32 sums of x and x^2 first, then per (batch row, group), mean and
// var = max(E[x^2] - E[x]^2, 0), rstd = rsqrt(var + eps); then
// y = (x - mean) * rstd * gamma + beta, out = y / (1 + exp(-y)), stored in the
// input dtype, with exp and the division on the hardware's exp2 and
// reciprocal (f32 output within 2e-6 of the plain version's). gamma and beta
// are f32 for both input dtypes, as the TPU kernel's are. When asked, it also
// writes the [B, G] f32 mean and rstd (the TPU kernel's `save_stats=True`),
// which K2 reads back.
//
// What bounds it: bytes. Per element it does about ten f32 operations against
// four bytes moved (bf16 read + write), far below the card's operations per
// byte, so the least time is one read and one write of the activation over
// device memory. One UNet forward of the 32 px scratch model at batch 128 in
// bf16 moves about 1.32 GB through its 65 calls (about 0.39 ms at 3.35 TB/s);
// the largest call, (32, 32, 256), about 134 MB (about 40 us). The 34 calls
// with H*W <= 16 move a few hundred KB each and are bound by launch latency.
//
// Design: one thread block owns a slab of whole groups of one batch row over
// all its pixels; a pixel's slab is a whole number of 32-byte sectors (or the
// whole row). Its threads form a grid of `cols` pack columns by `rows` pixel
// rows: neighbouring threads load neighbouring 16-byte packs of one pixel's
// slab, then of the next pixel's, so every sector a warp touches is used
// whole, and a thread sees the same channels at every pixel (its gamma/beta
// are loaded once). The first walk keeps each thread's per-channel sums in
// registers and stages the slab in shared memory; the sums are reduced over
// the threads of a channel (shuffles within a warp where a warp holds several
// pixel rows, then shared memory, in a fixed order, so every call gives the
// same bits) and folded into groups, and the second walk normalises from
// shared memory: x is read from device memory once. A slab too large to stage
// (H*W far beyond this model's 32 px) is walked twice from device memory.
// The launch plan (slab width, pack width, threads, shared memory, staging)
// is chosen in Python (ops/groupnorm.py `groupnorm_silu_plan`: the widest
// slab that still gives a block per SM) and checked here.
//
// The design it replaced ran one block of 256 threads per (batch row,
// group), 4096 blocks at B = 128: 8-16 byte loads at a stride of C elements
// used 25-50% of each sector, x was read twice, and at H*W <= 16 most threads
// had no work. It took 2.4565 ms per UNet forward at B = 128 in bf16 against
// the 0.3945 ms bound (chip_smoke.py on an H100 80GB HBM3 at 700 W).

#include "groupnorm.cuh"

namespace {

constexpr int kMaxThreads = 512;         // up to 128 registers a thread: no spills
constexpr int kMaxSmem = 232448;         // dynamic shared memory one block may use on an H100
constexpr int kDefaultSmem = 48 * 1024;  // more needs the kernel's opt-in attribute
constexpr int kMaxDevices = 64;
constexpr int kUnroll = 4;               // pixels a thread loads before it uses them

// Whether a warp holds whole pack columns (cols divides 32), so that the
// block sums each column within a warp by shuffles first.
__host__ __device__ inline bool shuffled(int cols, int threads) {
  return cols < 32 && 32 % cols == 0 && threads % 32 == 0;
}

// Rows of per-channel partial sums the block reduces: one per warp where it
// shuffles, else one per pixel row of threads.
__host__ __device__ inline int partial_rows(int cols, int threads) {
  return shuffled(cols, threads) ? threads / 32 : threads / cols;
}

// Dynamic shared memory of a launch: the staged slab (16-byte aligned), then
// the f32 partial sums [2][partial rows][slab channels] and the group
// statistics [2][slab groups]. ops/groupnorm.py computes the same.
int64_t smem_bytes_needed(int hw, int slab_c, int slab_groups, int elem_bytes, int cols, int threads, bool staged) {
  const int64_t staging = staged ? ((int64_t)hw * slab_c * elem_bytes + 15) / 16 * 16 : 0;
  return staging + 4 * (2 * (int64_t)partial_rows(cols, threads) * slab_c + 2 * (int64_t)slab_groups);
}

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const bd::Pack<T, VEC>& v, float (&sum)[VEC], float (&sq)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float f = bd::to_f32(v.v[k]);
    sum[k] += f;
    sq[k] += f * f;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ bd::Pack<T, VEC> norm_silu(const bd::Pack<T, VEC>& v, const float (&mu)[VEC],
                                                      const float (&rs)[VEC], const float (&gm)[VEC],
                                                      const float (&bt)[VEC]) {
  bd::Pack<T, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float xhat = (bd::to_f32(v.v[k]) - mu[k]) * rs[k];
    const float y = xhat * gm[k] + bt[k];
    o.v[k] = bd::from_f32<T>(__fdividef(y, 1.f + __expf(-y)));  // hardware exp2 and reciprocal
  }
  return o;
}

// Grid: batch * (groups / slab_groups) blocks, block b * slabs + s owning
// slab s of batch row b. blockDim.x = cols * rows, cols = slab channels / VEC.
template <typename T, int VEC, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads)
    groupnorm_silu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                              const float* __restrict__ beta, T* __restrict__ out,
                              float* __restrict__ mean_out, float* __restrict__ rstd_out, int hw, int c,
                              int groups, int slab_groups, float eps) {
  using P = bd::Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cg = c / groups;
  const int slab_c = slab_groups * cg;
  const int cols = slab_c / VEC;
  const int rows = blockDim.x / cols;
  const int col = threadIdx.x % cols;
  const int row = threadIdx.x / cols;
  const int slabs = groups / slab_groups;
  const int b = blockIdx.x / slabs;
  const int s = blockIdx.x - b * slabs;
  const int ch0 = s * slab_c + col * VEC;  // this thread's first channel
  const int64_t base = (int64_t)b * hw * c + ch0;
  P* stage = reinterpret_cast<P*>(smem);  // pixel p's slab at packs [p * cols, (p + 1) * cols)
  const bool by_warp = shuffled(cols, blockDim.x);
  const int npr = partial_rows(cols, blockDim.x);
  const int64_t staging = STAGED ? ((int64_t)hw * slab_c * sizeof(T) + 15) / 16 * 16 : 0;
  float* part = reinterpret_cast<float*>(smem + staging);  // [2][npr][slab_c]
  float* stat = part + 2 * npr * slab_c;                  // [2][slab_groups]

  float sum[VEC], sq[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sum[k] = 0.f;
    sq[k] = 0.f;
  }

  // walk 1: sums per channel, and the slab staged in shared memory; a
  // thread issues the loads of kUnroll pixels before it uses them
  for (int p = row; p < hw; p += kUnroll * rows) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * rows < hw) v[u] = *reinterpret_cast<const P*>(x + base + (int64_t)(p + u * rows) * c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * rows < hw) {
        if (STAGED) stage[(p + u * rows) * cols + col] = v[u];
        accumulate(v[u], sum, sq);
      }
    }
  }

  // per-channel partials: lanes of one column summed within the warp, or one
  // row of partials per pixel row of threads
  int prow = row;
  bool writes = true;
  if (by_warp) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      for (int off = cols; off < 32; off <<= 1) {
        sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], off);
        sq[k] += __shfl_xor_sync(0xffffffffu, sq[k], off);
      }
    }
    prow = threadIdx.x >> 5;
    writes = (threadIdx.x & 31) < cols;
  }
  if (writes) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      part[prow * slab_c + col * VEC + k] = sum[k];
      part[(npr + prow) * slab_c + col * VEC + k] = sq[k];
    }
  }
  __syncthreads();
  // each channel's total over the partial rows, in row order, into row 0
  for (int cc = threadIdx.x; cc < slab_c; cc += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < npr; ++r) {
      a += part[r * slab_c + cc];
      q += part[(npr + r) * slab_c + cc];
    }
    part[cc] = a;
    part[npr * slab_c + cc] = q;
  }
  __syncthreads();
  // each group's statistics from its channels' totals, in channel order
  const float n = (float)(hw * cg);
  for (int j = threadIdx.x; j < slab_groups; j += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int cc = j * cg; cc < (j + 1) * cg; ++cc) {
      a += part[cc];
      q += part[npr * slab_c + cc];
    }
    const float mean = a / n;
    const float var = fmaxf(q / n - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    stat[j] = mean;
    stat[slab_groups + j] = rstd;
    if (mean_out != nullptr) {
      const int gi = b * groups + s * slab_groups + j;
      mean_out[gi] = mean;
      rstd_out[gi] = rstd;
    }
  }
  __syncthreads();

  float mu[VEC], rs[VEC], gm[VEC], bt[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int j = (col * VEC + k) / cg;
    mu[k] = stat[j];
    rs[k] = stat[slab_groups + j];
    gm[k] = __ldg(gamma + ch0 + k);
    bt[k] = __ldg(beta + ch0 + k);
  }
  // walk 2: normalise and write, from the staged slab (or x again)
  for (int p = row; p < hw; p += kUnroll * rows) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * rows < hw) {
        v[u] = STAGED ? stage[(p + u * rows) * cols + col]
                      : *reinterpret_cast<const P*>(x + base + (int64_t)(p + u * rows) * c);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * rows < hw) {
        *reinterpret_cast<P*>(out + base + (int64_t)(p + u * rows) * c) = norm_silu(v[u], mu, rs, gm, bt);
      }
    }
  }
}

struct Launch {
  const void* x;
  const float* gamma;
  const float* beta;
  void* out;
  float* mean;
  float* rstd;
  int batch, hw, c, groups, slab_groups, threads, smem;
  float eps;
  cudaStream_t stream;
};

template <typename T, int VEC, bool STAGED>
cudaError_t launch(const Launch& a) {
  const auto kernel = groupnorm_silu_fwd_kernel<T, VEC, STAGED>;
  if (a.smem > kDefaultSmem) {  // opt in to the large shared memory, once per device
    static bool opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || !opted_in[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) opted_in[dev] = true;
    }
  }
  kernel<<<a.batch * (a.groups / a.slab_groups), a.threads, a.smem, a.stream>>>(
      static_cast<const T*>(a.x), a.gamma, a.beta, static_cast<T*>(a.out), a.mean, a.rstd, a.hw, a.c, a.groups,
      a.slab_groups, a.eps);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_staged(const Launch& a, bool staged) {
  return staged ? launch<T, VEC, true>(a) : launch<T, VEC, false>(a);
}

template <typename T>
cudaError_t dispatch(const Launch& a, int vec, bool staged) {
  switch (vec) {
    case 1: return launch_staged<T, 1>(a, staged);
    case 2: return launch_staged<T, 2>(a, staged);
    case 4: return launch_staged<T, 4>(a, staged);
    default:
      if constexpr (sizeof(T) * 8 <= 16) {
        return launch_staged<T, 8>(a, staged);
      } else {
        return cudaErrorInvalidValue;
      }
  }
}

}  // namespace

// x, out: [batch, hw, c] contiguous (NHWC with H*W flattened); gamma, beta:
// [c] f32; mean, rstd: [batch, groups] f32 outputs, or both null to skip
// them. The launch plan: slab_groups groups per block, packs of vec
// elements, threads per block (a multiple of the slab's pack columns),
// smem_bytes of dynamic shared memory (exactly what the plan needs), staged
// (1: the slab goes through shared memory, 0: x is read twice). Returns a
// cudaError_t code (0 on success); a plan that does not fit the shape or
// the pointers' alignment is cudaErrorInvalidValue. Launches on `device`,
// the tensors' (bd::DeviceGuard), in the stream `stream_ptr`.
extern "C" int bd_groupnorm_silu_fwd(const void* x, const float* gamma, const float* beta, void* out,
                                     float* mean, float* rstd, int batch, int hw, int c, int groups,
                                     int slab_groups, int vec, int threads, int smem_bytes, int staged,
                                     float eps, int dtype, int device, void* stream_ptr) {
  if (bd::gn::bad_shape(batch, hw, c, groups) || (mean == nullptr) != (rstd == nullptr) ||
      (dtype != bd::kFloat32 && dtype != bd::kBFloat16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int elem_bytes = dtype == bd::kFloat32 ? 4 : 2;
  const int cg = c / groups;
  if (slab_groups <= 0 || groups % slab_groups != 0) return (int)cudaErrorInvalidValue;
  const int slab_c = slab_groups * cg;
  if (vec <= 0 || (vec & (vec - 1)) != 0 || vec * elem_bytes > 16 || slab_c % vec != 0 ||
      ((uintptr_t)x | (uintptr_t)out) % (uintptr_t)(vec * elem_bytes) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int cols = slab_c / vec;
  if (threads <= 0 || threads > kMaxThreads || threads % cols != 0 || smem_bytes > kMaxSmem ||
      smem_bytes != smem_bytes_needed(hw, slab_c, slab_groups, elem_bytes, cols, threads, staged != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const bd::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Launch a{x, gamma, beta, out, mean, rstd, batch, hw, c, groups, slab_groups, threads, smem_bytes, eps,
                 static_cast<cudaStream_t>(stream_ptr)};
  return (int)(dtype == bd::kFloat32 ? dispatch<float>(a, vec, staged != 0)
                                     : dispatch<__nv_bfloat16>(a, vec, staged != 0));
}
