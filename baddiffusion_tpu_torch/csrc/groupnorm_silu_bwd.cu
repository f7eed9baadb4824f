// Fused GroupNorm + SiLU backward (K2) over NHWC activations, for Hopper
// (sm_90a). The forward (K1) is groupnorm_silu.cu.
//
// Replaces the Pallas TPU kernel `_backward_pallas` / `_bwd_kernel` in
// baddiffusion_tpu/ops/groupnorm.py. From x, the output cotangent g and the
// [B, G] mean/rstd that K1 saved:
//   x_hat = (x - mean) * rstd, y = x_hat * gamma + beta,
//   s = sigmoid(y), dy = g * s * (1 + y * (1 - s))
//   dbeta_c = sum_{b,hw} dy,  dgamma_c = sum_{b,hw} dy * x_hat
//   dx = rstd * (dx_hat - m1 - x_hat * m2),  dx_hat = dy * gamma,
//   m1 = mean over the group of dx_hat, m2 = mean of dx_hat * x_hat.
// m1 and m2 follow from one batch row's per-channel sums, as in the TPU
// kernel (per-channel sums first, then groups): m1_g = sum_{c in g} gamma_c *
// sum dy_c / n, m2_g = sum_{c in g} gamma_c * sum (dy * x_hat)_c / n. dx is
// stored in x's dtype; dgamma/dbeta are f32, as the TPU kernel's. x_hat and
// y keep that order; the sigmoid runs on the hardware's exp2 and reciprocal
// (`ex2.approx.ftz`, `rcp.approx.ftz`), g * SiLU'(y) is two FMAs after it,
// and dx is two FMAs on per-channel coefficients (rstd * gamma, -rstd * m2,
// -rstd * m1): f32 dx stays within 1e-5 of the plain version's.
//
// What bounds it: bytes, with the arithmetic close behind. It must read x
// and g and write dx: six bytes an element in bf16. One train step of the
// 32 px scratch UNet at batch 128 runs 65 calls over 330.4 M elements,
// 1.98 GB, about 0.59 ms at 3.35 TB/s. SiLU' is needed in both walks (the
// second walk recomputes it from the staged x and g): about 40 instructions
// and 4 special-function operations an element, roughly 0.4 ms of
// instruction dispatch and 0.3 ms of the special-function units over the
// step at the card's peak rates, so the design keeps the per-element
// instructions down as well as the bytes. The calls with H*W <= 16 move a
// few hundred KB each and are bound by launch latency.
//
// Design (K1's, carried over): one thread block owns a slab of whole groups
// of one batch row over all its pixels; a pixel's slab is a whole number of
// 32-byte sectors (or the whole row). Its threads form a grid of `cols` pack
// columns by `rows` pixel rows: neighbouring threads load neighbouring packs
// of x and of g at the same offsets, so every sector a warp touches is used
// whole, and a thread sees the same channels at every pixel (its
// gamma/beta/mean/rstd are loaded once). A pack is four elements (8 bytes
// in bf16), so the per-channel registers of a thread stay few; only a slab
// wider than 512 such packs takes 8-element packs. The first walk keeps
// only the per-channel sums of dy and dy * x_hat in registers and stages
// the slab of x and g in shared memory; the sums are reduced over the
// threads of a channel in a fixed order (shuffles within a warp where a
// warp holds whole pack columns, then shared memory), written out as the
// row's dgamma/dbeta, and folded into the group sums m1, m2, in channel
// order. The second walk writes dx from shared memory: x and g are
// read from device memory once and dx is written once. A slab too large to
// stage (128 px and beyond) is walked twice from device memory. The launch
// plan (slab width, pack width, threads, shared memory, staging) is chosen
// in Python (ops/groupnorm.py `groupnorm_silu_backward_plan`, K1's rules
// with K2's staged bytes and pack width) and checked here.
//
// dgamma/dbeta are sums over the batch, which the TPU kernel carried across
// its sequential grid. Here blocks run in parallel, so each block writes its
// row's per-channel sums into an f32 [B, 2C] workspace, and a second small
// kernel sums the workspace over B in a fixed order. No atomics: dx, dgamma
// and dbeta are the same bits on every run.
//
// The design it replaced ran one block of 256 threads per (batch row,
// group), 4096 blocks at B = 128: 8-16 byte loads at a stride of C elements
// used 25-50% of each sector, x and g were read twice, SiLU' ran twice per
// element on the accurate expf and division, and at H*W <= 16 most threads
// had no work. It took 4.3492 ms per train step at B = 128 in bf16 against
// the 0.5925 ms bound (chip_smoke.py on an H100 80GB HBM3 at 700 W).

#include "groupnorm.cuh"

namespace {

constexpr int kMaxThreads = 512;         // a block of 512 pack columns; at most 128 registers a thread
constexpr int kMaxSmem = 232448;         // dynamic shared memory one block may use on an H100
constexpr int kDefaultSmem = 48 * 1024;  // more needs the kernel's opt-in attribute
constexpr int kMaxDevices = 64;

// Pixels a thread loads before it uses them: four, or two with 8-element
// packs (bf16 groups wider than 2048 channels), which would spill otherwise.
template <int VEC>
constexpr int kUnrollOf = VEC == 8 ? 2 : 4;

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

__host__ __device__ inline int64_t align16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// Dynamic shared memory of a launch: the staged slab of x, then of g, each
// 16-byte aligned, then the f32 partial sums [2][partial rows][slab
// channels] and the group sums [2][slab groups]. ops/groupnorm.py computes
// the same.
int64_t smem_bytes_needed(int hw, int slab_c, int slab_groups, int elem_bytes, int cols, int threads, bool staged) {
  const int64_t staging = staged ? 2 * align16((int64_t)hw * slab_c * elem_bytes) : 0;
  return staging + 4 * (2 * (int64_t)partial_rows(cols, threads) * slab_c + 2 * (int64_t)slab_groups);
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// g * SiLU'(y) = g * s * (1 + y * (1 - s)) = gs + gs * (y - y * s), gs = g * s.
__device__ __forceinline__ float dsilu(float y, float g) {
  const float s = rcp_ftz(1.f + ex2_ftz(y * -1.4426950408889634f));  // sigmoid(y)
  const float gs = g * s;
  return fmaf(gs, fmaf(-y, s, y), gs);
}

// Grid: batch * (groups / slab_groups) blocks, block b * slabs + s owning
// slab s of batch row b. blockDim.x = cols * rows, cols = slab channels / VEC.
template <typename T, int VEC, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads)
    groupnorm_silu_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                              const float* __restrict__ beta, const float* __restrict__ mean_g,
                              const float* __restrict__ rstd_g, const T* __restrict__ gout,
                              T* __restrict__ dx, float* __restrict__ partial, int hw, int c, int groups,
                              int slab_groups) {
  using P = bd::Pack<T, VEC>;
  constexpr int kUnroll = kUnrollOf<VEC>;
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
  const int ch0 = s * slab_c + col * VEC;       // this thread's first channel
  const int g0 = b * groups + s * slab_groups;  // the slab's first group in [B, G]
  const int64_t slab_bytes = STAGED ? align16((int64_t)hw * slab_c * sizeof(T)) : 0;
  // each staged tensor: pixel p's slab at packs [p * cols, (p + 1) * cols)
  P* stage_x = reinterpret_cast<P*>(smem);
  P* stage_g = reinterpret_cast<P*>(smem + slab_bytes);
  const bool by_warp = shuffled(cols, blockDim.x);
  const int npr = partial_rows(cols, blockDim.x);
  float* part = reinterpret_cast<float*>(smem + 2 * slab_bytes);  // [2][npr][slab_c]
  float* stat = part + 2 * npr * slab_c;                          // [2][slab_groups]
  // the thread's pixels are row, row + rows, ...: its q-th at offset
  // first + q * step of x, g and dx, staged at pack q * blockDim.x + threadIdx.x
  const int npix = row < hw ? (hw - 1 - row) / rows + 1 : 0;
  const int64_t first = (int64_t)b * hw * c + (int64_t)row * c + ch0;
  const int64_t step = (int64_t)rows * c;

  float mu[VEC], rs[VEC], gm[VEC], bt[VEC], dg[VEC], db[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int j = (col * VEC + k) / cg;
    mu[k] = __ldg(mean_g + g0 + j);
    rs[k] = __ldg(rstd_g + g0 + j);
    gm[k] = __ldg(gamma + ch0 + k);
    bt[k] = __ldg(beta + ch0 + k);
    dg[k] = 0.f;
    db[k] = 0.f;
  }

  // walk 1: per-channel sums of dy and dy * x_hat, and the slab staged in
  // shared memory; a thread starts the loads of kUnroll pixels before it
  // uses them
  const T* xq = x + first;
  const T* gq = gout + first;
  for (int q = 0; q < npix; q += kUnroll, xq += kUnroll * step, gq += kUnroll * step) {
    P xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q + u < npix) {
        xv[u] = *reinterpret_cast<const P*>(xq + u * step);
        gv[u] = *reinterpret_cast<const P*>(gq + u * step);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q + u < npix) {
        if (STAGED) {
          stage_x[(q + u) * blockDim.x + threadIdx.x] = xv[u];
          stage_g[(q + u) * blockDim.x + threadIdx.x] = gv[u];
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xhat = (bd::to_f32(xv[u].v[k]) - mu[k]) * rs[k];
          const float dy = dsilu(xhat * gm[k] + bt[k], bd::to_f32(gv[u].v[k]));
          db[k] += dy;
          dg[k] += dy * xhat;
        }
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
        dg[k] += __shfl_xor_sync(0xffffffffu, dg[k], off);
        db[k] += __shfl_xor_sync(0xffffffffu, db[k], off);
      }
    }
    prow = threadIdx.x >> 5;
    writes = (threadIdx.x & 31) < cols;
  }
  if (writes) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      part[prow * slab_c + col * VEC + k] = dg[k];
      part[(npr + prow) * slab_c + col * VEC + k] = db[k];
    }
  }
  __syncthreads();
  // each channel's total over the partial rows, in row order: into row 0,
  // and out as this batch row's dgamma, dbeta
  float* row_out = partial + (int64_t)b * 2 * c + s * slab_c;
  for (int cc = threadIdx.x; cc < slab_c; cc += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < npr; ++r) {
      a += part[r * slab_c + cc];
      q += part[(npr + r) * slab_c + cc];
    }
    part[cc] = a;
    part[npr * slab_c + cc] = q;
    row_out[cc] = a;
    row_out[c + cc] = q;
  }
  __syncthreads();
  // each group's m1, m2 from its channels' totals, in channel order
  const float n = (float)(hw * cg);
  for (int j = threadIdx.x; j < slab_groups; j += blockDim.x) {
    float m1 = 0.f, m2 = 0.f;
    for (int cc = j * cg; cc < (j + 1) * cg; ++cc) {
      const float gmc = __ldg(gamma + s * slab_c + cc);
      m1 += gmc * part[npr * slab_c + cc];
      m2 += gmc * part[cc];
    }
    stat[j] = m1 / n;
    stat[slab_groups + j] = m2 / n;
  }
  __syncthreads();

  // dx = rstd * (dy * gamma - m1 - x_hat * m2) = a1 * dy + (a2 * x_hat + a0)
  float a1[VEC], a2[VEC], a0[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int j = (col * VEC + k) / cg;
    a1[k] = rs[k] * gm[k];
    a2[k] = -rs[k] * stat[slab_groups + j];
    a0[k] = -rs[k] * stat[j];
  }
  // walk 2: dx, from the staged slab (or x and g again)
  xq = x + first;
  gq = gout + first;
  T* dq = dx + first;
  for (int q = 0; q < npix; q += kUnroll, xq += kUnroll * step, gq += kUnroll * step, dq += kUnroll * step) {
    P xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q + u < npix) {
        if (STAGED) {
          xv[u] = stage_x[(q + u) * blockDim.x + threadIdx.x];
          gv[u] = stage_g[(q + u) * blockDim.x + threadIdx.x];
        } else {
          xv[u] = *reinterpret_cast<const P*>(xq + u * step);
          gv[u] = *reinterpret_cast<const P*>(gq + u * step);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q + u < npix) {
        P o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xhat = (bd::to_f32(xv[u].v[k]) - mu[k]) * rs[k];
          const float dy = dsilu(xhat * gm[k] + bt[k], bd::to_f32(gv[u].v[k]));
          o.v[k] = bd::from_f32<T>(fmaf(a1[k], dy, fmaf(a2[k], xhat, a0[k])));
        }
        *reinterpret_cast<P*>(dq + u * step) = o;
      }
    }
  }
}

constexpr int kSumThreads = 256;
constexpr int kSumCols = 32;                        // columns of a block: one warp's coalesced row
constexpr int kSumSlices = kSumThreads / kSumCols;  // threads that share a column

// out[j] = sum over r of in[r, j] in a fixed order: thread slice s of column
// j sums rows s, s + kSumSlices, ..., then slice 0 adds the slices in order.
__global__ void __launch_bounds__(kSumThreads)
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

struct Launch {
  const void* x;
  const float* gamma;
  const float* beta;
  const float* mean;
  const float* rstd;
  const void* gout;
  void* dx;
  float* partial;
  int batch, hw, c, groups, slab_groups, threads, smem;
  cudaStream_t stream;
};

template <typename T, int VEC, bool STAGED>
cudaError_t launch(const Launch& a) {
  const auto kernel = groupnorm_silu_bwd_kernel<T, VEC, STAGED>;
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
      static_cast<const T*>(a.x), a.gamma, a.beta, a.mean, a.rstd, static_cast<const T*>(a.gout),
      static_cast<T*>(a.dx), a.partial, a.hw, a.c, a.groups, a.slab_groups);
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
      if constexpr (sizeof(T) == 2) {
        return launch_staged<T, 8>(a, staged);
      } else {
        return cudaErrorInvalidValue;
      }
  }
}

}  // namespace

// x, gout, dx: [batch, hw, c] contiguous in `dtype`; gamma, beta: [c] f32;
// mean, rstd: [batch, groups] f32 from the forward; partial: an f32
// [batch, 2c] workspace; dgamma_dbeta: the f32 [2c] result, dgamma then
// dbeta. The launch plan: slab_groups groups per block, packs of vec
// elements, threads per block (a multiple of the slab's pack
// columns), smem_bytes of dynamic shared memory (exactly what the plan
// needs), staged (1: x and gout go through shared memory, 0: they are read
// twice). Returns a cudaError_t code (0 on success); a plan that does not
// fit the shape or the pointers' alignment is cudaErrorInvalidValue.
// Launches on `device`, the tensors' (bd::DeviceGuard), in `stream_ptr`.
extern "C" int bd_groupnorm_silu_bwd(const void* x, const float* gamma, const float* beta,
                                     const float* mean, const float* rstd, const void* gout, void* dx,
                                     float* partial, float* dgamma_dbeta, int batch, int hw, int c, int groups,
                                     int slab_groups, int vec, int threads, int smem_bytes, int staged, int dtype,
                                     int device, void* stream_ptr) {
  if (bd::gn::bad_shape(batch, hw, c, groups) || (int64_t)batch * 2 * c > 0x7fffffff ||
      (dtype != bd::kFloat32 && dtype != bd::kBFloat16) || (staged != 0 && staged != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int elem_bytes = dtype == bd::kFloat32 ? 4 : 2;
  const int cg = c / groups;
  if (slab_groups <= 0 || groups % slab_groups != 0) return (int)cudaErrorInvalidValue;
  const int slab_c = slab_groups * cg;
  if (vec <= 0 || (vec & (vec - 1)) != 0 || vec * elem_bytes > 16 || slab_c % vec != 0 ||
      ((uintptr_t)x | (uintptr_t)gout | (uintptr_t)dx) % (uintptr_t)(vec * elem_bytes) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int cols = slab_c / vec;
  if (threads <= 0 || threads > kMaxThreads || threads % cols != 0 || smem_bytes > kMaxSmem ||
      smem_bytes != smem_bytes_needed(hw, slab_c, slab_groups, elem_bytes, cols, threads, staged != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const bd::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Launch a{x,     gamma, beta,  mean, rstd, gout, dx, partial, batch, hw, c, groups, slab_groups,
                 threads, smem_bytes, static_cast<cudaStream_t>(stream_ptr)};
  const cudaError_t err = dtype == bd::kFloat32 ? dispatch<float>(a, vec, staged != 0)
                                                : dispatch<__nv_bfloat16>(a, vec, staged != 0);
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<(2 * c + kSumCols - 1) / kSumCols, kSumThreads, 0, a.stream>>>(partial, dgamma_dbeta, batch,
                                                                                   2 * c);
  return (int)cudaGetLastError();
}
