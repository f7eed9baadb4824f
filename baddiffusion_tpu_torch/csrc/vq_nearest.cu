// Nearest codebook row of each latent vector, for Hopper (sm_90a): the
// VQ-VAE's quantizer (ops/vq.py, models/vae.py `VectorQuantizer`).
//
// Replaces no Pallas kernel: the JAX package builds the whole [N, K] distance
// matrix ‖z‖² + ‖e‖² − 2 z·eᵀ with XLA and takes its argmin. At the LDM
// measure's batch of 256, N = 256·64·64 = 1,048,576 vectors against K = 8192
// codes, so one [N, K] f32 temporary is 32 GiB and the expression keeps three
// alive. This kernel allocates nothing of size N·K:
//   idx[i] = argmin_j (‖e_j‖² − 2 z_i·e_j),   zq[i] = codebook[idx[i]]
// in f32 (‖z_i‖² is the same for every code of a vector and moves no argmin),
// the lowest index among exact ties, as torch.argmin breaks them.
//
// What bounds it: operations. Three FMAs and one minimum a (vector, code)
// pair, 8.6 G pairs at the measure's shape; z is read once and idx (int64)
// and zq written once, 33.5 MB.
//
// Vectors of kDim = 3, the vq_embed_dim of every VQ-VAE configuration of the
// repo; the entry point refuses any other.
//
// Design: a thread owns V vectors, their −2z (exact) in registers. A block of
// kThreads threads walks the codebook in tiles of `tile` codes staged in
// shared memory as float4 rows (e_0, e_1, e_2, ‖e‖²); every thread of a warp
// reads the same row, a broadcast. A tile is walked in chunks of kChunk
// codes: each vector keeps the chunk's least distance (fminf), and a chunk
// whose least distance is strictly below the best so far becomes the
// vector's best chunk. At a
// tile's end, a vector whose best chunk lies in that tile walks the chunk
// again for the first code at that distance (the same FMA sequence, so the
// same bits). So the argmin stays in registers at one compare a pair. Codes
// past K in the last tile are rows of zeros at ‖e‖² = +inf, which no vector
// takes. No atomics and no exchange between blocks: the same bits on every
// run. The launch plan (vectors a thread, blocks, the tile) is chosen in
// Python (`vq_nearest_plan`) and checked here. It launches on the caller's
// stream, allocates nothing and never synchronises.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;             // codes whose minimum a vector takes before it compares with its best
constexpr int kDim = 3;                // the vectors' length
constexpr int kSmemBytes = 32 * 1024;  // a tile's staged rows

// ‖e‖² − 2 z·e from the staged row (e_0, e_1, e_2, ‖e‖²) and m = −2z.
__device__ __forceinline__ float distance(const float (&m)[kDim], const float4 e) {
  return fmaf(m[2], e.z, fmaf(m[1], e.y, fmaf(m[0], e.x, e.w)));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    vq_nearest_kernel(const float* __restrict__ z, const float* __restrict__ codebook, int64_t* __restrict__ idx,
                      float* __restrict__ zq, int64_t n, int k, int tile) {
  extern __shared__ float4 staged[];  // [tile]
  const int64_t first = (int64_t)blockIdx.x * (kThreads * V) + threadIdx.x;
  float m[V][kDim];
  float best[V];
  int best_idx[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t i = first + (int64_t)v * kThreads;
#pragma unroll
    for (int d = 0; d < kDim; ++d) m[v][d] = i < n ? -2.f * z[i * kDim + d] : 0.f;
    best[v] = INFINITY;
    best_idx[v] = 0;
  }
  for (int t0 = 0; t0 < k; t0 += tile) {
    const int count = min(tile, k - t0);
    const int padded = (count + kChunk - 1) / kChunk * kChunk;
    __syncthreads();  // every thread is done with the last tile
    for (int j = threadIdx.x; j < padded; j += kThreads) {
      float4 row = make_float4(0.f, 0.f, 0.f, INFINITY);
      if (j < count) {
        const float* e = codebook + (int64_t)(t0 + j) * kDim;
        row = make_float4(e[0], e[1], e[2], fmaf(e[2], e[2], fmaf(e[1], e[1], e[0] * e[0])));
      }
      staged[j] = row;
    }
    __syncthreads();
    int best_chunk[V];
#pragma unroll
    for (int v = 0; v < V; ++v) best_chunk[v] = -1;
    for (int c0 = 0; c0 < padded; c0 += kChunk) {
      float least[V];
#pragma unroll
      for (int v = 0; v < V; ++v) least[v] = INFINITY;
#pragma unroll 8
      for (int j = c0; j < c0 + kChunk; ++j) {
        const float4 row = staged[j];
#pragma unroll
        for (int v = 0; v < V; ++v) least[v] = fminf(least[v], distance(m[v], row));
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (least[v] < best[v]) {
          best[v] = least[v];
          best_chunk[v] = c0;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (best_chunk[v] >= 0) {
        for (int j = best_chunk[v]; j < best_chunk[v] + kChunk; ++j) {
          if (distance(m[v], staged[j]) == best[v]) {
            best_idx[v] = t0 + j;
            break;
          }
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t i = first + (int64_t)v * kThreads;
    if (i < n) {
      idx[i] = best_idx[v];
      const float* e = codebook + (int64_t)best_idx[v] * kDim;
#pragma unroll
      for (int d = 0; d < kDim; ++d) zq[i * kDim + d] = e[d];
    }
  }
}

template <int V>
cudaError_t launch(const float* z, const float* codebook, int64_t* idx, float* zq, int64_t n, int k, int tile,
                   int blocks, cudaStream_t stream) {
  vq_nearest_kernel<V><<<blocks, kThreads, tile * sizeof(float4), stream>>>(z, codebook, idx, zq, n, k, tile);
  return cudaGetLastError();
}

}  // namespace

// z: [n, 3] f32 contiguous; codebook: [k, 3] f32 contiguous; idx: the int64
// [n] result; zq: the f32 [n, 3] result. The launch plan: vecs vectors a
// thread (1, 2, 4 or 8), kThreads threads a block, `blocks` blocks covering
// n exactly (the last one ragged), tiles of `tile` codes (a multiple of
// kChunk whose staged rows fit kSmemBytes). Returns a cudaError_t code (0 on
// success); a plan that does not fit the shape, or d other than kDim, is
// cudaErrorInvalidValue. Launches on `device`, the tensors'
// (bd::DeviceGuard), in `stream_ptr`.
extern "C" int bd_vq_nearest(const float* z, const float* codebook, int64_t* idx, float* zq, int64_t n, int k,
                             int d, int vecs, int threads, int blocks, int tile, int device, void* stream_ptr) {
  const int64_t per_block = (int64_t)threads * vecs;
  if (n <= 0 || k <= 0 || d != kDim || threads != kThreads || vecs <= 0 || blocks <= 0 ||
      (int64_t)blocks * per_block < n || (int64_t)(blocks - 1) * per_block >= n || tile <= 0 ||
      tile % kChunk != 0 || tile * (int)sizeof(float4) > kSmemBytes) {
    return (int)cudaErrorInvalidValue;
  }
  const bd::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  switch (vecs) {
    case 1: return (int)launch<1>(z, codebook, idx, zq, n, k, tile, blocks, stream);
    case 2: return (int)launch<2>(z, codebook, idx, zq, n, k, tile, blocks, stream);
    case 4: return (int)launch<4>(z, codebook, idx, zq, n, k, tile, blocks, stream);
    case 8: return (int)launch<8>(z, codebook, idx, zq, n, k, tile, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
