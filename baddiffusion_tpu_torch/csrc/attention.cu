// Self-attention forward, softmax(q k^T * scale) v over [B, H, T, D], for
// Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel `_forward_pallas` / `_kernel` in
// baddiffusion_tpu/ops/attention.py, which keeps one (b, h)'s whole [T, T]
// score block in VMEM and runs both products on the MXU. Here no [T, T]
// tensor exists anywhere: the softmax is exact over registers (packed) or
// online over key tiles (tiled, rowwise). Envelope: T <= 4096 (the VQ-VAE's
// mid block at a 64x64 latent, [B, 1, 4096, 512], the longest sequence of any
// model of the repo), D a multiple of 8 in [8, 512], f32 or bf16; q, k, v and o are
// contiguous, 16-byte aligned and of one dtype. The softmax and every sum are
// f32; the output is stored in the input dtype.
//
// What bounds it, and the three variants of the launch plan (chosen on the
// host by ops/attention.py `attention_plan`, passed in and checked here):
//
// - packed (T <= 16, D <= 32, f32 or bf16): the 32 px UNet's calls,
//   [B, 64, 4, 8] and [B, 64, 1, 8]. A few MB per call: launch latency and
//   bytes bound them. One thread owns one query row: its q and its D
//   accumulators in registers, the <= 16 scores in registers, so the softmax
//   is exact and two-pass with one exponential per score. Key and value rows
//   come in 16-byte loads that the row's neighbours (the other rows of its
//   head) share through L1. Many heads share a block; no shared memory, no
//   barrier.
// - tiled (bf16, D <= 256, the rest): FlashAttention-2's shape on the tensor
//   cores. A warp owns 16 query rows of one (b, h), a block 64 of them (the
//   kernel also takes 16 and 32, which were slower on the card).
//   K and V tiles are staged in bf16 in shared memory by 16-byte cp.async,
//   double-buffered; Q is staged once. S = Q K^T and O += P V run on
//   mma.sync m16n8k16 (bf16 in, f32 accumulate), the operands loaded by
//   ldmatrix (V by ldmatrix.trans); D is zero-padded to the instantiation's
//   depth (16, 32, 64, 128 or 256). The online softmax works on S's
//   accumulator fragments: row max by quad shuffles, one ex2.approx a score
//   (scale * log2 e folded in), the running output rescaled once per key
//   tile; P is rounded to bf16 in registers and fed back as the A operand of
//   P V. At D = 8 the T^2 exponentials bound it (about 3.9 T/s on an H100
//   SXM5), at D = 64-256 the bytes or the products. No split over keys and
//   no atomics: the output is bitwise repeatable.
// - rowwise (the rest: f32 at T > 16 or D > 32, and D > 256): L lanes own one
//   query row (L = 8 for D = 8, 16 for D = 16, else 32) and walk the keys one
//   at a time with an online softmax, K and V staged as f32 in shared memory
//   from 16-byte loads. Exact f32 products, so the f32 checks hold it at atol
//   1e-5, which a bf16 or TF32 tensor-core product cannot; slow at long T.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

enum Variant : int { kPacked = 0, kTiled = 1, kRowwise = 2 };
constexpr int kMaxT = 4096;  // ops/attention.py MAX_T
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------ packed

constexpr int kPackedMaxT = 16;
constexpr int kPackedMaxD = 32;
constexpr int kPackedMaxThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kPackedMaxThreads)
    attention_packed_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                            T* __restrict__ o, int rows, int t_len, float c) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPacks = D / kVec;
  using P = bd::Pack<T, kVec>;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int64_t head = (int64_t)(row / t_len) * t_len * kPacks;  // this row's (b, h), in packs
  const P* kp = reinterpret_cast<const P*>(k) + head;
  const P* vp = reinterpret_cast<const P*>(v) + head;

  float qf[D];
#pragma unroll
  for (int p = 0; p < kPacks; ++p) {
    const P pk = reinterpret_cast<const P*>(q)[(int64_t)row * kPacks + p];
#pragma unroll
    for (int e = 0; e < kVec; ++e) qf[p * kVec + e] = bd::to_f32(pk.v[e]) * c;
  }
  float s[kPackedMaxT];  // scores in log2 units
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPackedMaxT; ++j) {
    if (j < t_len) {
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < kPacks; ++p) {
        const P pk = kp[j * kPacks + p];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc = fmaf(qf[p * kVec + e], bd::to_f32(pk.v[e]), acc);
      }
      s[j] = acc;
      m = fmaxf(m, acc);
    }
  }
  float acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) acc[e] = 0.f;
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kPackedMaxT; ++j) {
    if (j < t_len) {
      const float p = ex2(s[j] - m);
      l += p;
#pragma unroll
      for (int pp = 0; pp < kPacks; ++pp) {
        const P pv = vp[j * kPacks + pp];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[pp * kVec + e] = fmaf(p, bd::to_f32(pv.v[e]), acc[pp * kVec + e]);
      }
    }
  }
  const float inv = 1.f / l;  // l >= 1: the largest score contributes 2^0
#pragma unroll
  for (int p = 0; p < kPacks; ++p) {
    P out;
#pragma unroll
    for (int e = 0; e < kVec; ++e) out.v[e] = bd::from_f32<T>(acc[p * kVec + e] * inv);
    reinterpret_cast<P*>(o)[(int64_t)row * kPacks + p] = out;
  }
}

template <typename T>
void launch_packed(const void* q, const void* k, const void* v, void* o, int bh, int t_len, int d, float c,
                   int threads, cudaStream_t stream) {
  const int rows = bh * t_len;
  const int blocks = (rows + threads - 1) / threads;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (d) {
    case 8: attention_packed_kernel<T, 8><<<blocks, threads, 0, stream>>>(qt, kt, vt, ot, rows, t_len, c); break;
    case 16: attention_packed_kernel<T, 16><<<blocks, threads, 0, stream>>>(qt, kt, vt, ot, rows, t_len, c); break;
    case 24: attention_packed_kernel<T, 24><<<blocks, threads, 0, stream>>>(qt, kt, vt, ot, rows, t_len, c); break;
    default: attention_packed_kernel<T, 32><<<blocks, threads, 0, stream>>>(qt, kt, vt, ot, rows, t_len, c); break;
  }
}

// ------------------------------------------------------------------- tiled

constexpr int kTiledMaxThreads = 128;  // 4 warps: 64 query rows

// D padded to the depth of the instantiation that runs it, and that depth's
// key tile (the same rule as ops/attention.py `attention_plan`)
inline int tiled_depth(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }
inline int tiled_key_tile(int depth) { return depth > 128 ? 32 : 64; }
inline int tiled_smem_bytes(int rows, int key_tile, int depth) {
  return (rows + 4 * key_tile) * (depth + 8) * 2;  // Q, then K and V in two stages; rows padded 16 bytes
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled past src_bytes (0 or 16)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half: the lower column
  return *reinterpret_cast<uint32_t*>(&h);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + tq. A holds (row g
// | g + 8, columns 2 tq, 2 tq + 1 | + 8), B (rows 2 tq, 2 tq + 1 | + 8,
// column g), C (row g | g + 8, columns 2 tq, 2 tq + 1).
template <int DP, int BN>
__global__ void __launch_bounds__(kTiledMaxThreads)
    attention_tiled_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int t_len, int d,
                           int q_tiles, float c) {
  constexpr int kStride = DP + 8;  // a shared-memory row, in elements: ldmatrix's 8 rows hit 8 bank groups
  constexpr int kChunks = DP / 8;  // 16-byte chunks of a row
  constexpr int kKSteps = DP / 16;
  constexpr int kSTiles = BN / 8;
  constexpr int kPSteps = BN / 16;
  constexpr int kOTiles = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / 2;  // 16 a warp
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + rows * kStride;    // [2][BN][kStride]
  __nv_bfloat16* vs = ks + 2 * BN * kStride;  // [2][BN][kStride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * rows;
  const int64_t head = (int64_t)bh * t_len * d;

  // rows r0 .. r0 + n of one tensor into shared memory, zeros past T and past
  // D: a thread copies one 16-byte column of every (threads / kChunks)-th row
  const int ch = tid % kChunks, r_first = tid / kChunks, r_step = blockDim.x / kChunks;
  const bool ch_real = ch * 8 < d;
  auto stage_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int r0, int n) {
    const __nv_bfloat16* g = src + head + (int64_t)(r0 + r_first) * d + ch * 8;
    uint32_t sa = smem_addr(dst + r_first * kStride + ch * 8);
    for (int r = r_first; r < n; r += r_step, g += (int64_t)r_step * d, sa += r_step * kStride * 2) {
      const bool real = ch_real && r0 + r < t_len;
      cp_async_16(sa, real ? g : src, real ? 16 : 0);
    }
  };
  const int n_tiles = (t_len + BN - 1) / BN;
  stage_rows(qs, q, q0, rows);
  stage_rows(ks, k, 0, BN);
  stage_rows(vs, v, 0, BN);
  cp_async_commit();

  // ldmatrix row addresses: Q as A (matrices rows 0-7 | 8-15 x columns 0-7 |
  // 8-15), K as B of two n-tiles (keys 0-7 x depth 0-7 | 8-15, then keys
  // 8-15), V transposed as B of two n-tiles (keys 0-7 | 8-15 x depth 0-7,
  // then depth 8-15)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  const int v_row = a_row, v_col = a_col;
  const uint32_t q_addr = smem_addr(qs + (warp * 16 + a_row) * kStride + a_col);
  const int g = lane >> 2, tq = lane & 3;

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of their running sums

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      stage_rows(ks + (stage ^ 1) * BN * kStride, k, (it + 1) * BN, BN);
      stage_rows(vs + (stage ^ 1) * BN * kStride, v, (it + 1) * BN, BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + stage * BN * kStride;
    const __nv_bfloat16* vt = vs + stage * BN * kStride;

    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int n = 0; n < kSTiles; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(kt + (n * 8 + k_row) * kStride + kk * 16 + k_col));
        mma_bf16(s[n], a, b[0], b[1]);
        mma_bf16(s[n + 1], a, b[2], b[3]);
      }
    }

    const int key0 = it * BN;
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= c;
    }
    if (key0 + BN > t_len) {  // the last tile: keys past T take no weight
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (key0 + n * 8 + 2 * tq + (e & 1) >= t_len) s[n][e] = -INFINITY;
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);  // 0 on the first tile, where m = -inf
      m[r] = mx[r];
      l[r] *= corr[r];
    }

    uint32_t pa[kPSteps][4];  // P as the A operand of P V
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      const float p0 = ex2(s[n][0] - m[0]), p1 = ex2(s[n][1] - m[0]);
      const float p2 = ex2(s[n][2] - m[1]), p3 = ex2(s[n][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
#pragma unroll
      for (int n = 0; n < kOTiles; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(vt + (kk * 16 + v_row) * kStride + n * 8 + v_col));
        mma_bf16(acc[n], pa[kk], b[0], b[1]);
        mma_bf16(acc[n + 1], pa[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled on the next tile
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const int row = q0 + warp * 16 + g;
  __nv_bfloat16* out = o + head;
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    if (n * 8 < d) {
      const int col = n * 8 + 2 * tq;
      if (row < t_len) {
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * d + col) =
            __floats2bfloat162_rn(acc[n][0] * inv[0], acc[n][1] * inv[0]);
      }
      if (row + 8 < t_len) {
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)(row + 8) * d + col) =
            __floats2bfloat162_rn(acc[n][2] * inv[1], acc[n][3] * inv[1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_tiled(const void* q, const void* k, const void* v, void* o, int bh, int t_len, int d, float c,
                         int rows, int smem_bytes, cudaStream_t stream) {
  constexpr int kBN = DP > 128 ? 32 : 64;
  auto kernel = attention_tiled_kernel<DP, kBN>;
  if (smem_bytes > 48 * 1024) {  // above 48 KB only once the function allows it
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const int q_tiles = (t_len + rows - 1) / rows;
  kernel<<<bh * q_tiles, 2 * rows, smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), t_len, d, q_tiles, c);
  return cudaSuccess;
}

// ----------------------------------------------------------------- rowwise

constexpr int kRowwiseMaxWarps = 4;
constexpr int kSmemFloats = 8192;  // K and V tiles together: 32 KB

inline int rowwise_lanes(int d) { return d == 8 ? 8 : d == 16 ? 16 : 32; }

template <typename T, int L, int E>
__global__ void __launch_bounds__(kRowwiseMaxWarps * 32)
    attention_rowwise_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                             T* __restrict__ o, int t_len, int d, float scale, int tile) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + tile * d;
  constexpr int kVec = 16 / sizeof(T);  // K and V come in 16-byte packs
  using P = bd::Pack<T, kVec>;
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
    const P* kp = reinterpret_cast<const P*>(k + head + (int64_t)k0 * d);
    const P* vp = reinterpret_cast<const P*>(v + head + (int64_t)k0 * d);
    for (int i = threadIdx.x; i < n * d / kVec; i += blockDim.x) {
      const P kk = kp[i], vv = vp[i];
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(ks + i * kVec + e) = make_float4(
            bd::to_f32(kk.v[e]), bd::to_f32(kk.v[e + 1]), bd::to_f32(kk.v[e + 2]), bd::to_f32(kk.v[e + 3]));
        *reinterpret_cast<float4*>(vs + i * kVec + e) = make_float4(
            bd::to_f32(vv.v[e]), bd::to_f32(vv.v[e + 1]), bd::to_f32(vv.v[e + 2]), bd::to_f32(vv.v[e + 3]));
      }
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
void launch_rowwise_le(const void* q, const void* k, const void* v, void* o, int bh, int t_len, int d, float scale,
                       int threads, int rows, int tile, int smem_bytes, cudaStream_t stream) {
  const dim3 grid(bh, (t_len + rows - 1) / rows);
  attention_rowwise_kernel<T, L, E><<<grid, threads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), t_len, d,
      scale, tile);
}

template <typename T>
void launch_rowwise(const void* q, const void* k, const void* v, void* o, int bh, int t_len, int d, float scale,
                    int threads, int rows, int tile, int smem_bytes, cudaStream_t stream) {
  const int e = (d + 31) / 32;
  if (d == 8) launch_rowwise_le<T, 8, 1>(q, k, v, o, bh, t_len, d, scale, threads, rows, tile, smem_bytes, stream);
  else if (d == 16) launch_rowwise_le<T, 16, 1>(q, k, v, o, bh, t_len, d, scale, threads, rows, tile, smem_bytes, stream);
  else if (e <= 1) launch_rowwise_le<T, 32, 1>(q, k, v, o, bh, t_len, d, scale, threads, rows, tile, smem_bytes, stream);
  else if (e <= 2) launch_rowwise_le<T, 32, 2>(q, k, v, o, bh, t_len, d, scale, threads, rows, tile, smem_bytes, stream);
  else if (e <= 4) launch_rowwise_le<T, 32, 4>(q, k, v, o, bh, t_len, d, scale, threads, rows, tile, smem_bytes, stream);
  else if (e <= 8) launch_rowwise_le<T, 32, 8>(q, k, v, o, bh, t_len, d, scale, threads, rows, tile, smem_bytes, stream);
  else launch_rowwise_le<T, 32, 16>(q, k, v, o, bh, t_len, d, scale, threads, rows, tile, smem_bytes, stream);
}

bool bad_plan(int variant, int bh, int t_len, int d, int dtype, int threads, int rows, int key_tile, int depth,
              int smem_bytes) {
  switch (variant) {
    case kPacked:
      return t_len > kPackedMaxT || d > kPackedMaxD || threads < 32 || threads > kPackedMaxThreads ||
             threads % 32 != 0 || rows != threads || key_tile != 0 || depth != d || smem_bytes != 0;
    case kTiled:
      return dtype != bd::kBFloat16 || d > 256 || depth != tiled_depth(d) || key_tile != tiled_key_tile(depth) ||
             (rows != 16 && rows != 32 && rows != 64) || threads != 2 * rows ||
             smem_bytes != tiled_smem_bytes(rows, key_tile, depth) ||
             (int64_t)bh * ((t_len + rows - 1) / rows) > INT_MAX;
    case kRowwise: {
      const int warps = threads / 32;
      return threads % 32 != 0 || warps < 1 || warps > kRowwiseMaxWarps || rows != warps * (32 / rowwise_lanes(d)) ||
             key_tile != min(t_len, kSmemFloats / (2 * d)) || depth != d || smem_bytes != 8 * key_tile * d;
    }
    default:
      return true;
  }
}

}  // namespace

// q, k, v, o: [bh, t_len, d] contiguous, 16-byte aligned, all one dtype. The
// launch plan (variant, threads, rows a block, key tile, padded depth, dynamic
// shared memory) is ops/attention.py `attention_plan`'s; one that does not
// fit the shape is refused. Returns a cudaError_t code (0 on success).
extern "C" int bd_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh, int t_len, int d,
                                float scale, int dtype, int variant, int threads, int rows, int key_tile,
                                int depth, int smem_bytes, void* stream_ptr) {
  if (bh <= 0 || t_len < 1 || t_len > kMaxT || d < 8 || d > 512 || d % 8 != 0 || (int64_t)bh * t_len > INT_MAX ||
      (dtype != bd::kFloat32 && dtype != bd::kBFloat16) ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15) != 0 ||
      bad_plan(variant, bh, t_len, d, dtype, threads, rows, key_tile, depth, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool f32 = dtype == bd::kFloat32;
  if (variant == kPacked) {
    const float c = scale * kLog2e;
    if (f32) launch_packed<float>(q, k, v, o, bh, t_len, d, c, threads, stream);
    else launch_packed<__nv_bfloat16>(q, k, v, o, bh, t_len, d, c, threads, stream);
  } else if (variant == kTiled) {
    const float c = scale * kLog2e;
    cudaError_t err;
    switch (depth) {
      case 16: err = launch_tiled<16>(q, k, v, o, bh, t_len, d, c, rows, smem_bytes, stream); break;
      case 32: err = launch_tiled<32>(q, k, v, o, bh, t_len, d, c, rows, smem_bytes, stream); break;
      case 64: err = launch_tiled<64>(q, k, v, o, bh, t_len, d, c, rows, smem_bytes, stream); break;
      case 128: err = launch_tiled<128>(q, k, v, o, bh, t_len, d, c, rows, smem_bytes, stream); break;
      default: err = launch_tiled<256>(q, k, v, o, bh, t_len, d, c, rows, smem_bytes, stream); break;
    }
    if (err != cudaSuccess) return (int)err;
  } else {
    if (f32) launch_rowwise<float>(q, k, v, o, bh, t_len, d, scale, threads, rows, key_tile, smem_bytes, stream);
    else launch_rowwise<__nv_bfloat16>(q, k, v, o, bh, t_len, d, scale, threads, rows, key_tile, smem_bytes, stream);
  }
  return (int)cudaGetLastError();
}
