// Self-attention forward, softmax(q k^T * scale) v over [B, H, T, D], for
// Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel `_forward_pallas` / `_kernel` in
// baddiffusion_tpu/ops/attention.py, which keeps one (b, h)'s whole [T, T]
// score block in VMEM and runs both products on the MXU. Here no [T, T]
// tensor exists anywhere: the softmax is exact over registers (packed) or
// online over key tiles (the rest). Envelope: T <= 4096 (the VQ-VAE's
// mid block at a 64x64 latent, [B, 1, 4096, 512], the longest sequence of any
// model of the repo), D a multiple of 8 in [8, 512], f32 or bf16; q, k, v and o are
// contiguous, 16-byte aligned and of one dtype. The softmax and every sum are
// f32; the output is stored in the input dtype. No variant splits the keys
// or uses atomics: the output is bitwise repeatable.
//
// What bounds it, and the four variants of the launch plan (chosen on the
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
//   SXM5), at D = 64-256 the bytes or the products.
// - tf32x3 (f32, the rest: T > 16 or D > 32) and wide (bf16, D > 256): the
//   same online softmax on mma.sync fragments, with the depth split. One
//   warp's O for 16 rows at D = 512 is 256 f32 a lane, more than a thread's
//   255 registers, and 64 rows of it are half an SM's register file. So a
//   group of `parts` warps shares 16 query rows, each warp owning DW columns
//   of D: it computes its columns' share of the group's scores, the shares
//   meet in shared memory, where each warp adds a part of the scores over
//   the slices in a fixed order and writes the sums back, and every warp
//   reads all the sums (so every warp of the group holds the same S, max,
//   sum and P: no other exchange), then accumulates its own DW columns of
//   O. The group waits on its own named barrier for the shares and the
//   sums; the block meets once a key tile, when the next K and V tiles
//   (double-buffered, 16-byte cp.async) are issued. A block holds up to 64
//   rows and 512 threads (256 where a lane's accumulators take more than
//   128 registers); each K and V tile staged serves all of its rows.
//   * tf32x3 keeps f32 accuracy on the TF32 tensor cores (mma.sync m16n8k8):
//     each operand x is split into hi (x cut to TF32) and lo = x - hi, and
//     a b becomes al bh + ah bl + ah bh, f32 accumulate; the dropped al bl
//     and lo's own truncation are under 3 2^-20 of |a b|. The tensor cores
//     add into their accumulator with truncation, so f32 sums stay short
//     there: each key tile's S and P V start from zero, and P V is added to
//     O by the f32 cores. That holds the f32 checks (atol 1e-5) with a
//     margin (about 2e-6 on the card), which one TF32 product (2^-11)
//     cannot. Three products at the TF32 rate (495 TFLOP/s dense) are its
//     bound's operations: 165 TFLOP/s of f32 work, against 67 on the f32
//     cores. DW = 8, 16, 32 (one warp a group, 64 keys a tile), 64 or 128
//     (up to 8 or 4 warps a group at D = 512; 16 or 32 keys a tile). At
//     D = 8-32 the T^2 exponentials and the softmax's f32 arithmetic bound
//     it; at D >= 256 the products, then the split's arithmetic, the
//     staging and the exchange, each of which the warps of a block wait
//     for together (one block barrier a key tile).
//   * wide runs tiled's bf16 products (ldmatrix, m16n8k16) over DW = 128 or
//     256 columns a warp, 32 keys a tile; at D = 512 the products bound it.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

enum Variant : int { kPacked = 0, kTiled = 1, kTf32x3 = 2, kWide = 3 };
constexpr int kMaxT = 4096;  // ops/attention.py MAX_T
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory a block may have on an H100

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

// ---------------------------------------------------------- tf32x3, wide

// Both variants split a block's query rows into groups of 16 and each
// group's depth into `parts` slices of DW columns, one warp a slice (source
// note above). K and V tiles are double-buffered, as in tiled.
constexpr int kSplitMaxThreads = 512;

// a row stride, in elements, rounded up to `r` mod 32 (4-byte banks)
__host__ __device__ __forceinline__ int pad_to(int n, int r) { return n + ((r - n) % 32 + 32) % 32; }
// the (depth a warp owns, key tile) pairs instantiated
inline bool split_instance_ok(bool f32, int dw, int bn) {
  return f32 ? ((dw == 8 || dw == 16 || dw == 32) && bn == 64) || ((dw == 64 || dw == 128) && (bn == 16 || bn == 32))
             : (dw == 128 || dw == 256) && bn == 32;
}
// the widest block of an instantiation: 512 threads (at most 128 registers
// each) where a lane's accumulators and scores fit that, else 256. A warp's
// O takes DW / 2 registers a lane, f32 as much again for a key tile's P V;
// at DW <= 32 a tile's 64 scores take most of the rest
__host__ __device__ constexpr int split_max_threads(bool f32, int dw) {
  return (f32 ? dw != 64 : dw >= 256) ? 256 : kSplitMaxThreads;
}
// Q, then K and V in two stages each (f32: Q and K rows padded to 8 mod 32
// words for 8-byte loads, V rows to 4 mod 32 for 4-byte loads; bf16: 16
// bytes, as tiled), then the groups' partial scores when a group has more
// than one slice
inline int64_t split_smem_bytes(bool f32, int rows, int parts, int key_tile, int depth) {
  const int64_t x = parts > 1 ? 4LL * rows * parts * key_tile : 0;
  if (f32) return 4LL * ((rows + 2 * key_tile) * pad_to(depth, 8) + 2 * key_tile * pad_to(depth, 4)) + x;
  return 2LL * (rows + 4 * key_tile) * (depth + 8) + x;
}

// the `threads` threads of barrier `id` (1, 2, ...; __syncthreads is 0) wait for each other
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// c += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = hi + lo: hi is x's top 19 bits (sign, exponent, 10 mantissa bits:
// exact in tf32), lo the exact rest (|lo| < 2^-10 |x|), of which the tensor
// cores read the top 19 bits (within 2^-20 |x|)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// c += a * b to about f32 accuracy: three tf32 products, the small ones
// first; lo * lo (under 2^-20 of |a b|) is dropped
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// Fragment layouts (PTX ISA): m16n8k16 bf16 as in tiled; m16n8k8 tf32: A
// holds (row g | g + 8, k tq | tq + 4), B (k tq | tq + 4, column g), C as
// bf16's. In the f32 products the k index is relabelled, the same way in A
// and B: in S = Q K^T, k tq and tq + 4 stand for depth 2 tq and 2 tq + 1 of
// the step (one 8-byte load a row); in P V, for keys 2 tq and 2 tq + 1 of
// the step, which are the C columns of S a lane already holds, so P feeds
// the A operand without a shuffle. The tensor cores add into their
// accumulator with truncation, so f32 sums stay short there: S starts from
// zero every key tile, and each tile's P V is added to O by the f32 cores.
template <typename T, int DW, int BN>
__device__ __forceinline__ void split_attention(const T* __restrict__ q, const T* __restrict__ k,
                                                const T* __restrict__ v, T* __restrict__ o, int t_len, int d,
                                                int parts, int q_tiles, float c) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr int kSTiles = BN / 8;       // n-tiles of the group's S
  constexpr int kOTiles = DW / 8;       // n-tiles of the warp's slice of O
  constexpr int kX = BN / 2;            // partial scores a lane holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = blockDim.x / (2 * parts);  // 16 a group of `parts` warps
  const int grp = warp / parts, part = warp - grp * parts;
  const int dp = parts * DW;
  const int sq = kF32 ? pad_to(dp, 8) : dp + 8;  // row strides, in elements
  const int sv = kF32 ? pad_to(dp, 4) : sq;
  T* qs = reinterpret_cast<T*>(smem_raw);                  // [rows][sq]
  T* ks = qs + rows * sq;                                  // [2][BN][sq]
  T* vs = ks + 2 * BN * sq;                                // [2][BN][sv]
  float* xs = reinterpret_cast<float*>(vs + 2 * BN * sv);  // [warps][kX][32]

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * rows;
  const int64_t head = (int64_t)bh * t_len * d;
  // rows r0 .. r0 + n of one tensor into shared memory, zeros past T and past
  // D: a thread copies one 16-byte column of every (threads / chunks)-th row
  // (the threads are a whole number of rows' chunks in every plan)
  const int chunks = dp / kVec;
  const int ch_col = (tid % chunks) * kVec, r_first = tid / chunks, r_step = blockDim.x / chunks;
  const bool ch_real = ch_col < d;
  auto stage = [&](T* dst, int stride, const T* src, int r0, int n) {
    const T* gp = src + head + (int64_t)(r0 + r_first) * d + ch_col;
    uint32_t sa = smem_addr(dst + r_first * stride + ch_col);
    for (int r = r_first; r < n; r += r_step, gp += (int64_t)r_step * d, sa += r_step * stride * sizeof(T)) {
      const bool real = ch_real && r0 + r < t_len;
      cp_async_16(sa, real ? gp : src, real ? 16 : 0);
    }
  };
  const int n_tiles = (t_len + BN - 1) / BN;
  stage(qs, sq, q, q0, rows);
  stage(ks, sq, k, 0, BN);
  stage(vs, sv, v, 0, BN);
  cp_async_commit();

  const int g = lane >> 2, tq = lane & 3;
  const int col0 = part * DW;  // the warp's slice of D
  const int r_base = grp * 16;  // the group's first row in the block
  float* xg = xs + grp * parts * kX * 32;  // the group's partial scores
  // bf16 ldmatrix row addresses, as in tiled
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of their running sums

  for (int it = 0; it < n_tiles; ++it) {
    const int stage_now = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1 and its partial scores
    if (it + 1 < n_tiles) {  // the next tile lands while this one is used
      stage(ks + (stage_now ^ 1) * BN * sq, sq, k, (it + 1) * BN, BN);
      stage(vs + (stage_now ^ 1) * BN * sv, sv, v, (it + 1) * BN, BN);
      cp_async_commit();
    }
    const T* kt = ks + stage_now * BN * sq;
    const T* vt = vs + stage_now * BN * sv;

    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (kF32) {
      const float* qa = reinterpret_cast<const float*>(qs) + (r_base + g) * sq + col0 + 2 * tq;
      const float* kb = reinterpret_cast<const float*>(kt) + g * sq + col0 + 2 * tq;
#pragma unroll
      for (int kk = 0; kk < DW / 8; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(qa + kk * 8);           // row g
        const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * sq + kk * 8);  // row g + 8
        uint32_t ah[4], al[4];
        split_tf32(x0.x, ah[0], al[0]);
        split_tf32(x1.x, ah[1], al[1]);
        split_tf32(x0.y, ah[2], al[2]);
        split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < kSTiles; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(kb + n * 8 * sq + kk * 8);
          uint32_t bh[2], bl[2];
          split_tf32(y.x, bh[0], bl[0]);
          split_tf32(y.y, bh[1], bl[1]);
          mma_tf32x3(s[n], ah, al, bh, bl);
        }
      }
    } else {
      const uint32_t q_addr = smem_addr(qs + (r_base + a_row) * sq + col0 + a_col);
#pragma unroll
      for (int kk = 0; kk < DW / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, q_addr + kk * 32);
#pragma unroll
        for (int n = 0; n < kSTiles; n += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(kt + (n * 8 + k_row) * sq + col0 + kk * 16 + k_col));
          mma_bf16(s[n], a, b[0], b[1]);
          mma_bf16(s[n + 1], a, b[2], b[3]);
        }
      }
    }
    if (parts > 1) {  // the group's shares, added once each in a fixed order and read by every warp
      float* mine = xg + part * kX * 32 + lane;
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32] = s[n][e];
      }
      group_sync(1 + grp, 32 * parts);  // the group's shares are written
      for (int i = part; i < kX; i += parts) {  // this warp's entries: slice 0, 1, ... added into slice 0's place
        float* x = xg + i * 32 + lane;
        float sum = x[0];
        for (int p = 1; p < parts; ++p) sum += x[p * kX * 32];
        x[0] = sum;
      }
      group_sync(1 + grp, 32 * parts);  // the sums are written
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = xg[(n * 4 + e) * 32 + lane];
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
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {  // S becomes P
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = ex2(s[n][e] - m[e >> 1]);
      l[0] += s[n][0] + s[n][1];
      l[1] += s[n][2] + s[n][3];
    }

    if constexpr (kF32) {
      float pv[kOTiles][4];
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
      const float* vb = reinterpret_cast<const float*>(vt) + 2 * tq * sv + col0 + g;
#pragma unroll
      for (int kk = 0; kk < kSTiles; ++kk) {
        uint32_t ah[4], al[4];
        split_tf32(s[kk][0], ah[0], al[0]);  // row g, key 2 tq
        split_tf32(s[kk][2], ah[1], al[1]);  // row g + 8, key 2 tq
        split_tf32(s[kk][1], ah[2], al[2]);  // row g, key 2 tq + 1
        split_tf32(s[kk][3], ah[3], al[3]);  // row g + 8, key 2 tq + 1
#pragma unroll
        for (int n = 0; n < kOTiles; ++n) {
          uint32_t bh[2], bl[2];
          split_tf32(vb[kk * 8 * sv + n * 8], bh[0], bl[0]);
          split_tf32(vb[(kk * 8 + 1) * sv + n * 8], bh[1], bl[1]);
          mma_tf32x3(pv[n], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        acc[n][0] = fmaf(acc[n][0], corr[0], pv[n][0]);
        acc[n][1] = fmaf(acc[n][1], corr[0], pv[n][1]);
        acc[n][2] = fmaf(acc[n][2], corr[1], pv[n][2]);
        acc[n][3] = fmaf(acc[n][3], corr[1], pv[n][3]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      uint32_t pa[BN / 16][4];  // P as the A operand of P V
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
        pa[n / 2][(n & 1) * 2] = pack_bf16(s[n][0], s[n][1]);
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < kOTiles; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(vt + (kk * 16 + a_row) * sq + col0 + n * 8 + a_col));
          mma_bf16(acc[n], pa[kk], b[0], b[1]);
          mma_bf16(acc[n + 1], pa[kk], b[2], b[3]);
        }
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const int row = q0 + r_base + g;
  T* out = o + head;
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int col = col0 + n * 8 + 2 * tq;
    if (col0 + n * 8 < d) {
      if constexpr (kF32) {
        if (row < t_len) {
          *reinterpret_cast<float2*>(out + (int64_t)row * d + col) = make_float2(acc[n][0] * inv[0], acc[n][1] * inv[0]);
        }
        if (row + 8 < t_len) {
          *reinterpret_cast<float2*>(out + (int64_t)(row + 8) * d + col) =
              make_float2(acc[n][2] * inv[1], acc[n][3] * inv[1]);
        }
      } else {
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
}

template <int DW, int BN>
__global__ void __launch_bounds__(split_max_threads(true, DW))
    attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            float* __restrict__ o, int t_len, int d, int parts, int q_tiles, float c) {
  split_attention<float, DW, BN>(q, k, v, o, t_len, d, parts, q_tiles, c);
}

template <int DW, int BN>
__global__ void __launch_bounds__(split_max_threads(false, DW))
    attention_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int t_len, int d,
                          int parts, int q_tiles, float c) {
  split_attention<__nv_bfloat16, DW, BN>(q, k, v, o, t_len, d, parts, q_tiles, c);
}

template <typename T, typename Kernel>
cudaError_t launch_split(Kernel kernel, const void* q, const void* k, const void* v, void* o, int bh, int t_len, int d,
                         float c, int threads, int rows, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {  // above 48 KB only once the function allows it
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const int q_tiles = (t_len + rows - 1) / rows;
  kernel<<<bh * q_tiles, threads, smem_bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                        static_cast<const T*>(v), static_cast<T*>(o), t_len, d,
                                                        threads / (2 * rows), q_tiles, c);
  return cudaSuccess;
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
    case kTf32x3:
    case kWide: {
      const bool f32 = variant == kTf32x3;
      if (dtype != (f32 ? bd::kFloat32 : bd::kBFloat16) || (rows != 16 && rows != 32 && rows != 64) ||
          threads % (2 * rows) != 0) {
        return true;
      }
      const int parts = threads / (2 * rows);
      if (depth % parts != 0) return true;
      const int dw = depth / parts;
      return !split_instance_ok(f32, dw, key_tile) || parts != (d + dw - 1) / dw || threads % (depth / (f32 ? 4 : 8)) != 0 ||
             threads > split_max_threads(f32, dw) || smem_bytes != split_smem_bytes(f32, rows, parts, key_tile, depth) ||
             smem_bytes > kSmemLimit || (int64_t)bh * ((t_len + rows - 1) / rows) > INT_MAX;
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
// Launches on `device`, the tensors' (bd::DeviceGuard), in `stream_ptr`.
extern "C" int bd_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh, int t_len, int d,
                                float scale, int dtype, int variant, int threads, int rows, int key_tile,
                                int depth, int smem_bytes, int device, void* stream_ptr) {
  if (bh <= 0 || t_len < 1 || t_len > kMaxT || d < 8 || d > 512 || d % 8 != 0 || (int64_t)bh * t_len > INT_MAX ||
      (dtype != bd::kFloat32 && dtype != bd::kBFloat16) ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15) != 0 ||
      bad_plan(variant, bh, t_len, d, dtype, threads, rows, key_tile, depth, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const bd::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
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
    const float c = scale * kLog2e;
    const int dw = depth / (threads / (2 * rows));
    cudaError_t err;
    if (variant == kTf32x3) {
      switch (dw) {
        case 8: err = launch_split<float>(attention_tf32x3_kernel<8, 64>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream); break;
        case 16: err = launch_split<float>(attention_tf32x3_kernel<16, 64>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream); break;
        case 32: err = launch_split<float>(attention_tf32x3_kernel<32, 64>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream); break;
        case 64:
          err = key_tile == 16 ? launch_split<float>(attention_tf32x3_kernel<64, 16>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream)
                               : launch_split<float>(attention_tf32x3_kernel<64, 32>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream);
          break;
        default:
          err = key_tile == 16 ? launch_split<float>(attention_tf32x3_kernel<128, 16>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream)
                               : launch_split<float>(attention_tf32x3_kernel<128, 32>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream);
          break;
      }
    } else if (dw == 128) {
      err = launch_split<__nv_bfloat16>(attention_wide_kernel<128, 32>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream);
    } else {
      err = launch_split<__nv_bfloat16>(attention_wide_kernel<256, 32>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
