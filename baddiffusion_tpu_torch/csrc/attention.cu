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
// What bounds it, and the five variants of the launch plan (chosen on the
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
// - tf32x3_wg (f32, D <= 64, T > 16): the LDM UNet's heads of 32
//   ([B, 14, 1024, 32], [B, 21, 256, 32], [B, 28, 64, 32]), NCSN++'s and the
//   256 px scratch UNet's heads of 8. Three TF32 products a product (as
//   tf32x3 below) bound it: 12 T^2 D operations a head at 495 TFLOP/s, the
//   T^2 exponentials and the softmax's f32 arithmetic a fraction of that.
//   mma.sync cannot reach the tensor cores' rate on Hopper, so this variant
//   runs Hopper's warpgroup products (wgmma m64nNk8 .tf32) fed by TMA.
//   One persistent block an SM walks its items (128 query rows of a head,
//   or two heads where T <= 64). Warpgroup 0 feeds: one thread keeps Q and
//   a ring of K/V tiles (64 keys) in flight with TMA (128-byte swizzle,
//   zeros past T and D: D is zero-padded to 32 or 64), the other three
//   warps convert each staged tile once for both consumers: K cut to its
//   tf32 hi in place and its lo beside it, V transposed (wgmma takes tf32
//   operands K-major only) into hi and lo, each 8 keys even first, so P
//   feeds the A operand of P V straight from S's accumulator registers.
//   Warpgroups 1 and 2 own 64 query rows each: S = Q K^T with Q as register
//   fragments (depth 32) or from shared memory (64), then the online
//   softmax in f32 on the accumulator, then P V with P from registers. A
//   warpgroup issues tile j + 1's S with tile j's P V, and tile j's P V in
//   three parts between the parts of tile j + 1's softmax: the issue of a
//   product waits while the tensor cores' queue is full, so the products
//   run on while the warpgroup computes; the other warpgroup's products
//   fill the rest. Each key tile's S and P V start from zero and P V is
//   added to O by the f32 cores, as in tf32x3. No split over keys, no
//   atomics, nothing but the output in device memory. setmaxnreg moves
//   registers from the feeding warpgroup to the consumers.
// - tf32x3 (f32, the rest: D > 64, or T <= 16 with D > 32) and wide (bf16,
//   D > 256): the same online softmax on mma.sync fragments, with the depth split. One
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
//     cores. DW = 64 or 128 (up to 8 or 4 warps a group at D = 512; 16 or
//     32 keys a tile). At D >= 256 the products, then the split's arithmetic, the
//     staging and the exchange, each of which the warps of a block wait
//     for together (one block barrier a key tile).
//   * wide runs tiled's bf16 products (ldmatrix, m16n8k16) over DW = 128 or
//     256 columns a warp, 32 keys a tile; at D = 512 the products bound it.

#include <cuda.h>  // CUtensorMap and its encoder's types (the encoder is found through the runtime)
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

enum Variant : int { kPacked = 0, kTiled = 1, kTf32x3 = 2, kWide = 3, kTf32x3Wg = 4 };
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
  return f32 ? (dw == 64 || dw == 128) && (bn == 16 || bn == 32) : (dw == 128 || dw == 256) && bn == 32;
}
// the widest block of an instantiation: 512 threads (at most 128 registers
// each) where a lane's accumulators and scores fit that, else 256. A warp's
// O takes DW / 2 registers a lane, f32 as much again for a key tile's P V
__host__ __device__ constexpr int split_max_threads(bool f32, int dw) {
  return (f32 ? dw > 64 : dw >= 256) ? 256 : kSplitMaxThreads;
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

// ------------------------------------------------------------- tf32x3_wg

// The block: warpgroup 0 feeds (warp 0 issues the TMA copies, warps 1-3
// convert the staged tiles), warpgroups 1 and 2 compute, 64 query rows each.
constexpr int kWgThreads = 384;
constexpr int kWgRows = 64;        // query rows a consumer warpgroup owns
constexpr int kWgKeys = 64;        // keys a staged tile holds
constexpr int kWgConverters = 3;   // warps
constexpr int kWgTile = 64 * 128;  // bytes of a [64][32] f32 tile: one TMA box, rows of one 128-byte swizzle span
constexpr int kWgGrid = 132;       // persistent blocks: one per SM (ops/attention.py FULL_GRID)
constexpr uint32_t kTf32Hi = 0xffffe000u;
// registers a thread of the feeding and of a consumer warpgroup: 168 each at
// the launch (65,536 over 384 threads), moved by setmaxnreg
constexpr int kWgFeedRegs = 56, kWgComputeRegs = 224;
static_assert(128 * kWgFeedRegs + 256 * kWgComputeRegs <= 65536, "the SM's registers");

// the ring's stages at each depth (ops/attention.py WG_STAGES)
__host__ __device__ constexpr int wg_stages(int depth) { return depth == 32 ? 4 : 2; }
// both consumers' Q as loaded, and at depth 64 its lo part (at 32 Q lives
// in registers); a stage's five tiles (K, K lo, V as loaded, V^T hi, V^T
// lo); the barriers; 1024 bytes to align the swizzled tiles
__host__ __device__ constexpr int wg_smem_bytes(int depth) {
  return kWgTile * (depth / 32) * (depth == 32 ? 2 : 4) + 5 * kWgTile * (depth / 32) * wg_stages(depth) +
         8 * (3 * wg_stages(depth) + 2) + 1024;
}
// the items the persistent blocks share: two heads each where a head is one
// 64-row tile (T <= 64), else 128 query rows of one head
__host__ __device__ inline int wg_items(int bh, int t_len) {
  return t_len <= kWgRows ? (bh + 1) / 2 : bh * ((t_len + 2 * kWgRows - 1) / (2 * kWgRows));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {  // the loop inside: no branch the compiler sees
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @!p bra WAIT;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// box (c0, c1, c2) of a [bh][T][D] f32 tensor into shared memory, zeros past its edges
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// this thread's shared-memory writes, seen by the tensor cores' and the TMA's reads that follow
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte swizzle
// (rows of 128 bytes, 8-row groups 1024 bytes apart; the tile 1024-aligned,
// a k-step's 8 columns 32 bytes on from the last): the start address in the
// low word (bits 0-13, in 16 bytes; the leading offset 1 at bit 16), the
// group stride and the swizzle in the high word. An offset into the tile
// adds to the low word, so a product's descriptor costs one add.
__device__ __forceinline__ uint32_t wg_desc_lo(const void* p) { return ((smem_addr(p) & 0x3ffff) >> 4) | (1u << 16); }
__device__ __forceinline__ uint64_t wg_desc(uint32_t lo, int bytes) {
  return ((uint64_t)(64u | (1u << 30)) << 32) | (lo + (bytes >> 4));
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>  // the newest N committed groups may still run
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// registers the asynchronous products read or write are not touched across the wait
template <int N>
__device__ __forceinline__ void wg_keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wg_keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The accumulator operands of an m64nN product: N / 2 registers a thread
#define WG_REGS4 "{%0, %1, %2, %3}"
#define WG_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_REGS32                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, " \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_ACC4(c) c(d[0]), c(d[1]), c(d[2]), c(d[3])
#define WG_ACC8(c) WG_ACC4(c), c(d[4]), c(d[5]), c(d[6]), c(d[7])
#define WG_ACC16(c) \
  WG_ACC8(c), c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15])
#define WG_ACC32(c)                                                                                              \
  WG_ACC16(c), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]), \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
// "{ setp; wgmma }" with the accumulate flag ACC (0: d = a b, d only written; 1: d += a b) at operand %p
#define WG_MMA(shape, regs, ab, p) \
  "{\n .reg .pred p;\n setp.ne.b32 p, %" #p ", 0;\n wgmma.mma_async.sync.aligned." shape ".f32.tf32.tf32 " regs ", " ab ", p, 1, 1;\n}\n"

// d (64x64, f32) = or += a (64x8, shared) * b (64x8, shared)^T, tf32
template <int ACC>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (ACC) {
    asm volatile(WG_MMA("m64n64k8", WG_REGS32, "%32, %33", 34) : WG_ACC32("+f") : "l"(a), "l"(b), "n"(ACC));
  } else {
    asm volatile(WG_MMA("m64n64k8", WG_REGS32, "%32, %33", 34) : WG_ACC32("=f") : "l"(a), "l"(b), "n"(ACC));
  }
}
// d (64xN, f32) = or += a (64x8, registers) * b (Nx8, shared)^T, tf32; N = 8, 16, 32 or 64
template <int ACC>
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (ACC) {
    asm volatile(WG_MMA("m64n8k8", WG_REGS4, "{%4, %5, %6, %7}, %8", 9)
                 : WG_ACC4("+f") : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(ACC));
  } else {
    asm volatile(WG_MMA("m64n8k8", WG_REGS4, "{%4, %5, %6, %7}, %8", 9)
                 : WG_ACC4("=f") : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(ACC));
  }
}
template <int ACC>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (ACC) {
    asm volatile(WG_MMA("m64n16k8", WG_REGS8, "{%8, %9, %10, %11}, %12", 13)
                 : WG_ACC8("+f") : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(ACC));
  } else {
    asm volatile(WG_MMA("m64n16k8", WG_REGS8, "{%8, %9, %10, %11}, %12", 13)
                 : WG_ACC8("=f") : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(ACC));
  }
}
template <int ACC>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (ACC) {
    asm volatile(WG_MMA("m64n32k8", WG_REGS16, "{%16, %17, %18, %19}, %20", 21)
                 : WG_ACC16("+f") : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(ACC));
  } else {
    asm volatile(WG_MMA("m64n32k8", WG_REGS16, "{%16, %17, %18, %19}, %20", 21)
                 : WG_ACC16("=f") : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(ACC));
  }
}
template <int ACC>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (ACC) {
    asm volatile(WG_MMA("m64n64k8", WG_REGS32, "{%32, %33, %34, %35}, %36", 37)
                 : WG_ACC32("+f") : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(ACC));
  } else {
    asm volatile(WG_MMA("m64n64k8", WG_REGS32, "{%32, %33, %34, %35}, %36", 37)
                 : WG_ACC32("=f") : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(ACC));
  }
}

__device__ __forceinline__ float4 tf32_hi(float4 x) {
  return make_float4(__uint_as_float(__float_as_uint(x.x) & kTf32Hi), __uint_as_float(__float_as_uint(x.y) & kTf32Hi),
                     __uint_as_float(__float_as_uint(x.z) & kTf32Hi), __uint_as_float(__float_as_uint(x.w) & kTf32Hi));
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) { return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w); }

// One item of a block: the head and first query row of each consumer
// warpgroup w, whether it has rows below T (`live`), and the item's K/V
// loads: with T <= 64 one a live head (load j is head j's), else every key
// tile of the one head.
struct WgItem {
  int head0, row0, loads, last_head, t_len;
  bool split;
  __device__ WgItem(int item, int bh, int t) : last_head(bh - 1), t_len(t), split(t <= kWgRows) {
    if (split) {
      head0 = 2 * item, row0 = 0, loads = head0 + 1 < bh ? 2 : 1;
    } else {
      const int q_tiles = (t + 2 * kWgRows - 1) / (2 * kWgRows);
      head0 = item / q_tiles, row0 = (item - head0 * q_tiles) * 2 * kWgRows, loads = (t + kWgKeys - 1) / kWgKeys;
    }
  }
  __device__ int head(int w) const { return split ? head0 + w : head0; }
  __device__ int row(int w) const { return split ? 0 : row0 + w * kWgRows; }
  __device__ bool live(int w) const { return split ? head0 + w <= last_head : row0 + w * kWgRows < t_len; }
};

// The feeding warpgroup: warp 0 issues the TMA copies (Q an item, K and V a
// tile, in the order every role walks them); warps 1-3 convert each staged
// tile: K cut to tf32 hi in place and its lo beside it, V transposed and
// split in two.
template <int DP>
__device__ __forceinline__ void feed(const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map,
                                     int bh, int t_len, int n_items, unsigned char* q_hi, unsigned char* stages,
                                     uint64_t* full, uint64_t* conv, uint64_t* empty, uint64_t* q_full,
                                     uint64_t* q_empty) {
  constexpr int H = DP / 32, S = wg_stages(DP);
  constexpr int kHalves = H * kWgTile, kStage = 5 * kHalves;
  const bool split = t_len <= kWgRows;
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  if (warp == 0) {
    if (lane != 0) return;
    int n = 0;  // loads issued
    for (int k = 0, item = blockIdx.x; item < n_items; ++k, item += gridDim.x) {
      const WgItem it(item, bh, t_len);
      if (k > 0) mbar_wait(q_empty, (k - 1) & 1);  // the consumers have the last item's Q
      mbar_expect_tx(q_full, (it.live(0) + it.live(1)) * kHalves);
      for (int w = 0; w < 2; ++w) {
        if (!it.live(w)) continue;
        for (int h = 0; h < H; ++h) {
          tma_load(q_hi + w * kHalves + h * kWgTile, q_map, q_full, 32 * h, it.row(w), it.head(w));
        }
      }
      for (int j = 0; j < it.loads; ++j, ++n) {
        const int s = n % S;
        if (n >= S) mbar_wait(&empty[s], (n / S - 1) & 1);
        const int head = it.head(split ? j : 0), key0 = split ? 0 : j * kWgKeys;
        unsigned char* st = stages + s * kStage;
        mbar_expect_tx(&full[s], 2 * kHalves);
        for (int h = 0; h < H; ++h) {
          tma_load(st + h * kWgTile, k_map, &full[s], 32 * h, key0, head);
          tma_load(st + 2 * kHalves + h * kWgTile, v_map, &full[s], 32 * h, key0, head);
        }
      }
    }
    return;
  }
  const int ct = tid - 32;
  int n = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const WgItem it(item, bh, t_len);
    for (int j = 0; j < it.loads; ++j, ++n) {
      const int s = n % S;
      mbar_wait(&full[s], (n / S) & 1);
      unsigned char* st = stages + s * kStage;
      float4* kx = reinterpret_cast<float4*>(st);
      float4* kl = reinterpret_cast<float4*>(st + kHalves);
      for (int i = ct; i < kHalves / 16; i += 32 * kWgConverters) {
        const float4 x = kx[i], hi = tf32_hi(x);
        kx[i] = hi;
        kl[i] = sub4(x, hi);
      }
      // V as loaded: key row r of half h at h * tile + 128 r, its 16-byte
      // chunks swizzled by r % 8. V^T: [2 key halves][hi, lo][DP rows][32
      // keys], the same swizzle by row; each 8 keys even first, then odd
      const unsigned char* vr = st + 2 * kHalves;
      unsigned char* vth = st + 3 * kHalves;
      unsigned char* vtl = vth + DP * 128;
      for (int i = ct; i < DP * 8; i += 32 * kWgConverters) {
        const int n_row = i % DP, grp = i / DP;  // depth n_row; keys 8 grp .. 8 grp + 7
        const int h = n_row >> 5, col = n_row & 31;
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = 8 * grp + e;
          x[e] = *reinterpret_cast<const float*>(vr + h * kWgTile + r * 128 + (((col >> 2) ^ (r & 7)) << 4) + (col & 3) * 4);
        }
        const float4 ev = make_float4(x[0], x[2], x[4], x[6]), od = make_float4(x[1], x[3], x[5], x[7]);
        const float4 ev_hi = tf32_hi(ev), od_hi = tf32_hi(od);
        const int row = (grp >> 2) * 2 * DP * 128 + n_row * 128, c0 = 2 * (grp & 3);
        const int a0 = row + ((c0 ^ (n_row & 7)) << 4), a1 = row + (((c0 + 1) ^ (n_row & 7)) << 4);
        *reinterpret_cast<float4*>(vth + a0) = ev_hi;
        *reinterpret_cast<float4*>(vth + a1) = od_hi;
        *reinterpret_cast<float4*>(vtl + a0) = sub4(ev, ev_hi);
        *reinterpret_cast<float4*>(vtl + a1) = sub4(od, od_hi);
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(&conv[s]);
    }
  }
}

// Fragment layouts (PTX ISA, wgmma .tf32): warp wl of a consumer warpgroup
// holds rows 16 wl + g and 16 wl + g + 8 of its 64 (lane = 4 g + tq). An
// m64nN accumulator holds, for each 8 columns j, (row g, columns 8 j + 2 tq,
// + 1) then (row g + 8, the same); a register A operand of k-step j holds
// (row g, k tq), (g + 8, tq), (g, tq + 4), (g + 8, tq + 4). P feeds A straight
// from S's accumulator with k tq standing for key 2 tq of the step and k tq +
// 4 for key 2 tq + 1: V^T's staged rows put each 8 keys in that order (even
// keys, then odd), so the products pair each P with its own V row.
// DP: the depth staged (D zero-padded to 32 or 64); DK: the depth the
// products run at (D rounded up to 8, 16 or 32; 64 at DP = 64), so a small
// head does not pay for the padding.
template <int DP, int DK>
__global__ void __launch_bounds__(kWgThreads, 1)
    attention_tf32x3_kernel_wg(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map, float* __restrict__ o, int bh, int t_len,
                               int d, float c) {
  constexpr int H = DP / 32;  // 32-column halves of the depth: a TMA box and a swizzle span each
  constexpr int S = wg_stages(DP);
  constexpr int kHalves = H * kWgTile;   // bytes of 64 rows at the full depth
  constexpr int kStage = 5 * kHalves;    // K, K lo, V, V^T hi, V^T lo
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_hi = base;                                  // [2][H] tiles, as loaded (depth 64: then cut to tf32)
  unsigned char* q_lo = q_hi + 2 * kHalves;                    // [2][H] at depth 64
  unsigned char* stages = q_lo + (DP == 32 ? 0 : 2 * kHalves);  // [S] stages
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + S * kStage);  // K and V landed
  uint64_t* conv = full + S;                            // the stage converted
  uint64_t* empty = conv + S;                           // the consumers are done with it
  uint64_t* q_full = empty + S;
  uint64_t* q_empty = q_full + 1;

  // the warp's index as a value the compiler knows is the same in every lane:
  // wgmma in a branch it takes for divergent is serialized
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const bool split = t_len <= kWgRows;
  const int n_items = wg_items(bh, t_len);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&conv[s], kWgConverters);
      mbar_init(&empty[s], split ? 4 : 8);  // a load is one warpgroup's with T <= 64, else both's
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Registers: the feeding warpgroup gives up what the consumers' fragments
  // need (the roles' paths never join again: setmaxnreg holds to the end)
  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgFeedRegs));
    feed<DP>(&q_map, &k_map, &v_map, bh, t_len, n_items, q_hi, stages, full, conv, empty, q_full, q_empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgComputeRegs));

  // consumers: warpgroup w, its warp wl owns rows 16 wl .. 16 wl + 15
  const int w = (warp - 4) >> 2, wl = (warp - 4) & 3, wt = tid - 128 * (w + 1);
  const int g = lane >> 2, tq = lane & 3;
  unsigned char* my_lo = q_lo + w * kHalves;
  const uint32_t lo_desc = wg_desc_lo(my_lo);
  unsigned char* my_hi = q_hi + w * kHalves;
  const uint32_t hi_desc = wg_desc_lo(my_hi);
  int n = 0;  // the block's loads before this item
  for (int k = 0, item = blockIdx.x; item < n_items; ++k, item += gridDim.x) {
    const WgItem it(item, bh, t_len);
    const bool live = it.live(w);
    mbar_wait(q_full, k & 1);
    float acc[DK / 2];
    float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8, log2 units
    float l[2] = {0.f, 0.f};              // this lane's part of their running sums
    // Q: at depth 32 the A operand of S from registers, cut to tf32 hi and
    // lo (row g | g + 8, depth 8 kk + tq | + 4), and its buffer free at
    // once; at 64 (the registers are short) cut in place in shared memory,
    // its lo beside it
    uint32_t qf_hi[DP == 32 ? DK / 8 : 1][4], qf_lo[DP == 32 ? DK / 8 : 1][4];
    if constexpr (DP == 32) {
      if (live) {
#pragma unroll
        for (int kk = 0; kk < DK / 8; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * wl + g + 8 * (e & 1), col = 8 * kk + tq + 4 * (e >> 1);
            const float x = *reinterpret_cast<const float*>(my_hi + r * 128 + (((col >> 2) ^ (r & 7)) << 4) + (col & 3) * 4);
            qf_hi[kk][e] = __float_as_uint(x) & kTf32Hi;
            qf_lo[kk][e] = __float_as_uint(x - __uint_as_float(qf_hi[kk][e]));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);
    } else if (live) {
      for (int i = wt; i < kHalves / 16; i += 128) {
        float4* qx = reinterpret_cast<float4*>(my_hi) + i;
        const float4 x = *qx, hi = tf32_hi(x);
        *qx = hi;
        reinterpret_cast<float4*>(my_lo)[i] = sub4(x, hi);
      }
      fence_async_shared();
      group_sync(1 + w, 128);
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < DK / 2; ++i) acc[i] = 0.f;
    }

    // Key tile j + 1's S = Q K^T is issued with tile j's P V, and its
    // softmax runs while that P V does. The issue of a product waits while
    // the tensor cores' queue is full, so tile j's P V goes out in three
    // parts between the parts of that softmax: the tensor cores run on while
    // this warpgroup computes, and the other warpgroup's products fill what
    // is left. Each warpgroup takes a step a tile (with T <= 64 one an item,
    // and none where it has no head); one over rows past T (`live` false)
    // only takes its loads off the ring. A product's issue and its wait
    // stay in one branch: wgmma in flight across a join is serialized.
    const int steps = split ? (live ? 1 : 0) : it.loads;
    float sc[32];             // S, then P, of the newest tile
    uint32_t ph[32], pl[32];  // the tile before's P cut to tf32 hi and its lo, in S's accumulator order
    float pv[DK / 2];
    float corr[2], corr_next[2];
    auto issue_s = [&](int j) {
      wg_fence();
      const uint32_t k_desc = wg_desc_lo(stages + (n + (split ? w : j)) % S * kStage);
#pragma unroll
      for (int kk = 0; kk < DK / 8; ++kk) {  // lo hi, hi lo, hi hi: the k-steps of real depth
        const int off = (kk >> 2) * kWgTile + (kk & 3) * 32;
        if constexpr (DP == 32) {
          if (kk == 0) {
            wgmma_rs<0>(sc, qf_lo[kk], wg_desc(k_desc, off));
          } else {
            wgmma_rs<1>(sc, qf_lo[kk], wg_desc(k_desc, off));
          }
          wgmma_rs<1>(sc, qf_hi[kk], wg_desc(k_desc, kHalves + off));
          wgmma_rs<1>(sc, qf_hi[kk], wg_desc(k_desc, off));
        } else {
          if (kk == 0) {
            wgmma_ss_n64<0>(sc, wg_desc(lo_desc, off), wg_desc(k_desc, off));
          } else {
            wgmma_ss_n64<1>(sc, wg_desc(lo_desc, off), wg_desc(k_desc, off));
          }
          wgmma_ss_n64<1>(sc, wg_desc(hi_desc, off), wg_desc(k_desc, kHalves + off));
          wgmma_ss_n64<1>(sc, wg_desc(hi_desc, off), wg_desc(k_desc, off));
        }
      }
      wg_commit();
    };
    // P V: lo hi, hi lo, hi hi
    auto issue_pv = [&](int s, int kk0, int kk1) {  // k-steps kk0 .. kk1 - 1, one group
      if (kk0 == 0) wg_fence();
      const uint32_t v_desc = wg_desc_lo(stages + s * kStage + 3 * kHalves);
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 8; ++kk) {
        if (kk < kk0 || kk >= kk1) continue;
        const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1], ph[4 * kk + 3]};
        const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 2], pl[4 * kk + 1], pl[4 * kk + 3]};
        const int off = (kk >> 2) * 2 * DP * 128 + (kk & 3) * 32;
        if (kk == 0) {
          wgmma_rs<0>(pv, al, wg_desc(v_desc, off));
        } else {
          wgmma_rs<1>(pv, al, wg_desc(v_desc, off));
        }
        wgmma_rs<1>(pv, ah, wg_desc(v_desc, off + DP * 128));
        wgmma_rs<1>(pv, ah, wg_desc(v_desc, off));
      }
      wg_commit();
    };
    // S to P in place; the running max and sums; corr_next rescales what
    // came before. The scale c goes into each exponent's argument (one
    // fma): the max of c s is c times the max of s, or the min where c < 0.
    int keys = kWgKeys;  // the newest tile's keys below T
    auto exps = [&](int i0, int i1) {  // P of S's entries i0 .. i1 - 1, into the sums
      if (keys == kWgKeys || c != 0.f) {  // keys past T hold -inf / c: their P is 0
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (i < i0 || i >= i1) continue;
          sc[i] = ex2(fmaf(sc[i], c, -m[(i >> 1) & 1]));
          l[(i >> 1) & 1] += sc[i];
        }
      } else {  // c = 0 on the last tile: every key below T weighs the same, the rest 0
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (i < i0 || i >= i1) continue;
          sc[i] = 8 * (i >> 2) + 2 * tq + (i & 1) < keys ? ex2(-m[(i >> 1) & 1]) : 0.f;
          l[(i >> 1) & 1] += sc[i];
        }
      }
    };
    auto softmax = [&](int j) {  // the mask, the max, the first half's exponentials
      keys = min(kWgKeys, t_len - (split ? 0 : j * kWgKeys));
      if (keys < kWgKeys) {  // the last tile: keys past T left out of the max
        const float past = c > 0.f ? -INFINITY : INFINITY;  // times c: -inf
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (8 * (i >> 2) + 2 * tq + (i & 1) >= keys) sc[i] = past;
        }
      }
      float ext[2] = {sc[0], sc[2]};
      if (c > 0.f) {
#pragma unroll
        for (int i = 1; i < 32; ++i) ext[(i >> 1) & 1] = fmaxf(ext[(i >> 1) & 1], sc[i]);
      } else {
#pragma unroll
        for (int i = 1; i < 32; ++i) ext[(i >> 1) & 1] = fminf(ext[(i >> 1) & 1], sc[i]);
      }
      float mx[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(m[r], c * ext[r]);
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr_next[r] = ex2(m[r] - mx[r]);  // 0 on the first tile, where m = -inf
        m[r] = mx[r];
        l[r] *= corr_next[r];
      }
      exps(0, 16);
    };
    auto split_p = [&]() {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        ph[i] = __float_as_uint(sc[i]) & kTf32Hi;
        pl[i] = __float_as_uint(sc[i] - __uint_as_float(ph[i]));
      }
    };

    if (steps > 0) {  // the first tile's S and softmax
      const int ld = n + (split ? w : 0);
      mbar_wait(&conv[ld % S], (ld / S) & 1);
      if (live) {
        issue_s(0);
        wg_wait<0>();
        wg_keep(sc);
        softmax(0);
        exps(16, 32);
        split_p();
      }
    }
    for (int j = 0; j + 1 < steps; ++j) {  // a next tile: its S with this one's P V
      const int ld = n + j, s = ld % S;
      mbar_wait(&conv[(ld + 1) % S], ((ld + 1) / S) & 1);
      if (live) {
        issue_s(j + 1);
        issue_pv(s, 0, 4);
        wg_wait<1>();  // the next tile's S; the first part of this one's P V may still run
        wg_keep(sc);
        corr[0] = corr_next[0];
        corr[1] = corr_next[1];
        softmax(j + 1);
        issue_pv(s, 4, 7);
        exps(16, 32);
        issue_pv(s, 7, 8);
        wg_wait<0>();
        wg_keep(pv);
        wg_keep(ph);
        wg_keep(pl);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (live) {
#pragma unroll
        for (int i = 0; i < DK / 2; ++i) acc[i] = fmaf(acc[i], corr[(i >> 1) & 1], pv[i]);
        split_p();
      }
    }
    if (steps > 0) {  // the last tile's P V
      const int s = (n + (split ? w : steps - 1)) % S;
      if (live) {
        issue_pv(s, 0, 8);
        wg_wait<0>();
        wg_keep(pv);
        wg_keep(ph);
        wg_keep(pl);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (live) {
#pragma unroll
        for (int i = 0; i < DK / 2; ++i) {
          acc[i] = fmaf(acc[i], corr_next[(i >> 1) & 1], pv[i]);
        }
      }
    }
    if constexpr (DP != 32) {
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);
    }
    if (live) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / l[r];
      }
      const int row = it.row(w) + 16 * wl + g;
      float* out = o + (int64_t)it.head(w) * t_len * d;
#pragma unroll
      for (int j = 0; j < DK / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (8 * j < d) {
          if (row < t_len) {
            *reinterpret_cast<float2*>(out + (int64_t)row * d + col) = make_float2(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
          }
          if (row + 8 < t_len) {
            *reinterpret_cast<float2*>(out + (int64_t)(row + 8) * d + col) =
                make_float2(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
          }
        }
      }
    }
    n += it.loads;
  }
}

// cuTensorMapEncodeTiled, found through the runtime (no link to the driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [bh][T][D] f32 read in boxes of 64 rows by 32 columns, 128-byte swizzled, zeros past the edges
bool wg_map(EncodeTiled encode, CUtensorMap* map, const void* p, int bh, int t_len, int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t_len, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)t_len * d * 4};
  const cuuint32_t box[3] = {32, kWgKeys, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int DK>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o, int bh, int t_len, int d, float c,
                      cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map;
  if (!wg_map(encode, &q_map, q, bh, t_len, d) || !wg_map(encode, &k_map, k, bh, t_len, d) ||
      !wg_map(encode, &v_map, v, bh, t_len, d)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = attention_tf32x3_kernel_wg<DP, DK>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg_smem_bytes(DP));
  if (err != cudaSuccess) return err;
  const int blocks = wg_items(bh, t_len) < kWgGrid ? wg_items(bh, t_len) : kWgGrid;
  kernel<<<blocks, kWgThreads, wg_smem_bytes(DP), stream>>>(q_map, k_map, v_map, static_cast<float*>(o), bh, t_len, d, c);
  return cudaSuccess;
}

bool bad_plan(int variant, int bh, int t_len, int d, int dtype, int threads, int rows, int key_tile, int depth,
              int smem_bytes, int stages) {
  if ((variant == kTf32x3Wg) != (stages != 0)) return true;  // only tf32x3_wg has a ring of stages
  switch (variant) {
    case kTf32x3Wg:
      return dtype != bd::kFloat32 || d > 64 || depth != (d <= 32 ? 32 : 64) || threads != kWgThreads ||
             rows != kWgRows || key_tile != kWgKeys || stages != wg_stages(depth) ||
             smem_bytes != wg_smem_bytes(depth) || smem_bytes > kSmemLimit;
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
// shared memory, ring stages) is ops/attention.py `attention_plan`'s; one that does not
// fit the shape is refused. Returns a cudaError_t code (0 on success).
// Launches on `device`, the tensors' (bd::DeviceGuard), in `stream_ptr`.
extern "C" int bd_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh, int t_len, int d,
                                float scale, int dtype, int variant, int threads, int rows, int key_tile,
                                int depth, int smem_bytes, int stages, int device, void* stream_ptr) {
  if (bh <= 0 || t_len < 1 || t_len > kMaxT || d < 8 || d > 512 || d % 8 != 0 || (int64_t)bh * t_len > INT_MAX ||
      (dtype != bd::kFloat32 && dtype != bd::kBFloat16) ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15) != 0 ||
      bad_plan(variant, bh, t_len, d, dtype, threads, rows, key_tile, depth, smem_bytes, stages)) {
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
  } else if (variant == kTf32x3Wg) {
    const float c = scale * kLog2e;
    cudaError_t err;  // the depth the products run at: D rounded up to 8, 16, 32 or 64
    switch (d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : 64) {
      case 8: err = launch_wg<32, 8>(q, k, v, o, bh, t_len, d, c, stream); break;
      case 16: err = launch_wg<32, 16>(q, k, v, o, bh, t_len, d, c, stream); break;
      case 32: err = launch_wg<32, 32>(q, k, v, o, bh, t_len, d, c, stream); break;
      default: err = launch_wg<64, 64>(q, k, v, o, bh, t_len, d, c, stream); break;
    }
    if (err != cudaSuccess) return (int)err;
  } else {
    const float c = scale * kLog2e;
    const int dw = depth / (threads / (2 * rows));
    cudaError_t err;
    if (variant == kTf32x3) {
      if (dw == 64) {
        err = key_tile == 16 ? launch_split<float>(attention_tf32x3_kernel<64, 16>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream)
                             : launch_split<float>(attention_tf32x3_kernel<64, 32>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream);
      } else {
        err = key_tile == 16 ? launch_split<float>(attention_tf32x3_kernel<128, 16>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream)
                             : launch_split<float>(attention_tf32x3_kernel<128, 32>, q, k, v, o, bh, t_len, d, c, threads, rows, smem_bytes, stream);
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
