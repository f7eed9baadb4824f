// Per-channel shift of a convolution's output, forward and backward, for
// Hopper (sm_90a): the conv's bias, and a resnet's time embedding, added in
// one pass; their gradients summed in one deterministic reduce.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses the bias add into the
// convolution. Here cuDNN runs every conv of the port without its bias and
// this pass follows it (ops/bias_shift.py, models/resnet.py `Conv2d`):
//   y[b, p, c] = round(y[b, p, c] + (bias[c] + row[b, c]))
// in place on the conv's contiguous NHWC output y [B, H*W, C], in f32 and
// rounded once to y's dtype. bias is the f32 parameter; row (optional) is a
// [B, C] shift in y's dtype: a resnet's time-embedding projection, whose
// own broadcast pass over the tensor is then gone. The backward reads the
// output cotangent g once and writes the per-(b, c) f32 sums over H*W: the
// row's gradient (rounded to its dtype) and, summed over b, the bias's (f32).
// The gradient of y is g itself.
//
// What bounds it: bytes. The forward reads and writes y once (4 bytes an
// element in bf16), the backward reads g once; a few adds an element. One
// forward of google/ddpm-ema-celebahq-256 at B=16 in bf16 shifts 2.92 G
// elements (96 convs), 11.7 GB: 3.49 ms at 3.35 TB/s.
//
// Design: a thread keeps one pack column, VEC channels (16-byte loads and
// stores where C and the pointer allow; C = 3 takes packs of 1), at every
// pixel it visits, so its bias/row values are loaded once and stay in
// registers. A block is `rows` pixel rows of `cols` = C / VEC pack columns:
// neighbouring threads touch neighbouring packs, so each warp's accesses are
// contiguous. Forward: block (x, b) covers kUnroll * rows pixels of batch row
// b, its loads issued before its stores; the grid is sized to the tensor.
// Backward: block (k, b) sums the pixels of chunk k of batch row b in f32
// registers, reduces its `rows` partial sums per channel in shared memory in
// a fixed order and writes them to an f32 [B, chunks, C] workspace; a second
// kernel folds the chunks of each (b, c) in order, then the batch rows in a
// fixed order. No atomics: the gradients are the same bits on every run. The
// launch plan (pack width, threads, grid, chunks) is chosen in Python
// (`bias_shift_plan`) and checked here. Both launch on the caller's stream,
// allocate nothing and never synchronise (CUDA-graph capture works).

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;      // pixel rows a thread loads before it uses them
constexpr int kFoldCols = 32;   // channels a fold block owns
constexpr int kFoldSlices = 32; // batch-row slices of a fold block

template <typename T, int VEC, bool ROW>
__global__ void __launch_bounds__(kMaxThreads)
    bias_shift_fwd_kernel(T* y, const float* __restrict__ bias, const T* __restrict__ row, int hw, int c, int cols,
                          int rows) {
  using P = bd::Pack<T, VEC>;
  const int col = threadIdx.x % cols;
  const int r = threadIdx.x / cols;
  const int b = blockIdx.y;
  const int c0 = col * VEC;
  float shift[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    shift[v] = bias[c0 + v];
    if constexpr (ROW) shift[v] += bd::to_f32(row[(int64_t)b * c + c0 + v]);
  }
  T* base = y + (int64_t)b * hw * c + c0;
  const int p0 = blockIdx.x * (kUnroll * rows) + r;
  P vals[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = p0 + u * rows;
    if (p < hw) vals[u] = *reinterpret_cast<const P*>(base + (int64_t)p * c);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = p0 + u * rows;
    if (p < hw) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) vals[u].v[v] = bd::from_f32<T>(bd::to_f32(vals[u].v[v]) + shift[v]);
      *reinterpret_cast<P*>(base + (int64_t)p * c) = vals[u];
    }
  }
}

// Block (k, b): the f32 sums over pixels [k * chunk_rows, (k + 1) * chunk_rows)
// of batch row b, one per channel, into partial[b, k, :].
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    bias_shift_bwd_kernel(const T* __restrict__ g, float* __restrict__ partial, int hw, int c, int cols, int rows,
                          int chunk_rows) {
  using P = bd::Pack<T, VEC>;
  extern __shared__ float red[];  // [rows][c]
  const int col = threadIdx.x % cols;
  const int r = threadIdx.x / cols;
  const int b = blockIdx.y;
  const int c0 = col * VEC;
  const T* base = g + (int64_t)b * hw * c + c0;
  const int start = blockIdx.x * chunk_rows;
  const int end = min(hw, start + chunk_rows);
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  for (int p = start + r; p < end; p += kUnroll * rows) {
    P vals[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q < end) vals[u] = *reinterpret_cast<const P*>(base + (int64_t)q * c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * rows < end) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += bd::to_f32(vals[u].v[v]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) red[r * c + c0 + v] = acc[v];
  __syncthreads();
  float* out = partial + ((int64_t)b * gridDim.x + blockIdx.x) * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < rows; ++i) s += red[i * c + ch];
    out[ch] = s;
  }
}

// Block x owns channels [32x, 32x + 32); thread (col, s) folds the chunks of
// batch rows s, s + 32, ... in order (the row shift's gradient, when drow is
// given), then slice 0 folds the slices in order (the bias's).
template <typename T>
__global__ void __launch_bounds__(kFoldCols* kFoldSlices)
    bias_shift_fold_kernel(const float* __restrict__ partial, float* __restrict__ dbias, T* __restrict__ drow,
                           int batch, int chunks, int c) {
  __shared__ float slice_sum[kFoldSlices][kFoldCols];
  const int col = threadIdx.x % kFoldCols;
  const int s = threadIdx.x / kFoldCols;
  const int ch = blockIdx.x * kFoldCols + col;
  float total = 0.f;
  if (ch < c) {
    for (int b = s; b < batch; b += kFoldSlices) {
      const float* in = partial + (int64_t)b * chunks * c + ch;
      float sum = 0.f;
#pragma unroll 8
      for (int k = 0; k < chunks; ++k) sum += in[(int64_t)k * c];
      if (drow != nullptr) drow[(int64_t)b * c + ch] = bd::from_f32<T>(sum);
      total += sum;
    }
  }
  slice_sum[s][col] = total;
  __syncthreads();
  if (s == 0 && ch < c) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kFoldSlices; ++i) sum += slice_sum[i][col];
    dbias[ch] = sum;
  }
}

bool bad_plan(int batch, int hw, int c, int vec, int threads, int elem_bytes, const void* ptr) {
  if (batch <= 0 || batch > 65535 || hw <= 0 || c <= 0 || (int64_t)hw * c > 0x7fffffff) return true;
  if (vec <= 0 || (vec & (vec - 1)) != 0 || vec * elem_bytes > 16 || c % vec != 0 ||
      (uintptr_t)ptr % (uintptr_t)(vec * elem_bytes) != 0) {
    return true;
  }
  const int cols = c / vec;
  return threads <= 0 || threads > kMaxThreads || threads % cols != 0;
}

template <typename T, int VEC>
cudaError_t launch_fwd(T* y, const float* bias, const T* row, int batch, int hw, int c, int threads, int blocks,
                       cudaStream_t stream) {
  const int cols = c / VEC, rows = threads / cols;
  const dim3 grid(blocks, batch);
  if (row != nullptr) {
    bias_shift_fwd_kernel<T, VEC, true><<<grid, threads, 0, stream>>>(y, bias, row, hw, c, cols, rows);
  } else {
    bias_shift_fwd_kernel<T, VEC, false><<<grid, threads, 0, stream>>>(y, bias, row, hw, c, cols, rows);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(void* y, const float* bias, const void* row, int batch, int hw, int c, int vec,
                         int threads, int blocks, cudaStream_t stream) {
  T* yt = static_cast<T*>(y);
  const T* rt = static_cast<const T*>(row);
  switch (vec) {
    case 1: return launch_fwd<T, 1>(yt, bias, rt, batch, hw, c, threads, blocks, stream);
    case 2: return launch_fwd<T, 2>(yt, bias, rt, batch, hw, c, threads, blocks, stream);
    case 4: return launch_fwd<T, 4>(yt, bias, rt, batch, hw, c, threads, blocks, stream);
    default:
      if constexpr (sizeof(T) == 2) {
        return launch_fwd<T, 8>(yt, bias, rt, batch, hw, c, threads, blocks, stream);
      } else {
        return cudaErrorInvalidValue;
      }
  }
}

template <typename T, int VEC>
cudaError_t launch_bwd(const T* g, float* partial, float* dbias, T* drow, int batch, int hw, int c, int threads,
                       int chunks, int chunk_rows, cudaStream_t stream) {
  const int cols = c / VEC, rows = threads / cols;
  const size_t smem = (size_t)rows * c * sizeof(float);
  bias_shift_bwd_kernel<T, VEC><<<dim3(chunks, batch), threads, smem, stream>>>(g, partial, hw, c, cols, rows,
                                                                                 chunk_rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bias_shift_fold_kernel<T><<<(c + kFoldCols - 1) / kFoldCols, kFoldCols * kFoldSlices, 0, stream>>>(
      partial, dbias, drow, batch, chunks, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* g, float* partial, float* dbias, void* drow, int batch, int hw, int c, int vec,
                         int threads, int chunks, int chunk_rows, cudaStream_t stream) {
  const T* gt = static_cast<const T*>(g);
  T* rt = static_cast<T*>(drow);
  switch (vec) {
    case 1: return launch_bwd<T, 1>(gt, partial, dbias, rt, batch, hw, c, threads, chunks, chunk_rows, stream);
    case 2: return launch_bwd<T, 2>(gt, partial, dbias, rt, batch, hw, c, threads, chunks, chunk_rows, stream);
    case 4: return launch_bwd<T, 4>(gt, partial, dbias, rt, batch, hw, c, threads, chunks, chunk_rows, stream);
    default:
      if constexpr (sizeof(T) == 2) {
        return launch_bwd<T, 8>(gt, partial, dbias, rt, batch, hw, c, threads, chunks, chunk_rows, stream);
      } else {
        return cudaErrorInvalidValue;
      }
  }
}

}  // namespace

// y: [batch, hw, c] contiguous in `dtype`, shifted in place; bias: [c] f32;
// row: [batch, c] in `dtype`, or null. The launch plan: packs of vec
// elements, threads per block (a multiple of c / vec), blocks along the
// pixels of each batch row (covering hw at kUnroll * threads / (c / vec)
// pixels a block). Returns a cudaError_t code (0 on success); a plan that
// does not fit the shape or y's alignment is cudaErrorInvalidValue.
// Launches on `device`, y's (bd::DeviceGuard), in `stream_ptr`.
extern "C" int bd_bias_shift_fwd(void* y, const float* bias, const void* row, int batch, int hw, int c, int vec,
                                 int threads, int blocks, int dtype, int device, void* stream_ptr) {
  if ((dtype != bd::kFloat32 && dtype != bd::kBFloat16) ||
      bad_plan(batch, hw, c, vec, threads, dtype == bd::kFloat32 ? 4 : 2, y) || blocks <= 0 ||
      (int64_t)blocks * kUnroll * (threads / (c / vec)) < hw) {
    return (int)cudaErrorInvalidValue;
  }
  const bd::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)(dtype == bd::kFloat32
                   ? dispatch_fwd<float>(y, bias, row, batch, hw, c, vec, threads, blocks, stream)
                   : dispatch_fwd<__nv_bfloat16>(y, bias, row, batch, hw, c, vec, threads, blocks, stream));
}

// g: [batch, hw, c] contiguous in `dtype`; partial: an f32 [batch, chunks, c]
// workspace; dbias: the f32 [c] result; drow: the [batch, c] result in
// `dtype`, or null. The launch plan: packs of vec elements, threads per
// block (a multiple of c / vec), chunks of chunk_rows pixels (a multiple of
// kUnroll * threads / (c / vec)) covering hw. Returns a cudaError_t code.
// Launches on `device`, g's (bd::DeviceGuard), in `stream_ptr`.
extern "C" int bd_bias_shift_bwd(const void* g, float* partial, float* dbias, void* drow, int batch, int hw, int c,
                                 int vec, int threads, int chunks, int chunk_rows, int dtype, int device,
                                 void* stream_ptr) {
  if ((dtype != bd::kFloat32 && dtype != bd::kBFloat16) ||
      bad_plan(batch, hw, c, vec, threads, dtype == bd::kFloat32 ? 4 : 2, g) || chunks <= 0 || chunk_rows <= 0 ||
      (int64_t)chunks * chunk_rows < hw || (int64_t)(chunks - 1) * chunk_rows >= hw ||
      (int64_t)threads * vec * sizeof(float) > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const bd::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)(dtype == bd::kFloat32
                   ? dispatch_bwd<float>(g, partial, dbias, drow, batch, hw, c, vec, threads, chunks, chunk_rows,
                                         stream)
                   : dispatch_bwd<__nv_bfloat16>(g, partial, dbias, drow, batch, hw, c, vec, threads, chunks,
                                                 chunk_rows, stream));
}
