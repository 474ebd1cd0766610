// K7: the Difference-of-Gaussians of the NMI gate, in three launches.
//
// Replaces no TPU kernel: the JAX package leaves its DoG
// (microaligner_tpu/ops/filters.py::dog) to XLA.  It was added because the
// plain version on the card (ops/filters.py through sep_filter2d) makes one
// multiply and one add a tap, each a pass over a float32 plane: about 350
// launches and 1.4 TB of traffic a DoG at 20480^2, and OptFlowReg's gate
// runs three DoGs a pyramid level, FeatureReg's gate and find more.
//
// It computes the plain version's arithmetic, in its order, so the u8 output
// is bit-equal to it:
//   lo, hi = min and max of the input as float;
//   scale = hi > lo ? 1 / (hi - lo) : 0;  f = (x - lo) * scale
//   for each sigma, along W and then along H, REFLECT_101 borders:
//     acc = f_0 k_0;  acc = acc + f_t k_t for t = 1 .. K-1
//   d = hs - ls
//   lo2, hi2 = min and max of d;  scale2 = hi2 > lo2 ? 255 / (hi2 - lo2) : 0
//   out = u8(clamp(rint((d - lo2) * scale2), 0, 255))
// Every product, sum and quotient is a __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, which nvcc never contracts into an FMA.
//
// Bound on the H100: float32 operations.  4 x (K + K - 1) = 324 a pixel at
// K = 41, none of them an FMA, so they issue at half of the card's 67
// TFLOP/s; the bytes are about 11 a pixel (the input twice, d out and back,
// the u8 out).  The design:
// - Launch 1 (`minmax_kernel`) writes each block's min and max of the input;
//   its block 0 also resets the order keys of d's min and max.
// - Launch 2 (`dog_tile_kernel`): a block owns a tile of 152 x 32 outputs.
//   It reduces launch 1's partials itself (no host round trip), stages the
//   (152 + 2r) x (32 + 2r) window of f in shared memory with the REFLECT_101
//   fold applied at the load (the fold tables come from the wrapper, copied
//   to the device with each call, so nothing stays allocated), runs
//   both sigmas' W passes over the window's rows (one staged value feeds
//   both), keeps both results in shared memory, and runs both H passes.  It
//   writes d and folds its min and max into d's order keys with two atomics.
//   The staged rows above and below the tile are the cost of tiling: 367
//   operations a pixel where the algorithm needs 324.
// - A thread owns a run of consecutive outputs along the filtered axis (8 in
//   the W pass, 19 in the H pass) and slides a register window over its
//   inputs, so one shared-memory load feeds 2 x 8 or 19 multiplies and
//   adds.  The taps are kernel parameters (constant memory), the same for
//   the whole warp.  Rows of the staged window lie on an odd stride, so the
//   32 lanes of the W pass, one row each, hit 32 banks; in the H pass the
//   lanes are 32 consecutive columns.
// - 107 KB of shared memory a block at K = 41: two blocks an SM, so one
//   block's staging overlaps the other's sums.
// - Launch 3 (`quantize_kernel`) reads d's min and max from the keys and
//   writes the u8 plane, four pixels a thread.
// Scratch: one float32 plane (d) and a small head (the partials, the keys,
// the fold tables).
//
// K = 41, what the callers pass, is unrolled with the window in registers;
// any other odd K up to 81 takes the same kernel with the taps in a loop and
// the window read from shared memory (same arithmetic, slower).
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 32;                 // output columns a tile: one a lane in the H pass
constexpr int kRunV = 19;                  // consecutive outputs a thread in the H pass
constexpr int kTileH = kRunV * kWarps;     // output rows a tile: 152
constexpr int kRunH = 8;                   // consecutive outputs a thread in the W pass
constexpr int kFastTaps = 41;              // the unrolled instantiation
constexpr int kMaxTaps = 81;
constexpr int kHStride = kTileW + 1;       // the W passes' results, odd row stride
constexpr int kMinmaxBlocks = 512;         // launch 1's grid at most, and its partials
constexpr int kStageGroup = 8;             // staged rows a warp loads before it stores them

static_assert(kTileW % kRunH == 0, "whole runs a row");

struct Taps {
  float lo[kMaxTaps];
  float hi[kMaxTaps];
};

__host__ __device__ constexpr int staged_rows(int r) { return kTileH + 2 * r; }
__host__ __device__ constexpr int staged_cols(int r) { return kTileW + 2 * r; }
__host__ __device__ constexpr int in_stride(int r) { return staged_cols(r) | 1; }
__host__ __device__ constexpr int tile_smem_floats(int r) {
  return staged_rows(r) * (in_stride(r) + 2 * kHStride);
}

// An int that orders as the float does (-0 below +0), for atomicMin/atomicMax.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float key_value(int k) { return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff); }

__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ unsigned vmin(unsigned a, unsigned b) { return min(a, b); }
__device__ __forceinline__ unsigned vmax(unsigned a, unsigned b) { return max(a, b); }

// The block's min and max, in every thread; `red` holds 2 * kWarps values.
template <typename V>
__device__ __forceinline__ void block_minmax(V& lo, V& hi, V* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = vmin(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = vmax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) {
    red[warp] = lo;
    red[kWarps + warp] = hi;
  }
  __syncthreads();
  lo = red[0];
  hi = red[kWarps];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    lo = vmin(lo, red[i]);
    hi = vmax(hi, red[kWarps + i]);
  }
}

// Launch 1: partial[b] = (min, max) of the input as float over block b's
// share.  Integer inputs are compared as integers and converted once.
template <typename T>
__global__ void __launch_bounds__(kThreads) minmax_kernel(const T* __restrict__ img, int64_t n,
                                                          float2* __restrict__ partial, int* __restrict__ dkeys) {
  using A = std::conditional_t<std::is_same_v<T, float>, float, unsigned>;
  __shared__ A red[2 * kWarps];
  A lo, hi;
  if constexpr (std::is_same_v<T, float>) {
    lo = INFINITY;
    hi = -INFINITY;
  } else {
    lo = UINT_MAX;
    hi = 0;
  }
  constexpr int kPer = 16 / sizeof(T);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  // elements before the first 16-byte boundary and after the last whole vector
  const int64_t lead = (16 - reinterpret_cast<uintptr_t>(img) % 16) % 16 / sizeof(T);
  const int64_t head = lead < n ? lead : n;
  const int64_t nvec = (n - head) / kPer;
  for (int64_t i = first; i < head; i += step) {
    lo = vmin(lo, static_cast<A>(img[i]));
    hi = vmax(hi, static_cast<A>(img[i]));
  }
  for (int64_t i = head + nvec * kPer + first; i < n; i += step) {
    lo = vmin(lo, static_cast<A>(img[i]));
    hi = vmax(hi, static_cast<A>(img[i]));
  }
  const uint4* vec = reinterpret_cast<const uint4*>(img + head);
#pragma unroll 4
  for (int64_t v = first; v < nvec; v += step) {
    const uint4 q = __ldg(vec + v);
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      lo = vmin(lo, static_cast<A>(e[k]));
      hi = vmax(hi, static_cast<A>(e[k]));
    }
  }
  block_minmax(lo, hi, red);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = make_float2(static_cast<float>(lo), static_cast<float>(hi));
    if (blockIdx.x == 0) {
      dkeys[0] = INT_MAX;
      dkeys[1] = INT_MIN;
    }
  }
}

// The window of f for the tile at (y0, x0): staged row i, column j is the
// input at the folded position (rows[y0 + i], cols[x0 + j]), normalized.
// A warp owns every kWarps-th row, a lane every 32nd column; each warp
// loads kStageGroup rows before it stores them.  Rows and columns past the
// tables (tiles over the image's edge) repeat the tables' last entry: they
// feed only outputs that are not stored.
template <typename T, int kCols>
__device__ __forceinline__ void stage(const T* __restrict__ img, int h, int w, int r, int y0, int x0,
                                      const int* __restrict__ rows, const int* __restrict__ cols, float lo,
                                      float scale, float* in) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nr = staged_rows(r), nc = staged_cols(r), stride = in_stride(r);
  int gx[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) gx[q] = __ldg(cols + min(x0 + lane + 32 * q, w + 2 * r - 1));
  for (int i0 = warp; i0 < nr; i0 += kWarps * kStageGroup) {
    float v[kStageGroup][kCols];
#pragma unroll
    for (int g = 0; g < kStageGroup; ++g) {
      const int i = min(i0 + g * kWarps, nr - 1);
      const T* src = img + static_cast<int64_t>(__ldg(rows + min(y0 + i, h + 2 * r - 1))) * w;
#pragma unroll
      for (int q = 0; q < kCols; ++q) v[g][q] = static_cast<float>(src[gx[q]]);
    }
#pragma unroll
    for (int g = 0; g < kStageGroup; ++g) {
      const int i = i0 + g * kWarps;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = lane + 32 * q;
        if (i < nr && j < nc) in[i * stride + j] = ma::mul(ma::sub(v[g][q], lo), scale);
      }
    }
  }
}

// alo[j] = sum_t taps.lo[t] a[(j + t) stride], ahi[j] = sum_t taps.hi[t]
// b[(j + t) stride], t ascending from a first product, each product and
// sum rounded.  kOne: b is a (the W pass), and each load feeds both.
// K > 0: K taps, unrolled, the window of R inputs in registers; K = 0: n
// taps in a loop.
template <int K, int R, bool kOne>
__device__ __forceinline__ void correlate(const float* a, const float* b, int stride, const Taps& taps, int n,
                                          float (&alo)[R], float (&ahi)[R]) {
  if constexpr (K > 0) {
    float wa[R], wb[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      wa[j] = a[j * stride];
      wb[j] = kOne ? wa[j] : b[j * stride];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      alo[j] = ma::mul(wa[j], taps.lo[0]);
      ahi[j] = ma::mul(wb[j], taps.hi[0]);
    }
#pragma unroll
    for (int t = 1; t < K; ++t) {
#pragma unroll
      for (int j = 0; j + 1 < R; ++j) {
        wa[j] = wa[j + 1];
        wb[j] = wb[j + 1];
      }
      wa[R - 1] = a[(t + R - 1) * stride];
      wb[R - 1] = kOne ? wa[R - 1] : b[(t + R - 1) * stride];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        alo[j] = ma::add(alo[j], ma::mul(wa[j], taps.lo[t]));
        ahi[j] = ma::add(ahi[j], ma::mul(wb[j], taps.hi[t]));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      alo[j] = ma::mul(a[j * stride], taps.lo[0]);
      ahi[j] = ma::mul(b[j * stride], taps.hi[0]);
    }
    for (int t = 1; t < n; ++t) {
      const float tl = taps.lo[t], th = taps.hi[t];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        alo[j] = ma::add(alo[j], ma::mul(a[(t + j) * stride], tl));
        ahi[j] = ma::add(ahi[j], ma::mul(b[(t + j) * stride], th));
      }
    }
  }
}

// Launch 2: d over one 152 x 32 tile, and its min and max into dkeys.
template <int K>
__global__ void __launch_bounds__(kThreads, 2)
dog_tile_kernel(const void* __restrict__ img, int dtype, int h, int w, const int* __restrict__ rows,
                const int* __restrict__ cols, const float2* __restrict__ partial, int npartial,
                const __grid_constant__ Taps taps, int n, float* __restrict__ d, int* __restrict__ dkeys) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float fred[2 * kWarps];
  __shared__ int kred[2 * kWarps];
  constexpr int kCols = (kTileW + (K ? K : kMaxTaps) - 1 + 31) / 32;
  const int ntaps = K ? K : n;
  const int r = ntaps / 2;
  const int nr = staged_rows(r);
  const int stride = in_stride(r);
  float* in = smem;
  float* hlo = in + nr * stride;
  float* hhi = hlo + nr * kHStride;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;

  float lo = INFINITY, hi = -INFINITY;
  for (int i = tid; i < npartial; i += kThreads) {
    const float2 p = partial[i];
    lo = fminf(lo, p.x);
    hi = fmaxf(hi, p.y);
  }
  block_minmax(lo, hi, fred);
  const float scale = hi > lo ? __fdiv_rn(1.0f, ma::sub(hi, lo)) : 0.0f;

  if (dtype == 0)
    stage<uint8_t, kCols>(static_cast<const uint8_t*>(img), h, w, r, y0, x0, rows, cols, lo, scale, in);
  else if (dtype == 1)
    stage<uint16_t, kCols>(static_cast<const uint16_t*>(img), h, w, r, y0, x0, rows, cols, lo, scale, in);
  else
    stage<float, kCols>(static_cast<const float*>(img), h, w, r, y0, x0, rows, cols, lo, scale, in);
  __syncthreads();

  // W passes over every staged row, lanes on consecutive rows
  constexpr int kRuns = kTileW / kRunH;
  for (int task = tid; task < nr * kRuns; task += kThreads) {
    const int run = task / nr, row = task - run * nr;
    const float* src = in + row * stride + run * kRunH;
    float alo[kRunH], ahi[kRunH];
    correlate<K, kRunH, true>(src, src, 1, taps, ntaps, alo, ahi);
#pragma unroll
    for (int j = 0; j < kRunH; ++j) {
      hlo[row * kHStride + run * kRunH + j] = alo[j];
      hhi[row * kHStride + run * kRunH + j] = ahi[j];
    }
  }
  __syncthreads();

  // H passes: lane = column, warp = a run of kRunV rows
  const int i0 = warp * kRunV;
  float ls[kRunV], hs[kRunV];
  correlate<K, kRunV, false>(hlo + i0 * kHStride + lane, hhi + i0 * kHStride + lane, kHStride, taps, ntaps, ls,
                             hs);
  int kmin = INT_MAX, kmax = INT_MIN;
  const int x = x0 + lane;
#pragma unroll
  for (int j = 0; j < kRunV; ++j) {
    const int y = y0 + i0 + j;
    if (x < w && y < h) {
      const float v = ma::sub(hs[j], ls[j]);
      d[static_cast<int64_t>(y) * w + x] = v;
      kmin = min(kmin, order_key(v));
      kmax = max(kmax, order_key(v));
    }
  }
  block_minmax(kmin, kmax, kred);
  if (tid == 0 && kmin <= kmax) {
    atomicMin(dkeys, kmin);
    atomicMax(dkeys + 1, kmax);
  }
}

__device__ __forceinline__ uint8_t quantize(float v, float lo, float scale) {
  const float q = rintf(ma::mul(ma::sub(v, lo), scale));
  return static_cast<uint8_t>(fminf(fmaxf(q, 0.0f), 255.0f));
}

// Launch 3: out = the u8 min-max of d, four pixels a thread.
__global__ void __launch_bounds__(kThreads) quantize_kernel(const float* __restrict__ d, int64_t n,
                                                            const int* __restrict__ dkeys,
                                                            uint8_t* __restrict__ out) {
  const float lo = key_value(dkeys[0]), hi = key_value(dkeys[1]);
  const float scale = hi > lo ? __fdiv_rn(255.0f, ma::sub(hi, lo)) : 0.0f;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t n4 = n / 4;
  for (int64_t v = first; v < n4; v += step) {
    const float4 q = reinterpret_cast<const float4*>(d)[v];
    reinterpret_cast<uchar4*>(out)[v] =
        make_uchar4(quantize(q.x, lo, scale), quantize(q.y, lo, scale), quantize(q.z, lo, scale),
                    quantize(q.w, lo, scale));
  }
  for (int64_t i = 4 * n4 + first; i < n; i += step) out[i] = quantize(d[i], lo, scale);
}

template <typename T>
void launch_minmax(const void* img, int64_t n, int blocks, float2* partial, int* dkeys, cudaStream_t stream) {
  minmax_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(img), n, partial, dkeys);
}

}  // namespace

// img: (h, w) contiguous, dtype 0 = u8, 1 = u16, 2 = float.  folds: the
// REFLECT_101 fold tables of the rows (h + 2r entries, r = ksize / 2) and
// then the columns (w + 2r).  taps_host: 2 x ksize floats in host memory,
// the low sigma's then the high one's.  head: 2 * kMinmaxBlocks + 2 floats.
// d: h * w floats, 16-byte aligned.  out: (h, w) u8, 4-byte aligned.
extern "C" int ma_dog_u8(const void* img, int dtype, int h, int w, const int* folds, const float* taps_host,
                         int ksize, float* head, float* d, uint8_t* out, cudaStream_t stream) {
  if (ksize < 1 || ksize > kMaxTaps || ksize % 2 == 0 || dtype < 0 || dtype > 2 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps taps{};
  for (int t = 0; t < ksize; ++t) {
    taps.lo[t] = taps_host[t];
    taps.hi[t] = taps_host[ksize + t];
  }
  const int64_t n = static_cast<int64_t>(h) * w;
  const int blocks = static_cast<int>(std::min<int64_t>(kMinmaxBlocks, (n + 4095) / 4096));
  float2* partial = reinterpret_cast<float2*>(head);
  int* dkeys = reinterpret_cast<int*>(head + 2 * kMinmaxBlocks);
  if (dtype == 0)
    launch_minmax<uint8_t>(img, n, blocks, partial, dkeys, stream);
  else if (dtype == 1)
    launch_minmax<uint16_t>(img, n, blocks, partial, dkeys, stream);
  else
    launch_minmax<float>(img, n, blocks, partial, dkeys, stream);

  const int r = ksize / 2;
  const int* rows = folds;
  const int* cols = folds + h + 2 * r;
  const int smem = tile_smem_floats(r) * static_cast<int>(sizeof(float));
  auto kernel = ksize == kFastTaps ? dog_tile_kernel<kFastTaps> : dog_tile_kernel<0>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  kernel<<<grid, kThreads, smem, stream>>>(img, dtype, h, w, rows, cols, partial, blocks, taps, ksize, d, dkeys);

  const int64_t quads = (n / 4 + kThreads - 1) / kThreads;
  const int qblocks = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(4096, quads)));
  quantize_kernel<<<qblocks, kThreads, 0, stream>>>(d, n, dkeys, out);
  return static_cast<int>(cudaGetLastError());
}
