// K3: Gaussian window aggregation of the five normal-equation planes and the
// per-pixel 2x2 solve.
//
// Replaces microaligner_tpu/ops/pallas_agg.py::pallas_smooth5_solve (pass 1
// `_smooth_w_padded` / `_w_kernel_ring`, pass 2 `_h_solve_kernel_ring`).  The
// window has 2r+1 taps (r = winsize // 2, sigma = 0.3 r) and a replicate
// border.  Pass 1 smooths each plane along W into a scratch tensor; pass 2
// smooths along H and solves
//   det = g11 g22 - g12^2 + 1e-3,  fx = (g11 h2 - g12 h1) / det,
//   fy = (g22 h1 - g12 h2) / det,
// writing only fx and fy.
//
// Bound on the H100: float32 arithmetic, one fused multiply-add a tap, pass,
// channel and pixel (99 x 5 x 2 on the main path); the scratch's round trip
// through device memory comes second (about 95 bytes a pixel in all, tile
// halos included, against 1,980 multiply-adds).  The design keeps the other
// pipes out of the multiply-add's way:
// - A thread owns kOut = 16 consecutive outputs along the filtered axis and
//   slides a register window over the inputs they need, so a value loaded
//   from shared memory feeds 16 multiply-adds (`slide`).  In pass 2 a thread
//   is one column of a 32-column tile and the 32 lanes read 32 consecutive
//   floats.  In pass 1 it is one row of a 32-row tile and loads its inputs 16
//   bytes at a time; the row stride is 4 mod 8 floats, so the 8 lanes that
//   such a load serves together read 8 different 16-byte columns of the banks.
// - The taps come in the kernel's parameters (constant memory): the tap index
//   is the same for the whole warp and costs no shared-memory load.
// - A tile is kSpan = 256 outputs along the axis: 256 + 2r lines are staged to
//   write 256 (1.38 reads an output at r = 49).  Two tiles live in dynamic
//   shared memory (130 KB at r = 128).
// - Blocks are persistent: as many as the device holds at once (two an SM in
//   pass 1, one in pass 2, whose 80 accumulators take 124 registers), each
//   walking over every gridDim.x-th tile.  The next tile is copied with
//   cp.async while the current one is summed, across planes and tile
//   positions, so only a block's first tile is waited for.
// - The copies are 16 bytes a thread where W is a multiple of 4 and, in pass
//   1, the tile needs no border: with 4 bytes a copy, issuing the copies
//   took a quarter of a pass's time from the sums.  Pass 1's tiles start up
//   to 3 columns left of the image so that each one's first staged column is
//   a multiple of 4.
// - Pass 1 turns its sums through the tile it has just read, so that the
//   scratch is written in full rows.
// Each tap is one __fmaf_rn, taps in ascending order: the sums round once a
// tap where the plain version rounds twice, so K3 agrees with its plain
// version to a bar (1e-4 px), not bit for bit, and is no further from a
// float64 run than the plain version is.
//
// Design limit: r <= 128, the size of the tap table in the parameters; the
// wrapper checks it.  The zero taps that pad the table to whole steps
// multiply staged, finite inputs.
//
// This is the float32 entry.  Farneback's reduced-precision route (bf16 M)
// takes agg_tc.cu, the same two passes as a banded bf16 product on the
// tensor cores.
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kSpan = 256;       // outputs a block along the filtered axis
constexpr int kLanes = 32;       // lines a block across it, one a lane
constexpr int kOut = 16;         // consecutive outputs a thread
constexpr int kRowTaps = 20;     // taps an unrolled step of pass 1 (99 -> 5 x 20), a multiple of 4
constexpr int kColTaps = 11;     // taps an unrolled step of pass 2 (99 = 9 x 11)
constexpr int kGroups = kSpan / kOut;  // threadIdx.y: a thread's place along the axis
constexpr int kThreads = kLanes * kGroups;
constexpr int kMaxHalfWindow = 128;
constexpr int kTurnStride = kSpan + 1;  // pass 1's sums in the tile, odd row stride
constexpr int kMaxDevices = 64;
constexpr int kVec = 4;  // floats a vector copy or load moves

// 2r+1 taps rounded up to whole steps of `step` taps; the tail is zero.
__host__ __device__ constexpr int padded_taps(int r, int step) {
  return (2 * r + 1 + step - 1) / step * step;
}

struct Taps {
  float v[padded_taps(kMaxHalfWindow, kRowTaps) > padded_taps(kMaxHalfWindow, kColTaps)
              ? padded_taps(kMaxHalfWindow, kRowTaps)
              : padded_taps(kMaxHalfWindow, kColTaps)];
};

// Pass 1's tile: kSpan + ntp staged columns a row, on a row stride of 4 mod 8
// floats.  Rows then start on a vector, and the 8 lanes that a 16-byte load
// serves together read different columns of the banks.
__host__ __device__ constexpr int row_tile_stride(int r) {
  const int span4 = (kSpan + padded_taps(r, kRowTaps) + 3) / 4 * 4;
  return span4 % 8 == 0 ? span4 + 4 : span4;
}

// Columns left of the image at which pass 1's tiles start.
__host__ __device__ constexpr int row_tile_pad(int r) { return (4 - r % 4) % 4; }

// One float into shared memory.
__device__ __forceinline__ void copy_one(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
// kVec floats (16 bytes) into shared memory.
__device__ __forceinline__ void copy_vec(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst[i] = in[i * kStride], i < kCount.  Consecutive inputs (kStride == 1)
// lie on a vector and are loaded kVec at a time.
template <int kStride, int kCount>
__device__ __forceinline__ void load_inputs(const float* __restrict__ in, float* dst) {
  if constexpr (kStride == 1) {
    static_assert(kCount % kVec == 0, "whole vector loads");
#pragma unroll
    for (int i = 0; i < kCount / kVec; ++i) {
      const float4 v = reinterpret_cast<const float4*>(in)[i];
      dst[4 * i] = v.x;
      dst[4 * i + 1] = v.y;
      dst[4 * i + 2] = v.z;
      dst[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCount; ++i) dst[i] = in[i * kStride];
  }
}

// Inputs a thread carries from one step to the next: the kOut - 1 that the
// next step's first tap still needs, or kOut where they come four at a time.
template <int kStride>
constexpr int kHeld = kStride == 1 ? kOut : kOut - 1;

// acc[j] = sum_k taps[k] * in[(j + k) * kStride], k ascending, j < kOut.
// `in` is the thread's first staged input; it reads ntp + kHeld of them.  A
// window of kHeld + kTaps inputs lives in registers: each step loads kTaps
// new inputs and kTaps taps for kOut * kTaps multiply-adds.
template <int kStride, int kTaps>
__device__ __forceinline__ void slide(const float* __restrict__ in, const Taps& taps, int ntp,
                                      float (&acc)[kOut]) {
  constexpr int held = kHeld<kStride>;
  float win[held + kTaps];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.0f;
  load_inputs<kStride, held>(in, win);
  for (int k0 = 0; k0 < ntp; k0 += kTaps) {
    load_inputs<kStride, kTaps>(in + (k0 + held) * kStride, win + held);
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float t = taps.v[k0 + k];
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[j] = __fmaf_rn(win[j + k], t, acc[j]);
    }
#pragma unroll
    for (int i = 0; i < held; ++i) win[i] = win[i + kTaps];
  }
}

// out[p, y, x] = sum_k taps[k] * in[p, y, clamp(x + k - r)].  A tile is 32 rows
// x 256 columns of one plane, lane = row; a block walks over every
// gridDim.x-th tile and copies its next tile while it sums this one.  Tiles
// start `pad` columns left of the image so that a tile's first staged column,
// its first output less r, is a multiple of 4: where W is one too, a tile
// that needs no border is copied 16 bytes a thread.
__global__ void __launch_bounds__(kThreads, 2)
smooth_rows_kernel(const float* __restrict__ in, float* __restrict__ out, const __grid_constant__ Taps taps,
                   int planes, int h, int w, int r) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  float* smem = reinterpret_cast<float*>(smem_bytes);
  const int ntp = padded_taps(r, kRowTaps);
  const int span = kSpan + ntp;  // staged columns
  const int stride = row_tile_stride(r);
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int pad = row_tile_pad(r);
  const int tiles_x = (w + pad + kSpan - 1) / kSpan;
  const int tiles_y = (h + kLanes - 1) / kLanes;
  const int tiles = planes * tiles_y * tiles_x;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const bool aligned = w % kVec == 0 && reinterpret_cast<uintptr_t>(in) % (kVec * sizeof(float)) == 0;

  auto stage = [&](int tile, float* dst) {
    const int x0 = tile % tiles_x * kSpan - pad - r;  // first staged column
    const int y0 = tile / tiles_x % tiles_y * kLanes;
    const float* plane = in + (tile / tiles_x / tiles_y) * hw;
    const int span4 = (span + kVec - 1) / kVec * kVec;
    const bool wide = aligned && x0 >= 0 && x0 + span4 <= w;
    for (int row = g; row < kLanes; row += kGroups) {
      const float* src = plane + static_cast<int64_t>(min(y0 + row, h - 1)) * w;
      if (wide) {
        for (int i = kVec * lane; i < span4; i += kVec * kLanes)
          copy_vec(dst + row * stride + i, src + x0 + i);
      } else {
        for (int i = lane; i < span; i += kLanes)
          copy_one(dst + row * stride + i, src + min(max(x0 + i, 0), w - 1));
      }
    }
    cp_async_commit();
  };

  float* cur = smem;
  float* next = smem + kLanes * stride;
  stage(blockIdx.x, cur);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the other buffer is free
    if (tile + gridDim.x < tiles) stage(tile + gridDim.x, next);
    float acc[kOut];
    slide<1, kRowTaps>(cur + lane * stride + g * kOut, taps, ntp, acc);
    const int x0 = tile % tiles_x * kSpan - pad;  // first output column
    const int y0 = tile / tiles_x % tiles_y * kLanes;
    float* plane = out + (tile / tiles_x / tiles_y) * hw;
    __syncthreads();  // every thread has read its inputs: turn the sums through the tile
#pragma unroll
    for (int j = 0; j < kOut; ++j) cur[lane * kTurnStride + g * kOut + j] = acc[j];
    __syncthreads();
    for (int row = g; row < kLanes && y0 + row < h; row += kGroups) {
      float* dst = plane + static_cast<int64_t>(y0 + row) * w + x0;
      for (int i = lane; i < kSpan && x0 + i < w; i += kLanes)
        if (x0 + i >= 0) dst[i] = cur[row * kTurnStride + i];
    }
    float* t = cur;
    cur = next;
    next = t;
  }
}

// Smooths the five row-smoothed planes of one image along H and solves.  A
// tile is 256 rows x 32 columns of one plane, lane = column; a block walks
// over every gridDim.x-th tile position through its five planes and copies
// the next plane's (or position's) tile while it sums this one.
__global__ void __launch_bounds__(kThreads, 1)
smooth_cols_solve_kernel(const float* __restrict__ in, float* __restrict__ fx, float* __restrict__ fy,
                         const __grid_constant__ Taps taps, int n, int h, int w, int r) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  float* smem = reinterpret_cast<float*>(smem_bytes);
  const int ntp = padded_taps(r, kColTaps);
  const int span = kSpan + ntp - 1;  // staged rows
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int tiles_x = (w + kLanes - 1) / kLanes;
  const int tiles_y = (h + kSpan - 1) / kSpan;
  const int tiles = n * tiles_y * tiles_x;
  const int64_t hw = static_cast<int64_t>(h) * w;
  // a vector a copy where every row of a tile starts on a vector
  const bool wide = w % kVec == 0 && reinterpret_cast<uintptr_t>(in) % (kVec * sizeof(float)) == 0;
  const int tid = g * kLanes + lane;
  auto stage = [&](int tile, int c, float* dst) {
    const int x0 = tile % tiles_x * kLanes;
    const int y0 = tile / tiles_x % tiles_y * kSpan - r;
    const float* plane = in + (static_cast<int64_t>(tile / tiles_x / tiles_y) * 5 + c) * hw;
    if (wide) {
      const int col = kVec * (tid % (kLanes / kVec));
      const float* src = plane + min(x0 + col, w - kVec);
      for (int i = tid / (kLanes / kVec); i < span; i += kThreads / (kLanes / kVec))
        copy_vec(dst + i * kLanes + col, src + static_cast<int64_t>(min(max(y0 + i, 0), h - 1)) * w);
    } else {
      const float* src = plane + min(x0 + lane, w - 1);
      for (int i = g; i < span; i += kGroups)
        copy_one(dst + i * kLanes + lane, src + static_cast<int64_t>(min(max(y0 + i, 0), h - 1)) * w);
    }
    cp_async_commit();
  };

  float* cur = smem;
  float* next = smem + span * kLanes;
  stage(blockIdx.x, 0, cur);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float s[5][kOut];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      cp_async_wait_all();
      __syncthreads();  // this tile has landed; the other buffer is free
      if (c + 1 < 5) {
        stage(tile, c + 1, next);
      } else if (tile + gridDim.x < tiles) {
        stage(tile + gridDim.x, 0, next);
      }
      slide<kLanes, kColTaps>(cur + g * kOut * kLanes + lane, taps, ntp, s[c]);
      float* t = cur;
      cur = next;
      next = t;
    }
    const int x = tile % tiles_x * kLanes + lane;
    if (x >= w) continue;
    const int y0 = tile / tiles_x % tiles_y * kSpan + g * kOut;
    const int64_t o = (tile / tiles_x / tiles_y) * hw + static_cast<int64_t>(y0) * w + x;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      if (y0 + j >= h) break;
      const float g11 = s[0][j], g12 = s[1][j], g22 = s[2][j], h1 = s[3][j], h2 = s[4][j];
      const float det = ma::add(ma::sub(ma::mul(g11, g22), ma::mul(g12, g12)), 1e-3f);
      const float idet = __fdiv_rn(1.0f, det);
      fx[o + static_cast<int64_t>(j) * w] = ma::mul(ma::sub(ma::mul(g11, h2), ma::mul(g12, h1)), idet);
      fy[o + static_cast<int64_t>(j) * w] = ma::mul(ma::sub(ma::mul(g22, h1), ma::mul(g12, h2)), idet);
    }
  }
}

size_t rows_smem(int r) { return sizeof(float) * 2 * kLanes * row_tile_stride(r); }

// Two staged tiles.
size_t cols_smem(int r) { return sizeof(float) * 2 * (kSpan + padded_taps(r, kColTaps) - 1) * kLanes; }

// Lifts `kernel`'s dynamic shared memory limit to `bytes` (what r = 128
// needs), once a device.
template <typename Kernel>
cudaError_t allow_shared_memory(Kernel kernel, size_t bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return e;
}

// one flag a device for each kernel
std::atomic<bool> rows_allowed[kMaxDevices];
std::atomic<bool> cols_allowed[kMaxDevices];

// As many blocks as the device runs at once with `smem` bytes each, at most
// one a tile.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int64_t tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorLaunchOutOfResources;
  *blocks = static_cast<int>(std::min<int64_t>(tiles, static_cast<int64_t>(sms) * per_sm));
  return e;
}

// `taps`: 2r+1 floats in host memory.
cudaError_t make_taps(const float* taps, int r, Taps* out) {
  if (r < 0 || r > kMaxHalfWindow) return cudaErrorInvalidValue;
  std::memset(out, 0, sizeof(Taps));
  std::memcpy(out->v, taps, sizeof(float) * (2 * r + 1));
  return cudaSuccess;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

cudaError_t launch_smooth_rows(const float* in, float* out, const Taps& taps, int planes, int h, int w,
                               int r, cudaStream_t stream) {
  const int64_t tiles = planes * ceil_div(h, kLanes) * ceil_div(w + row_tile_pad(r), kSpan);
  if (tiles <= 0) return cudaSuccess;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t e = allow_shared_memory(smooth_rows_kernel, rows_smem(kMaxHalfWindow), rows_allowed);
  int blocks = 0;
  if (e == cudaSuccess) e = resident_blocks(smooth_rows_kernel, rows_smem(r), tiles, &blocks);
  if (e != cudaSuccess) return e;
  smooth_rows_kernel<<<blocks, dim3(kLanes, kGroups), rows_smem(r), stream>>>(in, out, taps, planes, h, w, r);
  return cudaGetLastError();
}

cudaError_t launch_smooth_cols_solve(const float* in, float* fx, float* fy, const Taps& taps, int n, int h,
                                     int w, int r, cudaStream_t stream) {
  const int64_t tiles = n * ceil_div(h, kSpan) * ceil_div(w, kLanes);
  if (tiles <= 0) return cudaSuccess;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t e = allow_shared_memory(smooth_cols_solve_kernel, cols_smem(kMaxHalfWindow), cols_allowed);
  int blocks = 0;
  if (e == cudaSuccess) e = resident_blocks(smooth_cols_solve_kernel, cols_smem(r), tiles, &blocks);
  if (e != cudaSuccess) return e;
  smooth_cols_solve_kernel<<<blocks, dim3(kLanes, kGroups), cols_smem(r), stream>>>(in, fx, fy, taps, n, h, w, r);
  return cudaGetLastError();
}

}  // namespace

// Pass 1 alone: `planes` float (h, w) planes smoothed along W.  `taps` (2r+1
// floats) is in host memory; every other pointer is device memory.
extern "C" int ma_smooth_rows(const float* x, float* out, const float* taps, int planes, int h, int w, int r,
                              cudaStream_t stream) {
  Taps t;
  const cudaError_t e = make_taps(taps, r, &t);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_smooth_rows(x, out, t, planes, h, w, r, stream));
}

// M (n, 5, h, w) float -> fx, fy (n, h, w); scratch (n, 5, h, w) holds pass
// 1.  `taps` (2r+1 floats) is in host memory.
extern "C" int ma_smooth5_solve(const float* m, float* scratch, float* fx, float* fy, const float* taps, int n,
                                int h, int w, int r, cudaStream_t stream) {
  Taps t;
  cudaError_t e = make_taps(taps, r, &t);
  if (e == cudaSuccess) e = launch_smooth_rows(m, scratch, t, n * 5, h, w, r, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_smooth_cols_solve(scratch, fx, fy, t, n, h, w, r, stream));
}
